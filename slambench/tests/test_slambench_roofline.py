"""The work counts behind the roofline shares, on hand-built problems."""
import pytest
import torch

from slambench import roofline


def _problem():
    """3 poses (0 fixed, 2 invalid), 4 points of 3 slots: point 0 seen by
    poses 0 and 1, point 1 by pose 1 with one slot masked, point 2 invalid,
    point 3 with no slot."""
    K, P, M = 3, 4, 3
    obs_kf = torch.full((P, M), -1, dtype=torch.int32)
    obs_kf[0, :2] = torch.tensor([0, 1])
    obs_kf[1, :2] = torch.tensor([1, 1])
    obs_kf[2, 0] = 1
    mask = obs_kf >= 0
    mask[1, 1] = False
    return dict(q=torch.zeros(K, 4), obs_kf=obs_kf, obs_mask=mask,
                point_valid=torch.tensor([True, True, False, True]),
                pose_valid=torch.tensor([True, True, False]),
                pose_fixed=torch.tensor([True, False, False]))


def test_counts_from_masks():
    c = roofline.ba_counts(_problem())
    assert c == dict(slots=3, points=2, live_poses=1, poses=2)


def test_k2_k3_k1_work():
    c = dict(slots=3, points=2, live_poses=1, poses=2)
    read = 3 * 21 + 2 * 12 + 2 * 28
    b, f = roofline.k2_work(c, builds=10, cost_evals=1)
    assert b == 10 * (read + 3 * 284 + 2 * 36) + (read + 3 * 8)
    assert f == 3 * (400 * 10 + 60)
    b, f = roofline.k3_work(c, solves=10)
    assert b == 10 * 4 * (36 + 18 + 36) and f == 10 * 32 * 2 * 36
    assert roofline.k1_work(100) == (3100.0, 1211000.0)


def test_share():
    # 3.35 GB at 3.35 TB/s is 1 ms: read in 4 ms is 25 %
    assert roofline.share_pct(3.35e9, 0.0, 4e-3) == pytest.approx(25.0)
    assert roofline.share_pct(0.0, 67e9, 1e-3) == pytest.approx(100.0)
    assert roofline.share_pct(1.0, 1.0, 0.0) is None
