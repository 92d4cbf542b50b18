"""The post-fusion maps at the configurations' capacities: sizes, masks
and layout."""
import pytest
import torch

from multiagent_orb_slam2_tpu_torch.optim import ba
from slambench import gbamap, manifest


@pytest.mark.parametrize("name", ["kitti00_split2", "euroc_mh01_split2"])
def test_map_sizes_and_masks(name):
    cell = manifest.cell(f"{name}.gba")
    cfg = cell.config
    m = gbamap.make_map(cfg, 2 ** 31 + 11, "cpu")
    f = gbamap.problem_fields(m)
    caps = cfg["capacities"]
    K, P, M = (caps[k] for k in ("max_keyframes", "max_points",
                                 "max_obs_per_point"))
    gm = cfg["gba_map"]
    n_kf = sum(int(round(v)) for v in gm["keyframes"])
    assert f["q"].shape == (K, 4) and f["obs_kf"].shape == (P, M)
    assert int(f["pose_valid"].sum()) == n_kf == m["n_kf"]
    assert int(f["pose_fixed"].sum()) == 1 and bool(f["pose_fixed"][0])
    assert int(f["point_valid"].sum()) == gm["points"]
    mask = f["obs_mask"]
    assert torch.equal(mask, f["obs_kf"] >= 0)
    assert not mask[~f["point_valid"]].any()
    # slots filled first, two views at least, every view a live keyframe
    n = mask.sum(1)
    assert torch.equal(mask, torch.arange(M)[None] < n[:, None])
    assert int(n[f["point_valid"]].min()) >= 2
    assert bool(f["pose_valid"][f["obs_kf"][mask].long()].all())
    assert not (f["obs_stereo"] & ~mask).any()
    mean = float(n[f["point_valid"]].float().mean())
    assert 7.5 < mean < 9.5                # about 8 views a point
    # quaternions of unit norm, the fixed pose at its true value
    assert torch.allclose(f["q"].norm(dim=-1), torch.ones(K), atol=1e-5)
    assert torch.equal(f["q"][0], m["true_q"][0])


def test_same_seed_same_map_and_overflow_only_in_the_room():
    def n_ov(name, seed):
        cfg = manifest.cell(f"{name}.gba").config
        f = gbamap.problem_fields(gbamap.make_map(cfg, seed, "cpu"))
        prob = ba.BAProblem(**f)
        return int(ba._classify_band(prob, 2048, 128, 64)[3]), f

    a, fa = n_ov("kitti00_split2", 5)
    _, fb = n_ov("kitti00_split2", 5)
    assert all(torch.equal(fa[k], fb[k]) for k in fa)
    assert a == 0
    e, _ = n_ov("euroc_mh01_split2", 5)
    # out of band, yet within the banded path's overflow capacity of 8,192
    assert 4096 < e <= 8192
