"""Seeded bundle-adjustment problems for the tests of the Schur-prep kernel
(optim/ba_prep.py, csrc/ba_prep.cu), and its check on the card.

Imports numpy, torch and the port only, so the card check also runs where
the JAX package is not installed:

    python3 tests/torch_ba_cases.py      # every card case, on one NVIDIA GPU
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multiagent_orb_slam2_tpu_torch.io import ba_problem  # noqa: E402
from multiagent_orb_slam2_tpu_torch.optim import ba_prep  # noqa: E402

K, P, M = 8, 1024, 8
D2M, D2S = 5.991, 7.815
LAM = 1e-3


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def mixed_fields():
    """A seeded problem with a stereo / mono mix, per-level information,
    masked slots, an invalid point and an unset pose index (numpy)."""
    fields, cam = ba_problem.build_problem(K, P, M, seed=5, active_share=0.8)
    rng = np.random.default_rng(6)
    fields["obs_stereo"] = rng.random((P, M)) < 0.7
    fields["obs_inv_sigma2"] = (1.0 / 1.2 ** (2 * rng.integers(0, 8, (P, M)))
                                ).astype(np.float32)
    fields["point_valid"][5] = False
    fields["obs_kf"][7, 2] = -1
    return fields, cam


def in_camera(q, t, pc):
    """The world point at camera coordinates pc of the pose (q, t)."""
    w, x, y, z = (float(v) for v in q)
    R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                   2 * (x * z + w * y)],
                  [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                   2 * (y * z - w * x)],
                  [2 * (x * z - w * y), 2 * (y * z + w * x),
                   1 - 2 * (x * x + y * y)]])
    return (R.T @ (np.asarray(pc, np.float64) - t)).astype(np.float32)


def slot_cases_fields(n_poses=8, n_points=300, n_slots=24, share=0.15,
                      seed=9):
    """A thin seeded problem with the slot cases of the kernel's mapping:
    point 3 has all its slots active, point 7 one slot, behind its camera,
    point 9 slots in front of one camera and behind two others, point 11 no
    active slot."""
    fields, cam = ba_problem.build_problem(n_poses, n_points, n_slots,
                                           seed=seed, active_share=share)
    mask, kf = fields["obs_mask"], fields["obs_kf"]
    q, t = fields["q"], fields["t"]
    mask[3] = True
    mask[7] = False
    mask[7, 5] = True
    kf[7, 5] = 2
    fields["pw"][7] = in_camera(q[2], t[2], (0.3, 0.2, -5.0))
    mask[9] = False
    mask[9, :3] = True
    kf[9, :3] = (0, 2, 3)
    fields["pw"][9] = in_camera(q[0], t[0], (0.2, -0.1, 1.5))
    mask[11] = False
    return fields, cam


CARD_CASES = ("random_m8", "random_m24", "packed_low_m24", "many_waves_m8",
              "many_waves_m24", "full_and_behind_m24", "none_active_m24")


def card_fields(case):
    """(fields, cam) of a card case: a random mask at M = 8 (the mixed
    problem) and 24; active points packed at low indices with low slots, as
    the local BA's map has them; more listed points than one pass of the
    persistent grid (its stride is even, P is odd); all slots of a point and
    behind-camera slots; no active slot at all."""
    if case == "random_m8":
        return mixed_fields()
    if case == "random_m24":
        return ba_problem.build_problem(16, 3001, 24, seed=21,
                                        active_share=0.13)
    if case == "packed_low_m24":
        fields, cam = ba_problem.build_problem(16, 4097, 24, seed=22)
        fields["obs_mask"][700:] = False
        fields["obs_mask"][:, 6:] = False
        return fields, cam
    if case == "many_waves_m8":
        return ba_problem.build_problem(32, 40001, 8, seed=23,
                                        active_share=0.5)
    if case == "many_waves_m24":
        return ba_problem.build_problem(32, 20001, 24, seed=24,
                                        active_share=0.3)
    if case == "full_and_behind_m24":
        return slot_cases_fields(n_points=1001)
    if case == "none_active_m24":
        fields, cam = ba_problem.build_problem(8, 2001, 24, seed=25)
        fields["obs_mask"][:] = False
        return fields, cam
    raise ValueError(f"no card case {case!r}")


def check_prep_on_card(case, device):
    """The list of points with an active slot (on the card: the compaction
    kernel) against numpy, then csrc/ba_prep.cu against the plain version on
    the same CUDA tensors:
    1e-3 of each output's scale (measured up to 4.6e-4: one-ulp differences
    of fused multiply-adds, amplified where world coordinates cancel against
    small depths); with no active point nothing is written and every output
    stays 0. Two launches are bit-identical and the cost-only mode equals
    the full mode. Returns the largest error over scale."""
    fields, cam = card_fields(case)
    t = {k: torch.from_numpy(np.array(v)).to(device)
         for k, v in fields.items()}
    ws = ba_prep.prepare(t["obs_kf"], t["obs_uvr"], t["obs_inv_sigma2"],
                         t["obs_stereo"], t["obs_mask"], t["point_valid"],
                         t["q"].shape[0])
    active = (fields["obs_mask"] & (fields["obs_kf"] >= 0)
              & fields["point_valid"][:, None])
    want = np.flatnonzero(active.any(axis=1))
    n = int(ws.n_points[0])
    assert n == len(want)
    np.testing.assert_array_equal(ws.points[:n].cpu().numpy(), want)
    assert not ws.points[n:].any()
    lam = torch.full((1,), LAM, device=device)
    args = (ws, t["q"], t["t"], t["pw"], lam, cam, D2M, D2S, True)
    before = ba_prep.prep_terms.launches
    k = ba_prep.prep_terms(*args)
    assert ba_prep.prep_terms.launches == before + 1
    kept = ba_prep.PrepTerms(*[a.clone() for a in k])
    p = ba_prep._prep_terms_plain(*args)
    worst = 0.0
    for name, a, b in zip(kept._fields, kept, p):
        if case.startswith("none_active"):
            assert not a.any() and not b.any(), name
        else:
            err = rel_err(a.cpu().numpy(), b.cpu().numpy())
            assert err <= 1e-3, (case, name, err)
            worst = max(worst, err)
    again = ba_prep.prep_terms(*args)
    for name, a, b in zip(kept._fields, again, kept):
        assert torch.equal(a, b), (case, name)
    c = ba_prep.prep_terms(ws, t["q"], t["t"], t["pw"], None, cam, D2M, D2S,
                           True, cost_only=True)
    assert torch.equal(c.cost, kept.cost) and torch.equal(c.chi2, kept.chi2)
    return worst


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    for name in CARD_CASES:
        print(name, "max error over scale",
              check_prep_on_card(name, torch.device("cuda")), flush=True)
