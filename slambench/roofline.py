"""Peaks of the card and the work a kernel's call needs, counted from the
problem's own masks (not from the program's internal lists), so that a
kernel's roofline share reads the same work whatever implements it.

A share is the least time the card could take (the larger of operations
over the peak rate and bytes over the peak bandwidth) over the measured
kernel time. Bytes count each input the function needs read once and each
output it must produce written once.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS_F32 = 67e12            # float32 outside the tensor cores

F32, I32 = 4, 4


def share_pct(bytes_: float, flops: float, seconds: float):
    """Roofline share in %, or None where no kernel time was read."""
    if seconds <= 0:
        return None
    floor = max(bytes_ / PEAK_BYTES_PER_S, flops / PEAK_FLOPS_F32)
    return 100.0 * floor / seconds


def ba_counts(f: dict) -> dict:
    """Sizes of one BA problem (the port's BAProblem fields) from its
    masks: active slots, listed points (with an active slot), live poses
    (valid, not fixed, observed) and all valid poses."""
    import torch
    act = f["obs_mask"] & (f["obs_kf"] >= 0) & f["point_valid"][:, None]
    K = f["q"].shape[0]
    seen = torch.zeros(K, dtype=torch.bool, device=act.device)
    seen[f["obs_kf"][act].long()] = True
    live = seen & f["pose_valid"] & ~f["pose_fixed"]
    return dict(slots=int(act.sum()), points=int(act.any(1).sum()),
                live_poses=int(live.sum()), poses=int(f["pose_valid"].sum()))


def k2_work(c: dict, builds: int, cost_evals: int):
    """(bytes, flops) of the Schur preparation over `builds` full builds
    and `cost_evals` cost-only evaluations of one solve. A slot reads its
    pose index, (u, v, u_r), its weight and its flags (13 + 1 bytes) and a
    full build writes its 18 + 18 + 33 terms, its robust cost and chi2 (71
    floats); a point reads its position and writes its damped inverse and
    right-hand side (3 + 9 floats); each observed pose is read once (7
    floats). A cost-only evaluation writes the cost and chi2 alone.
    Operations: about 400 a slot a full build, 60 cost-only."""
    read = c["slots"] * (I32 + 3 * F32 + F32 + 1) + c["points"] * 3 * F32 \
        + c["poses"] * 7 * F32
    full = read + c["slots"] * 71 * F32 + c["points"] * 9 * F32
    cost = read + c["slots"] * 2 * F32
    return (builds * full + cost_evals * cost,
            c["slots"] * (400 * builds + 60 * cost_evals))


def k3_work(c: dict, solves: int, cg_iters: int = 32):
    """(bytes, flops) of `solves` preconditioned CG solves of the reduced
    camera system on its live poses (DL = 6 x live poses): the live block
    of S, the right-hand side, the 6x6 preconditioner blocks and the start
    read once, the solution written once; 2 DL^2 operations an iteration
    for S p."""
    DL = 6 * c["live_poses"]
    b = (DL * DL + 3 * DL + 36 * c["live_poses"]) * F32
    return solves * b, solves * cg_iters * 2 * DL * DL


def k1_work(valid_obs: float):
    """(bytes, flops) of the pose optimizations over `valid_obs` valid
    observations, summed over the calls: each reads its point, (u, v,
    u_r), weight and flags and writes its inlier flag (31 bytes); about
    12,110 operations (residual, cost and normal equations in the 44
    passes of 4 rounds of 10 iterations, 5 relabellings and the final
    chi2), the count the port's kernel table gives."""
    return 31.0 * valid_obs, 12110.0 * valid_obs
