"""Post-fusion maps for the global-BA cells, drawn on the device from a seed.

A map is what a two-agent split has when its fusion hands the merged map
to global BA: the keyframes of both agents (interleaved in slot order as
the two agents created them, round robin in time), the points they
observe with their observation slots filled first, stereo observations
where the point is nearer than ThDepth baselines, pixel noise of the
feature's pyramid level, and poses and points perturbed from the truth so
that LM has work. The layout is the port's capacity layout (K keyframe
slots, P point slots, M observation slots a point); unused slots are
masked, as ``runtime/loop_closing.global_bundle_adjustment`` lays a map.

The configuration's ``gba_map`` block picks the trajectory:

- ``forward``: a vehicle driving forward with a slow random yaw (KITTI);
  a point is seen by a run of consecutive keyframes of one agent;
- ``room``: a camera circling a room ``laps`` times, looking outward
  (EuRoC MH01); a share of the points is seen again on a later lap, by
  keyframes far apart in slot order (the banded assembly's overflow pass).

Every draw comes from one ``torch.Generator`` on the device, in a few
large calls; sizes do not depend on the seed except through the
visibility of a slot, so every seed gives the same amount of work to
within a fraction of a percent.
"""
from __future__ import annotations

import math

import torch

# the fields of the port's BAProblem, in its order
FIELDS = ("q", "t", "pose_valid", "pose_fixed", "pw", "point_valid",
          "obs_kf", "obs_uvr", "obs_inv_sigma2", "obs_stereo", "obs_mask")


def sub_seed(seed: int, i: int) -> int:
    """A seed for the i-th draw of a run's seed, within 63 bits."""
    return (int(seed) * 1_000_003 + 7919 * (i + 1)) % (2 ** 63 - 1)


def _quat_from_yaw_pitch(yaw, pitch):
    """(w, x, y, z) of R_y(yaw) R_x(pitch): camera-to-world rotations of a
    camera whose optical axis is +z at yaw = pitch = 0."""
    cy, sy = torch.cos(yaw / 2), torch.sin(yaw / 2)
    cp, sp = torch.cos(pitch / 2), torch.sin(pitch / 2)
    return torch.stack([cy * cp, cy * sp, sy * cp, -sy * sp], -1)


def quat_to_rot(q):
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(q.shape[:-1] + (3, 3))


def quat_mul(a, b):
    w1, x1, y1, z1 = a.unbind(-1)
    w2, x2, y2, z2 = b.unbind(-1)
    return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)


def _axis_angle_quat(phi):
    th = phi.norm(dim=-1, keepdim=True)
    k = phi / th.clamp_min(1e-12)
    return torch.cat([torch.cos(th / 2), torch.sin(th / 2) * k], -1)


def _trajectory(gm: dict, n: int, g: torch.Generator, dev):
    """Camera-to-world rotations (q_wc [n, 4]) and centres (c_wc [n, 3])
    of the whole run."""
    f32 = dict(dtype=torch.float32, device=dev)
    if gm["trajectory"] == "forward":
        dyaw = torch.randn(n, generator=g, **f32) * gm["yaw_step_rad"]
        yaw = torch.cumsum(dyaw, 0)
        step = gm["kf_step_m"]
        d = torch.stack([torch.sin(yaw), torch.zeros_like(yaw),
                         torch.cos(yaw)], -1) * step
        c = torch.cumsum(d, 0) - d[:1]
        c = c + torch.randn(n, 3, generator=g, **f32) * gm["jitter_m"]
        pitch = torch.randn(n, generator=g, **f32) * gm["pitch_rad"]
    elif gm["trajectory"] == "room":
        ang = torch.arange(n, **f32) * (2 * math.pi * gm["laps"] / n)
        ang = ang + torch.randn(n, generator=g, **f32) * gm["yaw_jitter_rad"]
        r = gm["orbit_m"]
        c = torch.stack([r * torch.sin(ang), torch.zeros_like(ang),
                         r * torch.cos(ang)], -1)
        c = c + torch.randn(n, 3, generator=g, **f32) * gm["jitter_m"]
        yaw = ang       # looking outward, away from the room's centre
        pitch = torch.randn(n, generator=g, **f32) * gm["pitch_rad"]
    else:
        raise ValueError(f"gba_map trajectory: unknown {gm['trajectory']!r}")
    return _quat_from_yaw_pitch(yaw, pitch), c


def _slot_of_sequence(n_kf):
    """Keyframe slot of each sequence index: the agents' keyframes (agent
    a's are a contiguous stretch of the run) in the order two agents
    tracking round robin create them, by the share of their run done."""
    times, order_key = [], []
    for a, n in enumerate(n_kf):
        i = torch.arange(n, dtype=torch.float64)
        times.append(i / n)
        order_key.append(torch.full((n,), a, dtype=torch.float64))
    t = torch.cat(times)
    key = t * 16 + torch.cat(order_key) / 16
    slot = torch.empty(len(t), dtype=torch.int64)
    slot[torch.argsort(key, stable=True)] = torch.arange(len(t))
    return slot


def level_probs(n_levels: int, scale_factor: float):
    """Share of the features at each pyramid level: ORB's geometric
    per-level budget (ORBextractor's constructor)."""
    inv = 1.0 / scale_factor
    p = torch.tensor([inv ** i for i in range(n_levels)], dtype=torch.float64)
    return p / p.sum()


def make_map(cfg: dict, seed: int, device) -> dict:
    """The fields of one post-fusion map (the port's BAProblem, as tensors
    on `device`), plus the true poses and points it was drawn around
    (``true_q``, ``true_t``, ``true_pw``) and ``n_kf``, the live keyframes.
    """
    dev = torch.device(device)
    gm = cfg["gba_map"]
    cam = cfg["camera"]
    K, P, M = (cfg["capacities"][k] for k in
               ("max_keyframes", "max_points", "max_obs_per_point"))
    n_kf = [int(round(v)) for v in gm["keyframes"]]
    N = sum(n_kf)
    n_live = gm["points"]
    # candidates: the first `points` of them that two keyframes see are kept
    NP = int(n_live * gm["oversample"])
    if N > K or n_live > P or gm["max_track"] > M:
        raise ValueError("gba_map does not fit the capacities")
    g = torch.Generator(device=dev)
    g.manual_seed(sub_seed(seed, 0))
    f32 = dict(dtype=torch.float32, device=dev)

    q_wc, c_wc = _trajectory(gm, N, g, dev)
    R_wc = quat_to_rot(q_wc)
    # world-to-camera
    q_cw = q_wc * torch.tensor([1.0, -1.0, -1.0, -1.0], **f32)
    R_cw = quat_to_rot(q_cw)
    t_cw = -(R_cw @ c_wc[:, :, None])[..., 0]
    agent_end = torch.tensor([n_kf[0], N], device=dev)

    # points: drawn in their first observer's view
    anchor = torch.randint(0, N, (NP,), generator=g, device=dev)
    pix = torch.rand(NP, 2, generator=g, **f32)
    u0 = pix[:, 0] * (cam["width"] - 1)
    v0 = pix[:, 1] * (cam["height"] - 1)
    lo, hi = gm["depth_m"]
    d = lo + (hi - lo) * torch.rand(NP, generator=g, **f32)
    ray = torch.stack([(u0 - cam["cx"]) / cam["fx"] * d,
                       (v0 - cam["cy"]) / cam["fy"] * d, d], -1)
    pw = (R_wc[anchor] @ ray[:, :, None])[..., 0] + c_wc[anchor]

    # track lengths: 2 + a geometric draw with the configured mean
    def track_len(n, mean):
        p = 1.0 / max(mean - 1.0, 1.0 + 1e-6)
        u = torch.rand(n, generator=g, **f32).clamp_min(1e-12)
        geo = torch.floor(torch.log(u) / math.log(1.0 - p))
        return (2 + geo).clamp(max=gm["max_track"]).long()

    first_len = track_len(NP, gm["mean_track"])
    ar = torch.arange(M, device=dev)
    seq = anchor[:, None] + ar[None, :]                         # [NP, M]
    in_first = ar[None, :] < first_len[:, None]
    # a track stays inside its agent's own run
    ag = (anchor >= n_kf[0]).long()
    in_first &= seq < agent_end[ag][:, None]

    # revisits: an exact number of points seen again a lap later
    n_rev = int(round(gm.get("revisit_share", 0.0) * NP))
    if n_rev:
        lap = N / gm["laps"]
        rev = torch.randperm(NP, generator=g, device=dev)[:n_rev]
        k = 1 + torch.randint(0, max(int(gm["laps"]) - 1, 1), (n_rev,),
                              generator=g, device=dev)
        a2 = anchor[rev] + torch.round(k * lap).long()
        a2 = torch.where(a2 >= N, anchor[rev] - int(round(lap)), a2)
        a2 = a2.clamp(0, N - 1)
        second_len = track_len(n_rev, gm["mean_track"])
        n1 = in_first[rev].sum(1)
        # the second track follows the first in the point's slots
        pos2 = ar[None, :] - n1[:, None]
        s2 = a2[:, None] + pos2
        in_second = (pos2 >= 0) & (pos2 < second_len[:, None]) & (s2 < N)
        seq_rev = torch.where(ar[None, :] < n1[:, None], seq[rev], s2)
        seq[rev] = seq_rev
        in_first[rev] = in_first[rev] | in_second
    used = in_first
    seq = seq.clamp(0, N - 1)

    # project with the true poses; keep what the camera sees
    Rk = R_cw[seq]
    pc = (Rk @ pw[:, None, :, None])[..., 0] + t_cw[seq]
    z = pc[..., 2]
    zc = z.clamp_min(1e-3)
    u = cam["fx"] * pc[..., 0] / zc + cam["cx"]
    v = cam["fy"] * pc[..., 1] / zc + cam["cy"]
    seen = used & (z > 0.5) & (u >= 0) & (u <= cam["width"] - 1) \
        & (v >= 0) & (v <= cam["height"] - 1)

    probs = level_probs(cfg["orb"]["n_levels"],
                        cfg["orb"]["scale_factor"]).to(torch.float32).to(dev)
    level = torch.multinomial(probs, NP * M, replacement=True,
                              generator=g).reshape(NP, M)
    sigma = cfg["orb"]["scale_factor"] ** level.to(torch.float32)
    noise = torch.randn(NP, M, 3, generator=g, **f32) * gm["pixel_noise"]
    bf = cam["bf"]
    ur = u - bf / zc
    stereo = seen & (z < cfg["th_depth"] * bf / cam["fx"])
    uvr = torch.stack([u, v, ur], -1) + noise * sigma[..., None]
    uvr[..., 2] = torch.where(stereo, uvr[..., 2], torch.full_like(ur, -1.0))

    # slots filled first; a point with fewer than two views is not in the map
    order = torch.argsort((~seen).to(torch.int8), dim=1, stable=True)
    seen = torch.gather(seen, 1, order)
    kf_slot = _slot_of_sequence(n_kf).to(dev)[torch.gather(seq, 1, order)]
    uvr = torch.gather(uvr, 1, order[..., None].expand(-1, -1, 3))
    stereo = torch.gather(stereo, 1, order)
    level = torch.gather(level, 1, order)
    # a point seen only in mono needs ORB-SLAM2's triangulation parallax
    # (the cosine of the rays' angle under 0.9998) between two of its views
    c_obs = c_wc[seq]                                          # [NP, M, 3]
    ray = pw[:, None, :] - c_obs
    ray = ray / ray.norm(dim=-1, keepdim=True).clamp_min(1e-9)
    first = torch.argmax(seen.to(torch.int8), dim=1)
    last = M - 1 - torch.argmax(seen.flip(1).to(torch.int8), dim=1)
    ar_p = torch.arange(NP, device=dev)
    cos_par = (ray[ar_p, first] * ray[ar_p, last]).sum(-1)
    twice = (seen.sum(1) >= 2) & (stereo.any(1) | (cos_par < 0.9998))
    keep = torch.nonzero(twice)[:n_live, 0]
    if len(keep) < n_live:
        raise ValueError(f"gba_map: {len(keep)} of {n_live} points seen "
                         "twice; raise oversample")
    NP = n_live
    pw, seen, kf_slot, uvr, stereo, level = (
        x[keep] for x in (pw, seen, kf_slot, uvr, stereo, level))
    mask = seen
    live = torch.ones(NP, dtype=torch.bool, device=dev)

    # the truth, in slot order, and the perturbed start
    slot = _slot_of_sequence(n_kf).to(dev)
    qt = torch.zeros(K, 4, **f32)
    qt[:, 0] = 1
    tt = torch.zeros(K, 3, **f32)
    qt[slot] = q_cw
    tt[slot] = t_cw
    valid = torch.zeros(K, dtype=torch.bool, device=dev)
    valid[slot] = True
    fixed = torch.zeros(K, dtype=torch.bool, device=dev)
    fixed[slot[0]] = True
    xi = torch.randn(K, 6, generator=g, **f32)
    xi[:, :3] *= gm["pose_noise_m"]
    xi[:, 3:] *= gm["pose_noise_rad"]
    xi[fixed | ~valid] = 0
    dq = _axis_angle_quat(xi[:, 3:])
    q0 = quat_mul(dq, qt)
    q0 = q0 / q0.norm(dim=-1, keepdim=True)
    q0 = torch.where(q0[:, :1] < 0, -q0, q0)
    t0 = (quat_to_rot(dq) @ tt[:, :, None])[..., 0] + xi[:, :3]

    pw_full = torch.zeros(P, 3, **f32)
    pw_full[:NP] = pw
    pw0 = pw_full.clone()
    pw0[:NP] += torch.randn(NP, 3, generator=g, **f32) * gm["point_noise_m"]
    pv = torch.zeros(P, dtype=torch.bool, device=dev)
    pv[:NP] = live

    def pad(x, fill):
        out = torch.full((P,) + x.shape[1:], fill, dtype=x.dtype, device=dev)
        out[:NP] = x
        return out

    obs_kf = pad(torch.where(mask, kf_slot, torch.full_like(kf_slot, -1)),
                 -1).to(torch.int32)
    sf = cfg["orb"]["scale_factor"]
    isig = 1.0 / (sf ** (2 * level.to(torch.float32)))
    return dict(
        q=q0, t=t0, pose_valid=valid, pose_fixed=fixed,
        pw=pw0, point_valid=pv, obs_kf=obs_kf,
        obs_uvr=pad(torch.where(mask[..., None], uvr, torch.zeros_like(uvr)),
                    0.0),
        obs_inv_sigma2=pad(torch.where(mask, isig, torch.ones_like(isig)),
                           1.0),
        obs_stereo=pad(stereo & mask, False), obs_mask=pad(mask, False),
        true_q=qt, true_t=tt, true_pw=pw_full, n_kf=N)


def problem_fields(m: dict) -> dict:
    """The BAProblem's fields of a map from ``make_map``."""
    return {k: m[k] for k in FIELDS}
