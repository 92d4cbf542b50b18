"""MapState: the fixed-capacity, batched replacement for Map/KeyFrame/MapPoint.

Counterpart of the JAX package's ``mapstate/state.py``; one NamedTuple of
tensors:

- keyframe axis K: poses, per-feature arrays [K, F], validity;
- point axis P: positions, distinctive descriptors, viewing stats;
- observations stored BOTH directions with bounded capacity:
    forward  kf_mp   [K, F]  feature -> observed point (-1 none)
    inverse  mp_obs_{kf,feat} [P, O] point -> (keyframe, feature);
- dense covisibility weight matrix [K, K] int32;
- spanning tree parent array;
- multi-agent/multi-map membership ids on both axes.

Mutation functions return new states and leave their input untouched
(state-in/state-out, like the JAX package), so parity is checked field by
field; the host orchestrator owns slot allocation counters. Where the JAX
code scatters with a sentinel index that is dropped, the helpers of
``utils.torch_ops`` write into a tensor one row longer and slice it off.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SlamConfig
from ..geometry import se3
from ..ops import hamming
from ..ops.frame import FrameFeatures
from ..utils.torch_ops import fill_at, set_drop, set_drop2

NONE = -1  # empty slot marker for index arrays


class MapState(NamedTuple):
    # --- keyframes -------------------------------------------------------
    kf_q: torch.Tensor          # [K, 4] world-to-camera quaternion
    kf_t: torch.Tensor          # [K, 3]
    kf_valid: torch.Tensor      # [K] bool
    kf_frame_id: torch.Tensor   # [K] int32 source frame index
    kf_agent: torch.Tensor      # [K] int32 owning agent
    kf_map: torch.Tensor        # [K] int32 logical map id
    kf_parent: torch.Tensor     # [K] int32 spanning-tree parent (-1 root)
    kf_fixed_origin: torch.Tensor  # [K] bool BA gauge anchors (Map origin KFs)
    kf_seq: torch.Tensor        # [K] int32 creation sequence number (slots
    #                             are recycled, so slot order is not age)
    # per-feature arrays
    kf_xy: torch.Tensor         # [K, F, 2] undistorted level-0 coords
    kf_right: torch.Tensor      # [K, F] right-image u (-1 mono/no match)
    kf_depth: torch.Tensor      # [K, F] depth (-1 unknown)
    kf_level: torch.Tensor      # [K, F] int32
    kf_angle: torch.Tensor      # [K, F]
    kf_desc: torch.Tensor       # [K, F, 8] int32 (uint32 bit pattern)
    kf_feat_valid: torch.Tensor  # [K, F] bool
    kf_mp: torch.Tensor         # [K, F] int32 -> point slot (-1 none)
    # --- map points ------------------------------------------------------
    mp_pos: torch.Tensor        # [P, 3]
    mp_valid: torch.Tensor      # [P] bool
    mp_desc: torch.Tensor       # [P, 8] int32 distinctive descriptor
    mp_normal: torch.Tensor     # [P, 3] mean viewing direction
    mp_min_dist: torch.Tensor   # [P] scale-invariance band
    mp_max_dist: torch.Tensor   # [P]
    mp_ref_kf: torch.Tensor     # [P] int32 reference keyframe
    mp_agent: torch.Tensor      # [P] int32 creating agent
    mp_map: torch.Tensor        # [P] int32 logical map id
    mp_visible: torch.Tensor    # [P] float32 visibility counter
    mp_found: torch.Tensor      # [P] float32 found counter
    mp_first_kf: torch.Tensor   # [P] int32 creation KF (for culling age)
    # inverse observations
    mp_obs_kf: torch.Tensor     # [P, O] int32 (-1 empty)
    mp_obs_feat: torch.Tensor   # [P, O] int32
    # --- graph -----------------------------------------------------------
    covis: torch.Tensor         # [K, K] int32 shared-observation weights

    # convenience --------------------------------------------------------
    @property
    def caps(self):
        K, F = self.kf_mp.shape
        P, O = self.mp_obs_kf.shape
        return K, F, P, O

    def mp_n_obs(self):
        return torch.sum(self.mp_obs_kf >= 0, dim=-1)


def empty_map_state(cfg: SlamConfig, device=torch.device("cuda")) -> MapState:
    K = cfg.caps.max_keyframes
    F = cfg.caps.max_features
    P = cfg.caps.max_points
    O = cfg.caps.max_obs_per_point
    i32, f32 = torch.int32, torch.float32

    def zeros(*s, dtype=f32):
        return torch.zeros(s, dtype=dtype, device=device)

    def full(s, v, dtype=f32):
        return torch.full(s if isinstance(s, tuple) else (s,), v, dtype=dtype,
                          device=device)

    kf_q = zeros(K, 4)
    kf_q.select(-1, 0).fill_(1.0)
    return MapState(
        kf_q=kf_q,
        kf_t=zeros(K, 3),
        kf_valid=zeros(K, dtype=torch.bool),
        kf_frame_id=full(K, NONE, i32),
        kf_agent=full(K, NONE, i32),
        kf_map=full(K, NONE, i32),
        kf_parent=full(K, NONE, i32),
        kf_fixed_origin=zeros(K, dtype=torch.bool),
        kf_seq=full(K, NONE, i32),
        kf_xy=zeros(K, F, 2),
        kf_right=full((K, F), -1.0),
        kf_depth=full((K, F), -1.0),
        kf_level=zeros(K, F, dtype=i32),
        kf_angle=zeros(K, F),
        kf_desc=zeros(K, F, 8, dtype=i32),
        kf_feat_valid=zeros(K, F, dtype=torch.bool),
        kf_mp=full((K, F), NONE, i32),
        mp_pos=zeros(P, 3),
        mp_valid=zeros(P, dtype=torch.bool),
        mp_desc=zeros(P, 8, dtype=i32),
        mp_normal=zeros(P, 3),
        mp_min_dist=zeros(P),
        mp_max_dist=full(P, 1e9),
        mp_ref_kf=full(P, NONE, i32),
        mp_agent=full(P, NONE, i32),
        mp_map=full(P, NONE, i32),
        mp_visible=full(P, 1.0),
        mp_found=full(P, 1.0),
        mp_first_kf=full(P, NONE, i32),
        mp_obs_kf=full((P, O), NONE, i32),
        mp_obs_feat=full((P, O), NONE, i32),
        covis=zeros(K, K, dtype=i32),
    )


def _set_row(arr, slot: int, val):
    """arr.at[slot].set(val) for a host-known slot; returns a new tensor."""
    out = arr.clone()
    if torch.is_tensor(val):
        out[slot] = val
    else:
        fill_at(out, slot, val)
    return out


# ---------------------------------------------------------------------------
# Observation bookkeeping
# ---------------------------------------------------------------------------

def add_observations(state: MapState, kf_slot: int, feat_idx, mp_idx, valid):
    """Record observations (kf_slot, feat_idx[i]) -> mp_idx[i].

    Updates the forward map kf_mp and appends to each point's inverse
    observation list (first free slot; silently drops if the point's O slots
    are full, the bounded-capacity analogue of MapPoint::AddObservation).
    """
    K, F, P, O = state.caps
    mp_idx = mp_idx.to(torch.int32)
    mp_safe = torch.where(valid, mp_idx, torch.full_like(mp_idx, P))

    # forward: kf_mp[kf_slot, feat] = mp
    feat_drop = torch.where(valid, feat_idx.to(torch.int32),
                            torch.full_like(mp_idx, F))
    kf_mp = state.kf_mp.clone()
    kf_mp[kf_slot] = set_drop(state.kf_mp[kf_slot], feat_drop, mp_idx)

    # inverse: find first free slot per point. Multiple new obs never target
    # the same point within one call (feature->point is injective per KF).
    free = state.mp_obs_kf < 0                       # [P, O]
    first_free = torch.argmax(free.to(torch.int8), dim=-1)   # [P]
    has_free = torch.any(free, dim=-1)
    mp_c = mp_safe.long().clamp(0, P - 1)
    slot = first_free[mp_c]
    ok = valid & has_free[mp_c]
    row = torch.where(ok, mp_safe, torch.full_like(mp_safe, P))
    mp_obs_kf = set_drop2(state.mp_obs_kf, row, slot, kf_slot)
    mp_obs_feat = set_drop2(state.mp_obs_feat, row, slot,
                            feat_idx.to(torch.int32))
    return state._replace(kf_mp=kf_mp, mp_obs_kf=mp_obs_kf,
                          mp_obs_feat=mp_obs_feat)


def update_covisibility(state: MapState, kf_slot: int):
    """Recompute covisibility row/col for one keyframe from shared
    observations (KeyFrame::UpdateConnections: weight = #shared MapPoints;
    the th=15 edge filter is applied at read time, not storage time)."""
    K, F, P, O = state.caps
    mp = state.kf_mp[kf_slot]                             # [F]
    mp_safe = mp.long().clamp(0, P - 1)
    obs_kf = torch.where((mp >= 0)[:, None], state.mp_obs_kf[mp_safe],
                         torch.full_like(state.mp_obs_kf[mp_safe], NONE))
    flat = torch.where(obs_kf >= 0, obs_kf,
                       torch.full_like(obs_kf, K)).reshape(-1).long()
    w = torch.zeros(K + 1, dtype=torch.int32, device=flat.device)
    w.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    w = fill_at(w[:K].clone(), kf_slot, 0)
    w = (w * state.kf_valid).to(torch.int32)
    covis = state.covis.clone()
    covis[kf_slot, :] = w
    covis[:, kf_slot] = w
    return state._replace(covis=covis)


def covis_neighbors_mask(state: MapState, kf_slot: int, min_weight: int = 1):
    """Row read of the covisibility graph (GetCovisiblesByWeight)."""
    return (state.covis[kf_slot] >= min_weight) & state.kf_valid


# ---------------------------------------------------------------------------
# Keyframe insertion
# ---------------------------------------------------------------------------

def insert_keyframe(state: MapState, kf_slot: int, feats: FrameFeatures, q, t,
                    frame_id, agent, map_id, mp_assign, parent,
                    fixed_origin=False):
    """Write a new keyframe into slot kf_slot and register its observations.

    mp_assign: [F] int32 point slot per feature (-1 none), the tracked map
    point associations carried over from the frame.
    """
    K, F, P, O = state.caps
    state = state._replace(
        kf_q=_set_row(state.kf_q, kf_slot, q),
        kf_t=_set_row(state.kf_t, kf_slot, t),
        kf_valid=_set_row(state.kf_valid, kf_slot, True),
        kf_frame_id=_set_row(state.kf_frame_id, kf_slot, frame_id),
        kf_agent=_set_row(state.kf_agent, kf_slot, agent),
        kf_map=_set_row(state.kf_map, kf_slot, map_id),
        kf_parent=_set_row(state.kf_parent, kf_slot, parent),
        kf_fixed_origin=_set_row(state.kf_fixed_origin, kf_slot, fixed_origin),
        kf_xy=_set_row(state.kf_xy, kf_slot, feats.xy),
        kf_right=_set_row(state.kf_right, kf_slot, feats.u_right),
        kf_depth=_set_row(state.kf_depth, kf_slot, feats.depth),
        kf_level=_set_row(state.kf_level, kf_slot, feats.level),
        kf_angle=_set_row(state.kf_angle, kf_slot, feats.angle),
        kf_desc=_set_row(state.kf_desc, kf_slot, feats.desc),
        kf_feat_valid=_set_row(state.kf_feat_valid, kf_slot, feats.valid),
    )
    feat_idx = torch.arange(F, dtype=torch.int32, device=mp_assign.device)
    valid = (mp_assign >= 0) & feats.valid
    state = add_observations(state, kf_slot, feat_idx, mp_assign, valid)
    return update_covisibility(state, kf_slot)


def add_points(state: MapState, slots, pos, desc, normal, min_dist, max_dist,
               ref_kf, agent, map_id, valid):
    """Batch-create map points in the given slots (MapPoint ctor +
    Map::AddMapPoint). slots: [N] int32; invalid entries are dropped.
    ref_kf / agent / map_id are scalars (host ints or 0-d tensors) or [N]."""
    K, F, P, O = state.caps
    row = torch.where(valid, slots, torch.full_like(slots, P))
    return state._replace(
        mp_pos=set_drop(state.mp_pos, row, pos),
        mp_valid=set_drop(state.mp_valid, row, True),
        mp_desc=set_drop(state.mp_desc, row, desc),
        mp_normal=set_drop(state.mp_normal, row, normal),
        mp_min_dist=set_drop(state.mp_min_dist, row, min_dist),
        mp_max_dist=set_drop(state.mp_max_dist, row, max_dist),
        mp_ref_kf=set_drop(state.mp_ref_kf, row, ref_kf),
        mp_agent=set_drop(state.mp_agent, row, agent),
        mp_map=set_drop(state.mp_map, row, map_id),
        mp_first_kf=set_drop(state.mp_first_kf, row, ref_kf),
        mp_visible=set_drop(state.mp_visible, row, 1.0),
        mp_found=set_drop(state.mp_found, row, 1.0),
        mp_obs_kf=set_drop(state.mp_obs_kf, row, NONE),
        mp_obs_feat=set_drop(state.mp_obs_feat, row, NONE),
    )


# ---------------------------------------------------------------------------
# Derived point attributes
# ---------------------------------------------------------------------------

# points per block in update_point_descriptors: the [block, O, 256] float
# bit planes stay near 100 MB at O = 24
_DESC_BLOCK = 4096


def update_point_descriptors(state: MapState, point_mask):
    """Medoid descriptor per point (ComputeDistinctiveDescriptors): the
    observed descriptor minimizing the median Hamming distance to all other
    observations of the point.

    point_mask: [P] bool, which points to refresh (others untouched).
    """
    K, F, P, O = state.caps
    big = 10_000
    new_desc = []
    n_vals = []
    for p0 in range(0, P, _DESC_BLOCK):
        obs_kf = state.mp_obs_kf[p0:p0 + _DESC_BLOCK]
        kf = obs_kf.long().clamp(0, K - 1)
        ft = state.mp_obs_feat[p0:p0 + _DESC_BLOCK].long().clamp(0, F - 1)
        descs = state.kf_desc[kf, ft]                       # [p, O, 8]
        valid = obs_kf >= 0                                 # [p, O]
        d = hamming.hamming_matrix(descs, descs)            # [p, O, O]
        d = torch.where(valid[:, :, None] & valid[:, None, :], d,
                        torch.full_like(d, big))            # [p, O, O]
        # median over valid columns ~ sorted take at n_valid/2 (the
        # reference takes the median of each row and picks the min)
        d_sorted = torch.sort(d, dim=-1).values
        n_val = torch.sum(valid, dim=-1)                    # [p]
        med_idx = (n_val // 2).clamp(0, O - 1)
        med = torch.gather(d_sorted, -1,
                           med_idx[:, None, None].expand(-1, O, 1))[..., 0]
        med = torch.where(valid, med, torch.full_like(med, big))
        best = torch.argmin(med, dim=-1)                    # [p]
        new_desc.append(torch.gather(
            descs, 1, best[:, None, None].expand(-1, 1, 8))[:, 0])
        n_vals.append(n_val)
    new_desc = torch.cat(new_desc, 0)
    upd = point_mask & (torch.cat(n_vals, 0) > 0)
    return state._replace(
        mp_desc=torch.where(upd[:, None], new_desc, state.mp_desc))


def update_point_normals(state: MapState, point_mask, scale_factor: float,
                         n_levels: int):
    """Viewing normal + scale-invariance distance band
    (UpdateNormalAndDepth)."""
    K, F, P, O = state.caps
    kf = state.mp_obs_kf.long().clamp(0, K - 1)
    valid = state.mp_obs_kf >= 0
    # camera centers: Ow = -R^T t
    _, centers = se3.inverse(state.kf_q, state.kf_t)    # [K, 3]
    c = centers[kf]                                     # [P, O, 3]
    v = state.mp_pos[:, None, :] - c
    norm = torch.linalg.norm(v, dim=-1, keepdim=True)
    v = v / norm.clamp_min(1e-9)
    normal = torch.sum(torch.where(valid[..., None], v, torch.zeros_like(v)),
                       dim=1)
    n_val = torch.sum(valid, dim=-1).clamp_min(1)
    normal = normal / n_val[:, None]
    normal = normal / torch.linalg.norm(normal, dim=-1,
                                        keepdim=True).clamp_min(1e-9)

    # distance band from the reference keyframe's observation level
    ref = state.mp_ref_kf.long().clamp(0, K - 1)
    ref_c = centers[ref]
    dist = torch.linalg.norm(state.mp_pos - ref_c, dim=-1)
    ft0 = state.mp_obs_feat[:, 0].long().clamp(0, F - 1)
    kf0 = state.mp_obs_kf[:, 0].long().clamp(0, K - 1)
    level = state.kf_level[kf0, ft0]
    level_sf = scale_factor ** level.to(torch.float32)
    max_dist = dist * level_sf
    min_dist = max_dist / (scale_factor ** (n_levels - 1))
    upd = point_mask & (torch.sum(valid, -1) > 0)
    return state._replace(
        mp_normal=torch.where(upd[:, None], normal, state.mp_normal),
        mp_max_dist=torch.where(upd, max_dist, state.mp_max_dist),
        mp_min_dist=torch.where(upd, min_dist, state.mp_min_dist))


def predict_scale(dist, max_dist, scale_factor: float, n_levels: int):
    """Predict the pyramid level at which a point should be observed given its
    distance (MapPoint::PredictScale)."""
    ratio = max_dist.clamp_min(1e-9) / dist.clamp_min(1e-9)
    # float32 logarithm of the scale factor, as the JAX package computes it
    log_sf = float(np.log(np.float32(scale_factor)))
    level = torch.ceil(torch.log(ratio) / log_sf)
    return level.clamp(0, n_levels - 1).to(torch.int32)
