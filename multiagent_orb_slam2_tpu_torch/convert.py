"""Carry state between the JAX package and this one, through numpy.

The engine has no weights; its state is ``MapState``, ``FrameFeatures``,
``PoseObs``, the bundle-adjustment tuples ``BAProblem`` / ``BAResult``, the
loop-closing tuples ``PoseGraphEdges`` / ``PoseGraphResult`` and a verified
loop or fusion match ``Sim3Match``, the keyframe database ``KFDatabase`` and
the ``Vocabulary``. These functions take and
return numpy arrays (a test calls ``np.asarray`` on the JAX side), so
nothing here imports JAX. ``uint32``
descriptor words are re-viewed as ``int32`` (same bits), never
value-converted; every other integer array becomes int32, floats float32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import config as config_mod
from .geometry.camera import Intrinsics
from .mapstate.state import MapState
from .ops.frame import FrameFeatures
from .optim.ba import BAProblem, BAResult
from .optim.pose_graph import PoseGraphEdges, PoseGraphResult
from .optim.pose_opt import PoseObs
from .runtime.loop_closing import Sim3Match
from .vocab.bow import Vocabulary
from .vocab.kfdb import KFDatabase


def to_tensor(a, device) -> torch.Tensor:
    """numpy array -> tensor on `device` with the port's dtype rules."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype.kind in "iu" and a.dtype != np.int32:
        a = a.astype(np.int32)
    elif a.dtype.kind == "f" and a.dtype != np.float32:
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def to_numpy(t, unsigned: bool = False) -> np.ndarray:
    """tensor -> numpy; `unsigned` re-views int32 descriptor words as
    uint32."""
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if unsigned else a


# uint32 descriptor words in the JAX package
DESC_FIELDS = {"kf_desc", "mp_desc", "desc"}


def _from_numpy(cls, fields: dict, device):
    return cls(**{f: (None if fields[f] is None else
                      to_tensor(fields[f], device)) for f in cls._fields})


def _to_numpy(obj) -> dict:
    return {f: (None if v is None else to_numpy(v, f in DESC_FIELDS))
            for f, v in zip(obj._fields, obj)}


def map_state_from_numpy(fields: dict, device) -> MapState:
    return _from_numpy(MapState, fields, device)


def map_state_to_numpy(state: MapState) -> dict:
    return _to_numpy(state)


def frame_features_from_numpy(fields: dict, device) -> FrameFeatures:
    return _from_numpy(FrameFeatures, fields, device)


def frame_features_to_numpy(feats: FrameFeatures) -> dict:
    return _to_numpy(feats)


def pose_obs_from_numpy(fields: dict, device) -> PoseObs:
    return _from_numpy(PoseObs, fields, device)


def pose_obs_to_numpy(obs: PoseObs) -> dict:
    return _to_numpy(obs)


def ba_problem_from_numpy(fields: dict, device) -> BAProblem:
    return _from_numpy(BAProblem, fields, device)


def ba_problem_to_numpy(prob: BAProblem) -> dict:
    return _to_numpy(prob)


def ba_result_from_numpy(fields: dict, device) -> BAResult:
    return _from_numpy(BAResult, fields, device)


def ba_result_to_numpy(result: BAResult) -> dict:
    return _to_numpy(result)


def pose_graph_edges_from_numpy(fields: dict, device) -> PoseGraphEdges:
    return _from_numpy(PoseGraphEdges, fields, device)


def pose_graph_edges_to_numpy(edges: PoseGraphEdges) -> dict:
    return _to_numpy(edges)


def pose_graph_result_from_numpy(fields: dict, device) -> PoseGraphResult:
    return _from_numpy(PoseGraphResult, fields, device)


def pose_graph_result_to_numpy(result: PoseGraphResult) -> dict:
    return _to_numpy(result)


def sim3_match_from_numpy(fields: dict, device) -> Sim3Match:
    """{"kf_query", "kf_match", "s", "q", "t", "point_ids", "n_matches"}
    (the JAX package's Sim3Match fields, arrays as numpy) -> Sim3Match with
    its point_ids on `device`."""
    return Sim3Match(
        kf_query=int(fields["kf_query"]), kf_match=int(fields["kf_match"]),
        s=float(fields["s"]), q=np.asarray(fields["q"], np.float32),
        t=np.asarray(fields["t"], np.float32),
        point_ids=to_tensor(fields["point_ids"], device),
        n_matches=int(fields["n_matches"]))


def kfdb_from_numpy(fields: dict, device, width: int = None) -> KFDatabase:
    """{"words", "wts", "active"} -> KFDatabase on `device`. With `width`
    (the port's, caps.max_features) a row of another width, as the JAX
    package's 1024, is padded with word -1 and weight 0, or cut where only
    padding is cut (asserted)."""
    fields = dict(fields)
    words, wts = np.asarray(fields["words"]), np.asarray(fields["wts"])
    M = words.shape[1]
    if width is not None and width > M:
        fields["words"] = np.pad(words, ((0, 0), (0, width - M)),
                                 constant_values=-1)
        fields["wts"] = np.pad(wts, ((0, 0), (0, width - M)))
    elif width is not None and width < M:
        assert (words[:, width:] < 0).all() and (wts[:, width:] == 0).all(), \
            f"a row holds more than {width} words"
        fields["words"], fields["wts"] = words[:, :width], wts[:, :width]
    return _from_numpy(KFDatabase, fields, device)


def kfdb_to_numpy(db: KFDatabase) -> dict:
    return _to_numpy(db)


def vocabulary_from_numpy(fields: dict, device) -> Vocabulary:
    """{"centroids": [levels of [k^(l+1), 8] uint32], "idf", "k", "depth"}
    -> Vocabulary on `device`."""
    return Vocabulary(tuple(to_tensor(c, device) for c in fields["centroids"]),
                      to_tensor(fields["idf"], device), int(fields["k"]),
                      int(fields["depth"]))


def vocabulary_to_numpy(vocab: Vocabulary) -> dict:
    return {"centroids": [to_numpy(c, unsigned=True)
                          for c in vocab.centroids],
            "idf": to_numpy(vocab.idf), "k": vocab.k, "depth": vocab.depth}


def config_from_dict(d: dict) -> config_mod.SlamConfig:
    """Build the port's SlamConfig from ``dataclasses.asdict`` of the JAX
    package's (the camera arrives as a tuple, NamedTuple or dict)."""
    kw = {}
    for f in dataclasses.fields(config_mod.SlamConfig):
        if f.name not in d:
            continue
        v = d[f.name]
        if f.name == "camera":
            if isinstance(v, dict):
                v = Intrinsics(**{**v, "dist": tuple(v.get("dist", (0.0,) * 5))})
            else:
                v = list(v)
                if len(v) >= 8:
                    v[7] = tuple(v[7])
                v = Intrinsics(*v)
        elif isinstance(v, dict):
            sub = {"orb": config_mod.OrbConfig,
                   "matcher": config_mod.MatcherConfig,
                   "tracking": config_mod.TrackingConfig,
                   "mapping": config_mod.MappingConfig,
                   "optimizer": config_mod.OptimizerConfig,
                   "loop": config_mod.LoopConfig,
                   "caps": config_mod.Capacities}[f.name]
            v = sub(**{k: (tuple(x) if isinstance(x, list) else x)
                       for k, x in v.items()})
        kw[f.name] = v
    return config_mod.SlamConfig(**kw)
