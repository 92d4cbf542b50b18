"""Environment-gated diagnostics: the place-recognition recall log.

Counterpart of the part of the JAX package's ``utils/diag.py`` that loop
closing uses. Off unless ``SLAM_RECALL_LOG=<path>.jsonl`` names a file; then
one row per place-recognition query, with the survivors of each gate, so
where a true-overlap candidate died can be answered offline. When it is off,
nothing is computed or read back.
"""
from __future__ import annotations

import json
import os

import numpy as np


class _JsonlSink:
    def __init__(self, env: str):
        self.path = os.environ.get(env)
        self.f = open(self.path, "a") if self.path else None
        self.n = 0

    @property
    def enabled(self) -> bool:
        return self.f is not None

    def write(self, row: dict):
        if self.f is None:
            return
        self.f.write(json.dumps(row, default=_np_default) + "\n")
        self.n += 1
        if self.n % 20 == 0:
            self.f.flush()


def _np_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not serializable: {type(o)}")


_recall_sink = None


def recall_sink() -> _JsonlSink:
    global _recall_sink
    if _recall_sink is None:
        _recall_sink = _JsonlSink("SLAM_RECALL_LOG")
    return _recall_sink


def log_recall_query(kind: str, agent: int, kf_slot: int, frame_id: int,
                     db, words, valid, vec, covis_np, kf_map_np,
                     cur_map, cand_pre, cand_post, consistency_counts,
                     min_score=None):
    """One row per Detect* query, with the common-word counts and raw L1
    scores recomputed so each candidate's death can be attributed to a gate
    (common > 0.8 max / min_score / grouping / consistency)."""
    sink = recall_sink()
    if not sink.enabled:
        return
    from ..vocab import kfdb as kfdb_mod
    scores, common = kfdb_mod.score_and_common(db, words, valid, vec)
    scores, common = scores.cpu().numpy(), common.cpu().numpy()
    active = db.active.cpu().numpy().copy()
    active[kf_slot] = False
    elig = active & (common > 0)
    if kf_map_np is not None:
        cross = elig & (kf_map_np != cur_map) & (kf_map_np >= 0)
    else:
        cross = elig
    max_common = int(common[elig].max()) if elig.any() else 0
    # top candidates by common-word count among the relevant population
    idx = np.argsort(-np.where(cross, common, -1))[:10]
    top = [dict(kf=int(k), common=int(common[k]),
                score=round(float(scores[k]), 4),
                map=None if kf_map_np is None else int(kf_map_np[k]))
           for k in idx if cross[k]]
    sink.write(dict(
        kind=kind, agent=agent, kf=kf_slot, frame=frame_id,
        cur_map=cur_map, max_common=max_common,
        min_common=int(0.8 * max_common),
        min_score=None if min_score is None else float(min_score),
        top_cross=top,
        cand_pre=[int(c) for c in cand_pre],
        cand_post=[int(c) for c in cand_post],
        consistency=consistency_counts))
