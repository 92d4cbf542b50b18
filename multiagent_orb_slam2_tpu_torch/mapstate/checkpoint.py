"""Map-state checkpoint / resume.

Counterpart of the JAX package's ``mapstate/checkpoint.py`` (the reference
has none: System::SaveMap/LoadMap is a TODO there). The whole map is one
NamedTuple of tensors, so a checkpoint is one compressed npz in the JAX
package's layout: an ``ms_<field>`` array per ``MapState`` field, with the
dtypes that package writes (descriptor words as uint32, other integers
int32, floats float32, masks bool), and a ``__meta__`` object array of
(keys, values as strings) for the host's slot counters. A map saved by
either package loads in the other.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import convert
from .state import MapState


def save_map(path: str, state: MapState, n_kf: int, n_mp: int,
             extra: dict = None):
    arrays = {f"ms_{k}": convert.to_numpy(v, k in convert.DESC_FIELDS)
              for k, v in state._asdict().items()}
    meta = dict(n_kf=n_kf, n_mp=n_mp)
    if extra:
        meta.update(extra)
    np.savez_compressed(path, __meta__=np.asarray(
        [list(meta.keys()), [str(v) for v in meta.values()]], dtype=object),
        **arrays)


def load_map(path: str, device=torch.device("cuda")):
    """(MapState on `device`, meta dict). The object array of the meta is
    unpickled: load only checkpoints written by this program or the JAX
    package."""
    with np.load(path, allow_pickle=True) as z:
        state = convert.map_state_from_numpy(
            {k[3:]: z[k] for k in z.files if k.startswith("ms_")}, device)
        keys, vals = z["__meta__"]
    meta = {k: int(v) if str(v).lstrip("-").isdigit() else str(v)
            for k, v in zip(keys, vals)}
    return state, meta
