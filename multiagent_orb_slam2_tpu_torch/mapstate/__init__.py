"""Struct-of-arrays map state: keyframes, map points, observations,
covisibility, as fixed-capacity tensors with validity masks."""
from .state import MapState, empty_map_state  # noqa: F401
