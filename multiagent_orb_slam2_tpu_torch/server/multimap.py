"""Agent <-> map registry.

The port's copy of the JAX package's ``server/multimap.py`` (reference
MultiMap, include/MultiMap.h, src/MultiMap.cc): which agents currently share
which logical map, updated when maps merge (UpdateSystemMapAssociations
re-points every system of the absorbed map at the merged map; here a dict
rewrite, the array-side relabel happens in ``fusion.merge_maps``).
"""
from __future__ import annotations


class MultiMap:
    def __init__(self):
        self.map_of_agent: dict[int, int] = {}

    def add(self, agent: int, map_id: int):
        self.map_of_agent[agent] = map_id

    def map_of(self, agent: int) -> int:
        return self.map_of_agent[agent]

    def agents_of(self, map_id: int):
        return [a for a, m in self.map_of_agent.items() if m == map_id]

    def merge(self, src_map: int, dst_map: int):
        """All agents of src_map now operate on dst_map."""
        for a, m in list(self.map_of_agent.items()):
            if m == src_map:
                self.map_of_agent[a] = dst_map

    @property
    def n_maps(self) -> int:
        return len(set(self.map_of_agent.values()))
