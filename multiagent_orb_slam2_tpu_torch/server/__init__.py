"""Multi-agent server layer: the central map-fusion service.

Counterpart of the JAX package's ``server`` (reference MultiAgentServer,
MapFusion and MultiMap). All agents' maps live in one shared MapState,
partitioned by the kf_map / mp_map id columns, so moving a map into another
is a relabel plus one batched Sim3 correction, and fusion is a synchronous
phase between tracking steps.
"""
from .multimap import MultiMap  # noqa: F401
from .server import MultiAgentServer  # noqa: F401
