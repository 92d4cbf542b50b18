"""Multi-rank execution: meshes of torch.distributed ranks, sharded bundle
adjustment, batched multi-agent steps.

The reference's "distributed backend" is N threads sharing one heap; here
scaling is a process group with one rank per card (or several ranks on one
card, on gloo), laid out as a mesh:

- agents axis: data parallelism (one SLAM front end per rank block);
- points axis: the map's points sharded for distributed BA. Each rank owns
  a block of the points and their observations, computes its Schur
  complement contributions locally, and the reduced camera system is
  all-reduced over the axis' process group.

Importing this package starts no process group.
"""
from .dist_ba import distributed_ba_solve, make_mesh  # noqa: F401
