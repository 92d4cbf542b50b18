"""Batched SE3 / camera geometry on torch tensors (counterpart of the JAX
package's ``geometry``). Everything broadcasts over leading axes."""
from . import se3, camera  # noqa: F401
