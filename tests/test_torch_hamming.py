"""The port's ops/hamming.py against the JAX one: bit-exact. The port holds
descriptor words as int32 with the uint32 bit pattern."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)   # several test workers share few cores

from multiagent_orb_slam2_tpu.ops import hamming as jh
from multiagent_orb_slam2_tpu_torch.ops import hamming as th


def _desc(seed, n):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 2 ** 32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
    d[0] = 0xFFFFFFFF          # all sign bits set
    d[1] = 0x80000000
    d[2] = 0
    return d


def _t(d):
    return torch.from_numpy(d.view(np.int32).copy())


def test_popcount_exact():
    d = _desc(0, 40)
    np.testing.assert_array_equal(
        th.popcount_u32(_t(d)).numpy(), np.asarray(jh.popcount_u32(jnp.asarray(d))))


def test_hamming_exact():
    a, b = _desc(1, 33), _desc(2, 33)
    np.testing.assert_array_equal(
        th.hamming(_t(a), _t(b)).numpy(),
        np.asarray(jh.hamming(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("n,m", [(50, 70), (7, 300)])
def test_hamming_matrix_exact(n, m):
    a, b = _desc(3, n), _desc(4, m)
    ref = np.asarray(jh.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(th.hamming_matrix(_t(a), _t(b)).numpy(), ref)
    np.testing.assert_array_equal(
        th.hamming_matrix_chunked(_t(a), _t(b), chunk=64).numpy(),
        np.asarray(jh.hamming_matrix_chunked(jnp.asarray(a), jnp.asarray(b),
                                             chunk=64)))
    # batched over a leading axis, and against the elementwise popcount
    both = th.hamming_matrix(torch.stack([_t(a), _t(a)]),
                             torch.stack([_t(b), _t(b)]))
    np.testing.assert_array_equal(both[1].numpy(), ref)
    np.testing.assert_array_equal(
        th.hamming(_t(a)[:, None, :], _t(b)[None, :, :]).numpy(), ref)


def test_pack_unpack_exact():
    d = _desc(5, 25)
    bits_j = np.asarray(jh.unpack_bits(jnp.asarray(d)))
    bits_t = th.unpack_bits(_t(d))
    np.testing.assert_array_equal(bits_t.numpy(), bits_j)
    packed = th.pack_bits(bits_t)
    np.testing.assert_array_equal(packed.numpy().view(np.uint32), d)
    np.testing.assert_array_equal(
        packed.numpy().view(np.uint32),
        np.asarray(jh.pack_bits(jnp.asarray(bits_j))))


def test_masked_argmin_exact():
    rng = np.random.default_rng(6)
    dist = rng.integers(0, 30, size=(40, 60)).astype(np.int32)   # many ties
    mask = rng.random((40, 60)) < 0.3
    mask[3] = False                                              # empty row
    jo = jh.masked_argmin(jnp.asarray(dist), jnp.asarray(mask))
    to = th.masked_argmin(torch.from_numpy(dist), torch.from_numpy(mask))
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
