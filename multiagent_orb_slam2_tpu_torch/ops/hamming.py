"""Packed 256-bit binary descriptor Hamming distance, the universal matching
primitive.

Counterpart of the JAX package's ``ops/hamming.py``. Descriptors are packed
as [*, 8] words of 32 bits (256 bits). torch has neither a right shift for
uint32 on the CPU nor a popcount, so the words are held as **int32 with the
same bit pattern**; every shift below is followed by a mask that removes the
sign extension, which makes the arithmetic shift equal to the logical one.
Distances are bit-exact against the JAX package. All-pairs matrices go
through one exact float32 matrix product over the unpacked bits, which is far
cheaper than word popcounts on the CPU and on the GPU alike.
"""
from __future__ import annotations

import torch

WORDS = 8          # 8 x 32 bits = 256 bits
BITS = 256


def _byte_counts(x):
    """Per-byte popcounts of int32 words (each byte field 0..8)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    return (x + ((x >> 4) & 0x0F0F0F0F)) & 0x0F0F0F0F


def _fold_bytes(x):
    """Sum the four byte fields of int32 words (each field at most 64, so
    the total, at most 256, needs nine bits)."""
    x = (x & 0x00FF00FF) + ((x >> 8) & 0x00FF00FF)
    return (x + (x >> 16)) & 0xFFFF


def popcount_u32(x):
    """Vectorized 32-bit popcount of int32-held words -> int32."""
    return _fold_bytes(_byte_counts(x))


def hamming(a, b):
    """Elementwise distance between packed descriptors a, b [..., 8]."""
    # byte fields of 8 words sum to at most 64, so fold once after the sum
    return _fold_bytes(torch.sum(_byte_counts(torch.bitwise_xor(a, b)),
                                 dim=-1, dtype=torch.int32))


def _bits_f32(packed):
    """[..., 8] words -> [..., 256] float32 of zeros and ones."""
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed[..., :, None] >> shifts) & 1
    return bits.reshape(packed.shape[:-1] + (BITS,)).to(torch.float32)


def hamming_matrix(a, b):
    """All-pairs distance matrix: a [..., N, 8], b [..., M, 8] -> [..., N, M]
    int32 (leading axes batch).

    popcount(x ^ y) = |x| + |y| - 2 <x, y> over the 256 bits as 0/1 vectors:
    one float32 matrix product instead of N*M*8 word popcounts. Every term
    is an integer of at most 256, so float32 holds it exactly and the result
    equals the popcount formulation bit for bit.
    """
    A = _bits_f32(a)
    B = A if b is a else _bits_f32(b)
    dot = A @ B.transpose(-1, -2)
    d = A.sum(-1)[..., :, None] + B.sum(-1)[..., None, :] - 2.0 * dot
    return d.to(torch.int32)


def hamming_matrix_chunked(a, b, chunk: int = 512):
    """Memory-bounded all-pairs distance for large N*M (loop over b-chunks)."""
    return torch.cat([hamming_matrix(a, b[j:j + chunk])
                      for j in range(0, b.shape[0], chunk)], 1)


def unpack_bits(packed):
    """[..., 8] words -> [..., 256] {0,1} int8 (bit i of word w -> col w*32+i)."""
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed[..., :, None] >> shifts) & 1
    return bits.reshape(packed.shape[:-1] + (BITS,)).to(torch.int8)


def pack_bits(bits):
    """[..., 256] {0,1} -> [..., 8] int32 words (bit 31 lands in the sign)."""
    b = bits.reshape(bits.shape[:-1] + (WORDS, 32)).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    s = torch.sum(b << shifts, dim=-1)                 # 0 .. 2^32 - 1
    return torch.where(s >= (1 << 31), s - (1 << 32), s).to(torch.int32)


def masked_argmin(dist, mask, big: int = 10_000):
    """argmin over axis -1 with invalid entries masked out.

    Returns (best_idx, best_val, second_val), the triple every ratio-test
    matcher needs. Ties go to the lowest index.
    """
    d = torch.where(mask, dist, torch.full_like(dist, big))
    best_idx = torch.argmin(d, dim=-1)
    best = torch.gather(d, -1, best_idx[..., None])[..., 0]
    d2 = d.scatter(-1, best_idx[..., None], big)
    second = torch.min(d2, dim=-1).values
    return best_idx, best, second
