"""Tensor idioms the port needs in many places.

The JAX package leans on three things torch lacks: scatters that silently
drop out-of-range indices (``.at[i].set(v, mode="drop")`` with a sentinel
index one past the end), ``nonzero(size=, fill_value=)`` with a static output
size, and ``top_k`` with a lowest-index tie-break. Each has one helper here,
written so that it never synchronises the host with the device.
``blockwise_jacfwd`` stands for ``vmap(jax.jacfwd(f))`` over independent
rows.

``host_fetch`` is the one door through which the host reads device values on
the tracking path; it counts its calls so a run can report how often the
host waited for the device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.func import jvp, vmap


@functools.lru_cache(maxsize=256)
def _const_cached(values, dtype, device_str):
    return torch.tensor(values, dtype=dtype, device=torch.device(device_str))


def const_tensor(values, dtype, device):
    """A small read-only constant tensor, uploaded once per (value, device)."""
    return _const_cached(tuple(values), dtype, str(device))


# -- host reads --------------------------------------------------------------

class _FetchCounter:
    count = 0


def host_fetch(t: torch.Tensor) -> np.ndarray:
    """Copy a (small) tensor to the host as numpy; blocks until the device
    has produced it. Every blocking read on the tracking path goes through
    here so it is counted."""
    _FetchCounter.count += 1
    return t.detach().cpu().numpy()


def host_fetch_count() -> int:
    return _FetchCounter.count


def reset_host_fetch_count() -> None:
    _FetchCounter.count = 0


# -- selection ---------------------------------------------------------------

def top_k_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis of x,
    ties broken by lowest index (the rule of jax.lax.top_k; torch.topk
    promises none)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def first_true_indices(mask: torch.Tensor, size: int, fill_value: int):
    """Indices of the first `size` True entries of 1-D mask in ascending
    order, padded with fill_value: jnp.nonzero(mask, size=, fill_value=)
    without a data-dependent shape."""
    n = mask.shape[0]
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1          # rank of each True
    out = torch.full((size + 1,), fill_value, dtype=torch.int64,
                     device=mask.device)
    dst = torch.where(mask & (rank < size), rank,
                      torch.full_like(rank, size))
    out.scatter_(0, dst, torch.arange(n, device=mask.device))
    return out[:size]          # slot `size` collected the overflow


def fill_at(t: torch.Tensor, i: int, value) -> torch.Tensor:
    """t[i] = value in place for a host index and a host scalar, with the
    scalar passed as a kernel argument (plain item assignment uploads it,
    which makes the host wait for the stream)."""
    t.narrow(0, i, 1).fill_(value)
    return t


# -- derivatives -------------------------------------------------------------

def blockwise_jacfwd(fn, x: torch.Tensor) -> torch.Tensor:
    """[E, m, n] Jacobians of fn: [E, n] -> [E, m] whose row e depends on
    x[e] alone (a per-edge residual, a per-problem residual with E = 1):
    one forward-mode product per input component, every row at once.

    This is ``vmap(jacfwd(f))`` over the rows, written the other way round:
    under that form each row's scalars are 0-d inside the transform, where
    torch 2.13 promotes a 0-d dual tensor combined with a Python float to
    float64."""
    n = x.shape[-1]
    basis = torch.eye(n, dtype=x.dtype, device=x.device)[:, None, :] \
        .expand(n, x.shape[0], n)
    tangents = vmap(lambda v: jvp(fn, (x,), (v,))[1])(basis)   # [n, E, m]
    return tangents.permute(1, 2, 0)


# -- scatters that drop a sentinel index --------------------------------------

def set_drop(dst: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """dst.at[idx].set(val, mode="drop") along axis 0, where idx ==
    dst.shape[0] marks entries to discard. Returns a new tensor."""
    n = dst.shape[0]
    buf = torch.cat([dst, dst.new_zeros((1,) + tuple(dst.shape[1:]))], 0)
    if not torch.is_tensor(val):
        # a host scalar goes in as a kernel argument, not as an upload
        buf.index_fill_(0, idx.long(), val)
        return buf[:n]
    idx = idx.long()
    val = val.to(dst.dtype).expand(idx.shape + tuple(dst.shape[1:]))
    buf[_last_writes(idx, n)] = val
    return buf[:n]


def _last_writes(idx: torch.Tensor, n: int) -> torch.Tensor:
    """idx with every write but the last one to each slot sent to the
    sentinel n. Among duplicate indices the last write wins, as in XLA's
    sequential scatter; on CUDA an index_put with duplicates lets whichever
    write lands last win, which changes from run to run. An integer max
    over write positions picks the winner without a host read."""
    flat = idx.reshape(-1)
    pos = torch.arange(flat.numel(), device=flat.device)
    last = torch.full((n + 1,), -1, dtype=torch.int64,
                      device=flat.device).scatter_reduce_(0, flat, pos,
                                                          reduce="amax")
    return torch.where(last[flat] == pos, flat,
                       torch.full_like(flat, n)).reshape(idx.shape)


def add_drop(dst: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """dst.at[idx].add(val, mode="drop") along axis 0 (sentinel as above)."""
    n = dst.shape[0]
    buf = torch.cat([dst, dst.new_zeros((1,) + tuple(dst.shape[1:]))], 0)
    if not torch.is_tensor(val):
        val = torch.full((), val, dtype=dst.dtype, device=dst.device)
    val = val.to(dst.dtype).expand(idx.shape + tuple(dst.shape[1:]))
    buf.index_add_(0, idx.long(), val.contiguous())
    return buf[:n]


def set_drop2(dst: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
              val) -> torch.Tensor:
    """dst.at[row, col].set(val, mode="drop") for 2-D dst, where row ==
    dst.shape[0] or col == dst.shape[1] marks entries to discard."""
    r, c = dst.shape
    row = row.long()
    col = col.long()
    bad = (row >= r) | (col >= c) | (row < 0) | (col < 0)
    lin = torch.where(bad, torch.full_like(row, r * c), row * c + col)
    flat = set_drop(dst.reshape(-1), lin.reshape(-1),
                    val if not torch.is_tensor(val)
                    else val.expand(row.shape).reshape(-1))
    return flat.reshape(r, c)


def mask_from_ids(ids: torch.Tensor, n: int) -> torch.Tensor:
    """[n] bool with True at every id in `ids` that is >= 0 (negative ids
    are 'none'): zeros(n+1).at[where(ids>=0, ids, n)].set(True)[:n]."""
    flat = ids.reshape(-1).long()
    out = torch.zeros(n + 1, dtype=torch.bool, device=ids.device)
    out.index_fill_(0, torch.where(flat >= 0, flat,
                                   torch.full_like(flat, n)), True)
    return out[:n]
