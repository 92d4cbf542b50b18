"""Hierarchical binary vocabulary: training, transform, tf-idf scoring.

Counterpart of the JAX package's ``vocab/bow.py`` (DBoW2's
TemplatedVocabulary: hierarchical k-medians, transform, L1 score):

- the tree is one centroid table per level, the children of node i at rows
  [i*k, (i+1)*k); transform is `depth` rounds of gather + Hamming argmin
  over the k children;
- a frame's BoW vector is a dense [W] tf-idf row (W = k^depth words).

Descriptors and centroids are [*, 8] int32 words holding the bits of the
JAX package's uint32 words (``ops/hamming.py`` says why). Training is
host-side numpy, as in the JAX package; the system loads the committed
asset (``DEFAULT_VOCAB``) and never trains one in its place.
"""
from __future__ import annotations

import pathlib

import numpy as np
import torch

from ..ops import hamming

DEFAULT_VOCAB = (pathlib.Path(__file__).resolve().parents[2]
                 / "multiagent_orb_slam2_tpu" / "assets"
                 / "vocab_synth_100k.npz")


class Vocabulary:
    """Flat k-ary tree of packed binary centroids."""

    def __init__(self, centroids, idf, k: int, depth: int):
        self.centroids = tuple(centroids)  # per level: [k^(l+1), 8] int32
        self.idf = idf                     # [W] inverse document frequency
        self.k = k
        self.depth = depth

    @property
    def n_words(self) -> int:
        return self.k ** self.depth

    @property
    def device(self) -> torch.device:
        return self.idf.device


# ---------------------------------------------------------------------------
# Training (hierarchical binary k-medians, host side)
# ---------------------------------------------------------------------------

_POP8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def _popcount_np(x):
    return _POP8[x.view(np.uint8)].sum(-1, dtype=np.int32)


def _hamming_np(a, b, chunk: int = 1 << 16):
    """a [N, 8] u32, b [M, 8] u32 -> [N, M] int32 Hamming distances
    (byte-table popcount over XOR, chunked over N)."""
    a8 = np.ascontiguousarray(a).view(np.uint8).reshape(len(a), 32)
    b8 = np.ascontiguousarray(b).view(np.uint8).reshape(len(b), 32)
    out = np.empty((len(a), len(b)), np.int32)
    for s in range(0, len(a), chunk):
        e = min(s + chunk, len(a))
        out[s:e] = _POP8[a8[s:e, None, :] ^ b8[None, :, :]].sum(
            -1, dtype=np.int32)
    return out


def _binary_mean(descs):
    """Majority bit per position -> packed centroid [8] uint32."""
    bits = np.unpackbits(descs.view(np.uint8), axis=-1)  # [N, 256]
    maj = (bits.mean(0) >= 0.5).astype(np.uint8)
    return np.packbits(maj).view(np.uint32)


def _kmedians(descs, k, rng, iters=6):
    """Binary k-medians over packed descriptors [N, 8]. Returns [k, 8]."""
    n = descs.shape[0]
    if n <= k:
        cents = np.zeros((k, 8), np.uint32)
        cents[:n] = descs
        if n:
            cents[n:] = descs[rng.integers(0, n, size=k - n)]
        return cents
    cents = descs[rng.choice(n, size=k, replace=False)].copy()
    for _ in range(iters):
        d = _hamming_np(descs, cents)
        assign = d.argmin(1)
        for j in range(k):
            sel = descs[assign == j]
            if len(sel):
                cents[j] = _binary_mean(sel)
            else:
                cents[j] = descs[rng.integers(0, n)]
    return cents


def _to_vocabulary(levels, idf, k, depth, device) -> Vocabulary:
    """numpy uint32 levels and float idf -> a Vocabulary on `device`."""
    dev = torch.device(device)
    cents = tuple(torch.from_numpy(np.ascontiguousarray(c, np.uint32)
                                   .view(np.int32)).to(dev) for c in levels)
    return Vocabulary(cents, torch.from_numpy(np.asarray(idf, np.float32))
                      .to(dev), int(k), int(depth))


def train_vocabulary(descriptors: np.ndarray, k: int = 10, depth: int = 3,
                     seed: int = 0, device=torch.device("cuda")
                     ) -> Vocabulary:
    """Hierarchical k-medians over sample descriptors [N, 8] uint32, on the
    host; idf from the training corpus' word frequencies (each descriptor
    one 'document', as DBoW2 counts training images)."""
    rng = np.random.default_rng(seed)
    descs = np.asarray(descriptors).view(np.uint32)
    levels = []
    node_of = np.zeros(len(descs), np.int64)
    n_nodes = 1
    for level in range(depth):
        cents = np.zeros((n_nodes * k, 8), np.uint32)
        new_node_of = np.zeros_like(node_of)
        for node in range(n_nodes):
            sel = node_of == node
            sub = descs[sel]
            c = _kmedians(sub, k, rng) if len(sub) else \
                descs[rng.integers(0, len(descs), size=k)]
            cents[node * k:(node + 1) * k] = c
            if len(sub):
                a = _hamming_np(sub, c).argmin(1)
                new_node_of[sel] = node * k + a
        levels.append(cents)
        node_of = new_node_of
        n_nodes *= k

    W = k ** depth
    counts = np.bincount(node_of, minlength=W).astype(np.float64)
    n_docs = max(len(descs), 1)
    idf = np.log(n_docs / np.maximum(counts, 1.0))
    idf = np.where(counts > 0, idf, 0.0)
    return _to_vocabulary(levels, idf, k, depth, device)


def save_vocabulary(vocab: Vocabulary, path):
    np.savez_compressed(
        path, k=vocab.k, depth=vocab.depth, idf=vocab.idf.cpu().numpy(),
        **{f"level{i}": c.cpu().numpy().view(np.uint32)
           for i, c in enumerate(vocab.centroids)})


def load_vocabulary(path=DEFAULT_VOCAB, device=torch.device("cuda")
                    ) -> Vocabulary:
    """Read a vocabulary written by ``save_vocabulary`` (the JAX package
    writes the same file). A missing file raises FileNotFoundError."""
    path = pathlib.Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"vocabulary file not found: {path}")
    with np.load(path) as z:
        depth = int(z["depth"])
        return _to_vocabulary([z[f"level{i}"] for i in range(depth)],
                              z["idf"], int(z["k"]), depth, device)


# ---------------------------------------------------------------------------
# Transform + scoring (device side)
# ---------------------------------------------------------------------------

def transform_words(vocab: Vocabulary, desc, valid):
    """Descriptors [N, 8] -> word ids [N] int32 (invalid -> -1): walk the
    tree by Hamming argmin among each node's k children (the first of
    equals)."""
    node = torch.zeros(desc.shape[0], dtype=torch.int64, device=desc.device)
    ar = torch.arange(vocab.k, device=desc.device)
    for level in range(vocab.depth):
        child_base = node * vocab.k
        cand = vocab.centroids[level][child_base[:, None] + ar[None, :]]
        d = hamming.popcount_u32(
            torch.bitwise_xor(cand, desc[:, None, :])).sum(-1)
        node = child_base + torch.argmin(d, dim=-1)
    return torch.where(valid, node, torch.full_like(node, -1)).to(torch.int32)


def bow_vector(vocab: Vocabulary, words, valid):
    """Word ids -> L1-normalized tf-idf dense vector [W] (DBoW2 TF_IDF + L1
    normalization). Term frequencies are integer counts, so exact."""
    W = vocab.n_words
    w_safe = torch.where(valid & (words >= 0), words.long(),
                         torch.full_like(words, W, dtype=torch.int64))
    tf = torch.zeros(W + 1, dtype=torch.int32, device=words.device)
    tf.scatter_add_(0, w_safe, torch.ones_like(w_safe, dtype=torch.int32))
    v = tf[:W].to(torch.float32) * vocab.idf
    return v / torch.sum(torch.abs(v)).clamp_min(1e-9)


def l1_score(v, db):
    """L1 similarity of query v [W] against the rows of db [K, W]:
    s = 1 - 0.5 |v - w|_1 for L1-normalized vectors."""
    return 1.0 - 0.5 * torch.sum(torch.abs(v[None, :] - db), dim=-1)


def common_words(words_q, valid_q, word_presence_db):
    """Number of words the query shares with each row of the [K, W] bool
    presence table -> [K] int32."""
    W = word_presence_db.shape[1]
    w_safe = torch.where(valid_q & (words_q >= 0), words_q.long(),
                         torch.full_like(words_q, W, dtype=torch.int64))
    q_pres = torch.zeros(W + 1, dtype=torch.bool, device=words_q.device)
    q_pres.index_fill_(0, w_safe, True)
    return torch.sum(word_presence_db & q_pres[None, :W],
                     dim=-1).to(torch.int32)
