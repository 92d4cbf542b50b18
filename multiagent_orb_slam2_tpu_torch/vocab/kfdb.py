"""Keyframe database: loop / relocalization / covisibility candidate queries.

Counterpart of the JAX package's ``vocab/kfdb.py`` (the reference's
KeyFrameDatabase). The inverted index is a sparse per-keyframe word table:

- words:  [K, M] int32   unique word ids of each keyframe (-1 padded)
- wts:    [K, M] float32 L1-normalized tf-idf weight per unique word
- active: [K] bool       registered keyframes

A query scatters itself once into a dense [W] vector, then gathers it at
every row's word ids: O(K * M) work whatever the vocabulary's size. L1
scoring uses the min form: for L1-normalized non-negative vectors,
1 - 0.5 |v - w|_1 == sum_i min(v_i, w_i).

A row holds M = ``max_words_per_kf`` unique words, the lowest ids first.
The loop closer and the server pass ``caps.max_features``: a keyframe has no
more unique words than valid features, so every word of its BoW vector is
in the inverted file, as in the reference's KeyFrameDatabase::add. (The JAX
package keeps at most 1024 and drops the rest, about 840 of 1,870 a
keyframe at 2000 features.) A narrower M keeps the M lowest ids.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.torch_ops import fill_at, set_drop, top_k_stable
from . import bow as bow_mod
from .bow import Vocabulary


class KFDatabase(NamedTuple):
    words: torch.Tensor      # [K, M] int32 unique word ids (-1 = empty slot)
    wts: torch.Tensor        # [K, M] float32 tf-idf weights
    active: torch.Tensor     # [K] bool registered keyframes


def empty_database(max_kf: int, vocab: Vocabulary,
                   max_words_per_kf: int) -> KFDatabase:
    """An empty database on the vocabulary's device; `max_words_per_kf` at
    least the keyframes' feature capacity keeps every word."""
    M, dev = max_words_per_kf, vocab.device
    return KFDatabase(
        words=torch.full((max_kf, M), -1, dtype=torch.int32, device=dev),
        wts=torch.zeros((max_kf, M), dtype=torch.float32, device=dev),
        active=torch.zeros(max_kf, dtype=torch.bool, device=dev))


@torch.no_grad()
def add_keyframe(db: KFDatabase, vocab: Vocabulary, kf_slot: int, desc,
                 valid):
    """Insert a keyframe's descriptors (KeyFrameDatabase::add).

    Returns (db, words [F] per-feature word ids, dense tf-idf vector [W]);
    callers reuse the dense vector for their own query."""
    words = bow_mod.transform_words(vocab, desc, valid)
    v = bow_mod.bow_vector(vocab, words, valid)            # dense [W]
    M = db.words.shape[1]
    W = vocab.n_words
    # unique word ids of this frame, padded to M with -1
    ws = torch.sort(torch.where(valid & (words >= 0), words,
                                torch.full_like(words, W))).values
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=ws.device),
                       ws[1:] != ws[:-1]]) & (ws < W)
    rank = torch.cumsum(first.to(torch.int64), 0) - 1
    row_w = set_drop(
        torch.full((M,), -1, dtype=torch.int32, device=ws.device),
        torch.where(first & (rank < M), rank, torch.full_like(rank, M)),
        torch.where(first, ws, torch.full_like(ws, -1)))
    row_wt = torch.where(row_w >= 0, v[row_w.long().clamp(0, W - 1)],
                         torch.zeros_like(v[:1]))
    return _set_row(db, kf_slot, row_w, row_wt, True), words, v


def _set_row(db: KFDatabase, kf_slot: int, row_w, row_wt, active: bool):
    words, wts = db.words.clone(), db.wts.clone()
    words[kf_slot] = row_w
    wts[kf_slot] = row_wt
    return KFDatabase(words=words, wts=wts,
                      active=fill_at(db.active.clone(), kf_slot, active))


def erase_keyframe(db: KFDatabase, kf_slot: int) -> KFDatabase:
    words, wts = db.words.clone(), db.wts.clone()
    words[kf_slot].fill_(-1)
    wts[kf_slot].fill_(0.0)
    return KFDatabase(words=words, wts=wts,
                      active=fill_at(db.active.clone(), kf_slot, False))


def _query_dense(query_words, query_valid, query_bow):
    """Dense [W+1] presence / weight views of the query. Slot W is the
    shared sentinel of invalid query features and of database padding; it
    stays False / 0."""
    W = query_bow.shape[0]
    w_safe = torch.where(query_valid & (query_words >= 0), query_words.long(),
                         torch.full_like(query_words, W, dtype=torch.int64))
    q_pres = torch.zeros(W + 1, dtype=torch.bool, device=query_bow.device)
    q_pres.index_fill_(0, w_safe, True)
    q_pres = fill_at(q_pres, W, False)
    q_wt = torch.cat([query_bow, query_bow.new_zeros(1)])
    return q_pres, q_wt


def score_and_common(db: KFDatabase, query_words, query_valid, query_bow):
    """(scores [K], common-word counts [K] int32) of the query against every
    row: the reference's inverted-file walk as one gather over the sparse
    word table."""
    q_pres, q_wt = _query_dense(query_words, query_valid, query_bow)
    W = query_bow.shape[0]
    idx = torch.where(db.words >= 0, db.words,
                      torch.full_like(db.words, W)).long()   # [K, M]
    hit = q_pres[idx]
    common = torch.sum(hit, dim=-1).to(torch.int32)
    scores = torch.sum(torch.minimum(q_wt[idx], db.wts) * hit, dim=-1)
    return scores, common


def score_kfs(db: KFDatabase, query_bow, rows):
    """L1 similarity of the query against the selected rows [R]."""
    W = query_bow.shape[0]
    q_wt = torch.cat([query_bow, query_bow.new_zeros(1)])
    words = db.words[rows]
    idx = torch.where(words >= 0, words, torch.full_like(words, W)).long()
    return torch.sum(torch.minimum(q_wt[idx], db.wts[rows]) * (words >= 0),
                     dim=-1)


def _grouped_candidates(scores, cand, covis, top_covis: int = 10,
                        rel_acc: float = 0.75):
    """Covisibility-group accumulation: each candidate's score is summed
    over its top-10 covisible neighbours that are candidates too (equal
    weights in order of index, as jax.lax.top_k has them); groups below
    0.75 x the best sum are dropped; the best member of each surviving group
    is returned as a [K] mask."""
    K = scores.shape[0]
    w = torch.where(cand[None, :], covis, torch.zeros_like(covis))
    topw, topi = top_k_stable(w, min(top_covis, K))       # [K, <=10]
    member_ok = topw > 0
    s_top = scores[topi]
    acc = torch.where(cand, scores + torch.sum(
        torch.where(member_ok, s_top, torch.zeros_like(s_top)), dim=-1),
        torch.zeros_like(scores))
    best_acc = torch.max(acc)
    group_pass = cand & (acc >= rel_acc * best_acc) & (best_acc > 0)
    member_scores = torch.where(member_ok, s_top,
                                torch.full_like(s_top, -torch.inf))
    best_member_score = torch.max(member_scores, dim=-1).values
    arange = torch.arange(K, device=scores.device)
    best_kf = torch.where(
        scores >= best_member_score, arange,
        topi.gather(1, torch.argmax(member_scores, dim=-1)[:, None])[:, 0])
    return set_drop(torch.zeros(K, dtype=torch.bool, device=scores.device),
                    torch.where(group_pass, best_kf,
                                torch.full_like(best_kf, K)), True)


def detect_candidates(db: KFDatabase, query_words, query_valid, query_bow,
                      exclude, covis, min_score=None,
                      min_common_rel: float = 0.8):
    """Shared query core of the three Detect* entry points: keyframes
    sharing more than 0.8 x the best count of common words (and, for loop
    detection, scoring at least min_score), grouped by covisibility.
    Returns (candidate_mask [K], scores [K])."""
    scores, common = score_and_common(db, query_words, query_valid,
                                      query_bow)
    eligible = db.active & ~exclude & (common > 0)
    max_common = torch.max(torch.where(eligible, common,
                                       torch.zeros_like(common)))
    min_common = (min_common_rel * max_common).to(common.dtype)
    cand = eligible & (common > min_common)
    if min_score is not None:
        cand = cand & (scores >= min_score)
    return _grouped_candidates(scores, cand, covis), scores


def detect_loop_candidates(db, vocab, query_words, query_valid, query_bow,
                           query_covis_row, query_slot: int, covis,
                           min_score):
    """DetectLoopCandidates: exclude the query and its covisible
    neighbourhood; require score >= min_score (the lowest score against the
    query's directly covisible keyframes, computed by the caller)."""
    exclude = fill_at((query_covis_row > 0).clone(), query_slot, True)
    return detect_candidates(db, query_words, query_valid, query_bow,
                             exclude, covis, min_score=min_score)


def detect_reloc_candidates(db, query_words, query_valid, query_bow, covis):
    """DetectRelocalizationCandidates: no exclusion, no min_score gate."""
    exclude = torch.zeros_like(db.active)
    return detect_candidates(db, query_words, query_valid, query_bow,
                             exclude, covis)


def detect_covisibility_candidates(db, query_words, query_valid, query_bow,
                                   ignore_mask, covis):
    """DetectCovisibilityCandidates (fork addition): like loop detection,
    with the ignore set supplied by the caller (the keyframes moved by a map
    fusion)."""
    return detect_candidates(db, query_words, query_valid, query_bow,
                             ignore_mask, covis)
