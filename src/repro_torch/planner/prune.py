"""Threshold-aware candidate generation and the threshold cut (port of
``repro.planner.prune``, host numpy).

A record X can reach Ĉ(Q→X) = (o1 + D̂∩)/|Q| ≥ t only if the pair shares
buffer bits (o1 > 0) or retained tail hashes (K∩ > 0), and both are
enumerable from the postings. For each candidate the merge yields

    c  = |retained(Q) ∩ retained(X)|   (= K∩: a shared value is ≤ both
                                        thresholds, hence ≤ τ_pair)
    o1 = popcount(buf_Q & buf_X)       (exact)

and the tail estimator is bounded from the query's own sketch: the c
shared values are c distinct retained query hashes, so U_(k) ≥ h_Q[c-1]
and, with (k-1)/k < 1,

    D̂∩  <  max_{1≤j≤c} j / unit(h_Q[j-1]).

Records whose bound (o1 + bound_tail(c))/|Q| falls below t are pruned:
they are below the threshold under the estimator the dense sweep applies,
so the verify step returns the dense route's hit sets bit for bit.

Block skipping: the same bound is evaluated per block header before any
block decodes. A header's record-id range [first, last], against the id
ranges of the query's matched tail and buffer lists, bounds c and o1 of
every record in the block (c_max, o1_max). A block whose bound falls
below t never decodes. A record touching a skipped block has its full
count bound below t, so it is below threshold even if kept blocks show it
with partial counts; the verify step rescores candidates from the
sketches, never from the merge counts.

The dense route's cut compares where the scores live, fetches only the
bool mask, then packs every query's hit ids in one host pass.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.hashing import TWO32
from repro_torch.planner.postings import (PostingsIndex, _ragged_take,
                                          decode_blocks)

# Headroom on the float64 containment bound: the dense estimator computes
# in float32, whose rounding can land a few ulps above the exact value
# (e.g. o1 = 1, |Q| = 3 scores fl32(1/3) > 1/3). The slack keeps the bound
# above every float32 score the dense sweep can produce.
_BOUND_SLACK = 1.0 + 1e-5


@dataclasses.dataclass
class CandidateSet:
    """One query's pruned candidates (sorted ascending by record id)."""

    rec_ids: np.ndarray    # int64[n]
    counts: np.ndarray     # int32[n]  shared retained-hash counts c
    o1: np.ndarray         # int32[n]  exact buffer intersections
    hits: int              # posting entries decoded
    pruned: int            # candidates dropped by the containment bound
    blocks: int = 0        # posting blocks the merge touched
    skipped_blocks: int = 0  # blocks the header bound skipped pre-decode


def query_bits(buf_row: np.ndarray) -> np.ndarray:
    """Set bit positions of a query's packed top-r bitmap row."""
    buf_row = np.asarray(buf_row, dtype=np.uint32)
    if buf_row.size == 0:
        return np.zeros(0, dtype=np.int64)
    shifts = np.arange(32, dtype=np.uint32)
    bits = ((buf_row[:, None] >> shifts[None, :]) & np.uint32(1)).reshape(-1)
    return np.nonzero(bits)[0].astype(np.int64)


def _row_block_list(store, rows) -> np.ndarray:
    """Flat block ids of ``rows``, repeats kept: a duplicated query hash
    merges its posting list once per occurrence."""
    rb = store.row_blocks.astype(np.int64)
    rows = np.asarray(rows, np.int64)
    return _ragged_take(rb[rows], rb[rows + 1] - rb[rows])


def tail_bound(q_hashes: np.ndarray) -> np.ndarray:
    """float64[nq+1]: bound_tail(c) = max_{1≤j≤c} j / unit(h_Q[j-1]) over
    the query's retained hashes sorted ascending; entry 0 is 0."""
    h = np.asarray(q_hashes, dtype=np.uint64)
    n = len(h)
    out = np.zeros(n + 1, dtype=np.float64)
    if n:
        j = np.arange(1, n + 1, dtype=np.float64)
        unit = (h.astype(np.float64) + 1.0) / TWO32
        out[1:] = np.maximum.accumulate(j / unit)
    return out


def candidates_for(
    post: PostingsIndex,
    q_hashes: np.ndarray,
    q_bits: np.ndarray,
    threshold: float,
    q_size: int,
) -> CandidateSet:
    """Merge a query's hashes and bits against the blocked postings and
    prune by the bound, skipping whole blocks whose header bound already
    sits below ``threshold``. The result is a superset of the dense hits;
    its cost scales with the decoded posting entries, not the index."""
    q_hashes = np.asarray(q_hashes, dtype=np.uint32)

    # Tail merge: which postings rows exist for the query's hashes.
    pos = np.searchsorted(post.keys, q_hashes)
    ok = pos < len(post.keys)
    hit = np.zeros(len(q_hashes), dtype=bool)
    hit[ok] = post.keys[pos[ok]] == q_hashes[ok]
    rows_t = pos[hit]
    blks_t = _row_block_list(post.tail, rows_t)

    # Buffer merge: blocks of the query's top-r bit rows.
    q_bits = np.asarray(q_bits, dtype=np.int64)
    q_bits = q_bits[q_bits < post.buf.num_rows]
    blks_b = _row_block_list(post.buf, q_bits)

    n_blocks = len(blks_t) + len(blks_b)
    skipped = 0
    bound = tail_bound(np.sort(q_hashes))    # block skip and final cut
    if float(threshold) > 0.0 and n_blocks:
        rbt = post.tail.row_blocks.astype(np.int64)
        # Matched-list id ranges (tail rows are never empty; a buffer row
        # is empty when no record carries its bit).
        slo_t = np.sort(post.tail.first[rbt[rows_t]]) \
            if len(rows_t) else np.zeros(0, np.int32)
        shi_t = np.sort(post.tail.last[rbt[rows_t + 1] - 1]) \
            if len(rows_t) else np.zeros(0, np.int32)
        rbb = post.buf.row_blocks.astype(np.int64)
        qb_live = q_bits[rbb[q_bits + 1] > rbb[q_bits]]
        slo_b = np.sort(post.buf.first[rbb[qb_live]])
        shi_b = np.sort(post.buf.last[rbb[qb_live + 1] - 1])
        qs = max(int(q_size), 1)

        def _keep(first, last):
            c_max = (np.searchsorted(slo_t, last, side="right")
                     - np.searchsorted(shi_t, first, side="left"))
            o1_max = (np.searchsorted(slo_b, last, side="right")
                      - np.searchsorted(shi_b, first, side="left"))
            ub = (o1_max.astype(np.float64)
                  + bound[np.minimum(c_max, len(bound) - 1)]) / qs
            return ub * _BOUND_SLACK >= float(threshold) - 1e-12

        keep_t = _keep(post.tail.first[blks_t], post.tail.last[blks_t])
        keep_b = _keep(post.buf.first[blks_b], post.buf.last[blks_b])
        skipped = int((~keep_t).sum()) + int((~keep_b).sum())
        blks_t, blks_b = blks_t[keep_t], blks_b[keep_b]

    tail_ids, _ = decode_blocks(post.tail, blks_t)
    buf_ids, _ = decode_blocks(post.buf, blks_b)

    hits = len(tail_ids) + len(buf_ids)
    if hits == 0:
        empty = np.zeros(0, dtype=np.int64)
        return CandidateSet(empty, empty.astype(np.int32),
                            empty.astype(np.int32), 0, 0,
                            blocks=n_blocks - skipped,
                            skipped_blocks=skipped)

    rec_c, counts_c = np.unique(tail_ids, return_counts=True)
    rec_b, counts_b = np.unique(buf_ids, return_counts=True)
    rec = np.union1d(rec_c, rec_b).astype(np.int64)
    c = np.zeros(len(rec), dtype=np.int32)
    o1 = np.zeros(len(rec), dtype=np.int32)
    c[np.searchsorted(rec, rec_c)] = counts_c
    o1[np.searchsorted(rec, rec_b)] = counts_b

    # The containment bound (o1 + bound_tail(c)) / |Q|, slack on the whole
    # of it (buffer term included), against t.
    ub = (o1.astype(np.float64) + bound[np.minimum(c, len(bound) - 1)]) \
        / max(int(q_size), 1)
    keep = ub * _BOUND_SLACK >= float(threshold) - 1e-12
    pruned = int(len(rec) - keep.sum())
    return CandidateSet(rec[keep], c[keep], o1[keep], hits, pruned,
                        blocks=n_blocks - skipped, skipped_blocks=skipped)


def f32_threshold(t) -> np.ndarray:
    """Smallest float32 ≥ t (scalar or vector).

    A float32 score s satisfies ``s >= t`` under float64 comparison iff
    ``s >= f32_threshold(t)`` under float32 comparison, so a device-side
    compare stays bit-compatible with ``np.nonzero(s >= t)``.
    """
    t64 = np.asarray(t, dtype=np.float64)
    f = t64.astype(np.float32)
    return np.where(f.astype(np.float64) < t64,
                    np.nextafter(f, np.float32(np.inf)), f)


def mask_to_hits(mask: np.ndarray) -> list[np.ndarray]:
    """bool[m, Gq] hit mask → per-query sorted int64 id arrays."""
    mask = np.asarray(mask)
    if mask.ndim != 2:
        raise ValueError(f"expected [m, Gq] mask, got {mask.shape}")
    _, rec_idx = np.nonzero(mask.T)
    counts = mask.sum(axis=0)
    return np.split(rec_idx.astype(np.int64), np.cumsum(counts)[:-1])


def threshold_hits_packed(scores, thresholds) -> list[np.ndarray]:
    """Per-query hit ids from a score matrix f32[m, Gq] (numpy or a tensor
    on any device); ``thresholds`` is scalar or per-query. For a tensor the
    ≥ runs on its device and only the bool mask crosses to the host."""
    thr = f32_threshold(thresholds)
    if isinstance(scores, np.ndarray):
        mask = scores >= (thr if thr.ndim == 0 else thr[None, :])
    else:
        t = torch.as_tensor(np.atleast_1d(thr), dtype=torch.float32,
                            device=scores.device)
        mask = (scores >= t[None, :]).cpu().numpy()
    return mask_to_hits(mask)
