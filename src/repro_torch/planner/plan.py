"""Per-batch query planning: dense sweep or postings-pruned verify (port
of ``repro.planner.plan``, host numpy).

``choose_plan`` probes the postings (searchsorted and header arithmetic,
no merge) for the batch's query hashes and bits, feeds the touched-entry
count to the cost model (``core/cost_model.py``) and picks the cheaper
path. ``plan="dense"``/``"pruned"`` force a path; ``"auto"`` is the
default. Thresholds ≤ 0 always run dense: every record clears such a t,
and a filter built on "shares a hash or bit" would drop records the dense
sweep returns.

``pruned_batch`` generates candidates per query, scores the ragged union
in one call (the index passes a
:class:`repro_torch.kernels.gather_score.PairScorer`) and cuts at the
float32-exact threshold, so its hits equal the dense sweep's bit for bit.

``pruned_topk`` scores candidates in bound-descending chunks and stops
once the running k-th score exceeds every remaining bound. Records that
are not candidates score exactly 0, so the ranking equals the dense one
under the (score desc, record id asc) order. A scorer that runs on a card
(``score_fn.prefetch``) scores the bound-ordered list in a few growing
prefixes instead of one call per chunk, and the chunk loop and its stop
rule replay over those scores: the scored set, and so the answer, is the
chunked loop's by construction.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.core import cost_model
from repro_torch.core.hashing import to_numpy
from repro_torch.planner import prune
from repro_torch.planner.postings import PostingsIndex

PLAN_MODES = ("auto", "dense", "pruned")
# A prefetching scorer's first call covers PREFIX_GROWTH chunks of the
# top-k's bound-ordered list and each later call PREFIX_GROWTH times all
# fetched before, so at the default chunk of 64 a list of up to
# 64 · 16⁴ = 4,194,304 candidates takes at most four calls.
PREFIX_GROWTH = 16


@dataclasses.dataclass
class QueryPlan:
    """One batch's routing decision (attached to indexes as .last_plan)."""

    path: str              # "dense" | "pruned"
    est_dense: float       # cost-model units
    est_pruned: float
    hits: int              # posting entries the batch's hashes/bits touch
    reason: str
    per_query_hits: np.ndarray | None = None   # int64[Gq] probe breakdown
    blocks: int = 0               # posting blocks touched (tail + buffer)
    tail_blocks: int = 0          # tail blocks touched
    tail_dense_blocks: int = 0    # of which dense-bitmap blocks


def normalize_plan(plan: str | None) -> str:
    plan = "auto" if plan is None else plan
    if plan not in PLAN_MODES:
        raise ValueError(f"plan must be one of {PLAN_MODES}, got {plan!r}")
    return plan


def unpack_query_rows(qp):
    """Per-query planner inputs from a query pack: (retained-hash rows
    uint32, buffer-bit rows int64, query sizes int32)."""
    vals, lens = to_numpy(qp.values), qp.lengths.cpu().numpy()
    bufs = to_numpy(qp.buf)
    hash_rows = [vals[g, : lens[g]] for g in range(qp.num_records)]
    bit_rows = [prune.query_bits(bufs[g]) for g in range(qp.num_records)]
    return hash_rows, bit_rows, qp.sizes.cpu().numpy()


def _probe(
    post: PostingsIndex,
    q_hash_rows: Sequence[np.ndarray],
    q_bit_rows: Sequence[np.ndarray],
) -> tuple[np.ndarray, int, int, int]:
    """One key-probe pass over the batch: (per-query posting entries,
    tail_blocks, tail_dense_blocks, buf_blocks). Header arithmetic only;
    nothing decodes."""
    gq = len(q_hash_rows)
    per = np.zeros(gq, dtype=np.int64)
    if not gq:
        return per, 0, 0, 0
    allh = np.concatenate(
        [np.asarray(q, np.uint32).ravel() for q in q_hash_rows])
    hidx = np.repeat(np.arange(gq, dtype=np.int64),
                     [len(np.asarray(q).ravel()) for q in q_hash_rows])
    allb = np.concatenate(
        [np.asarray(q, np.int64).ravel() for q in q_bit_rows])
    bidx = np.repeat(np.arange(gq, dtype=np.int64),
                     [len(np.asarray(q).ravel()) for q in q_bit_rows])
    keys = post.keys
    rbt = post.tail.row_blocks.astype(np.int64)
    dcum = np.concatenate(
        [[0], np.cumsum((post.tail.meta >> np.uint32(13))
                        & np.uint32(1))]).astype(np.int64)
    rbb = post.buf.row_blocks.astype(np.int64)
    pos = np.searchsorted(keys, allh)
    ok = pos < len(keys)
    hit = np.zeros(len(allh), dtype=bool)
    hit[ok] = keys[pos[ok]] == allh[ok]
    r = pos[hit]
    # Per-query sums with np.add.at: int64-exact.
    np.add.at(per, hidx[hit], post.tail_row_lengths()[r].astype(np.int64))
    tb = int((rbt[r + 1] - rbt[r]).sum())
    td = int((dcum[rbt[r + 1]] - dcum[rbt[r]]).sum())
    live = allb < post.buf.num_rows
    qb = allb[live]
    np.add.at(per, bidx[live], post.buf_row_lengths()[qb].astype(np.int64))
    bb = int((rbb[qb + 1] - rbb[qb]).sum())
    return per, tb, td, bb


def probe_hits_per_query(post, q_hash_rows, q_bit_rows) -> np.ndarray:
    """int64[Gq] posting entries a merge would touch per query."""
    return _probe(post, q_hash_rows, q_bit_rows)[0]


def probe_hits(post, q_hash_rows, q_bit_rows) -> int:
    """Total posting entries a merge would touch for the batch."""
    return int(probe_hits_per_query(post, q_hash_rows, q_bit_rows).sum())


def probe_block_stats(post, q_hash_rows, q_bit_rows) -> tuple[int, int, int]:
    """(tail_blocks, tail_dense_blocks, buf_blocks) the batch touches."""
    return _probe(post, q_hash_rows, q_bit_rows)[1:]


def choose_plan(
    post: PostingsIndex,
    q_hash_rows: Sequence[np.ndarray],
    q_bit_rows: Sequence[np.ndarray],
    threshold: float,
    m: int,
    capacity: int,
    plan: str = "auto",
) -> QueryPlan:
    gq = len(q_hash_rows)
    plan = normalize_plan(plan)
    if float(threshold) <= 0.0:
        # Every record passes t ≤ 0; postings can't see zero-overlap pairs.
        return QueryPlan("dense", 0.0, np.inf, 0,
                         "threshold <= 0: pruning unsound, forced dense")
    per, tb, td, bb = _probe(post, q_hash_rows, q_bit_rows)
    hits = int(per.sum())
    est_dense = cost_model.dense_sweep_cost(m, capacity, gq)
    est_pruned = cost_model.pruned_path_cost(hits, capacity, gq,
                                             blocks=tb + bb)
    blk = dict(blocks=tb + bb, tail_blocks=tb, tail_dense_blocks=td)
    if plan != "auto":
        return QueryPlan(plan, est_dense, est_pruned, hits, "forced",
                         per, **blk)
    path = "pruned" if est_pruned < est_dense else "dense"
    return QueryPlan(path, est_dense, est_pruned, hits,
                     f"auto: dense≈{est_dense:.3g} vs pruned≈{est_pruned:.3g}",
                     per, **blk)


def pruned_batch(
    post: PostingsIndex,
    q_hash_rows: Sequence[np.ndarray],
    q_bit_rows: Sequence[np.ndarray],
    q_sizes: Sequence[int],
    thresholds,
    score_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
) -> tuple[list[np.ndarray], list[prune.CandidateSet]]:
    """Filter-and-verify for one query batch.

    ``score_fn(cand_rec i32[P], cand_q i32[P]) -> f32[P]`` scores the
    flattened ragged candidate list in one call. Returns (per-query hit
    ids, per-query candidate sets); the ids equal the dense sweep's
    ``np.nonzero(scores >= t)`` for each query.
    """
    gq = len(q_hash_rows)
    thr = np.broadcast_to(np.asarray(thresholds, np.float64), (gq,))
    cands = [prune.candidates_for(post, qh, qb, float(t), int(qs))
             for qh, qb, t, qs in zip(q_hash_rows, q_bit_rows, thr, q_sizes)]
    lens = [len(c.rec_ids) for c in cands]
    if sum(lens) == 0:
        return [np.zeros(0, dtype=np.int64) for _ in range(gq)], cands

    cand_rec = np.concatenate([c.rec_ids for c in cands]).astype(np.int32)
    cand_q = np.repeat(np.arange(gq, dtype=np.int32), lens)
    scores = np.asarray(score_fn(cand_rec, cand_q), dtype=np.float32)

    out = []
    pos = 0
    thr32 = prune.f32_threshold(thr)
    for g, c in enumerate(cands):
        s = scores[pos : pos + lens[g]]
        pos += lens[g]
        out.append(c.rec_ids[s >= thr32[g]].astype(np.int64))
    return out, cands


def topk_select(rec_ids, scores, k: int,
                num_records: int) -> tuple[np.ndarray, np.ndarray]:
    """The top-k output head: score descending, ties by ascending record
    id, and records absent from ``rec_ids`` (or scoring exactly 0)
    filling any shortfall in ascending-id order."""
    k = min(int(k), int(num_records))
    if k <= 0:
        return np.zeros(0, np.int64), np.zeros(0, np.float32)
    ids = np.asarray(rec_ids, np.int64)
    s = np.asarray(scores, np.float32)
    pos_mask = s > 0
    ids, s = ids[pos_mask], s[pos_mask]
    order = np.lexsort((ids, -s))           # score desc, id asc
    ids, s = ids[order][:k], s[order][:k]
    if len(ids) < k:
        fill = np.setdiff1d(np.arange(num_records, dtype=np.int64),
                            ids)[: k - len(ids)]
        ids = np.concatenate([ids, fill])
        s = np.concatenate([s, np.zeros(len(fill), np.float32)])
    return ids.astype(np.int64), s.astype(np.float32)


def topk_candidates(post: PostingsIndex, q_hashes: np.ndarray,
                    q_bits: np.ndarray, q_size: int
                    ) -> tuple[np.ndarray, np.ndarray]:
    """(record ids, containment bounds f64) of one query's threshold-0
    candidates in the order the top-k scores them: bound descending,
    stable. The bounds are the threshold filter's, inflated by its slack."""
    q_hashes = np.asarray(q_hashes, np.uint32)
    cand = prune.candidates_for(post, q_hashes, np.asarray(q_bits, np.int64),
                                0.0, int(q_size))
    if not len(cand.rec_ids):
        return cand.rec_ids, np.zeros(0, np.float64)
    bound = prune.tail_bound(np.sort(q_hashes))
    ub = (cand.o1.astype(np.float64)
          + bound[np.minimum(cand.counts, len(bound) - 1)]) \
        / max(int(q_size), 1) * prune._BOUND_SLACK
    order = np.argsort(-ub, kind="stable")
    return cand.rec_ids[order], ub[order]


def scored_prefix(ub: np.ndarray, k: int, chunk: int,
                  score_range: Callable[[int, int], np.ndarray]
                  ) -> np.ndarray:
    """f32 scores of the prefix of a bound-ordered list that the chunk
    loop scores: chunks of ``chunk`` entries until k scores are in hand and
    the next chunk's first bound ``ub[pos]`` sits strictly below the
    running k-th score (bounds descend, so nothing left can enter or tie).
    ``score_range(lo, hi)`` gives the scores of entries [lo, hi). The k-th
    score comes from a running selection of the k largest: the value a
    partition over everything scored gives."""
    n = len(ub)
    parts: list[np.ndarray] = []
    top = np.zeros(0, np.float32)
    kth = -np.inf
    pos = 0
    while pos < n:
        if pos >= k and ub[pos] < kth:
            break
        hi = min(pos + chunk, n)
        s = np.asarray(score_range(pos, hi), dtype=np.float32)
        parts.append(s)
        pos = hi
        top = np.concatenate([top, s])
        if len(top) >= k:
            top = np.partition(top, len(top) - k)[len(top) - k:]
            kth = float(top[0])
    return np.concatenate(parts) if parts else np.zeros(0, np.float32)


def _prefetched(score_range, n: int, chunk: int):
    """``score_range`` served from growing prefixes of an n-entry list:
    the first call scores PREFIX_GROWTH chunks, each later one
    PREFIX_GROWTH times all scored before (or up to what is asked)."""
    got = np.zeros(0, np.float32)

    def served(lo: int, hi: int) -> np.ndarray:
        nonlocal got
        if hi > len(got):
            end = min(n, max(hi, PREFIX_GROWTH * max(len(got), chunk)))
            got = np.concatenate([got, score_range(len(got), end)])
        return got[lo:hi]

    return served


def pruned_topk(
    post: PostingsIndex,
    q_hashes: np.ndarray,
    q_bits: np.ndarray,
    q_size: int,
    k: int,
    score_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
    num_records: int,
    chunk: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Top-k via postings-driven upper-bound pruning.

    Candidates come from the postings at threshold 0, each with the
    containment bound of the threshold filter, and are scored in
    bound-descending chunks (:func:`scored_prefix`). Once k scores are in
    hand and every remaining (slack-inflated) bound sits strictly below the
    running k-th score, nothing left can enter or tie into the top-k and
    scoring stops. When ``score_fn.prefetch`` is true the list is scored
    in growing prefixes (``PREFIX_GROWTH``) and the chunks read those
    scores.
    """
    k = min(int(k), int(num_records))
    if k <= 0:
        return np.zeros(0, np.int64), np.zeros(0, np.float32)
    ranked, ub = topk_candidates(post, q_hashes, q_bits, q_size)
    chunk = int(chunk) if chunk else max(4 * k, 64)

    def score_range(lo: int, hi: int) -> np.ndarray:
        return np.asarray(score_fn(ranked[lo:hi].astype(np.int32),
                                   np.zeros(hi - lo, np.int32)),
                          dtype=np.float32)

    if getattr(score_fn, "prefetch", False):
        score_range = _prefetched(score_range, len(ranked), chunk)
    s = scored_prefix(ub, k, chunk, score_range)
    # Zero-scored candidates join the non-candidates' tie pool; the shared
    # head applies the (score desc, id asc, zero-fill) contract.
    return topk_select(ranked[: len(s)], s, k, num_records)
