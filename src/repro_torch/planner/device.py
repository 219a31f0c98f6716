"""Device-resident pruned execution over a :class:`SketchArena` (port of
``repro.planner.device``).

With ``backend="torch"``, ``plan="pruned"`` runs the whole query chain on
the index's device: postings probe, block-task expand and decode, the K∩
scatter, the closed-form estimator, and the output head (packed hit words
or top-k), over the arena's resident mirrors
(:mod:`repro_torch.kernels.postings_merge`). The host works only before
it (sketching the queries, staging them: one copy) and after it (reading
back the packed hit words or the [Gq, k] top-k pair, never an m×Gq
matrix).

The staging pool keeps one host blob per (capacity, buffer width) and
device (type and index), pinned for a CUDA device and sized for the
largest batch seen: a batch fills a prefix of it in place through dtype
views and copies that prefix in one ``non_blocking`` transfer, and an
event recorded on that card's stream after the copy orders the next
refill behind it. A larger batch
replaces the blob, so the pool holds one blob per index layout whatever
batch sizes arrive. ``PIPELINE_STATS`` counts pipeline calls and the
pool's allocations and reuses.

``stage_query_inputs`` ends at the upload and the heads
(``pruned_scores``, ``fused_mask_words``, ``fused_topk_scores``) before
the fetch, so a test can run the middle under
``torch.cuda.set_sync_debug_mode("error")`` and show that it never waits
on the card.

Left out against the reference: its power-of-two Gq/k buckets and its
compile-signature counters, which serve a jit cache the port does not
have (a CUDA graph of the pipeline would bring them back), and its
observability spans (ROADMAP slice 7).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.arena import SketchArena
from repro_torch.core.hashing import to_numpy
from repro_torch.kernels import postings_merge
from repro_torch.planner import prune

#: Pipeline counters (process-global, monotonically increasing). In steady
#: state ``staging_reuse`` grows and ``staging_alloc`` does not.
PIPELINE_STATS = {"calls": 0, "staging_reuse": 0, "staging_alloc": 0}
_STAGING: dict = {}


def pipeline_stats() -> dict:
    """A snapshot of the counters plus the staging pool's size."""
    return {**PIPELINE_STATS, "staging_buffers": len(_STAGING)}


def reset_pipeline_stats() -> None:
    for key in PIPELINE_STATS:
        PIPELINE_STATS[key] = 0
    _STAGING.clear()


class StagedQuery(NamedTuple):
    """One staged batch: the query blob on the device and the dims that
    carve it (query count, sketch capacity, bitmap words)."""

    blob: torch.Tensor        # int32[gq * (cq + w + 3)]
    gq: int
    cq: int
    w: int

    def carve(self):
        """(values, thresh, buf, sizes, thresholds) views of the blob."""
        return postings_merge.carve_query_blob(self.blob, gq=self.gq,
                                               cq=self.cq, w=self.w)


@dataclasses.dataclass
class _Staging:
    host: torch.Tensor        # int32 host blob (pinned for CUDA)
    flat: np.ndarray          # the same memory, as uint32
    gq: int                   # the most queries it holds
    copied: torch.cuda.Event | None = None   # after the last copy out


def staging_key(cq: int, w: int, device: torch.device) -> tuple:
    """The pool key of a blob: the layout and the full device, so that two
    cards never share a blob (an index-less ``cuda`` is the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return (cq, w, device.type, device.index)


def _staging(gq: int, cq: int, w: int, device: torch.device) -> _Staging:
    key = staging_key(cq, w, device)
    st = _STAGING.get(key)
    if st is not None and st.copied is not None:
        st.copied.synchronize()       # the last copy out of this blob is done
    if st is not None and st.gq >= gq:
        PIPELINE_STATS["staging_reuse"] += 1
        return st
    PIPELINE_STATS["staging_alloc"] += 1
    host = torch.empty(gq * (cq + w + 3), dtype=torch.int32,
                       pin_memory=device.type == "cuda")
    st = _STAGING[key] = _Staging(host, host.numpy().view(np.uint32), gq)
    return st


def stage_query_inputs(arena: SketchArena, qp, thresholds=None, *, device):
    """Place one batch's inputs on ``device``: (device postings, device
    pack, :class:`StagedQuery`). The arena's mirrors are cached; only the
    query blob moves, in one copy out of the pooled host buffer. With
    ``thresholds`` None the threshold lane is +inf (the scores and top-k
    heads ignore it)."""
    device = torch.device(device)
    dpost = arena.device_postings(device)
    dpack = arena.device_pack(device)
    gq, cq, w = qp.num_records, qp.capacity, arena.buf_words
    st = _staging(gq, cq, w, device)
    # The prefix in carve_query_blob's layout.
    o0 = gq * cq
    o1 = o0 + gq
    o2 = o1 + gq * w
    o3 = o2 + gq
    flat = st.flat
    flat[:o0].reshape(gq, cq)[:] = to_numpy(qp.values)
    flat[o0:o1] = to_numpy(qp.thresh)
    buf = flat[o1:o2].reshape(gq, w)
    wq = min(w, qp.buf_words)
    buf[:] = 0                        # align bitmap widths
    buf[:, :wq] = to_numpy(qp.buf)[:, :wq]
    flat[o2:o3].view(np.int32)[:] = qp.sizes.cpu().numpy()
    thr = flat[o3:o3 + gq].view(np.float32)
    thr[:] = np.inf
    if thresholds is not None:
        thr[:] = np.broadcast_to(prune.f32_threshold(thresholds), (gq,))
    if device.type != "cuda":
        return dpost, dpack, StagedQuery(st.host[:o3 + gq].clone(), gq, cq, w)
    # The copy runs on the target card's current stream; the event that
    # orders the next refill behind it is recorded on that same stream.
    with torch.cuda.device(device):
        blob = st.host[:o3 + gq].to(device, non_blocking=True, copy=True)
        st.copied = torch.cuda.Event()
        st.copied.record(torch.cuda.current_stream(device))
    return dpost, dpack, StagedQuery(blob, gq, cq, w)


def pruned_scores(dpost, dpack, sq: StagedQuery) -> torch.Tensor:
    """f32[m, Gq] score matrix on the device: probe, decode, K∩ scatter,
    bitmap o1 and estimator over resident inputs, no host read."""
    PIPELINE_STATS["calls"] += 1
    qv, qt, qb, qs, _ = sq.carve()
    return postings_merge.pipeline_scores(dpost, dpack.values, dpack.thresh,
                                          dpack.buf, qv, qt, qb, qs)


def fused_mask_words(dpost, dpack, sq: StagedQuery) -> torch.Tensor:
    """u32[ceil(m/32), Gq] packed hit words on the device (int32 bits):
    the pipeline and the float32-exact cut the staged blob carries."""
    return postings_merge.pack_hit_words(pruned_scores(dpost, dpack, sq),
                                         sq.carve()[4])


def fused_topk_scores(dpost, dpack, sq: StagedQuery, *, k: int):
    """(scores f32[Gq, k], ids i32[Gq, k]) on the device: per query the k
    highest scores, descending, ties by ascending record id. Scores are
    ≥ 0, so their float32 bits order as the values; one int64 key of
    (score bits, m−1−id) per record makes every key distinct, and
    ``torch.topk`` of distinct keys has one answer."""
    s = pruned_scores(dpost, dpack, sq)
    m = s.shape[0]
    rev = torch.arange(m - 1, -1, -1, dtype=torch.int64, device=s.device)
    key = (s.t().contiguous().view(torch.int32).long() << 32) | rev[None, :]
    top = torch.topk(key, k, dim=1).values
    ids = (m - 1 - (top & 0xFFFFFFFF)).to(torch.int32)
    return (top >> 32).to(torch.int32).view(torch.float32), ids


def unpack_hit_words(words, m: int) -> np.ndarray:
    """bool[m, Gq] from packed hit words (a tensor on any device, fetched
    here, or numpy): bit ``i & 31`` of word ``i >> 5``."""
    words = to_numpy(words) if isinstance(words, torch.Tensor) \
        else np.asarray(words, np.uint32)
    shifts = np.arange(32, dtype=np.uint32)[None, :, None]
    bits = (words[:, None, :] >> shifts) & np.uint32(1)
    return bits.astype(bool).reshape(-1, words.shape[1])[:m]


def pruned_batch_device(arena: SketchArena, qp, thresholds, *, device,
                        plan=None) -> list[np.ndarray]:
    """Per-query hit ids of one batch through the device pipeline, equal
    to the dense sweep's. ``thresholds`` is a scalar or per-query vector
    (> 0: the planner runs t ≤ 0 dense). ``plan`` (a ``QueryPlan``) only
    short-circuits a batch whose hashes and bits touch no posting."""
    gq, m = qp.num_records, arena.num_records
    if m == 0 or (plan is not None and plan.hits <= 0):
        return [np.zeros(0, np.int64) for _ in range(gq)]
    dpost, dpack, sq = stage_query_inputs(arena, qp, thresholds,
                                          device=device)
    words = fused_mask_words(dpost, dpack, sq)
    return prune.mask_to_hits(unpack_hit_words(words, m))


def pruned_topk_device(arena: SketchArena, qp, k: int, *, device
                       ) -> list[tuple[np.ndarray, np.ndarray]]:
    """``[(ids int64[k'], scores float32[k'])]`` per query, k' = min(k, m):
    the host ``pruned_topk`` contract (score descending, id ascending,
    zero-score records filling a shortfall in ascending-id order), which
    a top-k over the full score matrix gives, since records that are not
    candidates score exactly 0. One fetch of the [2, Gq, k] result."""
    gq, m = qp.num_records, arena.num_records
    k_eff = min(int(k), m)
    if k_eff <= 0:
        return [(np.zeros(0, np.int64), np.zeros(0, np.float32))
                for _ in range(gq)]
    dpost, dpack, sq = stage_query_inputs(arena, qp, device=device)
    vals, ids = fused_topk_scores(dpost, dpack, sq, k=k_eff)
    both = torch.stack([vals.view(torch.int32), ids]).cpu().numpy()
    vals_h, ids_h = both[0].view(np.float32), both[1]
    return [(ids_h[g].astype(np.int64), vals_h[g].copy()) for g in range(gq)]
