"""GB-KMV: G-KMV + a bitmap buffer of the top-r frequent elements
(paper §IV-B, Algorithm 1-2). Port of ``repro.core.gbkmv``.

Budget accounting follows Algorithm 1: with budget ``b`` in 32-bit slots,
the buffer costs ``ceil(r/32)`` words per record and the G-KMV tail gets
the remainder. The host half of construction (CSR ingest, element
frequencies, the cost-model r, top-r, buffer bitmaps) is numpy; the
hash → τ → pack half runs either on the host (``build_backend="numpy"``)
or fused on the device (``"torch"``, the B2 kernel).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import cost_model
from repro_torch.core.arena import SketchArena
from repro_torch.core.gkmv import check_build_backend, select_tau_flat
from repro_torch.core.hashing import hash_u32_np
from repro_torch.core.sketches import (PackedSketches, RaggedBatch,
                                       make_bitmaps, pack_csr, top_membership)
from repro_torch.device import resolve_device


@dataclasses.dataclass
class GBKMVIndex:
    """A GB-KMV index: packed sketches + the metadata to sketch queries."""

    sketches: SketchArena
    tau: np.uint32            # global hash threshold of the G-KMV part
    top_elems: np.ndarray     # element ids owning buffer bits (len r)
    seed: int
    buffer_bits: int          # r

    @property
    def num_records(self) -> int:
        return self.sketches.num_records

    def nbytes(self) -> int:
        return self.sketches.nbytes()


def element_frequencies_csr(batch: RaggedBatch
                            ) -> tuple[np.ndarray, np.ndarray]:
    """(unique element ids, counts) over the flat id stream. Dense
    non-negative universes count through one ``np.bincount``; anything
    else through ``np.unique``."""
    ids = batch.ids
    if len(ids) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    lo, hi = int(ids.min()), int(ids.max())
    if lo >= 0 and hi < max(4 * len(ids), 1 << 22):
        counts = np.bincount(ids, minlength=hi + 1)
        uniq = np.nonzero(counts)[0].astype(np.int64)
        return uniq, counts[uniq]
    return np.unique(ids, return_counts=True)


def choose_top_elements_csr(uniq: np.ndarray, counts: np.ndarray,
                            r: int) -> np.ndarray:
    """Top-r element ids by (count desc, id asc): argpartition down to the
    candidates, then one small lexsort."""
    if r <= 0 or len(uniq) == 0:
        return np.zeros(0, dtype=np.int64)
    r_eff = min(int(r), len(uniq))
    if r_eff < len(uniq):
        kth = np.partition(counts, len(counts) - r_eff)[len(counts) - r_eff]
        cand = np.nonzero(counts >= kth)[0]
    else:
        cand = np.arange(len(uniq))
    order = np.lexsort((uniq[cand], -counts[cand]))[:r_eff]
    return uniq[cand[order]].astype(np.int64)


def _auto_buffer_bits(counts: np.ndarray, sizes: np.ndarray,
                      budget: int, m: int) -> int:
    """§IV-C6 cost model on the frequency table."""
    freqs = np.sort(counts.astype(np.int64))[::-1]
    return cost_model.choose_buffer_size(freqs, np.asarray(sizes, np.int64),
                                         budget, m)


def build_gbkmv(
    records,
    budget: int,
    r: int | str = "auto",
    seed: int = 0,
    capacity: int | None = None,
    tau_mode: str = "exact",
    build_backend: str = "torch",
    top_elems: np.ndarray | None = None,
    device="cuda",
) -> GBKMVIndex:
    """Algorithm 1: pick r (cost model), top-r elements, τ, pack sketches.

    Args:
      records:  element-id arrays (distinct ids within each record), or a
                pre-ingested :class:`RaggedBatch`
      budget:   total space in 32-bit slots across all records
      r:        buffer bits per record; "auto" runs the §IV-C6 cost model
      capacity: optional cap on the packed G-KMV row length
      tau_mode: "exact" (partition) or "histogram" (two-level refine,
                τ within 2⁸ of exact)
      build_backend: "numpy" = host hash/τ/pack, columns on the CPU;
                "torch" = the fused device build on ``device``
      top_elems: pin the buffer element set instead of deriving it from
                this batch's frequencies (r defaults to its length)
    """
    check_build_backend(build_backend)
    batch = (records if isinstance(records, RaggedBatch)
             else RaggedBatch.from_records(records))
    m = batch.num_records
    sizes = batch.sizes

    if top_elems is not None:
        top = np.asarray(top_elems, dtype=np.int64)
        r = len(top) if r == "auto" else int(r)
    else:
        uniq, counts = element_frequencies_csr(batch)
        if r == "auto":
            r = _auto_buffer_bits(counts, sizes.astype(np.int64), budget, m)
        r = int(r)
        top = choose_top_elements_csr(uniq, counts, r)

    is_top, bit = top_membership(batch.ids, top)
    tail_mask = ~is_top

    words_per_rec = -(-r // 32) if r else 0
    tail_budget = max(budget - m * words_per_rec, m)  # ≥1 slot per record

    bitmaps = make_bitmaps(batch, top, membership=(is_top, bit))
    if build_backend == "torch":
        from repro_torch.kernels.hash_threshold import fused_build_columns

        packed, tau = fused_build_columns(
            batch, tail_mask, tail_budget, seed=seed, capacity=capacity,
            tau_mode=tau_mode, bitmaps=bitmaps, device=resolve_device(device))
    else:
        h_tail = hash_u32_np(batch.ids[tail_mask], seed=seed)
        tau = select_tau_flat(h_tail, tail_budget, tau_mode=tau_mode)
        keep = h_tail <= tau
        row_tail = batch.row_index()[tail_mask]
        thr = np.full(m, tau, dtype=np.uint32)
        packed = pack_csr(h_tail[keep], row_tail[keep], m, thr, sizes,
                          bitmaps=bitmaps, capacity=capacity)
    return GBKMVIndex(sketches=SketchArena.from_pack(packed),
                      tau=np.uint32(tau), top_elems=top, seed=seed,
                      buffer_bits=r)


def sketch_query(index: GBKMVIndex, q_ids: np.ndarray) -> PackedSketches:
    """Sketch a query with the index's τ / top-r / seed (§IV-B)."""
    return sketch_query_batch(index, [np.asarray(q_ids)])


def sketch_query_batch(index: GBKMVIndex, queries) -> PackedSketches:
    """One vectorized host pack (CPU tensors) for a whole query batch,
    its buffer width aligned with the index's."""
    from repro_torch.core.gkmv import sketch_query_batch as _sqb

    q = _sqb(queries, index.tau, seed=index.seed,
             capacity=index.sketches.capacity, top_elems=index.top_elems)
    w = index.sketches.buf_words
    if q.buf_words != w:
        # A query pack WIDER than the index would drop live buffer bits:
        # an inconsistent index, not something to pad over.
        if q.buf_words > w:
            raise ValueError(
                f"query buffer needs {q.buf_words} words but the index "
                f"stores {w}: top_elems is inconsistent with the packed "
                "buffer width")
        buf = torch.zeros((q.num_records, w), dtype=torch.int32)
        buf[:, : q.buf_words] = q.buf
        q = dataclasses.replace(q, buf=buf)
    return q


def containment_scores(index: GBKMVIndex, q: PackedSketches,
                       backend: str = "torch", device="cuda") -> np.ndarray:
    """Ĉ(Q→X) for every record (Eq. 27): buffer popcount + G-KMV tail,
    scored on ``device`` (``backend`` as in ``containment_matrix``)."""
    from repro_torch.core.estimators import containment_matrix

    x = index.sketches.device_pack(resolve_device(device))
    return containment_matrix(q, x, backend=backend)[:, 0]


def search(index: GBKMVIndex, q_ids: np.ndarray, threshold: float,
           backend: str = "torch", device="cuda") -> np.ndarray:
    """Algorithm 2: record ids with estimated containment ≥ t*."""
    q = sketch_query(index, q_ids)
    scores = containment_scores(index, q, backend=backend, device=device)
    return np.nonzero(scores >= threshold)[0]
