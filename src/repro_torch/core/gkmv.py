"""G-KMV: KMV with a global hash threshold (paper §IV-A(2), Theorems 2-3).

Port of the τ selectors and the query packer of ``repro.core.gkmv``. Every
record keeps all hash values ``h(e) <= τ``; τ is the budget-th smallest
hash of the whole (record, element) multiset.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.hashing import PAD, hash_u32_np
from repro_torch.core.sketches import (PackedSketches, RaggedBatch,
                                       make_bitmaps, pack_csr, top_membership)

TAU_MODES = ("exact", "histogram")


def select_global_threshold(hash_rows: Sequence[np.ndarray],
                            budget: int) -> np.uint32:
    """Exact τ over per-record hash arrays; PAD-1 (keep all) when the
    budget covers every element."""
    total = sum(len(r) for r in hash_rows)
    if budget >= total or total == 0:
        return np.uint32(PAD - np.uint32(1))
    allh = np.concatenate([np.asarray(r, dtype=np.uint32) for r in hash_rows])
    return select_tau_flat(allh, budget)


def select_tau_flat(hashes: np.ndarray, budget: int,
                    tau_mode: str = "exact") -> np.uint32:
    """τ over a flat host hash stream.

    ``"exact"``: the budget-th smallest value (``np.partition``).
    ``"histogram"``: the two-level histogram refine
    (:func:`repro_torch.sketchindex.build.histogram_tau`), the 2⁸-wide
    bin upper bound ``(τ_exact & ~0xFF) | 0xFF`` whenever the budget binds.
    """
    if tau_mode not in TAU_MODES:
        raise ValueError(f"tau_mode must be one of {TAU_MODES}, "
                         f"got {tau_mode!r}")
    hashes = np.asarray(hashes, dtype=np.uint32)
    if budget >= len(hashes) or len(hashes) == 0:
        return np.uint32(PAD - np.uint32(1))
    if tau_mode == "histogram":
        from repro_torch.sketchindex.build import histogram_tau

        h = torch.from_numpy(hashes.astype(np.int64))
        return np.uint32(int(histogram_tau(h, budget)))
    return np.uint32(np.partition(hashes, budget - 1)[budget - 1])


def sketch_query_batch(
    queries,
    tau: np.uint32,
    seed: int = 0,
    capacity: int | None = None,
    top_elems: np.ndarray | None = None,
) -> PackedSketches:
    """Sketch a whole query batch at threshold τ in one vectorized host
    pass (CSR ingest, one hash pass, buffer membership, one pack).
    Returns a pack of CPU tensors."""
    batch = (queries if isinstance(queries, RaggedBatch)
             else RaggedBatch.from_records(queries))
    m = batch.num_records
    h = hash_u32_np(batch.ids, seed=seed)
    tail_mask = np.ones(batch.total, bool)
    bitmaps = None
    if top_elems is not None and len(top_elems):
        is_top, _ = top_membership(batch.ids, top_elems)
        tail_mask = ~is_top
        bitmaps = make_bitmaps(batch, top_elems)
    keep = tail_mask & (h <= tau)
    row = batch.row_index()
    thr = np.full(m, tau, dtype=np.uint32)
    return pack_csr(h[keep], row[keep], m, thr, batch.sizes,
                    bitmaps=bitmaps, capacity=capacity)
