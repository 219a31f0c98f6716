"""Plain KMV sketch (paper §II-C), the equal-allocation baseline (port of
``repro.core.kmv``).

Theorem 1: under a total budget ``b`` over ``m`` records the optimal plain
KMV allocation is uniform, ``k = floor(b / m)`` (at least 2), because a
pair is estimated at ``k = min(k_Q, k_X)`` (Eq. 8). Every record keeps its
k smallest hashes; the thresholds are PAD − 1, so they never bind.

The host build sorts one u64 (row | hash) key and cuts each row at k by
position; the device build is ``fused_build_columns``' ``row_cap`` route
(the B2 kernel hashes, one composite-key sort, the same cut). The
reference's per-record oracle stays there: the tests read it.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.gkmv import check_build_backend
from repro_torch.core.hashing import PAD, hash_u32_np
from repro_torch.core.sketches import RaggedBatch, pack_csr
from repro_torch.device import resolve_device


def build_kmv(records, budget: int, seed: int = 0,
              build_backend: str = "torch", device="cuda"):
    """A plain-KMV index (a :class:`repro_torch.core.arena.SketchArena`):
    every record's k = max(budget // m, 2) smallest hashes. ``budget`` counts
    hash slots (the paper's "number of signatures").
    ``build_backend="numpy"`` builds on the host (CPU columns); ``"torch"``
    runs the fused device build on ``device``."""
    from repro_torch.core.arena import SketchArena

    check_build_backend(build_backend)
    batch = (records if isinstance(records, RaggedBatch)
             else RaggedBatch.from_records(records))
    m = batch.num_records
    k = max(int(budget) // max(m, 1), 2)
    if build_backend == "torch":
        from repro_torch.kernels.hash_threshold import fused_build_columns

        packed, _ = fused_build_columns(
            batch, np.ones(batch.total, bool), 0, seed=seed, row_cap=k,
            device=resolve_device(device))
        return SketchArena.from_pack(packed)
    h = hash_u32_np(batch.ids, seed=seed)
    row = batch.row_index()
    # Per-row k smallest: one u64 (row | hash) key sort, keep pos < k.
    key = np.sort((row.astype(np.uint64) << np.uint64(32))
                  | h.astype(np.uint64))
    h = (key & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    row = (key >> np.uint64(32)).astype(np.int64)
    counts = np.bincount(row, minlength=m).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)])
    pos = np.arange(len(h), dtype=np.int64) - starts[row]
    keep = pos < k
    thr = np.full(m, PAD - np.uint32(1), dtype=np.uint32)
    return SketchArena.from_pack(pack_csr(
        h[keep], row[keep], m, thr, batch.sizes, capacity=k))


def kmv_distinct_estimate_np(hashes: np.ndarray, k: int) -> float:
    """D̂ = (k-1)/U_(k) (paper §II-C) for a single record, NumPy."""
    h = np.sort(np.asarray(hashes))
    if len(h) < k or k < 2:
        return float(len(set(h.tolist())))
    u = (float(h[k - 1]) + 1.0) / 4294967296.0
    return (k - 1) / u
