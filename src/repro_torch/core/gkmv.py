"""G-KMV: KMV with a global hash threshold (paper §IV-A(2), Theorems 2-3).

Port of ``repro.core.gkmv``: the τ selectors, the build and the query
packer. Every record keeps all hash values ``h(e) <= τ``; τ is the
budget-th smallest hash of the whole (record, element) multiset. The
build runs on the host (``build_backend="numpy"``: one hash pass, one
partition, one pack) or fused on the device (``"torch"``, the B2 kernel).
The reference's per-record oracles stay there: the tests read them.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.hashing import PAD, hash_u32_np
from repro_torch.core.sketches import (PackedSketches, RaggedBatch,
                                       make_bitmaps, pack_csr, top_membership)
from repro_torch.device import resolve_device

TAU_MODES = ("exact", "histogram")
BUILD_BACKENDS = ("numpy", "torch")


def check_build_backend(build_backend: str) -> None:
    if build_backend not in BUILD_BACKENDS:
        raise ValueError(f"build_backend must be one of {BUILD_BACKENDS}, "
                         f"got {build_backend!r}")


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


def build_gkmv(
    records,
    budget: int,
    seed: int = 0,
    capacity: int | None = None,
    tau_mode: str = "exact",
    build_backend: str = "torch",
    device="cuda",
):
    """A G-KMV index (a :class:`repro_torch.core.arena.SketchArena`): every
    record's hashes filtered at the global τ of ``budget``.

    ``capacity`` optionally caps the row length (rows above it lower their
    own threshold, ``pack_csr``'s rule). ``build_backend="numpy"`` hashes,
    selects τ and packs on the host (CPU columns); ``"torch"`` runs the
    fused device build on ``device``.
    """
    from repro_torch.core.arena import SketchArena

    check_build_backend(build_backend)
    batch = (records if isinstance(records, RaggedBatch)
             else RaggedBatch.from_records(records))
    m = batch.num_records
    if build_backend == "torch":
        from repro_torch.kernels.hash_threshold import fused_build_columns

        packed, _ = fused_build_columns(
            batch, np.ones(batch.total, bool), budget, seed=seed,
            capacity=capacity, tau_mode=tau_mode,
            device=resolve_device(device))
        return SketchArena.from_pack(packed)
    h = hash_u32_np(batch.ids, seed=seed)
    tau = select_tau_flat(h, budget, tau_mode=tau_mode)
    keep = h <= tau
    row = batch.row_index()
    thr = np.full(m, tau, dtype=np.uint32)
    return SketchArena.from_pack(pack_csr(
        h[keep], row[keep], m, thr, batch.sizes, capacity=capacity))


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


def sketch_query(
    q_ids: np.ndarray,
    tau: np.uint32,
    seed: int = 0,
    capacity: int | None = None,
    top_elems: np.ndarray | None = None,
) -> PackedSketches:
    """Sketch one query record at threshold τ (matching an index build)."""
    return sketch_query_batch([np.asarray(q_ids)], tau, seed=seed,
                              capacity=capacity, top_elems=top_elems)
