"""Fingerprint hash + global-τ filter (the B2 kernel's wrapper) and the
fused device sketch build on top of it.

Port of ``repro.kernels.hash_threshold``. :func:`hash_threshold` launches
``csrc/hash_threshold.cu`` on CUDA tensors and runs the plain version
:func:`repro_torch.kernels.ref.hash_threshold_ref` on CPU tensors.

:func:`fused_build_columns` is the construction pipeline's device path:
hash every tail element (the kernel), select τ, sort to (row, hash) order
on one composite int64 key, then scatter the packed columns. The only
host crossing is one two-int read (the largest per-row count, which fixes
the pack width, and τ); every per-element quantity stays on the device.
Bit-identical to the host ``pack_csr`` pipeline: same hashes, same τ
rule, same order, same capacity-overflow thresholds.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hashing import (PAD, as_bits, as_u64, seed_offset,
                                      to_tensor)
from repro_torch.kernels import ref
from repro_torch.kernels.library import check, library

_PAD = int(PAD)


def hash_threshold(ids: torch.Tensor, seed: int, tau: int | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """ids u32[N] (int32 bit patterns) → (hashes u32[N] as int32 bits,
    keep i32[N] = hash ≤ τ). With ``tau=None`` the kernel writes hashes
    only and ``keep`` is None."""
    if ids.dtype != torch.int32 or ids.dim() != 1 or not ids.is_contiguous():
        raise ValueError("ids must be a contiguous 1-D int32 tensor "
                         f"(u32 bit pattern), got {ids.dtype} "
                         f"{tuple(ids.shape)}")
    if tau is not None:
        tau = int(tau)
        if not 0 <= tau <= _PAD:
            raise ValueError(f"tau must be a u32 value, got {tau}")
    if ids.device.type == "cpu":
        h, keep = ref.hash_threshold_ref(ids, seed, tau)
        return as_bits(h), None if keep is None else keep.to(torch.int32)
    if ids.device.type != "cuda":
        raise ValueError(f"no kernel for device {ids.device}")
    h = torch.empty_like(ids)
    keep = None if tau is None else torch.empty_like(ids)
    if ids.numel():
        lib = library()
        with torch.cuda.device(ids.device):
            err = lib.hash_threshold_launch(
                ids.data_ptr(), h.data_ptr(),
                None if keep is None else keep.data_ptr(), ids.numel(),
                seed_offset(seed), 0 if tau is None else tau,
                torch.cuda.current_stream().cuda_stream)
        check(err, "hash_threshold_launch")
        hash_threshold.launches += 1
    return h, keep


hash_threshold.launches = 0


# ---------------------------------------------------------------------------
# Fused device-path sketch construction (hash → τ → sort → pack)
# ---------------------------------------------------------------------------


def _fused_hash_sort(ids32, row, seed: int, *, m: int, budget: int,
                     tau_mode: str):
    """Stage 1: hash every element, select τ, sort to row-major order.

    Returns (hs, rs, counts, starts, tau) as int64 device tensors: hashes
    and rows sorted by (row asc, hash asc) with τ-dropped elements parked
    on sentinel row ``m`` at the tail, per-row kept counts, their
    exclusive prefix sum, and τ (0-d).
    """
    n = ids32.numel()
    h32, _ = hash_threshold(ids32, seed)
    h = as_u64(h32)
    if budget >= n:
        tau = torch.tensor(_PAD - 1, dtype=torch.int64, device=h.device)
        keep = torch.ones_like(h, dtype=torch.bool)
    else:
        if tau_mode == "histogram":
            from repro_torch.sketchindex.build import histogram_tau

            tau = histogram_tau(h, budget)
        else:
            # Exact: the budget-th smallest hash, as np.partition gives it.
            tau = torch.sort(h).values[budget - 1]
        keep = h <= tau
    rkey = torch.where(keep, row.to(torch.int64), m)
    hkey = torch.where(keep, h, _PAD)
    # One sort on the composite key is the reference's lexsort((h, row)).
    # Kept keys are distinct (record rows hold distinct ids); equal keys
    # among dropped lanes are identical values, so their order is moot.
    key = torch.sort((rkey << 32) | hkey).values
    rs, hs = key >> 32, key & 0xFFFFFFFF
    counts = torch.zeros(m + 1, dtype=torch.int64, device=h.device).index_add_(
        0, rs, torch.ones_like(rs))[:m]
    starts = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    return hs, rs, counts, starts, tau


def _fused_pack(hs, rs, counts, starts, tau, *, m: int, cap: int):
    """Stage 2: scatter the row-sorted hashes into packed [m, cap] columns.

    A row with more kept hashes than ``cap`` drops its effective threshold
    to the largest value it packs (``pack_csr``'s capacity-overflow rule).
    """
    n = hs.numel()
    pos = torch.arange(n, device=hs.device) - starts[rs]
    sel = (rs < m) & (pos < cap)
    tr = torch.where(sel, rs, m)                 # sentinel row, sliced off
    tp = torch.where(sel, pos, 0)
    values = torch.full((m + 1, cap), -1, dtype=torch.int32, device=hs.device)
    values[tr, tp] = torch.where(sel, as_bits(hs), -1)
    lengths = torch.clamp_max(counts, cap).to(torch.int32)
    idx = (starts[:m] + (cap - 1)).clamp(0, n - 1)
    thresh = torch.where(counts > cap, hs[idx], tau)
    return values[:m], lengths, as_bits(thresh)


def fused_build_columns(batch, tail_mask, budget: int, *, seed: int = 0,
                        capacity: int | None = None, tau_mode: str = "exact",
                        bitmaps=None, device="cuda"):
    """Device-path sketch construction: (PackedSketches on ``device``, τ).

    ``batch`` is a :class:`repro_torch.core.sketches.RaggedBatch`;
    ``tail_mask`` selects the hashed (non-buffered) elements; ``bitmaps``
    is the host-built buffer matrix. On a CPU device every step runs as
    plain torch (the kernel's plain version).
    """
    from repro_torch.core.gkmv import TAU_MODES
    from repro_torch.core.sketches import (PackedSketches, _resolve_capacity,
                                           pack_csr)

    if tau_mode not in TAU_MODES:
        raise ValueError(f"tau_mode must be one of {TAU_MODES}, "
                         f"got {tau_mode!r}")
    tail_mask = np.asarray(tail_mask, bool)
    ids = np.asarray(batch.ids)[tail_mask]
    row = batch.row_index()[tail_mask]
    m, n = batch.num_records, len(ids)
    sizes = batch.sizes

    if m == 0 or n == 0:
        thr_fill = np.uint32(PAD - np.uint32(1))
        pack = pack_csr(np.zeros(0, np.uint32), np.zeros(0, np.int64), m,
                        np.full(m, thr_fill, np.uint32), sizes,
                        bitmaps=bitmaps, capacity=capacity)
        return pack.to(device), thr_fill

    # uint32 id view with the same wrap rule as hash_u32_np.
    ids32 = to_tensor((ids.astype(np.uint64) & np.uint64(0xFFFFFFFF))
                      .astype(np.uint32)).to(device)
    row_t = torch.from_numpy(row.astype(np.int32)).to(device)
    hs, rs, counts, starts, tau = _fused_hash_sort(
        ids32, row_t, seed, m=m, budget=int(budget), tau_mode=tau_mode)

    # The one host crossing: the longest row fixes the pack width.
    max_count, tau_h = torch.stack([counts.max(), tau]).tolist()
    cap = _resolve_capacity(max_count, capacity, 8)
    values, lengths, thresh = _fused_pack(hs, rs, counts, starts, tau,
                                          m=m, cap=cap)
    if bitmaps is None:
        bitmaps = np.zeros((m, 0), np.uint32)
    pack = PackedSketches(values=values, lengths=lengths, thresh=thresh,
                          buf=to_tensor(bitmaps).to(device),
                          sizes=torch.from_numpy(sizes).to(device))
    return pack, np.uint32(tau_h)
