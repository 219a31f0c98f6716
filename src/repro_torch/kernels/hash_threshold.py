"""Fingerprint hash + global-τ filter (the B2 kernel's wrapper) and the
fused device sketch build on top of it.

Port of ``repro.kernels.hash_threshold``. :func:`hash_threshold` launches
``csrc/hash_threshold.cu`` on CUDA tensors and runs the plain version
:func:`repro_torch.kernels.ref.hash_threshold_ref` on CPU tensors.

:func:`fused_build_columns` is the construction pipeline's device path:
hash every tail element (the kernel), select τ, sort to (row, hash) order
on one composite int64 key, then scatter the packed columns. The only
host crossing is one two-int read (the largest per-row count, which fixes
the pack width, and τ; none for plain KMV's ``row_cap`` route, which keeps
each row's k smallest hashes); every per-element quantity stays on the
device.
Bit-identical to the host ``pack_csr`` pipeline: same hashes, same τ
rule, same order, same capacity-overflow thresholds.

:func:`fused_encode_postings` is the device path of the postings build:
it block-compresses the tail postings from the packed columns where they
live, array-equal to the host encoder, with one three-int host read.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hashing import (PAD, as_bits, as_u64, seed_offset,
                                      to_tensor)
from repro_torch.kernels import ref
from repro_torch.kernels.library import check, current_stream_ptr, library

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
    dev = ids.device
    if dev.type == "cpu":
        h, keep = ref.hash_threshold_ref(ids, seed, tau)
        return as_bits(h), None if keep is None else keep.to(torch.int32)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    n = ids.numel()
    h = torch.empty(n, dtype=torch.int32, device=dev)
    keep = None if tau is None else torch.empty(n, dtype=torch.int32,
                                                device=dev)
    if n:
        check(library().hash_threshold_launch(
            ids.data_ptr(), h.data_ptr(),
            None if keep is None else keep.data_ptr(), n, seed_offset(seed),
            0 if tau is None else tau, dev.index,
            current_stream_ptr(dev.index)), "hash_threshold_launch")
        hash_threshold.launches += 1
    return h, keep


hash_threshold.launches = 0


# ---------------------------------------------------------------------------
# Fused device-path sketch construction (hash → τ → sort → pack)
# ---------------------------------------------------------------------------


def _fused_hash_sort(ids32, row, seed: int, *, m: int, budget: int,
                     tau_mode: str, filter_tau: bool = True):
    """Stage 1: hash every element, select τ, sort to row-major order.

    Returns (hs, rs, counts, starts, tau) as int64 device tensors: hashes
    and rows sorted by (row asc, hash asc) with τ-dropped elements parked
    on sentinel row ``m`` at the tail, per-row kept counts, their
    exclusive prefix sum, and τ (0-d). ``filter_tau=False`` (plain KMV)
    keeps every element and pins τ at PAD − 1; the positional cut is
    stage 2's.
    """
    n = ids32.numel()
    h32, _ = hash_threshold(ids32, seed)
    h = as_u64(h32)
    if not filter_tau or budget >= n:
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
    # The key is the whole (row, hash) value, so equal keys are identical
    # values and the sort's order among them is moot, with or without the
    # τ filter (the positional cut of plain KMV included).
    key = torch.sort((rkey << 32) | hkey).values
    rs, hs = key >> 32, key & 0xFFFFFFFF
    counts = torch.zeros(m + 1, dtype=torch.int64, device=h.device).index_add_(
        0, rs, torch.ones_like(rs))[:m]
    starts = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    return hs, rs, counts, starts, tau


def _fused_pack(hs, rs, counts, starts, tau, *, m: int, cap: int,
                limit: int | None = None, lower_thresh: bool = True):
    """Stage 2: scatter the row-sorted hashes into packed [m, cap] columns.

    ``limit`` is the kept length of a row: ``cap`` in τ mode, k for plain
    KMV (whose ``cap`` is k rounded up to the pad multiple). With
    ``lower_thresh`` a row with more kept hashes than ``cap`` drops its
    effective threshold to the largest value it packs (``pack_csr``'s
    capacity-overflow rule); without it every row keeps τ.
    """
    limit = cap if limit is None else limit
    n = hs.numel()
    pos = torch.arange(n, device=hs.device) - starts[rs]
    sel = (rs < m) & (pos < limit)
    tr = torch.where(sel, rs, m)                 # sentinel row, sliced off
    tp = torch.where(sel, pos, 0)
    values = torch.full((m + 1, cap), -1, dtype=torch.int32, device=hs.device)
    values[tr, tp] = torch.where(sel, as_bits(hs), -1)
    lengths = torch.clamp_max(counts, limit).to(torch.int32)
    if lower_thresh:
        idx = (starts[:m] + (cap - 1)).clamp(0, n - 1)
        thresh = torch.where(counts > cap, hs[idx], tau)
    else:
        thresh = tau.expand(m)
    return values[:m], lengths, as_bits(thresh)


def fused_build_columns(batch, tail_mask, budget: int, *, seed: int = 0,
                        capacity: int | None = None, tau_mode: str = "exact",
                        bitmaps=None, row_cap: int | None = None,
                        device="cuda"):
    """Device-path sketch construction: (PackedSketches on ``device``, τ).

    ``batch`` is a :class:`repro_torch.core.sketches.RaggedBatch`;
    ``tail_mask`` selects the hashed (non-buffered) elements; ``bitmaps``
    is the host-built buffer matrix. ``row_cap`` switches to plain-KMV
    semantics: every row keeps its k = ``row_cap`` smallest hashes, the
    width is k rounded up to 8 and τ is PAD − 1, so it never binds. On a
    CPU device every step runs as plain torch (the kernel's plain
    version).
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
                        bitmaps=bitmaps,
                        capacity=capacity if row_cap is None else row_cap)
        return pack.to(device), thr_fill

    # uint32 id view with the same wrap rule as hash_u32_np.
    ids32 = to_tensor((ids.astype(np.uint64) & np.uint64(0xFFFFFFFF))
                      .astype(np.uint32)).to(device)
    row_t = torch.from_numpy(row.astype(np.int32)).to(device)
    hs, rs, counts, starts, tau = _fused_hash_sort(
        ids32, row_t, seed, m=m, budget=int(budget), tau_mode=tau_mode,
        filter_tau=row_cap is None)

    if row_cap is not None:
        # Plain KMV: the width is known and τ is PAD − 1, so nothing is read.
        cap, tau_h = _resolve_capacity(int(row_cap), None, 8), _PAD - 1
        values, lengths, thresh = _fused_pack(
            hs, rs, counts, starts, tau, m=m, cap=cap, limit=int(row_cap),
            lower_thresh=False)
    else:
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


# ---------------------------------------------------------------------------
# Device-path postings encode (packed columns → blocked tail store)
# ---------------------------------------------------------------------------


def _encode_tail_device(values, lengths, *, m: int, cap: int):
    """Block-compress the tail postings on the columns' device.

    The device twin of ``planner/postings.py::build_postings``'s tail
    (``_row_pairs``, ``_csr_from_pairs``, ``encode_store``), as the
    reference's ``_encode_tail_device`` spells it: the same (hash asc,
    record asc) order, 128-entry blocks and delta-bitpack / dense-bitmap
    rule, bit for bit, as scatter arithmetic over the flattened [m·cap]
    slot stream. Every output is sized n+1 = m·cap+1 with slot n as the
    scatter trash; the true sizes (#keys U, #blocks NB, #payload words P)
    are the returned ``sizes`` vector. Arithmetic is int64 on u32 values;
    a payload word sums disjoint bit fields, so the sum is the OR.
    """
    from repro_torch.planner.postings import BLOCK, DENSE_MAX_WORDS

    dev = values.device
    n = m * cap
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    rec = iota // cap
    live = (iota % cap) < lengths.long()[rec]
    h = torch.where(live, as_u64(values.reshape(-1)), _PAD)
    r = torch.where(live, rec, m)
    # (hash asc, record asc): a stable sort by record, then by hash. Dead
    # (PAD, m) slots sort to the tail.
    o1 = torch.sort(r, stable=True).indices
    order = o1[torch.sort(h[o1], stable=True).indices]
    hs, rsrt = h[order], r[order]
    valid = iota < live.sum()

    def shifted(x):
        return torch.cat([x[:1], x[:-1]])

    newkey = valid & ((iota == 0) | (hs != shifted(hs)))
    key_id = torch.cumsum(newkey, 0) - 1
    posr = iota - torch.cummax(torch.where(newkey, iota, -1), 0).values
    bstart = valid & (posr % BLOCK == 0)
    blk_id = torch.cumsum(bstart, 0) - 1
    posb = iota - torch.cummax(torch.where(bstart, iota, -1), 0).values
    delta_ok = valid & (posb > 0)
    d = torch.where(delta_ok, rsrt - shifted(rsrt), 0)

    # -- per-block headers (slot n = trash) ---------------------------------
    def slots(fill=0):
        return torch.full((n + 1,), fill, dtype=torch.int64, device=dev)

    tgt = torch.where(valid, blk_id, n)
    first_b = slots().scatter_(0, torch.where(bstart, blk_id, n), rsrt)
    last_b = slots().scatter_reduce_(0, tgt, torch.where(valid, rsrt, 0),
                                     "amax")
    cnt_b = slots().scatter_add_(0, tgt, torch.ones_like(tgt))
    md_b = slots().scatter_reduce_(0, tgt, d, "amax")
    mind_b = slots(1 << 30).scatter_reduce_(
        0, torch.where(delta_ok, blk_id, n), d, "amin")
    bw = slots()
    for k in range(31):
        bw += (md_b >> k) > 0
    w_sparse = ((cnt_b - 1) * bw + 31) // 32
    w_dense = (last_b - first_b + 1 + 31) // 32
    dense = (mind_b >= 1) & (w_dense < w_sparse) & (w_dense <= DENSE_MAX_WORDS)
    words_b = torch.where(dense, w_dense, w_sparse)
    words_b[n] = 0
    off_b = torch.cat([slots()[:1], torch.cumsum(words_b[:n], 0)])
    meta_b = ((cnt_b - 1) & 0x7F) | (bw << 8) | (dense.long() << 13)

    # -- payload scatters ---------------------------------------------------
    blk = blk_id.clamp(0, n)
    b_dense, b_bw, b_off, b_first = dense[blk], bw[blk], off_b[blk], first_b[blk]
    payload = slots()
    sel = delta_ok & ~b_dense & (b_bw > 0)
    bitpos = (posb - 1) * b_bw
    wloc = b_off + (bitpos >> 5)
    sh = bitpos & 31
    lo = (d << sh) & 0xFFFFFFFF
    hi = torch.where(sh > 0, d >> ((32 - sh) & 31), 0)
    payload.scatter_add_(0, torch.where(sel, wloc, n), torch.where(sel, lo, 0))
    payload.scatter_add_(0, torch.where(sel, wloc + 1, n),
                         torch.where(sel, hi, 0))
    dsel = valid & b_dense
    bit = rsrt - b_first
    payload.scatter_add_(0, torch.where(dsel, b_off + (bit >> 5), n),
                         torch.where(dsel, torch.ones_like(bit) << (bit & 31), 0))

    # -- keyspace -------------------------------------------------------------
    keys_b = slots().scatter_(0, torch.where(newkey, key_id, n), hs)
    nblk_k = slots().scatter_add_(0, torch.where(bstart, key_id, n),
                                  torch.ones_like(key_id))
    row_blocks_b = torch.cat([slots()[:1], torch.cumsum(nblk_k[:n], 0)])
    nb = bstart.sum()
    sizes = torch.stack([newkey.sum(), nb, off_b[nb]])
    return (as_bits(keys_b), row_blocks_b.to(torch.int32),
            first_b.to(torch.int32), last_b.to(torch.int32),
            meta_b.to(torch.int32), off_b.to(torch.int32),
            as_bits(payload & 0xFFFFFFFF), sizes)


def fused_encode_postings(values, lengths, *, m: int, cap: int) -> dict:
    """The blocked tail postings of packed columns, encoded where the
    columns live: the arrays of a
    :class:`repro_torch.core.arena.DevicePostings` and the blocks' ``last``
    ids (int32, u32 as bit patterns), cut to their true sizes. The one
    host read is the three-int sizes vector. The cuts are copies, so the
    m·cap-sized encode buffers are freed."""
    keys, rb, first, last, meta, off, payload, sizes = _encode_tail_device(
        values, lengths, m=m, cap=cap)
    u, nb, p = sizes.tolist()
    cut = {"keys": keys[:u], "row_blocks": rb[:u + 1], "first": first[:nb],
           "last": last[:nb], "meta": meta[:nb], "off": off[:nb + 1],
           "payload": payload[:p]}
    return {name: t.clone() for name, t in cut.items()}
