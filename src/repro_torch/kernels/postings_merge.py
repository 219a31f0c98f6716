"""The device pruned pipeline over the block postings (port of
``repro.kernels.postings_merge``): candidate counting for the pruned query
route without leaving the card, and without flat posting lists.

    probe     each query hash's row in the sorted tail-key column, and the
              prefix sum of the hit rows' block counts (:func:`probe_tasks`:
              kernel B3, ``csrc/postings_probe.cu``, one launch)
    decode    every block of every hit row, decoded and scattered into the
              exact K∩ count matrix (:func:`block_decode`: kernel B4,
              ``csrc/block_decode.cu``, which also does the block-task
              expand and the dense-bitmap blocks). A posting entry for
              (h, X) against query Q is one shared retained hash, so the
              multiplicity is the count.
    score     o1 from the resident packed bitmaps (the dense kernel's
              popcount: the buffer postings need no mirror), then the
              estimator in closed form per cell: n_x, n_q and U₍k₎ from
              per-row binary searches against τ_pair, every float op in
              the dense kernel's order (:func:`estimate_scores`)

The score matrix equals the dense sweep's bit for bit everywhere: inside
the candidate set the counts are the dense kernel's counts, outside it
K∩ = 0 and o1 is the same popcount. :func:`pack_hit_words` is the
hit-word head (score ≥ threshold, bit-packed along the record axis into
u32 words: an 8× smaller fetch than a bool mask); the planner's
``repro_torch.planner.device`` applies it or a top-k to
:func:`pipeline_scores`.

On CUDA tensors the probe and the decode launch the kernels; on CPU
tensors they run the plain versions in :mod:`repro_torch.kernels.ref`.
The rest are torch ops, as the reference's are XLA programs. Nothing
between the staged upload and the fetch reads a value on the host.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.estimators import popcount
from repro_torch.core.hashing import TWO32, as_bits, as_u64
from repro_torch.kernels import ref
from repro_torch.kernels.library import check, current_stream_ptr, library

# XOR with the sign bit maps u32 bit patterns held in int32 onto int32
# values in the same (unsigned) order; PAD goes to the top.
_SIGN_BIT = -(1 << 31)


def _require(name: str, t: torch.Tensor, dtype, device, dim: int = 1):
    if (t.dtype != dtype or t.dim() != dim or not t.is_contiguous()
            or t.device != device):
        raise ValueError(f"{name} must be a contiguous {dim}-D {dtype} tensor "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def fence_shift(u: int) -> int:
    """The probe's fence stride s for a u-key column, as its C entry picks
    it: the smallest shift for which every 2^s-th key fits in the kernel's
    shared-memory budget (0: the whole column; the last s search levels
    then run in device memory). Asks the kernel library, so needs the card's
    toolchain."""
    return library().postings_probe_fence_shift(u)


# The probe's C entry stores the fence stride it ran with here.
_shift_out = ctypes.c_int32(-1)
_SHIFT_OUT = ctypes.addressof(_shift_out)


def postings_probe(keys: torch.Tensor, q_flat: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(pos i32[n], hit bool[n]): for each query hash, the number of keys
    below it and whether it is a key (never for PAD), as the reference's
    ``_probe_pallas``. ``keys`` is the ascending u32 tail-key column,
    ``q_flat`` the batch's query hashes, both int32 bit patterns on one
    device. U = 0 or n = 0 launches nothing. Every launch of the probe
    kernel, here or in :func:`probe_tasks`, adds one to
    ``postings_probe.launches`` and sets ``postings_probe.last_fence_shift``
    to the fence stride it ran with."""
    dev = keys.device
    _require("keys", keys, torch.int32, dev)
    _require("q_flat", q_flat, torch.int32, dev)
    if dev.type == "cpu":
        return ref.postings_probe_ref(keys, q_flat)
    return _probe(keys, q_flat, None)


def probe_tasks(keys: torch.Tensor, q_flat: torch.Tensor,
                row_blocks: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(pos i32[n], hit bool[n], cum i32[n]): :func:`postings_probe` and the
    inclusive prefix sum of the lanes' block counts (``row_blocks[pos+1] −
    row_blocks[pos]`` for a lane that hit, else 0), in one launch: lane i
    owns block tasks [cum[i-1], cum[i]) of :func:`block_decode`.
    ``row_blocks`` i32[U+1] is the tail store's block range per key."""
    dev = keys.device
    _require("keys", keys, torch.int32, dev)
    _require("q_flat", q_flat, torch.int32, dev)
    _require("row_blocks", row_blocks, torch.int32, dev)
    if row_blocks.numel() != keys.numel() + 1:
        raise ValueError("probe_tasks: row_blocks must hold U + 1 entries")
    if dev.type == "cpu":
        return ref.probe_tasks_ref(keys, q_flat, row_blocks)
    return _probe(keys, q_flat, row_blocks)


def _probe(keys, q_flat, row_blocks):
    """Launch the probe kernel on the keys' card: (pos, hit), and cum too
    when ``row_blocks`` is given. The kernel writes every lane."""
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    n, u = q_flat.numel(), keys.numel()
    tasks = row_blocks is not None
    if not (n and u):
        # Nothing to search: every lane misses, nothing is launched.
        out = (torch.zeros(n, dtype=torch.int32, device=dev),
               torch.zeros(n, dtype=torch.bool, device=dev))
        return out + (torch.zeros(n, dtype=torch.int32, device=dev),) \
            if tasks else out
    pos = torch.empty(n, dtype=torch.int32, device=dev)
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    cum = torch.empty(n, dtype=torch.int32, device=dev) if tasks else None
    check(library().postings_probe_launch(
        keys.data_ptr(), u, q_flat.data_ptr(), n,
        row_blocks.data_ptr() if tasks else None, pos.data_ptr(),
        hit.data_ptr(), cum.data_ptr() if tasks else None, _SHIFT_OUT,
        dev.index, current_stream_ptr(dev.index)), "postings_probe_launch")
    postings_probe.launches += 1
    postings_probe.last_fence_shift = _shift_out.value
    return (pos, hit, cum) if tasks else (pos, hit)


postings_probe.launches = 0
postings_probe.last_fence_shift = None


def block_decode(pos, hit, row_blocks, first, meta, off, payload, *,
                 gq: int, cq: int, m: int, cum=None) -> torch.Tensor:
    """i32[m, gq] K∩ counts of a query batch against every record.

    Lane ``i`` of ``pos``/``hit`` (the probe of query hash ``i``, which
    belongs to query ``i // cq``) expands to the blocks of its key when it
    hit; each decoded record id adds one to its cell. The block arrays are
    a :class:`repro_torch.core.arena.DevicePostings`' tail store. ``cum``
    is the lanes' block-task prefix as :func:`probe_tasks` writes it;
    without it the prefix is computed here by the plain torch ops
    (:func:`repro_torch.kernels.ref.task_prefix_ref`). On CUDA a warp a
    task strides over the tasks up to that prefix's total, read in device
    memory; the counts are zeroed on the same stream by a kernel that the
    decode overlaps (programmatic dependent launch) up to its first
    atomic. No lanes or no blocks launch nothing.
    """
    dev = pos.device
    _require("pos", pos, torch.int32, dev)
    _require("hit", hit, torch.bool, dev)
    for name, t in (("row_blocks", row_blocks), ("first", first),
                    ("meta", meta), ("off", off), ("payload", payload)):
        _require(name, t, torch.int32, dev)
    if cum is not None:
        _require("cum", cum, torch.int32, dev)
    nb = first.numel()
    if (hit.shape != pos.shape or pos.numel() != gq * cq
            or meta.numel() != nb or off.numel() != nb + 1
            or (cum is not None and cum.shape != pos.shape)):
        raise ValueError("block_decode: inconsistent shapes")
    if dev.type == "cpu":
        return ref.kcount_ref(pos, hit, row_blocks, first, meta, off, payload,
                              gq=gq, cq=cq, m=m, cum=cum)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    n = pos.numel()
    if not (n and nb and m):
        return torch.zeros((m, gq), dtype=torch.int32, device=dev)
    if cum is None:
        cum = ref.task_prefix_ref(pos, hit, row_blocks)
    kcount = torch.empty((m, gq), dtype=torch.int32, device=dev)
    check(library().block_decode_launch(
        pos.data_ptr(), cum.data_ptr(), n, row_blocks.data_ptr(),
        first.data_ptr(), meta.data_ptr(), off.data_ptr(), nb,
        payload.data_ptr(), payload.numel(), gq, cq, m, kcount.data_ptr(), 1,
        dev.index, current_stream_ptr(dev.index)), "block_decode_launch")
    block_decode.launches += 1
    return kcount


block_decode.launches = 0


# ---------------------------------------------------------------------------
# The scoring tail: bitmap o1 and the closed-form estimator
# ---------------------------------------------------------------------------


def bitmap_o1(x_buf: torch.Tensor, q_buf: torch.Tensor) -> torch.Tensor:
    """i32[m, Gq] exact buffer intersections: popcount(x_buf & q_buf)."""
    if x_buf.shape[1]:
        both = as_u64(x_buf[:, None, :] & q_buf[None, :, :])
        return popcount(both).sum(-1).to(torch.int32)
    return torch.zeros((x_buf.shape[0], q_buf.shape[0]), dtype=torch.int32,
                       device=x_buf.device)


def _ordered(bits: torch.Tensor) -> torch.Tensor:
    return bits ^ _SIGN_BIT


def estimate_scores(kcap, o1, x_values, x_thresh, q_values, q_thresh,
                    q_sizes) -> torch.Tensor:
    """f32[m, Gq] GB-KMV scores from the count matrices ``kcap`` (K∩) and
    ``o1``, as the reference's ``_estimate_scores``.

    Rows are sorted and duplicate-free, so a row's insertion point after
    τ_pair is its ≤ count n_x (n_q), and U₍k₎ is the larger of the two
    rows' last live values. The searches run on sign-flipped int32 (the
    u32 order); the float tail copies the dense kernel's op order and
    divides by tensors only.
    """
    xs, qs = _ordered(x_values), _ordered(q_values)
    tau = torch.minimum(_ordered(x_thresh)[:, None],
                        _ordered(q_thresh)[None, :])           # [m, Gq]
    nx = torch.searchsorted(xs, tau, right=True)               # [m, Gq]
    nq_t = torch.searchsorted(qs, tau.t().contiguous(), right=True)
    lx = as_u64(_ordered(xs.gather(1, (nx - 1).clamp_min(0))))
    lx = torch.where(nx > 0, lx, 0)
    lq = as_u64(_ordered(qs.gather(1, (nq_t - 1).clamp_min(0))))
    lq = torch.where(nq_t > 0, lq, 0).t()
    u_unit = (torch.maximum(lx, lq).to(torch.float32) + 1.0) / TWO32

    kc = kcap.long()
    k = nx + nq_t.t() - kc
    kf = k.to(torch.float32)
    cf = kc.to(torch.float32)
    d_hat = (cf / kf.clamp_min(1.0)) * ((kf - 1.0) / u_unit.clamp_min(1e-30))
    d_hat = torch.where((k >= 2) & (kc >= 1), d_hat,
                        torch.where(kc >= 1, cf, 0.0))
    return (o1.to(torch.float32) + d_hat) \
        / q_sizes.to(torch.float32).clamp_min(1.0)[None, :]


# ---------------------------------------------------------------------------
# The pipeline: probe → decode + K∩ scatter → estimator; the hit-word head
# ---------------------------------------------------------------------------


def carve_query_blob(blob: torch.Tensor, *, gq: int, cq: int, w: int):
    """(values [gq, cq], thresh [gq], buf [gq, w], sizes i32[gq],
    thresholds f32[gq]) as views of the one staged int32 blob, laid out
    [values | thresh | buf | sizes | thresholds]."""
    o0 = gq * cq
    o1 = o0 + gq
    o2 = o1 + gq * w
    o3 = o2 + gq
    return (blob[:o0].view(gq, cq), blob[o0:o1], blob[o1:o2].view(gq, w),
            blob[o2:o3], blob[o3:o3 + gq].view(torch.float32))


def pipeline_scores(dpost, x_values, x_thresh, x_buf, q_values, q_thresh,
                    q_buf, q_sizes) -> torch.Tensor:
    """f32[m, Gq] pruned score matrix, every stage on the columns' device
    (``dpost`` a :class:`repro_torch.core.arena.DevicePostings`)."""
    m = x_values.shape[0]
    gq, cq = q_values.shape
    o1 = bitmap_o1(x_buf, q_buf)
    if gq * cq == 0 or dpost.first.numel() == 0:
        # K∩ ≡ 0: the score is the o1 base everywhere (D̂∩ = 0).
        return o1.to(torch.float32) \
            / q_sizes.to(torch.float32).clamp_min(1.0)[None, :]
    pos, hit, cum = probe_tasks(dpost.keys, q_values.reshape(-1),
                                dpost.row_blocks)
    kcap = block_decode(pos, hit, dpost.row_blocks, dpost.first, dpost.meta,
                        dpost.off, dpost.payload, gq=gq, cq=cq, m=m, cum=cum)
    return estimate_scores(kcap, o1, x_values, x_thresh, q_values, q_thresh,
                           q_sizes)


def pack_hit_words(s: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """u32[ceil(m/32), Gq] packed hit words (int32 bits): bit ``i & 31`` of
    word ``i >> 5`` is (s[i, g] ≥ thresholds[g])."""
    m, gq = s.shape
    mw = max(-(-m // 32), 1)
    hits = torch.zeros((mw * 32, gq), dtype=torch.int64, device=s.device)
    hits[:m] = s >= thresholds[None, :]
    weights = torch.ones(32, dtype=torch.int64, device=s.device) \
        << torch.arange(32, device=s.device)
    return as_bits((hits.view(mw, 32, gq) * weights[None, :, None]).sum(1))
