"""GB-KMV estimator math and the scoring door (port of
``repro.core.estimators``).

The torch functions here are the plain versions the kernels are held
against: they take u32-bit-pattern int32 tensors, widen to int64 at entry
(unsigned order), and repeat the reference's float32 operation order.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from repro_torch.core.hashing import PAD, TWO32, as_u64, to_numpy

BACKENDS = ("numpy", "torch")


def normalize_backend(backend: str) -> str:
    """``"torch"``: the hand kernel on CUDA tensors, its plain version on
    CPU tensors. ``"numpy"``: the host estimator."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    return backend


def popcount(v: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 values in [0, 2³²) (torch has none)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def gkmv_pair_estimate(q_values, q_length, q_thresh,
                       x_values, x_lengths, x_thresh):
    """G-KMV intersection estimator D̂∩ (Eq. 25) of one query row against
    m record rows under pairwise thresholds τ = min(thr_Q, thr_X).

    q_values u32[Cq], q_thresh u32 scalar, x_values u32[m, C],
    x_thresh u32[m] (int32 bit patterns; lengths are unused, as in the
    reference). Returns (d_hat f32[m], k i64[m], k_cap i64[m]).
    """
    del q_length, x_lengths
    qv = as_u64(q_values)
    xv = as_u64(x_values)
    tau = torch.minimum(as_u64(x_thresh), as_u64(q_thresh))       # [m]

    nq = (qv[None, :] <= tau[:, None]).sum(-1)
    live = xv <= tau[:, None]
    nx = live.sum(-1)
    # Both rows are sorted and duplicate-free, so the equality count of
    # live record values against the query row is the exact |L_Q ∩ L_X|.
    member = (xv[:, :, None] == qv[None, None, :]).any(-1)
    k_cap = (live & member).sum(-1)
    k = nq + nx - k_cap

    uq = torch.where(nq > 0, qv[(nq - 1).clamp_min(0)], 0)
    ux = torch.where(nx > 0, xv.gather(1, (nx - 1).clamp_min(0)[:, None])[:, 0], 0)
    u = torch.maximum(uq, ux)
    u_unit = (u.to(torch.float32) + 1.0) / TWO32

    kf = k.to(torch.float32)
    cf = k_cap.to(torch.float32)
    d_hat = torch.where(
        (k >= 2) & (k_cap >= 1),
        (cf / kf.clamp_min(1.0)) * ((kf - 1.0) / u_unit.clamp_min(1e-30)),
        torch.where(k_cap >= 1, cf, torch.zeros_like(cf)))
    return d_hat, k, k_cap


def kmv_pair_estimate(q_values, q_length, x_values, x_lengths):
    """Plain-KMV D̂∩ (Eq. 10) of one query row against m record rows, as
    torch ops on the rows' device (the reference's jnp program, op for op).

    q_values u32[Cq] and x_values u32[m, C] are each row's smallest hashes,
    sorted and PAD-filled (int32 bit patterns); q_length and x_lengths
    i32[m] their lengths. The pair's k is min(k_Q, k_X); U₍k₎ is the k-th
    smallest distinct value of the union and K∩ the values among those k
    that both rows hold. Returns (d_hat f32[m], k i32[m], k_cap i32[m]).
    """
    m = x_values.shape[0]
    cq = q_values.shape[0]
    x_lengths = x_lengths.to(torch.int32)
    k = torch.clamp_max(x_lengths, int(q_length))                # [m]
    # The distinct union of the two rows, sorted: concat, sort, dedup mask.
    # int64 carriers keep the u32 order (PAD sorts last).
    merged = torch.sort(torch.cat(
        [as_u64(q_values)[None, :].expand(m, cq), as_u64(x_values)],
        dim=-1), dim=-1).values                                  # [m, Cq+C]
    same = merged[:, 1:] == merged[:, :-1]
    edge = torch.zeros((m, 1), dtype=torch.bool, device=merged.device)
    dup = torch.cat([edge, same], dim=-1)
    distinct = ~dup & (merged != int(PAD))
    rank = torch.cumsum(distinct.to(torch.int32), dim=-1)        # 1-based
    in_topk = distinct & (rank <= k[:, None])
    # U₍k₎: the largest of the k smallest distinct values.
    u = torch.where(in_topk, merged, 0).amax(dim=-1)
    u_unit = (u.to(torch.float32) + 1.0) / TWO32
    # K∩ among the k smallest: a value both rows hold (a duplicate pair)
    # whose first occurrence is in the top k.
    next_dup = torch.cat([same, edge], dim=-1)
    kcap = (in_topk & next_dup).sum(-1).to(torch.int32)

    kf = k.to(torch.float32)
    cf = kcap.to(torch.float32)
    d_hat = torch.where(
        (k >= 2) & (kcap >= 1),
        (cf / k.clamp_min(1).to(torch.float32))
        * ((kf - 1.0) / u_unit.clamp_min(1e-30)),
        torch.where(kcap >= 1, cf, torch.zeros_like(cf)))
    return d_hat, k, kcap


def buffer_intersection(q_buf, x_buf) -> torch.Tensor:
    """|H_Q ∩ H_X| via AND + popcount: q_buf u32[W], x_buf u32[m, W] →
    int64[m]."""
    if x_buf.shape[-1] == 0:
        return torch.zeros(x_buf.shape[0], dtype=torch.int64,
                           device=x_buf.device)
    return popcount(as_u64(x_buf & q_buf[None, :])).sum(-1)


def _popcount_np(words: np.ndarray) -> np.ndarray:
    """Per-row popcount of uint32[..., W] (host path)."""
    if words.shape[-1] == 0:
        return np.zeros(words.shape[:-1], dtype=np.int32)
    bytes_ = np.ascontiguousarray(words).view(np.uint8)
    return np.unpackbits(bytes_, axis=-1).sum(axis=-1).astype(np.int32)


def gbkmv_containment_np(q_values, q_thresh, q_buf, q_size, x) -> np.ndarray:
    """Host estimator for one query row against every record of ``x``
    (an object with numpy ``values``/``thresh``/``buf`` columns).
    Float32 arithmetic in the reference's order."""
    qv = np.asarray(q_values, dtype=np.uint32)
    xv = np.asarray(x.values, dtype=np.uint32)
    xt = np.asarray(x.thresh, dtype=np.uint32)
    tau_pair = np.minimum(xt, np.uint32(q_thresh))

    nq = (qv[None, :] <= tau_pair[:, None]).sum(-1).astype(np.int32)
    nx = (xv <= tau_pair[:, None]).sum(-1).astype(np.int32)
    live = xv <= tau_pair[:, None]
    member = np.isin(xv, qv)
    k_cap = (live & member).sum(-1).astype(np.int32)
    k = nq + nx - k_cap

    m = xv.shape[0]
    uq = np.where(nq > 0, qv[np.maximum(nq - 1, 0)], np.uint32(0))
    ux = xv[np.arange(m), np.maximum(nx - 1, 0)]
    ux = np.where(nx > 0, ux, np.uint32(0))
    u = np.maximum(uq, ux)
    u_unit = (u.astype(np.float32) + np.float32(1.0)) / np.float32(TWO32)

    kf = k.astype(np.float32)
    cf = k_cap.astype(np.float32)
    valid = (k >= 2) & (k_cap >= 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        d_hat = np.where(
            valid,
            (cf / np.maximum(kf, np.float32(1.0)))
            * ((kf - np.float32(1.0)) / np.maximum(u_unit, np.float32(1e-30))),
            np.where(k_cap >= 1, cf, np.float32(0.0)),
        ).astype(np.float32)

    x_buf = np.asarray(x.buf)
    if x_buf.shape[-1]:
        o1 = _popcount_np(x_buf & np.asarray(q_buf, np.uint32)[None, :])
    else:
        o1 = np.zeros(m, dtype=np.int32)
    qs = np.float32(max(int(q_size), 1))
    return ((o1.astype(np.float32) + d_hat) / qs).astype(np.float32)


def _align_buf_widths(q, x):
    """Zero-pad the narrower bitmap so both packs share a buffer width."""
    wq, wx = q.buf.shape[1], x.buf.shape[1]
    if wq == wx:
        return q, x

    def widen(p, w):
        buf = torch.zeros((p.buf.shape[0], w), dtype=torch.int32,
                          device=p.buf.device)
        buf[:, : p.buf.shape[1]] = p.buf
        return dataclasses.replace(p, buf=buf)

    w = max(wq, wx)
    return (widen(q, w) if wq < w else q), (widen(x, w) if wx < w else x)


def containment_matrix(q, x, backend: str = "torch", *, as_numpy: bool = True):
    """Ĉ(Q→X) scores f32[m, Gq]: every query row of ``q`` against every
    record row of ``x`` (both :class:`PackedSketches`).

    ``"torch"`` scores on ``x``'s device (the B1 kernel on CUDA, its plain
    version on CPU); ``as_numpy=False`` keeps that result a tensor there.
    ``"numpy"`` runs the host estimator and returns numpy.
    """
    backend = normalize_backend(backend)
    q, x = _align_buf_widths(q, x)
    if backend == "numpy":
        xh = SimpleNamespace(values=to_numpy(x.values),
                             thresh=to_numpy(x.thresh), buf=to_numpy(x.buf))
        qv, qt, qb = to_numpy(q.values), to_numpy(q.thresh), to_numpy(q.buf)
        qs = q.sizes.cpu().numpy()
        cols = [gbkmv_containment_np(qv[g], qt[g], qb[g], qs[g], xh)
                for g in range(q.num_records)]
        return np.stack(cols, axis=-1) if cols else \
            np.zeros((x.num_records, 0), np.float32)
    from repro_torch.kernels.ops import score_index

    q = q.to(x.device)
    out = score_index(x.values, x.thresh, x.buf,
                      q.values, q.thresh, q.buf, q.sizes)
    return out.cpu().numpy() if as_numpy else out
