"""Plain PyTorch versions of the CUDA kernels (port of ``repro.kernels.ref``).

They are the semantics of record: on CPU tensors the kernel wrappers run
them, the CPU tests hold them against the JAX reference, and on the card
``chip_smoke.py`` holds each kernel against them on the same inputs.
"""

from __future__ import annotations

import torch

from repro_torch.core.estimators import (buffer_intersection,
                                         gkmv_pair_estimate, popcount)
from repro_torch.core.hashing import TWO32, as_u64, hash_u32

# Bound on the [rows, C, Cq] equality intermediate of one chunk.
_CHUNK_ELEMS = 1 << 26


def gbkmv_score_ref(x_values, x_thresh, x_buf,
                    q_values, q_thresh, q_buf, q_sizes) -> torch.Tensor:
    """Containment scores f32[M, Gq] for every (record, query) pair.

    Shapes: x_values u32[M, C], x_thresh u32[M], x_buf u32[M, W],
    q_values u32[Gq, Cq], q_thresh u32[Gq], q_buf u32[Gq, W],
    q_sizes i32[Gq] (u32 columns as int32 bit patterns). Records are
    scored in chunks so the equality intermediate stays bounded.
    """
    m, c = x_values.shape
    gq, cq = q_values.shape
    out = torch.empty((m, gq), dtype=torch.float32, device=x_values.device)
    # A [1]-shaped divisor per query: a tensor, never a Python scalar,
    # which CUDA would turn into a multiply by its reciprocal.
    qsf = q_sizes.to(torch.float32).clamp_min(1.0)
    rows = max(1, _CHUNK_ELEMS // max(c * cq, 1))
    for g in range(gq):
        for lo in range(0, m, rows):
            hi = min(m, lo + rows)
            d_hat, _, _ = gkmv_pair_estimate(
                q_values[g], None, q_thresh[g],
                x_values[lo:hi], None, x_thresh[lo:hi])
            o1 = buffer_intersection(q_buf[g], x_buf[lo:hi])
            out[lo:hi, g] = (o1.to(torch.float32) + d_hat) / qsf[g:g + 1]
    return out


def gather_score_ref(x_values, x_thresh, x_buf, q_values, q_thresh, q_buf,
                     q_sizes, cand_rec, cand_q) -> torch.Tensor:
    """Containment scores f32[P] of the candidate pairs
    (record ``cand_rec[p]``, query ``cand_q[p]``), in the operation order
    of the reference's ``_gather_score_jnp``.

    Column shapes as in :func:`gbkmv_score_ref` (equal buffer widths W);
    cand_rec, cand_q i32[P]. Pairs are scored in chunks so the
    [pairs, C, Cq] equality intermediate stays bounded.
    """
    p = cand_rec.shape[0]
    c, cq, w = x_values.shape[1], q_values.shape[1], x_buf.shape[1]
    out = torch.empty(p, dtype=torch.float32, device=x_values.device)
    step = max(1, _CHUNK_ELEMS // max(c * cq, 1))
    for lo in range(0, p, step):
        rec = cand_rec[lo:lo + step].long()
        qi = cand_q[lo:lo + step].long()
        xv, xt = as_u64(x_values[rec]), as_u64(x_thresh[rec])
        qv, qt = as_u64(q_values[qi]), as_u64(q_thresh[qi])

        tau = torch.minimum(xt, qt)
        nq = (qv <= tau[:, None]).sum(-1)
        live = xv <= tau[:, None]
        nx = live.sum(-1)
        member = (xv[:, :, None] == qv[:, None, :]).any(-1)
        kcap = (live & member).sum(-1)
        k = nq + nx - kcap

        def last_live(vals, n):
            v = vals.gather(1, (n - 1).clamp_min(0)[:, None])[:, 0]
            return torch.where(n > 0, v, torch.zeros_like(v))

        u = torch.maximum(last_live(qv, nq), last_live(xv, nx))
        u_unit = (u.to(torch.float32) + 1.0) / TWO32
        kf = k.to(torch.float32)
        cf = kcap.to(torch.float32)
        d_hat = torch.where(
            (k >= 2) & (kcap >= 1),
            (cf / k.clamp_min(1).to(torch.float32))
            * ((kf - 1.0) / u_unit.clamp_min(1e-30)),
            torch.where(kcap >= 1, cf, torch.zeros_like(cf)))
        if w:
            o1 = popcount(as_u64(x_buf[rec] & q_buf[qi])).sum(-1)
        else:
            o1 = torch.zeros_like(k)
        qsf = q_sizes[qi].to(torch.float32).clamp_min(1.0)
        out[lo:lo + step] = (o1.to(torch.float32) + d_hat) / qsf
    return out


def hash_threshold_ref(ids, seed: int, tau: int | None):
    """(hashes int64[N] in [0, 2³²), kept bool[N]): murmur-mix then the
    global-τ filter; ``kept`` is None when ``tau`` is None."""
    h = hash_u32(ids, seed=seed)
    return h, None if tau is None else h <= int(tau)
