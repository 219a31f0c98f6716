"""Plain PyTorch versions of the CUDA kernels (port of ``repro.kernels.ref``).

They are the semantics of record: on CPU tensors the kernel wrappers run
them, the CPU tests hold them against the JAX reference, and on the card
``chip_smoke.py`` holds each kernel against them on the same inputs.
"""

from __future__ import annotations

import torch

from repro_torch.core.estimators import buffer_intersection, gkmv_pair_estimate
from repro_torch.core.hashing import hash_u32

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


def hash_threshold_ref(ids, seed: int, tau: int | None):
    """(hashes int64[N] in [0, 2³²), kept bool[N]): murmur-mix then the
    global-τ filter; ``kept`` is None when ``tau`` is None."""
    h = hash_u32(ids, seed=seed)
    return h, None if tau is None else h <= int(tau)
