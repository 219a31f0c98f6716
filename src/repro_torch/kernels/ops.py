"""Public wrappers around the kernels (port of ``repro.kernels.ops``).

They take natural shapes: buffer widths are aligned here, and a query
batch whose pack outgrows one block's shared memory is scored in parts.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import gbkmv_score as _score_mod
from repro_torch.kernels import hash_threshold as _hash_mod


def _widen(buf: torch.Tensor, w: int) -> torch.Tensor:
    if buf.shape[1] == w:
        return buf.contiguous()
    out = buf.new_zeros((buf.shape[0], w))
    out[:, : buf.shape[1]] = buf
    return out


def score_index(x_values, x_thresh, x_buf,
                q_values, q_thresh, q_buf, q_sizes) -> torch.Tensor:
    """Containment scores f32[M, Gq] of a query batch against the index
    (u32 columns as int32 bit patterns, all on one device)."""
    w = max(x_buf.shape[1], q_buf.shape[1])
    x = (x_values.contiguous(), x_thresh.contiguous(), _widen(x_buf, w))
    q = (q_values.contiguous(), q_thresh.contiguous(), _widen(q_buf, w),
         q_sizes.contiguous())
    gq, cq = q_values.shape
    step = _score_mod.queries_per_launch(x_values.device, gq, cq, w)
    if step >= gq:
        return _score_mod.gbkmv_score(*x, *q)
    parts = [_score_mod.gbkmv_score(*x, *(t[g:g + step] for t in q))
             for g in range(0, gq, step)]
    return torch.cat(parts, dim=1)


def hash_and_filter(ids, seed: int, tau) -> tuple[torch.Tensor, torch.Tensor]:
    """(hashes u32[N] as int32 bits, keep bool[N]) for a flat id stream
    given as u32 bit patterns."""
    h, keep = _hash_mod.hash_threshold(ids.contiguous(), seed, int(tau))
    return h, keep.to(torch.bool)
