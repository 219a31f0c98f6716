"""Threshold cut of a dense score matrix (port of the dense-path half of
``repro.planner.prune``): compare where the scores live, fetch only the
bool mask, then pack every query's hit ids in one host pass."""

from __future__ import annotations

import numpy as np
import torch


def f32_threshold(t) -> np.ndarray:
    """Smallest float32 ≥ t (scalar or vector).

    A float32 score s satisfies ``s >= t`` under float64 comparison iff
    ``s >= f32_threshold(t)`` under float32 comparison, so a device-side
    compare stays bit-compatible with ``np.nonzero(s >= t)``.
    """
    t64 = np.asarray(t, dtype=np.float64)
    f = t64.astype(np.float32)
    return np.where(f.astype(np.float64) < t64,
                    np.nextafter(f, np.float32(np.inf)), f)


def mask_to_hits(mask: np.ndarray) -> list[np.ndarray]:
    """bool[m, Gq] hit mask → per-query sorted int64 id arrays."""
    mask = np.asarray(mask)
    if mask.ndim != 2:
        raise ValueError(f"expected [m, Gq] mask, got {mask.shape}")
    _, rec_idx = np.nonzero(mask.T)
    counts = mask.sum(axis=0)
    return np.split(rec_idx.astype(np.int64), np.cumsum(counts)[:-1])


def threshold_hits_packed(scores, thresholds) -> list[np.ndarray]:
    """Per-query hit ids from a score matrix f32[m, Gq] (numpy or a tensor
    on any device); ``thresholds`` is scalar or per-query. For a tensor the
    ≥ runs on its device and only the bool mask crosses to the host."""
    thr = f32_threshold(thresholds)
    if isinstance(scores, np.ndarray):
        mask = scores >= (thr if thr.ndim == 0 else thr[None, :])
    else:
        t = torch.as_tensor(np.atleast_1d(thr), dtype=torch.float32,
                            device=scores.device)
        mask = (scores >= t[None, :]).cpu().numpy()
    return mask_to_hits(mask)
