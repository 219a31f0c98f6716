"""Synthetic set-valued dataset generation (paper Table II / Fig. 16 / 19).

Records are element-id sets with:
  * element popularity ~ zipf(α1) over a universe of ``n_elems``
  * record size ~ truncated power-law(α2) on [size_min, size_max]
(paper §IV-C1 assumptions; Fig. 16 varies both z-values).

A numpy copy of ``repro.data.synth``: the same seed gives the same
records. The real datasets of Table II are stood in for by synthetics with
their published (α1, α2) statistics — see data/datasets.py.
"""

from __future__ import annotations

import numpy as np


def powerlaw_sizes(
    m: int, alpha: float, size_min: int, size_max: int, rng: np.random.Generator
) -> np.ndarray:
    """Record sizes ~ p(x) ∝ x^{-alpha} on [size_min, size_max] (inverse CDF)."""
    u = rng.random(m)
    if abs(alpha - 1.0) < 1e-9:
        s = size_min * (size_max / size_min) ** u
    elif alpha == 0.0:
        s = size_min + u * (size_max - size_min)
    else:
        a = 1.0 - alpha
        s = (size_min**a + u * (size_max**a - size_min**a)) ** (1.0 / a)
    return np.clip(s.astype(np.int64), size_min, size_max)


def zipf_element_sampler(n_elems: int, alpha: float, rng: np.random.Generator):
    """Sampler over element ids with zipf(alpha) popularity (alias-free:
    inverse-CDF on the normalized rank weights)."""
    ranks = np.arange(1, n_elems + 1, dtype=np.float64)
    w = ranks ** (-alpha) if alpha > 0 else np.ones(n_elems)
    cdf = np.cumsum(w / w.sum())

    def sample(k: int) -> np.ndarray:
        return np.searchsorted(cdf, rng.random(k), side="left")

    return sample


def generate_dataset(
    m: int,
    n_elems: int,
    alpha_freq: float,
    alpha_size: float,
    size_min: int = 10,
    size_max: int = 500,
    seed: int = 0,
) -> list[np.ndarray]:
    """m records of *distinct* element ids (sets), zipf-popular elements.

    Sampling with rejection-free trick: draw 2× the target size, unique,
    then top up uniformly if dedup undershot (rare for big universes).
    """
    rng = np.random.default_rng(seed)
    sizes = powerlaw_sizes(m, alpha_size, size_min, size_max, rng)
    sample = zipf_element_sampler(n_elems, alpha_freq, rng)
    records = []
    for s in sizes:
        draw = np.unique(sample(int(2.2 * s) + 4))
        if len(draw) < s:
            extra = rng.choice(n_elems, size=int(s) * 2, replace=False)
            draw = np.unique(np.concatenate([draw, extra]))
        rng.shuffle(draw)
        records.append(np.sort(draw[: int(s)]).astype(np.int64))
    return records


def make_query_workload(
    records: list[np.ndarray], n_queries: int, seed: int = 0
) -> list[np.ndarray]:
    """Queries randomly chosen from the records (paper §IV-C1 / §V-A)."""
    rng = np.random.default_rng(seed + 7919)
    idx = rng.integers(0, len(records), size=n_queries)
    return [records[i] for i in idx]
