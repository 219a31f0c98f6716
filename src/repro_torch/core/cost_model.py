"""GB-KMV cost models, host numpy (a copy of ``repro.core.cost_model``).

Build side: the empirical variance functional Var_GBKMV(r) of paper
§IV-C6 and its grid minimization. Query side: the planner's relative
costs of the dense sweep and the postings-pruned verify, the
reference's default constants, so both packages route a batch alike.
"""

from __future__ import annotations

import numpy as np


def pair_variance(d_cap: np.ndarray, d_cup: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Var[D̂∩] — paper Eq. 11, vectorized.

    k <= 2 leaves Eq. 11 undefined; the error of a degenerate tail is
    bounded by missing the tail intersection entirely, so D∩² is charged.
    """
    d_cap = np.asarray(d_cap, dtype=np.float64)
    d_cup = np.asarray(d_cup, dtype=np.float64)
    k = np.asarray(k, dtype=np.float64)
    num = d_cap * (k * d_cup - k * k - d_cup + k + d_cap)
    den = k * (k - 2.0)
    out = np.where(den > 0, num / np.maximum(den, 1e-12), np.square(d_cap))
    return np.maximum(out, 0.0)


def _stats_for_r(freqs: np.ndarray, r: int):
    """(f_r, f_n2 - f_r2) for buffer size r over sorted-descending freqs."""
    n_total = float(freqs.sum())
    if n_total <= 0:
        return 0.0, 0.0
    fr = float(freqs[:r].sum()) / n_total
    fn2 = float((freqs.astype(np.float64) ** 2).sum()) / n_total**2
    fr2 = float((freqs[:r].astype(np.float64) ** 2).sum()) / n_total**2
    return fr, fn2 - fr2


def gbkmv_variance(
    freqs: np.ndarray,
    sizes: np.ndarray,
    budget: int,
    m: int,
    r: int,
    rng: np.random.Generator | None = None,
    n_pairs: int = 4096,
) -> float:
    """Average Var[Ĉ_GBKMV] over random (query, record) pairs at buffer r."""
    freqs = np.sort(np.asarray(freqs, dtype=np.float64))[::-1]
    sizes = np.asarray(sizes, dtype=np.float64)
    n_total = float(freqs.sum())
    words = -(-r // 32) if r else 0
    t2 = float(budget - m * words)
    if t2 <= 0:
        return np.inf
    fr, tail_fn2 = _stats_for_r(freqs, r)
    n_tail = n_total * (1.0 - fr)
    if n_tail <= 0:
        return 0.0  # everything buffered — exact answers
    tau = min(t2 / n_tail, 1.0)

    rng = rng or np.random.default_rng(0)
    j = rng.integers(0, len(sizes), size=n_pairs)
    l = rng.integers(0, len(sizes), size=n_pairs)
    xj, xl = sizes[j], sizes[l]

    d_cap = xj * xl * tail_fn2
    tail_j = xj * (1.0 - fr)
    tail_l = xl * (1.0 - fr)
    d_cup = np.maximum(tail_j + tail_l - d_cap, 1.0)
    k = tau * (tail_j + tail_l) - tau**2 * xj * xl * tail_fn2
    k = np.maximum(k, 0.0)

    var = pair_variance(d_cap, d_cup, k) / np.maximum(xj, 1.0) ** 2
    return float(var.mean())


def choose_buffer_size(
    freqs: np.ndarray,
    sizes: np.ndarray,
    budget: int,
    m: int,
    grid_step: int = 8,
    max_r: int | None = None,
    rng: np.random.Generator | None = None,
) -> int:
    """Numerical minimization of the §IV-C6 variance on the r-grid
    {0, 8, 16, ...}, bounded by the number of distinct elements and by
    half the budget."""
    freqs = np.sort(np.asarray(freqs, dtype=np.float64))[::-1]
    n_distinct = len(freqs)
    cap = max_r if max_r is not None else n_distinct
    cap = min(cap, n_distinct, int(32 * (budget / 2) / max(m, 1)))
    best_r, best_v = 0, gbkmv_variance(freqs, sizes, budget, m, 0, rng=rng)
    r = grid_step
    while r <= cap:
        v = gbkmv_variance(freqs, sizes, budget, m, r, rng=rng)
        if v < best_v:
            best_r, best_v = r, v
        r += grid_step
    return best_r


# ---------------------------------------------------------------------------
# Query-path cost model (planner): dense sweep vs postings-pruned verify.
#
# Relative units: one unit is one (record-slot × query) pair of the dense
# sweep. The constants only rank the two paths; none is fitted to the
# port's own costs yet.
# ---------------------------------------------------------------------------

DENSE_COST_PER_SLOT = 1.0       # one record-slot scored for one query
PRUNE_COST_PER_HIT = 6.0        # one posting entry decoded + merged on host
PRUNE_COST_PER_CAND_SLOT = 3.0  # one gather-scored candidate slot
PRUNE_FIXED_PER_QUERY = 2048.0  # postings probe + ragged dispatch
PRUNE_COST_PER_BLOCK = 12.0     # block header check + decode setup


def dense_sweep_cost(m: int, capacity: int, gq: int) -> float:
    """Cost of scoring the full [m, Gq] matrix (one index sweep)."""
    return (DENSE_COST_PER_SLOT * float(m) * float(max(capacity, 1))
            * max(gq, 1))


def pruned_path_cost(hits: int, capacity: int, gq: int,
                     blocks: int = 0) -> float:
    """Cost of block decode + merge + ragged verify: ``hits`` posting
    entries touched by the batch (a bound on the candidates) in
    ``blocks`` compressed blocks."""
    return (PRUNE_FIXED_PER_QUERY * max(gq, 1)
            + PRUNE_COST_PER_HIT * float(hits)
            + PRUNE_COST_PER_BLOCK * float(blocks)
            + PRUNE_COST_PER_CAND_SLOT * float(hits) * float(max(capacity, 1)))
