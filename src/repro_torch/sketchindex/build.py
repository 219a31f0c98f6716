"""Global-τ selection by two-level histogram (port of
``repro.sketchindex.build.histogram_tau``).

A 4096-bin histogram of the top 12 hash bits finds the bin where the
budget is crossed; a second 4096-bin histogram of the next 12 bits inside
that bin narrows it. τ is that second bin's upper bound, so it lands
within 2⁸ hash values of the exact budget-th smallest hash.
"""

from __future__ import annotations

import torch

_LEVEL_BITS = 12
_BINS = 1 << _LEVEL_BITS


def _hist(idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """int64[BINS] counts by ``index_add_`` (``bincount`` would read its
    input's max back to the host on CUDA)."""
    return torch.zeros(_BINS, dtype=torch.int64,
                       device=idx.device).index_add_(0, idx, weight)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """int64[1]: index of the first True (0 when none), as ``jnp.argmax``."""
    return mask.to(torch.int32).argmax().view(1)


def histogram_tau(hashes: torch.Tensor, budget: int) -> torch.Tensor:
    """Two-level histogram τ over int64 hashes in [0, 2³²), on their device.

    Returns a 0-d int64 tensor: the upper bound of the 2⁸-wide bin holding
    the budget-th smallest hash. Nothing is read back to the host.
    """
    h = hashes.to(torch.int64)
    ones = torch.ones_like(h)
    s1 = 32 - _LEVEL_BITS
    hi = h >> s1
    c1 = _hist(hi, ones).cumsum(0)
    b1 = _first_true(c1 >= budget)

    s2 = 32 - 2 * _LEVEL_BITS
    h2 = _hist((h >> s2) & (_BINS - 1), (hi == b1).to(torch.int64))
    below1 = torch.where(b1 > 0, c1.index_select(0, (b1 - 1).clamp_min(0)), 0)
    b2 = _first_true(below1 + h2.cumsum(0) >= budget)
    return ((b1 << s1) | (b2 << s2) | ((1 << s2) - 1)).squeeze(0)
