"""Fingerprint hashing and the u32 storage convention of the port.

The hash is the reference's (``repro.core.hashing``): element id →
``x + 0x9E3779B9·(seed+1)`` mod 2³², then the murmur3 fmix32 avalanche.

Torch has no usable unsigned 32-bit arithmetic on the CPU (no ``<=``,
``>>``, ``minimum`` or ``searchsorted`` for ``torch.uint32``), and a plain
int32 comparison sorts PAD (2³²−1, read as −1) first. So the port keeps
two spellings of a u32 value:

* **storage**: the u32 bit pattern in a ``torch.int32`` tensor — the same
  bytes as the reference's ``uint32`` arrays, so an npz round trip is a
  ``.view`` and a CUDA kernel reads the buffer as ``uint32_t*``;
* **arithmetic**: int64 in [0, 2³²) (:func:`as_u64`), where ordering and
  shifts are the unsigned ones.
"""

from __future__ import annotations

import numpy as np
import torch

# 2^32 as float — normalization constant of U_(k) = (v + 1) / 2^32.
TWO32 = 4294967296.0
# Padding sentinel for fixed-capacity sketch rows (max uint32 — sorts last).
PAD = np.uint32(0xFFFFFFFF)

_MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35


def seed_offset(seed: int) -> int:
    """The additive pre-mix constant ``0x9E3779B9·(seed+1)`` mod 2³²."""
    return (_GOLDEN * (int(seed) + 1)) & _MASK32


def as_u64(bits: torch.Tensor) -> torch.Tensor:
    """int32 u32-bit-pattern tensor → int64 in [0, 2³²)."""
    return bits.to(torch.int64) & _MASK32


def as_bits(u: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2³²) → int32 tensor holding the u32 bit pattern."""
    return (u - ((u >> 31) << 32)).to(torch.int32)


def to_tensor(a: np.ndarray) -> torch.Tensor:
    """A numpy uint32 array as an int32 bit-pattern CPU tensor (no copy
    when ``a`` is already a contiguous uint32 array)."""
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """An int32 bit-pattern tensor (any device) as a numpy uint32 array."""
    return t.detach().to("cpu").contiguous().numpy().view(np.uint32)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h · c) mod 2³² for int64 h in [0, 2³²): the product is split into
    16-bit halves so no intermediate leaves the int64 range."""
    lo = (h & 0xFFFF) * c
    hi = ((h >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def mix_u64(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on int64 values in [0, 2³²)."""
    h = x ^ (x >> 16)
    h = _mul32(h, _C1)
    h = h ^ (h >> 13)
    h = _mul32(h, _C2)
    return h ^ (h >> 16)


def hash_u32(ids: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Hash int element ids → fingerprints as int64 in [0, 2³²).

    Ids wrap mod 2³² first, as the reference's ``astype(uint32)`` does.
    Plain torch: runs on any device; the kernel's plain version.
    """
    x = (ids.to(torch.int64) & _MASK32) + seed_offset(seed)
    return mix_u64(x & _MASK32)


def hash_u32_np(ids, seed: int = 0) -> np.ndarray:
    """NumPy twin of :func:`hash_u32` (host-side pipelines)."""
    with np.errstate(over="ignore"):
        x = np.asarray(ids, dtype=np.uint64) & np.uint64(_MASK32)
        x = x.astype(np.uint32)
        x = x + np.uint32(seed_offset(seed))
        h = x
        h = h ^ (h >> np.uint32(16))
        h = (h.astype(np.uint64) * np.uint64(_C1)).astype(np.uint32)
        h = h ^ (h >> np.uint32(13))
        h = (h.astype(np.uint64) * np.uint64(_C2)).astype(np.uint32)
        h = h ^ (h >> np.uint32(16))
    return h
