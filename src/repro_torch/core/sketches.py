"""Packed, fixed-capacity sketch containers (port of ``repro.core.sketches``).

The whole index is a structure of arrays:

    values  u32[m, C]   sorted ascending, PAD-filled
    lengths i32[m]      number of live hash values per row
    thresh  u32[m]      per-record effective threshold: the global τ, or the
                        C-th smallest hash for rows that overflowed capacity C
    buf     u32[m, W]   GB-KMV bitmap buffer (W = ceil(r / 32) words)
    sizes   i32[m]      true |X| (record cardinalities)

Here every column is a ``torch.int32`` tensor; the u32 columns hold the
u32 bit pattern (see :mod:`repro_torch.core.hashing`). Host construction
(record ingest, bitmaps, the numpy pack) stays numpy and hands its result
over as CPU tensors; :meth:`PackedSketches.to` places a pack on a device.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.hashing import to_tensor


@dataclasses.dataclass
class RaggedBatch:
    """A record batch ingested once into CSR form (flat ids + offsets).

    ``ids`` is record-major: record i owns ``ids[offsets[i]:offsets[i+1]]``.
    """

    ids: np.ndarray       # int64[N] flat element ids, record-major
    offsets: np.ndarray   # int64[m+1] row starts (offsets[-1] == N)

    @classmethod
    def from_records(cls, records: Sequence[np.ndarray]) -> "RaggedBatch":
        try:
            sizes = np.fromiter((len(r) for r in records), np.int64,
                                count=len(records))
            ids = (np.concatenate(records).astype(np.int64, copy=False)
                   if len(records) and sizes.sum() else np.zeros(0, np.int64))
            if ids.ndim != 1:
                raise ValueError
        except (ValueError, TypeError):
            arrs = [np.asarray(r, dtype=np.int64).reshape(-1)
                    for r in records]
            sizes = np.asarray([len(a) for a in arrs], dtype=np.int64)
            ids = (np.concatenate(arrs) if arrs else np.zeros(0, np.int64))
        offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        return cls(ids=ids, offsets=offsets)

    @property
    def num_records(self) -> int:
        return len(self.offsets) - 1

    @property
    def total(self) -> int:
        return int(self.offsets[-1])

    @property
    def sizes(self) -> np.ndarray:
        return np.diff(self.offsets).astype(np.int32)

    def row_index(self) -> np.ndarray:
        """int64[N]: the record id owning each flat position."""
        return np.repeat(np.arange(self.num_records, dtype=np.int64),
                         np.diff(self.offsets))


@dataclasses.dataclass
class PackedSketches:
    """A packed GB-KMV index (or a query batch): int32 tensors on one device."""

    values: torch.Tensor   # u32 bits [m, C]
    lengths: torch.Tensor  # i32 [m]
    thresh: torch.Tensor   # u32 bits [m]
    buf: torch.Tensor      # u32 bits [m, W] (W may be 0)
    sizes: torch.Tensor    # i32 [m]

    @classmethod
    def from_numpy(cls, values, lengths, thresh, buf, sizes) -> "PackedSketches":
        """CPU tensors over numpy columns (u32 columns viewed as int32)."""
        return cls(values=to_tensor(values),
                   lengths=torch.from_numpy(np.asarray(lengths, np.int32)),
                   thresh=to_tensor(thresh), buf=to_tensor(buf),
                   sizes=torch.from_numpy(np.asarray(sizes, np.int32)))

    @property
    def num_records(self) -> int:
        return self.values.shape[0]

    @property
    def capacity(self) -> int:
        return self.values.shape[1]

    @property
    def buf_words(self) -> int:
        return self.buf.shape[1]

    @property
    def device(self) -> torch.device:
        return self.values.device

    def columns(self) -> tuple[torch.Tensor, ...]:
        return (self.values, self.lengths, self.thresh, self.buf, self.sizes)

    def to(self, device) -> "PackedSketches":
        return PackedSketches(*(c.to(device) for c in self.columns()))

    def nbytes(self) -> int:
        return sum(c.numel() * c.element_size() for c in self.columns())


def _resolve_capacity(max_len: int, capacity: int | None,
                      pad_to_multiple: int) -> int:
    """The shared pack width rule: requested capacity (or the longest
    row), floored at 1, rounded up to ``pad_to_multiple``."""
    cap = capacity if capacity is not None else max_len
    cap = max(cap, 1)
    return -(-cap // pad_to_multiple) * pad_to_multiple


def pack_csr(
    hashes: np.ndarray,
    row: np.ndarray,
    m: int,
    thresholds: np.ndarray,
    sizes: np.ndarray,
    bitmaps: np.ndarray | None = None,
    capacity: int | None = None,
    pad_to_multiple: int = 8,
) -> PackedSketches:
    """Pack a flat (hash, row) list into a :class:`PackedSketches` (CPU).

    One u64 key sort orders the batch (row asc, hash asc) and one scatter
    writes the value matrix. Rows longer than the capacity keep their
    smallest values and lower their effective threshold to the largest
    kept value.
    """
    hashes = np.asarray(hashes, dtype=np.uint32)
    row = np.asarray(row, dtype=np.int64)
    key = np.sort((row.astype(np.uint64) << np.uint64(32))
                  | hashes.astype(np.uint64))
    hashes = (key & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    row = (key >> np.uint64(32)).astype(np.int64)

    counts = np.bincount(row, minlength=m).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)])
    cap = _resolve_capacity(int(counts.max()) if m else 0, capacity,
                            pad_to_multiple)

    thr = np.asarray(thresholds, dtype=np.uint32).copy()
    over = counts > cap
    if over.any():
        thr[over] = hashes[starts[:-1][over] + cap - 1]

    pos = np.arange(len(hashes), dtype=np.int64) - starts[row]
    keep = pos < cap
    values = np.full((m, cap), 0xFFFFFFFF, dtype=np.uint32)
    values[row[keep], pos[keep]] = hashes[keep]
    lengths = np.minimum(counts, cap).astype(np.int32)

    if bitmaps is None:
        bitmaps = np.zeros((m, 0), dtype=np.uint32)
    return PackedSketches.from_numpy(values, lengths, thr, bitmaps, sizes)


def top_membership(ids: np.ndarray, top_elems: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
    """(is_top bool[N], bit j int64[N]) of flat ids vs the top-r set.

    ``bit[k]`` is only meaningful where ``is_top[k]``; bit j is the
    frequency-order position of the element in ``top_elems``.
    """
    ids = np.asarray(ids, dtype=np.int64)
    top = np.asarray(top_elems, dtype=np.int64)
    if len(top) == 0 or len(ids) == 0:
        return np.zeros(len(ids), bool), np.zeros(len(ids), np.int64)
    max_id = int(top.max())
    if 0 <= int(top.min()) and max_id < max(4 * len(ids), 1 << 22):
        # Dense-universe fast path: one gather per element.
        table = np.full(max_id + 2, -1, np.int64)
        table[top] = np.arange(len(top), dtype=np.int64)
        if int(ids.min()) >= 0 and int(ids.max()) <= max_id:
            bit = table[ids]
        else:
            safe = np.where((ids >= 0) & (ids <= max_id), ids, max_id + 1)
            bit = table[safe]
        return bit >= 0, bit
    sort_idx = np.argsort(top, kind="stable")
    sorted_top = top[sort_idx]
    pos = np.searchsorted(sorted_top, ids)
    ok = pos < len(top)
    is_top = np.zeros(len(ids), bool)
    is_top[ok] = sorted_top[pos[ok]] == ids[ok]
    bit = np.zeros(len(ids), np.int64)
    bit[is_top] = sort_idx[pos[is_top]]
    return is_top, bit


def make_bitmaps(records, top_elems: np.ndarray,
                 membership: tuple[np.ndarray, np.ndarray] | None = None
                 ) -> np.ndarray:
    """Per-record bitmap over the top-r frequent elements: uint32[m, W].

    Bit j (the element ``top_elems[j]``) lives in word ``j // 32`` at
    position ``j % 32``. Accepts a record list or a :class:`RaggedBatch`;
    ``membership`` passes a precomputed :func:`top_membership`.
    """
    batch = (records if isinstance(records, RaggedBatch)
             else RaggedBatch.from_records(records))
    r = len(top_elems)
    words = max(-(-r // 32), 1) if r else 0
    m = batch.num_records
    out = np.zeros((m, words), dtype=np.uint32)
    if r == 0 or batch.total == 0:
        return out
    is_top, bit = (membership if membership is not None
                   else top_membership(batch.ids, top_elems))
    rows = batch.row_index()[is_top]
    j = bit[is_top]
    # Bool scatter then one vectorized bit-pack, in row chunks so the
    # [chunk, words*32] bool matrix stays small. ``rows`` is ascending.
    shifts = (np.uint32(1) << np.arange(32, dtype=np.uint32))
    chunk = max(1, (1 << 22) // max(words * 32, 1))
    lo_idx = 0
    for lo in range(0, m, chunk):
        hi = min(lo + chunk, m)
        hi_idx = np.searchsorted(rows, hi, side="left")
        bits = np.zeros((hi - lo, words * 32), dtype=bool)
        bits[rows[lo_idx:hi_idx] - lo, j[lo_idx:hi_idx]] = True
        out[lo:hi] = (bits.reshape(hi - lo, words, 32)
                      * shifts[None, None, :]).sum(axis=2, dtype=np.uint32)
        lo_idx = hi_idx
    return out
