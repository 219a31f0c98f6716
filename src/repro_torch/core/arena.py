"""Sketch arena: the one owner of an index's packed columns and the
postings over them (port of ``repro.core.arena``).

An arena is a :class:`PackedSketches` whose columns live where they were
built — CPU tensors after a host build or a load, device tensors after the
fused device build — plus one cached mirror on the scoring device, placed
once and then resident, the block-compressed postings of the planner
(host numpy, built lazily from the host columns), and a mirror of the
postings' tail store on the scoring device (:class:`DevicePostings`), which
the device pruned pipeline reads. Per-shard slices and merges arrive with
their slices of the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.hashing import to_tensor
from repro_torch.core.sketches import PackedSketches

_DENSE_KIND = 1 << 13     # meta bit of a dense-bitmap block


@dataclasses.dataclass
class DevicePostings:
    """The postings' TAIL store on one device, for the pruned pipeline.

    Only the hash-keyed tail blocks are mirrored: the pipeline takes the
    exact buffer intersections o1 from the packed bitmaps already resident
    in the device pack (the dense kernel's popcount), so the buffer posting
    lists never need a mirror. u32 columns are int32 bit patterns; offsets
    are int32 (payload words < 2³¹). The blocks' ``last`` ids stay on the
    host store: only the host planner's block skip reads them.
    """

    keys: torch.Tensor        # u32 bits [U]   distinct retained hashes, asc
    row_blocks: torch.Tensor  # i32 [U+1]      block range per key
    first: torch.Tensor       # i32 [NB]       min record id per block
    meta: torch.Tensor        # i32 [NB]       count-1 | bitwidth<<8 | kind<<13
    off: torch.Tensor         # i32 [NB+1]     payload word offsets
    payload: torch.Tensor     # u32 bits [P]   bitpacked block bodies
    num_records: int
    # Whether any block is dense-bitmap encoded: a property of the store.
    has_dense: bool

    @classmethod
    def from_postings(cls, post, device) -> "DevicePostings":
        """The tail store of a host :class:`PostingsIndex` on ``device``."""
        t = post.tail
        meta = np.asarray(t.meta, np.uint32)

        def put(a, dtype=np.int32):
            return torch.from_numpy(np.asarray(a, dtype)).to(device)

        return cls(keys=to_tensor(post.keys).to(device),
                   row_blocks=put(t.row_blocks), first=put(t.first),
                   meta=put(meta), off=put(t.off),
                   payload=to_tensor(t.payload).to(device),
                   num_records=post.num_records,
                   has_dense=bool(np.any(meta & _DENSE_KIND)))

    @property
    def device(self) -> torch.device:
        return self.keys.device

    def arrays(self) -> tuple[torch.Tensor, ...]:
        return (self.keys, self.row_blocks, self.first, self.meta, self.off,
                self.payload)

    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self.arrays())


@dataclasses.dataclass
class SketchArena(PackedSketches):
    """A :class:`PackedSketches` that owns its device mirror and postings.

    The caches live outside the dataclass fields, so
    ``dataclasses.replace`` resets them.
    """

    def __post_init__(self):
        self._dev_pack: PackedSketches | None = None
        self._post = None         # planner PostingsIndex | None
        self._dev_post: DevicePostings | None = None

    @classmethod
    def from_pack(cls, pack: PackedSketches) -> "SketchArena":
        if isinstance(pack, cls):
            return pack
        return cls(*pack.columns())

    def ensure_host(self) -> "SketchArena":
        """Pin device-built columns to CPU tensors in place (one transfer).
        The device originals become the cached device pack, so residency
        is kept. No-op for host columns."""
        if self.device.type != "cpu":
            if self._dev_pack is None:
                self._dev_pack = PackedSketches(*self.columns())
            (self.values, self.lengths, self.thresh, self.buf,
             self.sizes) = (c.cpu() for c in self.columns())
        return self

    def device_pack(self, device) -> PackedSketches:
        """The columns on ``device`` — adopted as they are when already
        there, else copied once and cached."""
        device = _resolve(device)
        if self.device == device:
            return self
        if self._dev_pack is None or self._dev_pack.device != device:
            self._dev_pack = self.to(device)
        return self._dev_pack

    # -- postings ----------------------------------------------------------

    def postings(self):
        """The block-compressed postings over these columns: built on
        first use from the host columns (device-built columns are pinned
        to the host once, :meth:`ensure_host`), then cached until
        installed or cleared."""
        if self._post is None or self._post.num_records != self.num_records:
            from repro_torch.planner.postings import build_postings
            self._post = build_postings(self.ensure_host())
            self._dev_post = None
        return self._post

    def install_postings(self, post) -> None:
        self._post = post
        self._dev_post = None

    def clear_postings(self) -> None:
        self._post = None
        self._dev_post = None

    def device_postings(self, device) -> DevicePostings:
        """The postings' tail store on ``device``: mirrored once from the
        host postings (built if absent), then resident."""
        device = _resolve(device)
        post = self.postings()
        if self._dev_post is None or self._dev_post.device != device:
            self._dev_post = DevicePostings.from_postings(post, device)
        return self._dev_post

    def adopt_device_postings(self, dev: DevicePostings) -> None:
        """Install a tail-store mirror made on the device (the device
        encode); the caller installs the host postings first."""
        self._dev_post = dev

    # -- space accounting --------------------------------------------------

    def sketch_nbytes(self) -> int:
        """The packed columns alone (the paper's space budget)."""
        return super().nbytes()

    def postings_nbytes(self) -> int:
        """At-rest bytes of the postings (built if absent)."""
        return self.postings().nbytes()

    def nbytes(self) -> int:
        """Columns plus every structure that exists: the postings and the
        device mirrors of the columns and of the postings' tail store."""
        total = super().nbytes()
        if self._post is not None:
            total += self._post.nbytes()
        if self._dev_pack is not None:
            total += self._dev_pack.nbytes()
        if self._dev_post is not None:
            total += self._dev_post.nbytes()
        return total


def _resolve(device) -> torch.device:
    """``device`` with a CUDA index filled in, so mirrors compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
