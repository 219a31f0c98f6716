"""Sketch arena: the one owner of an index's packed columns and the
postings over them (port of ``repro.core.arena``).

An arena is a :class:`PackedSketches` whose columns live where they were
built — CPU tensors after a host build or a load, device tensors after the
fused device build — plus one cached mirror on the scoring device, placed
once and then resident, and the block-compressed postings of the planner
(host numpy, built lazily from the host columns). Device postings,
per-shard slices and merges arrive with their slices of the port.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.sketches import PackedSketches


@dataclasses.dataclass
class SketchArena(PackedSketches):
    """A :class:`PackedSketches` that owns its device mirror and postings.

    The caches live outside the dataclass fields, so
    ``dataclasses.replace`` resets them.
    """

    def __post_init__(self):
        self._dev_pack: PackedSketches | None = None
        self._post = None         # planner PostingsIndex | None

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
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
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
        return self._post

    def install_postings(self, post) -> None:
        self._post = post

    def clear_postings(self) -> None:
        self._post = None

    # -- space accounting --------------------------------------------------

    def sketch_nbytes(self) -> int:
        """The packed columns alone (the paper's space budget)."""
        return super().nbytes()

    def postings_nbytes(self) -> int:
        """At-rest bytes of the postings (built if absent)."""
        return self.postings().nbytes()

    def nbytes(self) -> int:
        """Columns plus every structure that exists: the postings and the
        device mirror of the columns."""
        total = super().nbytes()
        if self._post is not None:
            total += self._post.nbytes()
        if self._dev_pack is not None:
            total += self._dev_pack.nbytes()
        return total
