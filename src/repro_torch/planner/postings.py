"""Block-compressed inverted postings over the retained sketch hashes and
the buffer bits: the filter half of the planner's filter-and-verify route.

A host numpy copy of ``repro.planner.postings`` (build, encode, decode,
equality). A record X can share tail mass with a query only through hash
values both sketches retained, and buffer mass only through top-r bits
both have set, so postings over those two keyspaces enumerate every
record with a non-zero estimated intersection.

Layout of one keyspace (:class:`BlockStore`, all numpy):

    row_blocks int32[nrows+1]  CSR over blocks: row r owns blocks
                               row_blocks[r] : row_blocks[r+1]
    first      int32[NB]       min record id in the block
    last       int32[NB]       max record id in the block
    meta       uint32[NB]      (count-1) | bitwidth << 8 | kind << 13
    off        int64[NB+1]     payload word offsets per block
    payload    uint32[P]       bitpacked block bodies

A block covers up to ``BLOCK`` (128) consecutive entries of one row, in
one of two bodies chosen by encoded size:

    sparse (kind 0)   count-1 deltas ``id[i] - id[i-1]``, bitpacked at
                      the block's max-delta bitwidth
    dense  (kind 1)   a bitmap of ``last - first + 1`` bits; only when
                      strictly smaller than sparse and the ids strictly
                      ascend (a bitmap cannot hold the duplicate ids a
                      32-bit hash collision inside a record produces)

A :class:`PostingsIndex` is ``keys`` (distinct retained hashes, ascending)
plus a tail store (one row per key) and a buffer store (one row per buffer
bit). These arrays are what is stored and saved, in the reference's npz
keys, so postings cross between the two packages unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.hashing import to_numpy
from repro_torch.core.sketches import PackedSketches

BLOCK = 128          # max entries per block
_BW_SHIFT = 8        # meta bit layout: count-1 [0:7], bitwidth [8:13],
_KIND_SHIFT = 13     # kind [13]
_CNT_MASK = np.uint32(0x7F)
_BW_MASK = np.uint32(0x1F)
# Dense bodies never exceed this many words: sparse needs at most
# ceil(127·31/32) = 124 words, and dense is chosen only when strictly
# smaller, so a 124-word window always covers a dense body.
DENSE_MAX_WORDS = 124


@dataclasses.dataclass
class BlockStore:
    """One keyspace's block-compressed posting lists."""

    row_blocks: np.ndarray   # int32[nrows+1]
    first: np.ndarray        # int32[NB]
    last: np.ndarray         # int32[NB]
    meta: np.ndarray         # uint32[NB]
    off: np.ndarray          # int64[NB+1]
    payload: np.ndarray      # uint32[P]

    @property
    def num_rows(self) -> int:
        return len(self.row_blocks) - 1

    @property
    def num_blocks(self) -> int:
        return len(self.first)

    def counts(self) -> np.ndarray:
        """int64[NB] entries per block (from the packed meta)."""
        return ((self.meta & _CNT_MASK) + 1).astype(np.int64)

    def row_lengths(self) -> np.ndarray:
        """int64[nrows] entries per row (header arithmetic, no decode)."""
        ccum = np.concatenate([[0], np.cumsum(self.counts())])
        rb = self.row_blocks.astype(np.int64)
        return ccum[rb[1:]] - ccum[rb[:-1]]

    @property
    def nnz(self) -> int:
        return int(self.counts().sum())

    def nbytes(self) -> int:
        return sum(int(a.nbytes) for a in (
            self.row_blocks, self.first, self.last, self.meta,
            self.off, self.payload))


def _ragged_take(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenate ``[starts[i], starts[i]+lens[i])`` ranges (int64)."""
    lens = np.asarray(lens, np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    cum = np.cumsum(lens)
    out = np.arange(total, dtype=np.int64)
    seg = np.searchsorted(cum, out, side="right")
    return np.asarray(starts, np.int64)[seg] + out - (cum[seg] - lens[seg])


def _bitlen(x: np.ndarray) -> np.ndarray:
    """int32 bit lengths (0 for 0). Exact for values < 2**53."""
    x = np.asarray(x, np.int64)
    out = np.zeros(x.shape, np.int32)
    nz = x > 0
    if nz.any():
        out[nz] = (np.floor(np.log2(x[nz].astype(np.float64)))
                   .astype(np.int32) + 1)
    return out


def _empty_store(nrows: int) -> BlockStore:
    return BlockStore(
        row_blocks=np.zeros(nrows + 1, np.int32),
        first=np.zeros(0, np.int32), last=np.zeros(0, np.int32),
        meta=np.zeros(0, np.uint32), off=np.zeros(1, np.int64),
        payload=np.zeros(0, np.uint32))


def encode_store(offsets: np.ndarray, rec_ids: np.ndarray) -> BlockStore:
    """Encode a flat CSR (row pointers + sorted-per-row ids) into blocks."""
    offsets = np.asarray(offsets, np.int64)
    rec = np.asarray(rec_ids, np.int64)
    nrows = len(offsets) - 1
    lens = np.diff(offsets)
    nblk_row = -(-lens // BLOCK)
    row_blocks = np.concatenate([[0], np.cumsum(nblk_row)]).astype(np.int32)
    nb = int(row_blocks[-1])
    if nb == 0:
        return _empty_store(nrows)

    rowid = np.repeat(np.arange(nrows), nblk_row)
    within = np.arange(nb, dtype=np.int64) - row_blocks[rowid]
    bstart = offsets[rowid] + within * BLOCK
    bend = np.minimum(bstart + BLOCK, offsets[rowid + 1])
    cnt = (bend - bstart).astype(np.int64)
    first = rec[bstart].astype(np.int32)
    last = rec[bend - 1].astype(np.int32)

    # Deltas, zeroed at block starts (blocks tile the positions exactly,
    # so reduceat segments over ``bstart`` are the blocks).
    d = np.zeros(len(rec), np.int64)
    d[1:] = rec[1:] - rec[:-1]
    d[bstart] = 0
    md = np.maximum.reduceat(d, bstart)
    d_lo = d.copy()
    d_lo[bstart] = np.int64(2) ** 62
    mind = np.minimum.reduceat(d_lo, bstart)    # 2^62 for 1-entry blocks

    bw = _bitlen(md)
    span = last.astype(np.int64) - first + 1
    w_sparse = ((cnt - 1) * bw + 31) // 32
    w_dense = (span + 31) // 32
    dense = (mind >= 1) & (w_dense < w_sparse) & (w_dense <= DENSE_MAX_WORDS)
    words = np.where(dense, w_dense, w_sparse)
    off = np.concatenate([[0], np.cumsum(words)]).astype(np.int64)
    payload = np.zeros(int(off[-1]), np.uint32)

    blkof = np.repeat(np.arange(nb, dtype=np.int64), cnt)
    pos_in_blk = np.arange(len(rec), dtype=np.int64) - bstart[blkof]

    # Sparse bodies: bitpack the count-1 deltas at the block's width.
    sel = (pos_in_blk > 0) & ~dense[blkof] & (bw[blkof] > 0)
    if sel.any():
        b = blkof[sel]
        bitpos = (pos_in_blk[sel] - 1) * bw[b]
        word = off[b] + (bitpos >> 5)
        shift = (bitpos & 31).astype(np.uint64)
        val = d[sel].astype(np.uint64) << shift
        np.bitwise_or.at(payload, word, (val & 0xFFFFFFFF).astype(np.uint32))
        hi = (val >> np.uint64(32)).astype(np.uint32)
        spill = hi != 0
        np.bitwise_or.at(payload, word[spill] + 1, hi[spill])

    # Dense bodies: one bit per id over the block's span.
    seld = dense[blkof]
    if seld.any():
        b = blkof[seld]
        bit = rec[seld] - first[b]
        np.bitwise_or.at(payload, off[b] + (bit >> 5),
                         (np.uint32(1) << (bit & 31).astype(np.uint32)))

    meta = ((cnt - 1).astype(np.uint32)
            | (bw.astype(np.uint32) << np.uint32(_BW_SHIFT))
            | (dense.astype(np.uint32) << np.uint32(_KIND_SHIFT)))
    return BlockStore(row_blocks=row_blocks, first=first, last=last,
                      meta=meta, off=off, payload=payload)


def decode_blocks(store: BlockStore, blks: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray]:
    """(ids int32[total], counts int64[len(blks)]) for a block subset.

    ``blks`` may repeat a block: a duplicated query hash merges its list
    once per occurrence, so a repeated block decodes once per occurrence.
    Entries come back grouped in ``blks`` order, ascending in each block.
    """
    blks = np.asarray(blks, np.int64)
    if len(blks) == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int64)
    meta = store.meta[blks]
    cnt = ((meta & _CNT_MASK) + 1).astype(np.int64)
    bw = ((meta >> np.uint32(_BW_SHIFT)) & _BW_MASK).astype(np.int64)
    dense = (meta >> np.uint32(_KIND_SHIFT)) & np.uint32(1)
    first = store.first[blks].astype(np.int64)
    off = store.off[blks]
    pay = store.payload

    total = int(cnt.sum())
    estart = np.concatenate([[0], np.cumsum(cnt)])
    eblk = np.repeat(np.arange(len(blks), dtype=np.int64), cnt)
    erank = np.arange(total, dtype=np.int64) - estart[eblk]

    # Sparse: unpack the deltas, then a per-block prefix sum back to ids.
    dall = np.zeros(total, np.int64)
    read = (dense[eblk] == 0) & (erank >= 1) & (bw[eblk] > 0)
    if read.any():
        b = eblk[read]
        bitpos = (erank[read] - 1) * bw[b]
        w = off[b] + (bitpos >> 5)
        w0 = pay[w].astype(np.uint64)
        w1 = pay[np.minimum(w + 1, max(len(pay) - 1, 0))].astype(np.uint64)
        shift = (bitpos & 31).astype(np.uint64)
        mask = (np.uint64(1) << bw[b].astype(np.uint64)) - np.uint64(1)
        dall[read] = ((((w1 << np.uint64(32)) | w0) >> shift) & mask
                      ).astype(np.int64)
    cs = np.cumsum(dall)
    base = cs[estart[:-1]] - dall[estart[:-1]]
    ids = first[eblk] + (cs - base[eblk])

    # Dense: the set-bit positions of each bitmap are the ids.
    db = np.nonzero(dense)[0]
    if len(db):
        wcnt = (store.off[blks[db] + 1] - off[db]).astype(np.int64)
        widx = _ragged_take(off[db], wcnt)
        bits = ((pay[widx][:, None] >> np.arange(32, dtype=np.uint32))
                & np.uint32(1)).astype(bool)
        wrow, bpos = np.nonzero(bits)        # word order == block order
        wblk = np.repeat(np.arange(len(db)), wcnt)[wrow]
        dense_ids = (first[db[wblk]]
                     + (widx[wrow] - off[db[wblk]]) * 32 + bpos)
        ids[_ragged_take(estart[db], cnt[db])] = dense_ids
    return ids.astype(np.int32), cnt


def decode_store(store: BlockStore) -> tuple[np.ndarray, np.ndarray]:
    """Full decode → flat CSR (offsets int64[nrows+1], ids int32)."""
    ids, _ = decode_blocks(store, np.arange(store.num_blocks))
    ccum = np.concatenate([[0], np.cumsum(store.counts())])
    return ccum[store.row_blocks.astype(np.int64)].astype(np.int64), ids


@dataclasses.dataclass
class PostingsIndex:
    """Block-compressed inverted postings over one index's sketches."""

    keys: np.ndarray          # uint32[U] distinct retained hashes, asc
    tail: BlockStore          # one row per key
    buf: BlockStore           # one row per buffer bit
    num_records: int
    tau: np.uint32            # largest retained key at build time

    def __post_init__(self):
        self._row_lens = None       # tail row_lengths cache (probe path)
        self._buf_row_lens = None   # buffer row_lengths cache (probe path)

    def nbytes(self) -> int:
        """At-rest bytes: keys and both block stores."""
        return int(self.keys.nbytes) + self.tail.nbytes() + self.buf.nbytes()

    def tail_row_lengths(self) -> np.ndarray:
        """int64[U] entries per key (header arithmetic, cached)."""
        if self._row_lens is None:
            self._row_lens = self.tail.row_lengths()
        return self._row_lens

    def buf_row_lengths(self) -> np.ndarray:
        """int64[R] entries per buffer bit (header arithmetic, cached)."""
        if self._buf_row_lens is None:
            self._buf_row_lens = self.buf.row_lengths()
        return self._buf_row_lens


def _bit_matrix(buf: np.ndarray) -> np.ndarray:
    """bool[m, W*32]: bit j of word j//32 at position j%32."""
    buf = np.asarray(buf, dtype=np.uint32)
    m, w = buf.shape
    if w == 0:
        return np.zeros((m, 0), dtype=bool)
    shifts = np.arange(32, dtype=np.uint32)
    bits = (buf[:, :, None] >> shifts[None, None, :]) & np.uint32(1)
    return bits.reshape(m, w * 32).astype(bool)


def _row_pairs(s: PackedSketches) -> tuple[np.ndarray, np.ndarray]:
    """Flat (hash, record) pairs over the packed values' live slots."""
    vals = to_numpy(s.values)
    lens = s.lengths.cpu().numpy()
    n, c = vals.shape
    live = np.arange(c)[None, :] < lens[:, None]
    h = vals[live]
    rec = np.broadcast_to(np.arange(n, dtype=np.int32)[:, None], (n, c))[live]
    return h.astype(np.uint32), rec


def _csr_from_pairs(h: np.ndarray, rec: np.ndarray):
    """Sort pairs by (hash, record) and group into (keys, offsets, rec_ids)."""
    order = np.lexsort((rec, h))
    h, rec = h[order], rec[order]
    keys, starts = np.unique(h, return_index=True)
    offsets = np.concatenate([starts, [len(h)]]).astype(np.int64)
    return keys, offsets, rec.astype(np.int32)


def _buf_csr(buf: np.ndarray):
    """(offsets int64[R+1], rec_ids int32) from a bitmap block."""
    bits = _bit_matrix(buf)
    _, r = bits.shape
    if r == 0:
        return np.zeros(1, dtype=np.int64), np.zeros(0, dtype=np.int32)
    bit_idx, recs = np.nonzero(bits.T)       # sorted by bit, then record
    counts = np.bincount(bit_idx, minlength=r)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return offsets, recs.astype(np.int32)


def from_flat(keys, offsets, rec_ids, buf_offsets, buf_rec_ids,
              num_records: int, tau) -> PostingsIndex:
    """Encode a flat CSR (what version-2 index files carry) into blocks."""
    return PostingsIndex(
        keys=np.asarray(keys, np.uint32),
        tail=encode_store(offsets, rec_ids),
        buf=encode_store(buf_offsets, buf_rec_ids),
        num_records=int(num_records), tau=np.uint32(tau))


def build_postings(sketches: PackedSketches) -> PostingsIndex:
    """Build hash + buffer postings from a packed index in one host pass
    (columns on any device; they are read back as numpy)."""
    m = sketches.num_records
    h, rec = _row_pairs(sketches)
    keys, offsets, rec_ids = _csr_from_pairs(h, rec)
    buf_offsets, buf_rec_ids = _buf_csr(to_numpy(sketches.buf))
    tau = keys[-1] if len(keys) else np.uint32(0)
    return from_flat(keys, offsets, rec_ids, buf_offsets, buf_rec_ids,
                     m, tau)


def build_postings_device(sketches: PackedSketches):
    """``(PostingsIndex, DevicePostings)`` with the tail store encoded where
    the columns live (:func:`repro_torch.kernels.hash_threshold.
    fused_encode_postings`), array-equal to :func:`build_postings`.

    For device-built columns the tail is bit-packed on the card and its
    mirror adopted as it is; the host :class:`PostingsIndex` is copied back
    once per build, for the host planner and for save. Buffer postings are
    encoded on the host as always: they never go to the device.
    """
    from repro_torch.core.arena import _DENSE_KIND, DevicePostings
    from repro_torch.kernels.hash_threshold import fused_encode_postings

    m = sketches.num_records
    dev = fused_encode_postings(sketches.values, sketches.lengths, m=m,
                                cap=sketches.capacity)
    keys = to_numpy(dev["keys"])
    meta = to_numpy(dev["meta"])
    tail = BlockStore(
        row_blocks=dev["row_blocks"].cpu().numpy(),
        first=dev["first"].cpu().numpy(), last=dev.pop("last").cpu().numpy(),
        meta=meta, off=dev["off"].cpu().numpy().astype(np.int64),
        payload=to_numpy(dev["payload"]))
    buf_offsets, buf_rec_ids = _buf_csr(to_numpy(sketches.buf))
    post = PostingsIndex(
        keys=keys, tail=tail, buf=encode_store(buf_offsets, buf_rec_ids),
        num_records=m, tau=keys[-1] if len(keys) else np.uint32(0))
    dpost = DevicePostings(**dev, num_records=m,
                           has_dense=bool(np.any(meta & _DENSE_KIND)))
    return post, dpost


def _stores_equal(a: BlockStore, b: BlockStore) -> bool:
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("row_blocks", "first", "last", "meta", "off",
                         "payload"))


def postings_equal(a: PostingsIndex, b: PostingsIndex) -> bool:
    """Structural equality, on the blocked arrays: segmentation and each
    block's encoding must match, not only the decoded ids."""
    return (a.num_records == b.num_records
            and np.array_equal(a.keys, b.keys)
            and _stores_equal(a.tail, b.tail)
            and _stores_equal(a.buf, b.buf))
