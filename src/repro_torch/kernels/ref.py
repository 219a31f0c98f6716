"""Plain PyTorch versions of the CUDA kernels (port of ``repro.kernels.ref``).

They are the semantics of record: on CPU tensors the kernel wrappers run
them, the CPU tests hold them against the JAX reference, and on the card
``chip_smoke.py`` holds each kernel against them on the same inputs.
"""

from __future__ import annotations

import torch

from repro_torch.core.estimators import (buffer_intersection,
                                         gkmv_pair_estimate, popcount)
from repro_torch.core.hashing import PAD, TWO32, as_u64, hash_u32
from repro_torch.planner.postings import BLOCK, DENSE_MAX_WORDS

# Bound on the [rows, C, Cq] equality intermediate of one chunk.
_CHUNK_ELEMS = 1 << 26

# Slack the reference pads the payload with, so a decode's word reads
# (clipped to the end) see zeros past the last body.
DECODE_WINDOW = 128


def gbkmv_score_ref(x_values, x_thresh, x_buf,
                    q_values, q_thresh, q_buf, q_sizes) -> torch.Tensor:
    """Containment scores f32[M, Gq] for every (record, query) pair.

    Shapes: x_values u32[M, C], x_thresh u32[M], x_buf u32[M, W],
    q_values u32[Gq, Cq], q_thresh u32[Gq], q_buf u32[Gq, W],
    q_sizes i32[Gq] (u32 columns as int32 bit patterns). Records are
    scored in chunks so the equality intermediate stays bounded.
    """
    m, c = x_values.shape
    gq, cq = q_values.shape
    out = torch.empty((m, gq), dtype=torch.float32, device=x_values.device)
    # A [1]-shaped divisor per query: a tensor, never a Python scalar,
    # which CUDA would turn into a multiply by its reciprocal.
    qsf = q_sizes.to(torch.float32).clamp_min(1.0)
    rows = max(1, _CHUNK_ELEMS // max(c * cq, 1))
    for g in range(gq):
        for lo in range(0, m, rows):
            hi = min(m, lo + rows)
            d_hat, _, _ = gkmv_pair_estimate(
                q_values[g], None, q_thresh[g],
                x_values[lo:hi], None, x_thresh[lo:hi])
            o1 = buffer_intersection(q_buf[g], x_buf[lo:hi])
            out[lo:hi, g] = (o1.to(torch.float32) + d_hat) / qsf[g:g + 1]
    return out


def gather_score_ref(x_values, x_thresh, x_buf, q_values, q_thresh, q_buf,
                     q_sizes, cand_rec, cand_q) -> torch.Tensor:
    """Containment scores f32[P] of the candidate pairs
    (record ``cand_rec[p]``, query ``cand_q[p]``), in the operation order
    of the reference's ``_gather_score_jnp``.

    Column shapes as in :func:`gbkmv_score_ref` (equal buffer widths W);
    cand_rec, cand_q i32[P]. Pairs are scored in chunks so the
    [pairs, C, Cq] equality intermediate stays bounded.
    """
    p = cand_rec.shape[0]
    c, cq, w = x_values.shape[1], q_values.shape[1], x_buf.shape[1]
    out = torch.empty(p, dtype=torch.float32, device=x_values.device)
    step = max(1, _CHUNK_ELEMS // max(c * cq, 1))
    for lo in range(0, p, step):
        rec = cand_rec[lo:lo + step].long()
        qi = cand_q[lo:lo + step].long()
        xv, xt = as_u64(x_values[rec]), as_u64(x_thresh[rec])
        qv, qt = as_u64(q_values[qi]), as_u64(q_thresh[qi])

        tau = torch.minimum(xt, qt)
        nq = (qv <= tau[:, None]).sum(-1)
        live = xv <= tau[:, None]
        nx = live.sum(-1)
        member = (xv[:, :, None] == qv[:, None, :]).any(-1)
        kcap = (live & member).sum(-1)
        k = nq + nx - kcap

        def last_live(vals, n):
            v = vals.gather(1, (n - 1).clamp_min(0)[:, None])[:, 0]
            return torch.where(n > 0, v, torch.zeros_like(v))

        u = torch.maximum(last_live(qv, nq), last_live(xv, nx))
        u_unit = (u.to(torch.float32) + 1.0) / TWO32
        kf = k.to(torch.float32)
        cf = kcap.to(torch.float32)
        d_hat = torch.where(
            (k >= 2) & (kcap >= 1),
            (cf / k.clamp_min(1).to(torch.float32))
            * ((kf - 1.0) / u_unit.clamp_min(1e-30)),
            torch.where(kcap >= 1, cf, torch.zeros_like(cf)))
        if w:
            o1 = popcount(as_u64(x_buf[rec] & q_buf[qi])).sum(-1)
        else:
            o1 = torch.zeros_like(k)
        qsf = q_sizes[qi].to(torch.float32).clamp_min(1.0)
        out[lo:lo + step] = (o1.to(torch.float32) + d_hat) / qsf
    return out


def hash_threshold_ref(ids, seed: int, tau: int | None):
    """(hashes int64[N] in [0, 2³²), kept bool[N]): murmur-mix then the
    global-τ filter; ``kept`` is None when ``tau`` is None."""
    h = hash_u32(ids, seed=seed)
    return h, None if tau is None else h <= int(tau)


# ---------------------------------------------------------------------------
# Pruned pipeline: postings probe (B3), block decode and K∩ scatter (B4)
# ---------------------------------------------------------------------------


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 → int32 with two's-complement wrap (the reference's int32
    arithmetic)."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def postings_probe_ref(keys, q_flat) -> tuple[torch.Tensor, torch.Tensor]:
    """(pos i32[n], hit bool[n]) of each query hash against the sorted key
    column, as the reference's ``_probe_jnp``: pos = #keys < q, hit = q is
    a key and not PAD. ``keys`` u32[U], ``q_flat`` u32[n] (int32 bits)."""
    u = keys.shape[0]
    ku, qu = as_u64(keys), as_u64(q_flat)
    pos = torch.searchsorted(ku, qu).to(torch.int32)
    if u == 0:
        return pos, torch.zeros(q_flat.shape, dtype=torch.bool,
                                device=q_flat.device)
    safe = pos.clamp(0, u - 1).long()
    hit = (pos < u) & (ku[safe] == qu) & (qu != int(PAD))
    return pos, hit


def task_prefix_ref(pos, hit, row_blocks) -> torch.Tensor:
    """i32[n] inclusive prefix sum of the lanes' block counts, as the
    reference's ``_pipeline_scores`` forms ``cum`` after the probe:
    ``row_blocks[pos+1] − row_blocks[pos]`` for a lane that hit, else 0.
    ``row_blocks`` i32[U+1]; no keys give 0 everywhere."""
    u = row_blocks.numel() - 1
    if u == 0:
        return torch.zeros(pos.shape, dtype=torch.int32, device=pos.device)
    pos_c = pos.long().clamp(0, u - 1)
    nblk = torch.where(hit, row_blocks[pos_c + 1] - row_blocks[pos_c], 0)
    return torch.cumsum(nblk, 0, dtype=torch.int32)


def probe_tasks_ref(keys, q_flat, row_blocks
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(pos i32[n], hit bool[n], cum i32[n]): the probe
    (:func:`postings_probe_ref`) and then the block-task prefix
    (:func:`task_prefix_ref`), the function of the B3 kernel when it is
    given ``row_blocks``."""
    pos, hit = postings_probe_ref(keys, q_flat)
    return pos, hit, task_prefix_ref(pos, hit, row_blocks)


def decode_sparse_ref(first, off, bw, cnt, payload) -> torch.Tensor:
    """i32[tb, BLOCK] ids of sparse blocks, as ``_decode_sparse_jnp``:
    unpack the count-1 deltas of ``bw`` bits (two straddled words joined
    by shift-or), zero the lanes ≥ cnt−1, prefix-sum from ``first``.
    Lanes ≥ cnt carry garbage the caller masks. first/off/bw/cnt i32[tb];
    payload u32[P] (int32 bits), padded by the caller; reads clip to it."""
    pmax = payload.shape[0] - 1
    pay = as_u64(payload)
    p = torch.arange(BLOCK - 1, dtype=torch.int64,
                     device=first.device)[None, :]               # [1, 127]
    bitpos = p * bw.long()[:, None]
    w = off.long()[:, None] + (bitpos >> 5)
    w0 = pay[w.clamp(0, pmax)]
    w1 = pay[(w + 1).clamp(0, pmax)]
    sh = bitpos & 31
    lo = w0 >> sh
    hi = torch.where(sh > 0, (w1 << ((32 - sh) & 31)) & 0xFFFFFFFF, 0)
    bwl = bw.long()[:, None]
    mask = torch.where(bwl > 0, (1 << bwl) - 1, 0)
    v = (lo | hi) & mask
    v = torch.where(p < cnt.long()[:, None] - 1, v, 0)
    zeros = torch.zeros((first.shape[0], 1), dtype=torch.int64,
                        device=first.device)
    return _wrap32(first.long()[:, None]
                   + torch.cat([zeros, torch.cumsum(v, 1)], 1))


def decode_dense_ref(first, off, wcnt, payload, *, m: int) -> torch.Tensor:
    """i32[n, BLOCK] set-bit ids of dense-bitmap blocks, as
    ``_decode_dense_jnp``: the bits of the first ``wcnt`` body words in
    rank order; lanes past a block's population (or its 128th set bit)
    carry the sentinel ``m``."""
    n = first.shape[0]
    pmax = payload.shape[0] - 1
    dev = first.device
    win = torch.arange(DENSE_MAX_WORDS, dtype=torch.int64, device=dev)[None, :]
    words = as_u64(payload)[(off.long()[:, None] + win).clamp(0, pmax)]
    words = torch.where(win < wcnt.long()[:, None], words, 0)
    bits = ((words[:, :, None] >> torch.arange(32, device=dev)) & 1
            ).reshape(n, -1)                                     # [n, DW*32]
    rank = torch.cumsum(bits, 1)
    col = torch.where((bits == 1) & (rank <= BLOCK), rank - 1, BLOCK)
    j = torch.arange(DENSE_MAX_WORDS * 32, dtype=torch.int64, device=dev)
    vals = first.long()[:, None] + j[None, :]
    out = torch.full((n, BLOCK + 1), m, dtype=torch.int64, device=dev)
    out.scatter_(1, col, vals)       # every column < BLOCK is set once
    return out[:, :BLOCK].to(torch.int32)


def kcount_ref(pos, hit, row_blocks, first, meta, off, payload, *,
               gq: int, cq: int, m: int, cum=None) -> torch.Tensor:
    """i32[m, gq] K∩ counts: the block-task expand, both decode streams
    and the scatter of the reference's ``_pipeline_scores``, over all
    tasks at once (this plain version reads the task count on the host).

    Each hit lane (query hash ``lane`` of query ``lane // cq``) expands to
    its key's blocks; every decoded record id adds one to its
    (record, query) cell. ``pos``/``hit`` come from the probe; the block
    arrays are a :class:`DevicePostings`' (int32, u32 as bit patterns).
    ``cum``, the probe's block-task prefix (:func:`probe_tasks_ref`), gives
    the lanes' block counts as the B4 kernel reads them; without it they
    come from ``hit`` and ``row_blocks``.
    """
    dev = pos.device
    kflat = torch.zeros(m * gq, dtype=torch.int64, device=dev)
    u, nb = row_blocks.shape[0] - 1, first.shape[0]
    if pos.numel() == 0 or nb == 0:
        return kflat.view(m, gq).to(torch.int32)
    pos_c = pos.long().clamp(0, max(u - 1, 0))
    if cum is None:
        rs = torch.where(hit, row_blocks.long()[pos_c], 0)
        re = torch.where(hit, row_blocks.long()[pos_c + 1], 0)
        nblk = re - rs
        cum = torch.cumsum(nblk, 0)
    else:
        cum = cum.long()
        nblk = torch.diff(cum, prepend=cum.new_zeros(1))
        rs = torch.where(nblk > 0, row_blocks.long()[pos_c], 0)
    total = int(cum[-1])
    t = torch.arange(total, dtype=torch.int64, device=dev)
    lane = torch.searchsorted(cum, t, right=True)
    blk = rs[lane] + t - (cum[lane] - nblk[lane])
    task_q = lane // cq
    meta_u = as_u64(meta)[blk]
    t_first, t_off = first[blk], off[blk]
    t_cnt = (meta_u & 0x7F) + 1
    t_bw = (meta_u >> 8) & 0x1F
    dense = ((meta_u >> 13) & 1) == 1
    pay = torch.cat([payload, payload.new_zeros(DECODE_WINDOW)])

    lanes = torch.arange(BLOCK, device=dev)[None, :]
    ids = decode_sparse_ref(t_first, t_off, t_bw, t_cnt, pay).long()
    ids = torch.where((lanes < t_cnt[:, None]) & ~dense[:, None], ids, m)
    parts = [(ids, task_q)]
    if bool(dense.any()):
        d = torch.nonzero(dense)[:, 0]
        d_blk = blk[d]
        wcnt = off[(d_blk + 1).clamp_max(nb)] - off[d_blk]
        parts.append((decode_dense_ref(first[d_blk], off[d_blk], wcnt, pay,
                                       m=m).long(), task_q[d]))
    for ids, q in parts:
        ok = (ids >= 0) & (ids < m)
        lin = (ids * gq + q[:, None])[ok]
        kflat += torch.bincount(lin, minlength=m * gq)
    return kflat.view(m, gq).to(torch.int32)


def flash_attention_ref(q, k, v, *, scale: float | None = None
                        ) -> torch.Tensor:
    """Causal GQA attention, the B6 kernel's function: q [B,S,Hq,D], k/v
    [B,S,Hkv,D] -> [B,S,Hq,D] in q's dtype. Query head h attends with kv
    head h // G (G = Hq/Hkv); scores ``(q * scale) · k`` in f32 with
    ``scale = D**-0.5`` by default, keys above the query's position masked,
    an f32 softmax, and the f32 probabilities times f32 v."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    qg = (q.float() * scale).reshape(b, s, hkv, hq // hkv, d)
    scores = torch.einsum("bthgd,bshd->bhgts", qg, k.float())
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("bhgts,bshd->bthgd", p, v.float())
    return o.reshape(b, s, hq, d).to(q.dtype)
