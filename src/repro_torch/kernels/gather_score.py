"""Ragged candidate verify: the B5 kernel's wrapper and the ``score_pairs``
door (port of ``repro.kernels.gather_score``).

After postings pruning, the work left is a ragged list of (record, query)
pairs, a few per query at selective thresholds, so the verify step is a
gather, not a sweep:

    cand_rec i32[P]   record row to score
    cand_q   i32[P]   query row it belongs to
    out      f32[P]   Ĉ(Q_{cand_q[p]} → X_{cand_rec[p]})

On CUDA tensors :func:`gather_score` launches ``csrc/gather_score.cu``
(a lane group per pair), whose float tail is the dense kernel's; on CPU
tensors it runs the plain version
:func:`repro_torch.kernels.ref.gather_score_ref`.

:func:`score_pairs` is the numpy door the host planner calls, and
:class:`PairScorer` the planner's ``score_fn`` over one index and one query
pack. On a card the door moves both index arrays up as one pinned blob in
one copy and fetches the scores into pinned memory.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.estimators import (_align_buf_widths, _popcount_np,
                                         normalize_backend)
from repro_torch.core.hashing import TWO32, to_numpy
from repro_torch.kernels import ref
from repro_torch.kernels.gbkmv_score import _check_inputs
from repro_torch.kernels.library import check, current_stream_ptr, library

def gather_score(x_values, x_thresh, x_buf, q_values, q_thresh, q_buf,
                 q_sizes, cand_rec, cand_q) -> torch.Tensor:
    """f32[P] containment scores of the candidate pairs.

    Columns as for :func:`repro_torch.kernels.gbkmv_score.gbkmv_score`
    (int32 u32 bit patterns, contiguous, one device, equal buffer widths);
    ``cand_rec``/``cand_q`` contiguous int32[P] on the same device, each
    index in range of its rows. P = 0 returns an empty tensor without a
    launch. Each launch adds one to ``gather_score.launches``.
    """
    _check_inputs(x_values, x_thresh, x_buf, q_values, q_thresh, q_buf,
                  q_sizes)
    dev = x_values.device
    for name, t in (("cand_rec", cand_rec), ("cand_q", cand_q)):
        if (t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous()
                or t.device != dev):
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor "
                             f"on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if cand_rec.shape != cand_q.shape:
        raise ValueError(f"cand_rec {tuple(cand_rec.shape)} and cand_q "
                         f"{tuple(cand_q.shape)} differ in length")
    if dev.type == "cpu":
        return ref.gather_score_ref(x_values, x_thresh, x_buf, q_values,
                                    q_thresh, q_buf, q_sizes, cand_rec,
                                    cand_q)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    p = cand_rec.shape[0]
    out = torch.empty(p, dtype=torch.float32, device=dev)
    if p:
        m, c = x_values.shape
        gq, cq = q_values.shape
        check(library().gather_score_launch(
            x_values.data_ptr(), x_thresh.data_ptr(), x_buf.data_ptr(), m, c,
            x_buf.shape[1], q_values.data_ptr(), q_thresh.data_ptr(),
            q_buf.data_ptr(), q_sizes.data_ptr(), gq, cq, cand_rec.data_ptr(),
            cand_q.data_ptr(), p, out.data_ptr(), dev.index,
            current_stream_ptr(dev.index)), "gather_score_launch")
        gather_score.launches += 1
    return out


gather_score.launches = 0


def _gather_score_np(x_values, x_thresh, x_buf, q_values, q_thresh, q_buf,
                     q_sizes, cand_rec, cand_q) -> np.ndarray:
    """Host twin (numpy uint32 columns, float32 arithmetic in the
    reference's order)."""
    xv = x_values[cand_rec].astype(np.uint32)
    xt = x_thresh[cand_rec].astype(np.uint32)
    xb = x_buf[cand_rec]
    qv = q_values[cand_q].astype(np.uint32)
    qt = q_thresh[cand_q].astype(np.uint32)
    qb = q_buf[cand_q]
    qs = q_sizes[cand_q]

    tau = np.minimum(xt, qt)
    nq = (qv <= tau[:, None]).sum(-1).astype(np.int32)
    nx = (xv <= tau[:, None]).sum(-1).astype(np.int32)
    live = xv <= tau[:, None]
    member = (xv[:, :, None] == qv[:, None, :]).any(-1)
    kcap = (live & member).sum(-1).astype(np.int32)
    k = nq + nx - kcap

    p = xv.shape[0]
    uq = qv[np.arange(p), np.maximum(nq - 1, 0)]
    uq = np.where(nq > 0, uq, np.uint32(0))
    ux = xv[np.arange(p), np.maximum(nx - 1, 0)]
    ux = np.where(nx > 0, ux, np.uint32(0))
    u = np.maximum(uq, ux)
    u_unit = (u.astype(np.float32) + np.float32(1.0)) / np.float32(TWO32)

    kf = k.astype(np.float32)
    cf = kcap.astype(np.float32)
    valid = (k >= 2) & (kcap >= 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        d_hat = np.where(
            valid,
            (cf / np.maximum(kf, np.float32(1.0)))
            * ((kf - np.float32(1.0)) / np.maximum(u_unit, np.float32(1e-30))),
            np.where(kcap >= 1, cf, np.float32(0.0)),
        ).astype(np.float32)

    if xb.shape[-1]:
        o1 = _popcount_np(xb & qb)
    else:
        o1 = np.zeros(p, dtype=np.int32)
    qsf = np.maximum(qs.astype(np.float32), np.float32(1.0))
    return ((o1.astype(np.float32) + d_hat) / qsf).astype(np.float32)


def stage_pairs(cand_rec: np.ndarray, cand_q: np.ndarray, device
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cand_rec, cand_q) int32 on the card ``device``: one pinned blob
    holding both, copied up in one transfer on the card's current stream
    (the stream the kernel then runs on)."""
    p = len(cand_rec)
    blob = torch.empty(2 * p, dtype=torch.int32, pin_memory=True)
    host = blob.numpy()
    host[:p] = cand_rec
    host[p:] = cand_q
    idx = blob.to(device, non_blocking=True)
    return idx[:p], idx[p:]


def fetch_scores(out: torch.Tensor) -> np.ndarray:
    """The scores on the host: one copy into pinned memory, which waits
    for the card's stream."""
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out)
    return host.numpy()


def score_pairs(x, q, cand_rec, cand_q, *, backend: str = "torch"
                ) -> np.ndarray:
    """f32[P] pair scores for a ragged candidate list (numpy out).

    ``x``/``q`` are :class:`PackedSketches` (record index / query batch);
    the narrower buffer is zero-padded to the wider, as the reference
    aligns them. ``cand_rec[p]`` indexes x rows, ``cand_q[p]`` q rows.
    ``"torch"`` scores on ``x``'s device (B5 on CUDA, through
    :func:`stage_pairs` and :func:`fetch_scores`; its plain version on
    CPU); ``"numpy"`` runs the host twin.
    """
    backend = normalize_backend(backend)
    cand_rec = np.asarray(cand_rec, dtype=np.int32)
    cand_q = np.asarray(cand_q, dtype=np.int32)
    p = len(cand_rec)
    if p == 0:
        return np.zeros(0, dtype=np.float32)
    if len(cand_q) != p:
        raise ValueError(f"cand_rec has {p} pairs, cand_q {len(cand_q)}")
    for name, idx, n in (("cand_rec", cand_rec, x.num_records),
                         ("cand_q", cand_q, q.num_records)):
        if idx.min() < 0 or idx.max() >= n:
            raise IndexError(f"{name} out of range [0, {n})")
    q, x = _align_buf_widths(q, x)
    if backend == "numpy":
        return _gather_score_np(
            to_numpy(x.values), to_numpy(x.thresh), to_numpy(x.buf),
            to_numpy(q.values), to_numpy(q.thresh), to_numpy(q.buf),
            q.sizes.cpu().numpy(), cand_rec, cand_q)
    q = q.to(x.device)
    cols = (x.values, x.thresh, x.buf, q.values, q.thresh, q.buf, q.sizes)
    if x.device.type != "cuda":
        return gather_score(*cols, torch.from_numpy(cand_rec),
                            torch.from_numpy(cand_q)).numpy()
    return fetch_scores(gather_score(*cols,
                                     *stage_pairs(cand_rec, cand_q, x.device)))


class PairScorer:
    """The planner's ``score_fn`` over one index pack ``x`` and one query
    pack ``q``: ``scorer(cand_rec, cand_q)`` is :func:`score_pairs` with the
    two packs aligned, and placed on ``x``'s device, once.

    ``prefetch`` is True when the scorer runs on a card: there
    ``planner.pruned_topk`` scores its bound-ordered list in a few growing
    prefixes, each one launch, rather than one launch per chunk; off the
    card it scores chunk by chunk (the host twin materialises [P, C, Cq]).
    """

    def __init__(self, x, q, *, backend: str = "torch"):
        self.backend = normalize_backend(backend)
        q, x = _align_buf_widths(q, x)
        self.x = x
        self.q = q.to(x.device) if self.backend == "torch" else q
        self.prefetch = self.backend == "torch" and x.device.type == "cuda"

    def __call__(self, cand_rec, cand_q) -> np.ndarray:
        return score_pairs(self.x, self.q, cand_rec, cand_q,
                           backend=self.backend)
