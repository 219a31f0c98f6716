"""The B5 kernel's plain version and the ``score_pairs`` door against the
JAX reference's ``repro.kernels.gather_score.score_pairs``: its numpy
route and its Pallas kernel in interpret mode (as tests/test_planner.py
runs it). Tolerance 0: pair scores must be bitwise equal, since hits are
``score >= t``."""

import numpy as np
import pytest
import torch

from repro.core.sketches import PackedSketches as RefPack
from repro.kernels import gather_score as ref_gather
from repro_torch.core.hashing import PAD, to_tensor
from repro_torch.core.sketches import PackedSketches
from repro_torch.kernels import gather_score as gs_mod, ref


def _rows(rng, m, c, hi, repeats=False):
    """Sorted, PAD-filled rows drawn from [0, hi); with ``repeats`` a row
    may hold a value twice (a hash collision inside a record)."""
    values = np.full((m, c), PAD, np.uint32)
    for i, n in enumerate(rng.integers(0, c + 1, size=m)):
        v = rng.integers(0, hi, size=int(n), dtype=np.uint64).astype(np.uint32)
        v = np.sort(v) if repeats else np.unique(v)
        values[i, : len(v)] = v
    return values


def _columns(seed, m, c, gq, cq, wx, wq, hi=48, repeats=False):
    """Record and query columns (numpy) with edge rows appended to the
    records: an empty row, a k = 1 row, a threshold-0 row, a row with a
    repeated value, and the largest threshold below PAD."""
    rng = np.random.default_rng(seed)
    xv = _rows(rng, m, c, hi, repeats)
    qv = _rows(rng, gq, cq, hi, repeats)
    xt = rng.integers(0, hi + 8, size=m).astype(np.uint32)
    qt = rng.integers(0, hi + 8, size=gq).astype(np.uint32)
    edge = np.full((5, c), PAD, np.uint32)
    edge[1, :1] = qv[0, :1] if qv[0, 0] != PAD else [3]
    edge[2, :2] = [1, 2]
    edge[3, :3] = [4, 4, 9]
    edge[4, :2] = [2, 40]
    xv = np.concatenate([xv, edge])
    xt = np.concatenate([xt, np.asarray([50, 50, 0, 50, PAD - 1], np.uint32)])
    xb = rng.integers(0, 2**32, size=(m + 5, wx), dtype=np.uint64
                      ).astype(np.uint32)
    qb = rng.integers(0, 2**32, size=(gq, wq), dtype=np.uint64
                      ).astype(np.uint32)
    qs = rng.integers(0, 40, size=gq).astype(np.int32)
    qs[0] = 0                                          # a query of size 0
    lengths_x = (xv != PAD).sum(1).astype(np.int32)
    lengths_q = (qv != PAD).sum(1).astype(np.int32)
    sizes_x = np.maximum(lengths_x, 1).astype(np.int32)
    return (xv, lengths_x, xt, xb, sizes_x), (qv, lengths_q, qt, qb, qs)


def _pairs(seed, m, gq, p=64):
    """~p pairs: every edge row against every query, then random pairs."""
    rng = np.random.default_rng(seed + 100)
    edge_rec = np.repeat(np.arange(m - 5, m), gq)
    edge_q = np.tile(np.arange(gq), 5)
    n = max(p - len(edge_rec), 0)
    rec = np.concatenate([edge_rec, rng.integers(0, m, size=n)])
    q = np.concatenate([edge_q, rng.integers(0, gq, size=n)])
    return rec.astype(np.int32), q.astype(np.int32)


def _widen(cols, w):
    """Zero-pad a column tuple's buffer to w words (the reference's numpy
    route expects widths already aligned; its Pallas route aligns)."""
    v, n, t, b, s = cols
    wide = np.zeros((len(b), w), np.uint32)
    wide[:, : b.shape[1]] = b
    return v, n, t, wide, s


def _bits_equal(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


CASES = [
    # seed, m, c, gq, cq, wx, wq, repeats
    (0, 40, 8, 4, 8, 1, 1, False),      # W = 1
    (1, 60, 16, 3, 24, 2, 2, False),    # W > 1, query wider than records
    (2, 33, 16, 5, 8, 1, 3, False),     # record buffer narrower: aligned
    (3, 50, 8, 2, 16, 0, 0, False),     # no buffer words
    (4, 45, 16, 4, 16, 2, 1, True),     # repeated values in rows
]


@pytest.mark.parametrize("seed,m,c,gq,cq,wx,wq,repeats", CASES)
def test_plain_matches_reference_numpy_and_pallas(seed, m, c, gq, cq, wx, wq,
                                                  repeats):
    xcols, qcols = _columns(seed, m, c, gq, cq, wx, wq, repeats=repeats)
    rec, q = _pairs(seed, m + 5, gq)
    x_ref, q_ref = RefPack(*xcols), RefPack(*qcols)
    x, qp = PackedSketches.from_numpy(*xcols), PackedSketches.from_numpy(*qcols)

    got = gs_mod.score_pairs(x, qp, rec, q, backend="torch")
    w = max(wx, wq)
    _bits_equal(got, ref_gather.score_pairs(
        RefPack(*_widen(xcols, w)), RefPack(*_widen(qcols, w)), rec, q,
        backend="numpy"))
    _bits_equal(got, ref_gather.score_pairs(x_ref, q_ref, rec, q,
                                            backend="pallas", interpret=True))
    _bits_equal(gs_mod.score_pairs(x, qp, rec, q, backend="numpy"), got)


@pytest.mark.parametrize("seed", [0, 1])
def test_pair_scores_equal_dense_matrix_entries(seed):
    """B5's plain version gives each pair what B1's gives it in the full
    matrix: the two kernels share one per-pair math."""
    xcols, qcols = _columns(seed, 70, 16, 4, 16, 2, 2)
    x, qp = PackedSketches.from_numpy(*xcols), PackedSketches.from_numpy(*qcols)
    rec = np.repeat(np.arange(75), 4).astype(np.int32)
    q = np.tile(np.arange(4), 75).astype(np.int32)
    dense = ref.gbkmv_score_ref(x.values, x.thresh, x.buf, qp.values,
                                qp.thresh, qp.buf, qp.sizes)
    got = ref.gather_score_ref(x.values, x.thresh, x.buf, qp.values,
                               qp.thresh, qp.buf, qp.sizes,
                               torch.from_numpy(rec), torch.from_numpy(q))
    _bits_equal(got.numpy(), dense[rec.astype(np.int64), q].numpy())


def test_door_edges():
    xcols, qcols = _columns(7, 20, 8, 2, 8, 1, 1)
    x, qp = PackedSketches.from_numpy(*xcols), PackedSketches.from_numpy(*qcols)
    before = gs_mod.gather_score.launches
    for backend in ("torch", "numpy"):
        out = gs_mod.score_pairs(x, qp, [], [], backend=backend)
        assert out.shape == (0,) and out.dtype == np.float32
        with pytest.raises(IndexError):
            gs_mod.score_pairs(x, qp, [25], [0], backend=backend)
        with pytest.raises(IndexError):
            gs_mod.score_pairs(x, qp, [0], [2], backend=backend)
    with pytest.raises(ValueError):
        gs_mod.score_pairs(x, qp, [0, 1], [0], backend="torch")
    with pytest.raises(ValueError):
        gs_mod.score_pairs(x, qp, [0], [0], backend="cuda")
    # CPU tensors run the plain version: no launch is counted.
    assert gs_mod.gather_score.launches == before


def test_wrapper_checks_inputs():
    xcols, qcols = _columns(8, 10, 8, 2, 8, 1, 1)
    x, qp = PackedSketches.from_numpy(*xcols), PackedSketches.from_numpy(*qcols)
    cols = (x.values, x.thresh, x.buf, qp.values, qp.thresh, qp.buf, qp.sizes)
    rec = torch.zeros(3, dtype=torch.int32)
    out = gs_mod.gather_score(*cols, rec, rec)
    assert out.shape == (3,) and out.dtype == torch.float32
    with pytest.raises(ValueError):
        gs_mod.gather_score(*cols, rec.long(), rec)
    with pytest.raises(ValueError):
        gs_mod.gather_score(*cols, rec, rec[:2])
    with pytest.raises(ValueError):              # unaligned buffer widths
        gs_mod.gather_score(*cols[:5], to_tensor(np.zeros((2, 2), np.uint32)),
                            cols[6], rec, rec)
