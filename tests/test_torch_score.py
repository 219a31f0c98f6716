"""The B1 kernel's plain version and the port's scoring door against the JAX
reference: the Pallas kernel in interpret mode (as tests/test_kernels.py
runs it) and the reference's numpy estimator. Tolerance 0: the f32 score
matrices must be bitwise equal, since hits are ``score >= t``."""

import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis", reason="property fuzzing needs hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import estimators as ref_est  # noqa: E402
from repro.core.sketches import PackedSketches as RefPack  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.core import estimators  # noqa: E402
from repro_torch.core.hashing import PAD, to_tensor  # noqa: E402
from repro_torch.core.sketches import PackedSketches  # noqa: E402
from repro_torch.kernels import gbkmv_score as score_mod, ops, ref  # noqa: E402


def _rand_rows(rng, m, c, hi, full=False):
    """Sorted, duplicate-free, PAD-filled rows drawn from [0, hi)."""
    values = np.full((m, c), PAD, np.uint32)
    lengths = rng.integers(c if full else 0, c + 1, size=m)
    for i in range(m):
        v = np.unique(rng.integers(0, hi, size=2 * int(lengths[i]) + 1,
                                   dtype=np.uint64).astype(np.uint32))
        v = v[: lengths[i]]
        values[i, : len(v)] = v
    return values


def _case(seed, m, c, gq, cq, w, hi=64):
    """Inputs of one score call; a small hash range ``hi`` makes rows
    share values, so K∩ ≥ 1 and the Eq. 25 branch are exercised."""
    rng = np.random.default_rng(seed)
    xv = _rand_rows(rng, m, c, hi)
    qv = _rand_rows(rng, gq, cq, hi)
    # Thresholds are real hashes: never PAD.
    xt = np.minimum(rng.integers(0, hi + 8, size=m), PAD - 1).astype(np.uint32)
    qt = np.minimum(rng.integers(0, hi + 8, size=gq), PAD - 1).astype(np.uint32)
    xb = rng.integers(0, 2**32, size=(m, w), dtype=np.uint64).astype(np.uint32)
    qb = rng.integers(0, 2**32, size=(gq, w), dtype=np.uint64).astype(np.uint32)
    qs = rng.integers(0, 60, size=gq).astype(np.int32)
    return xv, xt, xb, qv, qt, qb, qs


def _edge_case():
    """k < 2, K∩ = 0, an all-PAD row, threshold-0 rows (the reference's
    record padding), the largest threshold below PAD, and a query of
    size 0. Thresholds are real hashes, so never PAD itself."""
    xv = np.full((7, 8), PAD, np.uint32)
    xv[0, :1] = [5]                       # k = 1 with the query's 5
    xv[1, :3] = [1, 2, 3]                 # K∩ = 0
    xv[2, :4] = [5, 9, 17, 30]            # K∩ ≥ 1, k ≥ 2
    # row 3 all PAD
    xv[4, :2] = [5, 9]                    # threshold 0: nothing live
    xv[5, :2] = [0, 5]                    # threshold 0: value 0 live
    xv[6, :3] = [5, 9, 40]                # threshold PAD - 1
    xt = np.asarray([5, 50, 50, 50, 0, 0, PAD - 1], np.uint32)
    qv = np.full((3, 8), PAD, np.uint32)
    qv[0, :1] = [5]
    qv[1, :4] = [0, 5, 9, 30]
    xb = np.zeros((7, 1), np.uint32)
    xb[2, 0] = 0b1011
    qb = np.asarray([[0b0011], [0b1111], [0]], np.uint32)
    qt = np.asarray([50, PAD - 1, 50], np.uint32)
    qs = np.asarray([4, 7, 0], np.int32)
    return xv, xt, xb, qv, qt, qb, qs


def _port(xv, xt, xb, qv, qt, qb, qs):
    return ops.score_index(to_tensor(xv), to_tensor(xt), to_tensor(xb),
                           to_tensor(qv), to_tensor(qt), to_tensor(qb),
                           torch.from_numpy(qs)).numpy()


def _pallas(xv, xt, xb, qv, qt, qb, qs):
    return np.asarray(ref_ops.score_index(xv, xt, xb, qv, qt, qb, qs,
                                          interpret=True))


def _ref_numpy(xv, xt, xb, qv, qt, qb, qs):
    x = RefPack(xv, np.zeros(len(xv), np.int32), xt, xb,
                np.zeros(len(xv), np.int32))
    q = RefPack(qv, np.zeros(len(qv), np.int32), qt, qb, qs)
    return ref_est.containment_matrix(q, x, backend="numpy")


def _bits_equal(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


CASES = [
    (0, 8, 16, 1, 16, 1),      # single query
    (1, 13, 16, 3, 24, 2),     # odd M, query wider than records
    (2, 40, 32, 4, 8, 4),      # query narrower than records
    (3, 64, 8, 2, 8, 0),       # no buffer words
    (4, 1, 8, 4, 32, 1),       # one record
]


@pytest.mark.parametrize("seed,m,c,gq,cq,w", CASES)
def test_plain_matches_pallas_interpret_and_numpy(seed, m, c, gq, cq, w):
    args = _case(seed, m, c, gq, cq, w)
    got = _port(*args)
    _bits_equal(got, _pallas(*args))
    _bits_equal(got, _ref_numpy(*args))


def test_edge_cases_match_reference():
    args = _edge_case()
    got = _port(*args)
    _bits_equal(got, _pallas(*args))
    _bits_equal(got, _ref_numpy(*args))
    assert got[3].max() == 0.0 and got[4, 0] == 0.0
    assert np.isfinite(got).all()


def test_empty_buffer_and_mismatched_widths():
    xv, xt, _, qv, qt, _, qs = _case(5, 9, 8, 2, 8, 1)
    xb = np.zeros((9, 0), np.uint32)
    qb = np.zeros((2, 0), np.uint32)
    _bits_equal(_port(xv, xt, xb, qv, qt, qb, qs),
                _pallas(xv, xt, xb, qv, qt, qb, qs))
    qb2 = np.full((2, 2), 0xFFFF, np.uint32)
    _bits_equal(_port(xv, xt, xb, qv, qt, qb2, qs),
                _ref_numpy(xv, xt, np.zeros((9, 2), np.uint32), qv, qt, qb2, qs))


# The kernel's pack, as csrc/gbkmv_score.cu lays it out and budgets it
# (the library's answers on a card are checked in test_torch_cuda.py):
# values, buffers and four words a query, within the 232,448 B one block
# may use on Hopper less the 8,192-B filter.
def _kernel_pack_bytes(gq, cq, w):
    return (gq * cq + gq * w + 4 * gq) * 4


_KERNEL_MAX_PACK_BYTES = 232448 - 8192


def _split_like_a_card(monkeypatch, max_bytes):
    """Have ``ops.score_index`` split CPU batches as it splits them on a
    card whose kernel library answers with the layout above."""
    monkeypatch.setattr(score_mod, "query_pack_bytes", _kernel_pack_bytes)
    monkeypatch.setattr(score_mod, "max_pack_bytes", lambda: max_bytes)
    on_card = score_mod.queries_per_launch
    monkeypatch.setattr(
        score_mod, "queries_per_launch",
        lambda device, gq, cq, w: on_card(torch.device("cuda"), gq, cq, w))


def test_query_batch_split_across_launches(monkeypatch):
    """A pack over the shared-memory limit is scored in parts; the parts
    concatenate to the one-call answer."""
    args = _case(6, 11, 8, 4, 8, 1)
    whole = _port(*args)
    assert score_mod.queries_per_launch(torch.device("cpu"), 4, 8, 1) == 4
    _split_like_a_card(monkeypatch, _kernel_pack_bytes(1, 8, 1) * 3)
    launch = score_mod.gbkmv_score
    parts = []
    monkeypatch.setattr(score_mod, "gbkmv_score",
                        lambda *cols: parts.append(len(cols[3])) or
                        launch(*cols))
    _bits_equal(_port(*args), whole)
    assert parts == [3, 1]


@pytest.mark.parametrize("gq,cq,w", [(60, 1024, 1), (20, 3000, 2),
                                     (5, 12000, 0)])
def test_score_index_splits_to_the_kernel_pack(monkeypatch, gq, cq, w):
    """``ops.score_index`` cuts a batch whose pack is over the kernel's
    budget into consecutive parts, each as large as fits the kernel's pack
    (values, buffers and four words a query); the parts' scores equal the
    reference's."""
    args = _case(10 + gq, 6, 8, gq, cq, w, hi=2**16)
    assert _kernel_pack_bytes(gq, cq, w) > _KERNEL_MAX_PACK_BYTES
    _split_like_a_card(monkeypatch, _KERNEL_MAX_PACK_BYTES)
    launch = score_mod.gbkmv_score
    parts = []

    def part(*cols):
        n, wq = cols[3].shape[0], cols[5].shape[1]
        assert _kernel_pack_bytes(n, cq, wq) <= _KERNEL_MAX_PACK_BYTES
        parts.append(n)
        return launch(*cols)

    monkeypatch.setattr(score_mod, "gbkmv_score", part)
    got = _port(*args)
    step = _KERNEL_MAX_PACK_BYTES // ((cq + w + 4) * 4)
    assert parts == [min(step, gq - g) for g in range(0, gq, step)]
    assert len(parts) == 2
    _bits_equal(got, _ref_numpy(*args))


def test_containment_matrix_backends_agree_with_reference():
    xv, xt, xb, qv, qt, qb, qs = _case(7, 30, 16, 3, 16, 2)
    x = PackedSketches.from_numpy(xv, np.zeros(30, np.int32), xt, xb,
                                  np.zeros(30, np.int32))
    q = PackedSketches.from_numpy(qv, np.zeros(3, np.int32), qt, qb, qs)
    want = _ref_numpy(xv, xt, xb, qv, qt, qb, qs)
    _bits_equal(estimators.containment_matrix(q, x, backend="numpy"), want)
    got = estimators.containment_matrix(q, x, backend="torch", as_numpy=False)
    assert isinstance(got, torch.Tensor)
    _bits_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        estimators.containment_matrix(q, x, backend="jnp")


def test_pair_estimate_and_popcount_match_reference():
    import jax.numpy as jnp

    xv, xt, xb, qv, qt, qb, _ = _case(8, 25, 16, 1, 16, 3)
    d, k, kc = estimators.gkmv_pair_estimate(
        to_tensor(qv[0]), None, to_tensor(qt)[0], to_tensor(xv), None,
        to_tensor(xt))
    d_r, k_r, kc_r = ref_est.gkmv_pair_estimate(
        jnp.asarray(qv[0]), None, jnp.asarray(qt[0]), jnp.asarray(xv), None,
        jnp.asarray(xt))
    _bits_equal(d.numpy(), np.asarray(d_r))
    np.testing.assert_array_equal(k.numpy(), np.asarray(k_r))
    np.testing.assert_array_equal(kc.numpy(), np.asarray(kc_r))
    o1 = estimators.buffer_intersection(to_tensor(qb[0]), to_tensor(xb))
    np.testing.assert_array_equal(
        o1.numpy(), np.asarray(ref_est.buffer_intersection(
            jnp.asarray(qb[0]), jnp.asarray(xb))))


def test_score_wrapper_rejects_bad_input():
    args = [to_tensor(a) if a.dtype == np.uint32 else torch.from_numpy(a)
            for a in _case(9, 4, 8, 2, 8, 1)]
    with pytest.raises(TypeError):
        score_mod.gbkmv_score(args[0].to(torch.int64), *args[1:])
    with pytest.raises(ValueError):
        score_mod.gbkmv_score(args[0], args[1][:3], *args[2:])
    with pytest.raises(ValueError):
        score_mod.gbkmv_score(args[0].t(), *args[1:])


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**16), m=st.integers(1, 24),
       c=st.sampled_from([8, 16, 32]), gq=st.integers(1, 4),
       cq=st.sampled_from([8, 24]), w=st.integers(0, 3),
       hi=st.sampled_from([32, 2**32]))
def test_plain_matches_reference_fuzz(seed, m, c, gq, cq, w, hi):
    args = _case(seed, m, c, gq, cq, w, hi=hi)
    got = _port(*args)
    _bits_equal(got, _pallas(*args))
    _bits_equal(got, _ref_numpy(*args))
