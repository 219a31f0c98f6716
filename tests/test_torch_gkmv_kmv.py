"""The port's G-KMV and plain-KMV engines against the JAX reference's:
columns and τ of both builds (host, and the device build's plain version)
bit for bit against ``repro.core.gkmv`` / ``repro.core.kmv`` and their
per-record oracles; the query packers; ``kmv_pair_estimate`` against the
reference's jnp program (tolerance 0); every route of both api engines
against ``repro.api`` (hit lists, top-k orders and scores equal); and index
files across the two packages."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import api as ref_api
from repro.core import estimators as ref_est
from repro.core import gkmv as ref_gkmv
from repro.core import kmv as ref_kmv
from repro.core.hashing import PAD, hash_u32_np
from repro.data.synth import generate_dataset, make_query_workload
from repro_torch import api
from repro_torch.core import gbkmv, gkmv, kmv
from repro_torch.core.estimators import containment_matrix, kmv_pair_estimate
from repro_torch.core.hashing import to_numpy, to_tensor
from repro_torch.core.sketches import RaggedBatch
from repro_torch.kernels.hash_threshold import fused_build_columns
from repro_torch.planner import device as planner_device

ENGINES = ("gkmv", "kmv")
THRESHOLDS = (0.0, 0.5, 0.9, 1.0)


def _records(seed=11, m=64, size_max=30):
    return generate_dataset(m=m, n_elems=1500, alpha_freq=1.14,
                            alpha_size=2.5, size_min=5, size_max=size_max,
                            seed=seed)


@pytest.fixture(scope="module")
def data():
    recs = _records()
    budget = int(0.3 * sum(len(r) for r in recs))
    queries = make_query_workload(recs, 3, seed=2) + [recs[0][:2],
                                                      np.zeros(0, np.int64)]
    return recs, budget, queries


def _columns(pack):
    """Packed columns as numpy, u32 columns as uint32, from either package."""
    cols = (pack.values, pack.lengths, pack.thresh, pack.buf, pack.sizes)
    if isinstance(pack.values, torch.Tensor):
        return [to_numpy(c) if i in (0, 2, 3) else c.cpu().numpy()
                for i, c in enumerate(cols)]
    return [np.asarray(c) for c in cols]


def _assert_same_pack(port, want):
    for name, a, b in zip(("values", "lengths", "thresh", "buf", "sizes"),
                          _columns(port), _columns(want)):
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=name)


# ---------------------------------------------------------------------------
# Builds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("capacity", [None, 5])
@pytest.mark.parametrize("tau_mode", ["exact", "histogram"])
@pytest.mark.parametrize("build_backend", ["numpy", "torch"])
def test_build_gkmv_matches_reference(build_backend, tau_mode, capacity):
    recs = _records(seed=4, m=48)
    # At half the ids kept, rows of up to 30 ids overflow a width of 8.
    budget = int((0.2 if capacity is None else 0.5)
                 * sum(len(r) for r in recs))
    got = gkmv.build_gkmv(recs, budget, seed=2, capacity=capacity,
                          tau_mode=tau_mode, build_backend=build_backend,
                          device="cpu")
    want = ref_gkmv.build_gkmv(recs, budget, seed=2, capacity=capacity,
                               tau_mode=tau_mode)
    _assert_same_pack(got, want)
    if capacity is not None:
        assert got.capacity == 8 and (got.lengths == 8).any()
        assert (to_numpy(got.thresh) < to_numpy(got.thresh).max()).any(), \
            "the capacity binds on some row"
    if tau_mode == "exact":
        _assert_same_pack(got, ref_gkmv.build_gkmv_oracle(
            recs, budget, seed=2, capacity=capacity))


@pytest.mark.parametrize("budget_per_record", [0, 3, 9, 1000])
@pytest.mark.parametrize("build_backend", ["numpy", "torch"])
def test_build_kmv_matches_reference(build_backend, budget_per_record):
    recs = _records(seed=5, m=40)
    budget = budget_per_record * len(recs)
    got = kmv.build_kmv(recs, budget, seed=1, build_backend=build_backend,
                        device="cpu")
    _assert_same_pack(got, ref_kmv.build_kmv(recs, budget, seed=1))
    _assert_same_pack(got, ref_kmv.build_kmv_oracle(recs, budget, seed=1))
    k = max(budget // len(recs), 2)
    assert int(got.lengths.max()) == min(k, max(len(r) for r in recs))


@pytest.mark.parametrize("build_backend", ["numpy", "torch"])
def test_builds_on_no_records_and_empty_records(build_backend):
    for recs in ([], [np.zeros(0, np.int64)] * 3,
                 [np.zeros(0, np.int64), np.arange(5), np.zeros(0, np.int64)]):
        _assert_same_pack(
            gkmv.build_gkmv(recs, 4, build_backend=build_backend,
                            device="cpu"),
            ref_gkmv.build_gkmv(recs, 4))
        _assert_same_pack(
            kmv.build_kmv(recs, 4, build_backend=build_backend, device="cpu"),
            ref_kmv.build_kmv(recs, 4))


def test_row_cap_route_matches_host_cut():
    """The device build's plain-KMV route on rows shorter and longer than k,
    empty rows, and ids that wrap mod 2³² onto one hash: the host cut."""
    recs = [np.arange(20), np.zeros(0, np.int64), np.asarray([7, 7 + 2**32]),
            np.arange(100, 103), np.asarray([2**40 + 3, 5, 2**33])]
    batch = RaggedBatch.from_records(recs)
    for k in (2, 3, 8, 11):
        got, tau = fused_build_columns(batch, np.ones(batch.total, bool), 0,
                                       seed=3, row_cap=k, device="cpu")
        assert tau == PAD - 1
        _assert_same_pack(got, ref_kmv.build_kmv(recs, k * len(recs), seed=3))


def test_gbkmv_at_r0_is_gkmv():
    recs = _records(seed=6, m=50)
    budget = int(0.15 * sum(len(r) for r in recs))
    a = gbkmv.build_gbkmv(recs, budget, r=0, device="cpu")
    b = gkmv.build_gkmv(recs, budget, device="cpu")
    _assert_same_pack(a.sketches, b)
    assert a.tau == np.uint32(to_numpy(b.thresh).max())


def test_query_sketches_match_reference():
    recs = _records(seed=7, m=30)
    tau = np.uint32(2**31)
    for capacity in (None, 4, 16):
        got = gkmv.sketch_query_batch(recs[:6], tau, seed=3,
                                      capacity=capacity)
        _assert_same_pack(got, ref_gkmv.sketch_query_batch(
            recs[:6], tau, seed=3, capacity=capacity))
        for q in recs[:3] + [np.zeros(0, np.int64)]:
            one = gkmv.sketch_query(q, tau, seed=3, capacity=capacity)
            _assert_same_pack(one, ref_gkmv.sketch_query(
                q, tau, seed=3, capacity=capacity))
            _assert_same_pack(one, ref_gkmv.sketch_query_oracle(
                q, tau, seed=3, capacity=capacity))


# ---------------------------------------------------------------------------
# The plain-KMV pair estimator
# ---------------------------------------------------------------------------


def _pack_rows(rows, cap):
    v = np.full((len(rows), cap), PAD, np.uint32)
    n = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        v[i, : len(r)] = r
        n[i] = len(r)
    return v, n


def _assert_kmv_estimate_equal(q_row, q_len, xv, xn):
    want = ref_est.kmv_pair_estimate(jnp.asarray(q_row), jnp.int32(q_len),
                                     jnp.asarray(xv), jnp.asarray(xn))
    got = kmv_pair_estimate(to_tensor(q_row), q_len, to_tensor(xv),
                            torch.from_numpy(xn))
    d, k, kc = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32),
                                  d.view(np.uint32))
    np.testing.assert_array_equal(got[1].numpy(), k)
    np.testing.assert_array_equal(got[2].numpy(), kc)
    return got


@pytest.mark.parametrize("seed", [0, 5, 9])
def test_kmv_pair_estimate_matches_reference(seed):
    """Tolerance 0 on random KMV rows (the reference test's recipe)."""
    rng = np.random.default_rng(seed)
    kq, kx = 40, 25
    qh = np.sort(hash_u32_np(rng.choice(3000, size=500, replace=False)))[:kq]
    rows = [np.sort(hash_u32_np(rng.choice(3000, size=rng.integers(1, 600),
                                           replace=False)))[:kx]
            for _ in range(30)]
    xv, xn = _pack_rows(rows, kq)
    qv, qn = _pack_rows([qh], kq)
    d, k, kc = _assert_kmv_estimate_equal(qv[0], int(qn[0]), xv, xn)
    for i, r in enumerate(rows):
        od, ok, okc = ref_est.kmv_pair_oracle_np(qh, r)
        assert int(k[i]) == ok and int(kc[i]) == okc
        np.testing.assert_allclose(float(d[i]), od, rtol=2e-5)


def test_kmv_pair_estimate_edge_rows():
    """Rows with PAD inside the live prefix' reach, k < 2, K∩ = 0, an
    identical row, empty rows, and values at 0 and PAD − 1."""
    q = np.asarray([0, 5, 9, 30, 31, PAD - 1], np.uint32)
    rows = [q.copy(),                                    # identical
            np.asarray([1, 2, 3], np.uint32),            # K∩ = 0
            np.asarray([5], np.uint32),                  # k = 1
            np.zeros(0, np.uint32),                      # empty
            np.asarray([0, 9, 31, 40, PAD - 1], np.uint32),
            np.asarray([5, 9, 17, 30, 31, 50, 60, 70], np.uint32)]
    xv, xn = _pack_rows(rows, 8)
    qv = np.full(8, PAD, np.uint32)
    qv[: len(q)] = q
    for q_len in (0, 1, 2, len(q)):
        _assert_kmv_estimate_equal(qv, q_len, xv, xn)


def test_kmv_distinct_estimate_matches_reference():
    h = hash_u32_np(np.arange(300))
    for k in (0, 1, 2, 10, 300, 400):
        assert kmv.kmv_distinct_estimate_np(h, k) == \
            ref_kmv.kmv_distinct_estimate_np(h, k)


# ---------------------------------------------------------------------------
# The api engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_indexes(data):
    recs, budget, _ = data
    return {e: ref_api.get_engine(e).build(recs, budget, backend="numpy")
            for e in ENGINES}


def _assert_same_answers(port, ref, queries):
    m = ref.num_records
    for t in THRESHOLDS:
        want = ref.batch_query(queries, t, plan="dense")
        for plan in ("dense", "auto", "pruned"):
            got = port.batch_query(queries, t, plan=plan)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    for q in queries:
        np.testing.assert_array_equal(port.scores(q).view(np.uint32),
                                      ref.scores(q).view(np.uint32))
        for k in (0, 1, 10, m):
            rids, rsc = ref.topk(q, k, plan="dense")
            for plan in ("dense", "auto", "pruned"):
                ids, sc = port.topk(q, k, plan=plan)
                np.testing.assert_array_equal(ids, rids)
                np.testing.assert_array_equal(sc.view(np.uint32),
                                              rsc.view(np.uint32))


@pytest.mark.parametrize("build_backend", ["torch", "numpy"])
@pytest.mark.parametrize("backend", ["torch", "numpy"])
@pytest.mark.parametrize("engine", ENGINES)
def test_engine_answers_like_reference(data, ref_indexes, engine, backend,
                                       build_backend):
    recs, budget, queries = data
    ref = ref_indexes[engine]
    port = api.build(engine, recs, budget, backend=backend,
                     build_backend=build_backend, device="cpu")
    assert port.engine == engine and port.num_records == len(recs)
    _assert_same_pack(port.sketches, ref.sketches)
    if engine == "gkmv":
        assert port.tau == ref.tau
    _assert_same_answers(port, ref, queries)
    for t in (0.0, 0.5, 0.9):
        port.batch_query(queries, t)
        ref.batch_query(queries, t)
        got, want = port.last_plan, ref.last_plan
        assert (got.path, got.hits, got.blocks, got.reason) == \
            (want.path, want.hits, want.blocks, want.reason)
    port.batch_query(queries, 0.5, plan="pruned")
    ref.batch_query(queries, 0.5, plan="pruned")
    if engine == "gkmv" and backend == "torch":
        assert port.last_candidate_sizes is None      # the device pipeline
    else:
        assert port.last_candidate_sizes == ref.last_candidate_sizes
    assert port.nbytes() == port.sketches.nbytes() > 0


def test_gkmv_device_route_scores_equal_the_dense_matrix(data):
    """gkmv's pruned pipeline at buffer width 0 gives B1's dense matrix bit
    for bit (both as their plain versions here)."""
    recs, budget, queries = data
    port = api.build("gkmv", recs, budget, device="cpu", postings="eager")
    arena = port.sketches
    assert arena.buf_words == 0
    qp = port._query_pack(queries)
    staged = planner_device.stage_query_inputs(arena, qp, device="cpu")
    s = planner_device.pruned_scores(*staged)
    dense = containment_matrix(qp, arena, as_numpy=False)
    assert torch.equal(s.view(torch.int32), dense.view(torch.int32))


@pytest.mark.parametrize("engine", ENGINES)
def test_reference_file_loads_in_port(data, tmp_path, engine):
    recs, budget, queries = data
    ref = ref_api.get_engine(engine).build(recs, budget, backend="jnp",
                                           postings="eager")
    path = str(tmp_path / "ref.npz")
    ref.save(path)
    port = api.load_index(path, device="cpu")
    assert port.engine == engine and port.backend == "torch"
    assert port.sketches._post is not None, "postings carried"
    _assert_same_answers(port, ref, queries)


@pytest.mark.parametrize("build_backend", ["torch", "numpy"])
@pytest.mark.parametrize("engine", ENGINES)
def test_port_file_loads_in_reference(data, tmp_path, engine, build_backend):
    recs, budget, queries = data
    port = api.build(engine, recs, budget, build_backend=build_backend,
                     postings="eager", device="cpu")
    path = str(tmp_path / "port.npz")
    port.save(path)
    with np.load(path) as f:
        assert str(f["engine"]) == engine and str(f["backend"]) == "jnp"
        assert "post_blk_payload" in f.files
    ref = ref_api.load_index(path)
    assert ref.backend == "jnp"
    _assert_same_answers(port, ref, queries)
    again = api.load_index(path, device="cpu")
    _assert_same_pack(again.sketches, port.sketches)
    _assert_same_answers(again, ref, queries)


@pytest.mark.parametrize("engine", ENGINES)
def test_wrap_adopts_a_built_arena(data, ref_indexes, engine):
    recs, budget, queries = data
    core = (gkmv.build_gkmv(recs, budget, device="cpu") if engine == "gkmv"
            else kmv.build_kmv(recs, budget, device="cpu"))
    port = api.get_engine(engine).wrap(core, device="cpu")
    _assert_same_answers(port, ref_indexes[engine], queries[:2])
