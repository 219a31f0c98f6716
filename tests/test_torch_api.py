"""The port's slices end to end against ``repro.api``: build, batch_query
and topk on every plan, and save/load across the two packages. Hit lists
and top-k orders must be equal and scores bitwise equal."""

import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.data.synth import generate_dataset, make_query_workload
from repro_torch import api
from repro_torch.core import gbkmv

THRESHOLDS = (0.0, 0.3, 0.5, 0.9)


@pytest.fixture(scope="module")
def data():
    recs = generate_dataset(m=64, n_elems=1500, alpha_freq=1.14,
                            alpha_size=2.5, size_min=5, size_max=30, seed=11)
    budget = int(0.3 * sum(len(r) for r in recs))
    queries = make_query_workload(recs, 3, seed=2) + [recs[0][:2]]
    return recs, budget, queries


@pytest.fixture(scope="module")
def ref_index(data):
    recs, budget, _ = data
    return ref_api.get_engine("gbkmv").build(recs, budget, backend="numpy")


def _assert_same_answers(port, ref, queries):
    for t in THRESHOLDS:
        want = ref.batch_query(queries, t, plan="dense")
        for plan in ("dense", "auto", "pruned"):
            got = port.batch_query(queries, t, plan=plan)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    s_got, s_want = port.batch_scores(queries), ref.batch_scores(queries)
    np.testing.assert_array_equal(s_got.view(np.uint32), s_want.view(np.uint32))
    for q in queries:
        for k in (1, 5, 200):
            rids, rsc = ref.topk(q, k, plan="dense")
            for plan in ("auto", "pruned"):
                ids, sc = port.topk(q, k, plan=plan)
                np.testing.assert_array_equal(ids, rids)
                np.testing.assert_array_equal(sc.view(np.uint32),
                                              rsc.view(np.uint32))


@pytest.mark.parametrize("build_backend", ["torch", "numpy"])
@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_built_index_answers_like_reference(data, ref_index, build_backend,
                                            backend):
    recs, budget, queries = data
    port = api.build("gbkmv", recs, budget, backend=backend,
                     build_backend=build_backend, device="cpu")
    _assert_same_answers(port, ref_index, queries)
    for t in (0.0, 0.5):
        port.batch_query(queries, t)
        ref_index.batch_query(queries, t)
        got, want = port.last_plan, ref_index.last_plan
        assert (got.path, got.hits, got.blocks, got.reason) == \
            (want.path, want.hits, want.blocks, want.reason)
    port.batch_query(queries, 0.5, plan="dense")
    assert port.last_plan.path == "dense" and port.last_plan.reason == "forced"
    assert port.nbytes() == port.core.sketches.nbytes() > 0


def test_auto_plan_matches_reference_planner(data, ref_index):
    recs, budget, queries = data
    port = api.build("gbkmv", recs, budget, device="cpu")
    for t in (0.5, 0.7):
        for a, b in zip(port.batch_query(queries, t),
                        ref_index.batch_query(queries, t, plan="auto")):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.query(queries[1], 0.5),
                                  ref_index.query(queries[1], 0.5))
    np.testing.assert_array_equal(port.scores(queries[2]),
                                  ref_index.scores(queries[2]))


@pytest.mark.parametrize("ref_build", [None, "jnp"])
def test_reference_file_loads_in_port(data, tmp_path, ref_build):
    recs, budget, queries = data
    ref = ref_api.get_engine("gbkmv").build(
        recs, budget, backend="jnp", build_backend=ref_build, postings="eager")
    path = str(tmp_path / "ref.npz")
    ref.save(path)
    with np.load(path) as f:
        assert any(k.startswith("post_") for k in f.files)
    port = api.load_index(path, device="cpu")
    assert port.backend == "torch" and port.budget == budget
    _assert_same_answers(port, ref, queries)


def test_port_file_loads_in_reference(data, tmp_path):
    recs, budget, queries = data
    port = api.build("gbkmv", recs, budget, device="cpu")
    path = str(tmp_path / "port.npz")
    port.save(path)
    with np.load(path) as f:
        assert not any(k.startswith("post_") for k in f.files)
        assert str(f["backend"]) == "jnp" and int(f["arena_version"]) == 3
    ref = ref_api.load_index(path)
    assert ref.backend == "jnp"
    _assert_same_answers(port, ref, queries)
    again = api.load_index(path, device="cpu")
    _assert_same_answers(again, ref, queries)


def test_arrays_carry_state_both_ways(data, ref_index):
    recs, budget, queries = data
    core = ref_index.core
    d = ref_api._arena_to_npz(core.sketches)
    d.update(tau=core.tau, top_elems=core.top_elems, seed=core.seed,
             buffer_bits=core.buffer_bits, budget=budget)
    port = api.index_from_arrays(d, device="cpu")
    _assert_same_answers(port, ref_index, queries)

    back = ref_api.GBKMVEngine._load(api.index_to_arrays(port))
    _assert_same_answers(port, back, queries)


def test_default_device_raises_without_cuda(data, tmp_path, monkeypatch):
    recs, budget, _ = data
    path = str(tmp_path / "i.npz")
    api.build("gbkmv", recs, budget, device="cpu").save(path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        api.build("gbkmv", recs, budget)
    with pytest.raises(RuntimeError, match="cuda"):
        api.build("gbkmv", recs, budget, build_backend="numpy")
    with pytest.raises(RuntimeError, match="cuda"):
        api.load_index(path)
    with pytest.raises(RuntimeError, match="cuda"):
        gbkmv.build_gbkmv(recs, budget)


def test_unported_routes_raise(data):
    recs, budget, queries = data
    port = api.build("gbkmv", recs, budget, device="cpu")
    # The pruned route is ported: it answers as the dense sweep does.
    for a, b in zip(port.batch_query(queries, 0.5, plan="pruned"),
                    port.batch_query(queries, 0.5, plan="dense")):
        np.testing.assert_array_equal(a, b)
    for x, y in zip(port.topk(queries[0], 3, plan="pruned"),
                    port.topk(queries[0], 3, plan="dense")):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.query(queries[0], 0.5, explain=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.insert(recs[:2])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        api.build("gbkmv", recs, budget, windowed=True, device="cpu")
    with pytest.raises(ValueError):
        port.batch_query(queries, 0.5, plan="cheapest")
    with pytest.raises(ValueError, match="postings"):
        api.build("gbkmv", recs, budget, postings="always", device="cpu")
    with pytest.raises(ValueError):
        api.get_engine("lshe")
    for engine in ("gkmv", "kmv"):
        other = api.build(engine, recs, budget, device="cpu")
        with pytest.raises(NotImplementedError, match="slice 5b"):
            other.insert(recs[:2])
        with pytest.raises(NotImplementedError, match="slice 5c"):
            api.build(engine, recs, budget, windowed=True, device="cpu")
        with pytest.raises(NotImplementedError, match="slice 7"):
            other.query(queries[0], 0.5, explain=True)
    assert port.batch_query([], 0.5) == []


def test_bad_files_raise(tmp_path):
    junk = tmp_path / "junk.npz"
    junk.write_bytes(b"not a zip file")
    with pytest.raises(api.CorruptIndexError):
        api.load_index(str(junk), device="cpu")
    np.savez(tmp_path / "noengine.npz", values=np.zeros(3))
    with pytest.raises(api.CorruptIndexError):
        api.load_index(str(tmp_path / "noengine.npz"), device="cpu")
    np.savez(tmp_path / "partial.npz", engine="gbkmv", values=np.zeros(3))
    with pytest.raises(api.CorruptIndexError):
        api.load_index(str(tmp_path / "partial.npz"), device="cpu")
    with pytest.raises(FileNotFoundError):
        api.load_index(str(tmp_path / "missing.npz"), device="cpu")


def test_core_search_matches_reference(data):
    from repro.core import gbkmv as ref_gbkmv

    recs, budget, queries = data
    idx = gbkmv.build_gbkmv(recs, budget, device="cpu")
    ref_idx = ref_gbkmv.build_gbkmv(recs, budget)
    for q in queries:
        q_pack = gbkmv.sketch_query(idx, q)
        np.testing.assert_array_equal(
            gbkmv.containment_scores(idx, q_pack, device="cpu"),
            ref_gbkmv.containment_scores(
                ref_idx, ref_gbkmv.sketch_query(ref_idx, q), backend="numpy"))
        for t in (0.2, 0.6):
            np.testing.assert_array_equal(
                gbkmv.search(idx, q, t, device="cpu"),
                ref_gbkmv.search(ref_idx, q, t, backend="numpy"))
