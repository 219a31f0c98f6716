"""The port's host planner against ``repro.planner``: the query-path cost
model, ``choose_plan``, candidate generation, ``pruned_batch`` and
``pruned_topk``, and the planned routes of the api index. Tolerance 0:
plan fields, candidate sets, hit lists and top-k orders are equal, and
pruned answers equal the dense route's."""

import numpy as np
import pytest

from repro import api as ref_api, planner as ref_planner
from repro.core import cost_model as ref_cost
from repro.data.synth import generate_dataset, make_query_workload
from repro.planner import prune as ref_prune
from repro_torch import api, planner
from repro_torch.core import cost_model
from repro_torch.kernels import gather_score as gs_mod
from repro_torch.planner import prune

THRESHOLDS = (0.3, 0.7, 1.0)


@pytest.fixture(scope="module")
def corpus():
    recs = generate_dataset(m=320, n_elems=3000, alpha_freq=1.05,
                            alpha_size=1.8, size_min=4, size_max=80, seed=7)
    total = sum(len(r) for r in recs)
    queries = make_query_workload(recs, 6, seed=1)
    rng = np.random.default_rng(3)
    queries += [rng.choice(3000, size=s, replace=False) for s in (5, 40)]
    queries += [recs[3], recs[3][:1]]              # a duplicate-rich pair
    return recs, int(total * 0.12), queries


@pytest.fixture(scope="module")
def ref_index(corpus):
    recs, budget, _ = corpus
    return ref_api.get_engine("gbkmv").build(recs, budget, backend="numpy",
                                             postings="eager")


@pytest.fixture(scope="module")
def port_index(corpus):
    recs, budget, _ = corpus
    return api.build("gbkmv", recs, budget, device="cpu", postings="eager")


@pytest.fixture
def calibrated(monkeypatch):
    """Give both packages the same query-path constants (ones that make
    the pruned route cheap), and restore the defaults afterwards: the
    reference through its calibration hook, the port through its module
    constants."""
    cal = {"dense_cost_per_slot": 50.0, "prune_cost_per_hit": 1.0,
           "prune_cost_per_cand_slot": 0.5, "prune_fixed_per_query": 8.0}
    ref_cost.set_calibration(cal)     # a missing per-block cost means 0.0
    for key, v in {**cal, "prune_cost_per_block": 0.0}.items():
        monkeypatch.setattr(cost_model, key.upper(), v)
    yield cal
    ref_cost.set_calibration(None)


def _plan_inputs(index, queries):
    return index._plan_queries([np.asarray(q) for q in queries])


def test_query_rows_match_reference(corpus, ref_index, port_index):
    _, _, queries = corpus
    _, ph, pb, ps = _plan_inputs(port_index, queries)
    _, rh, rb, rs = _plan_inputs(ref_index, queries)
    for a, b in zip(ph, rh):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    for a, b in zip(pb, rb):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ps, rs)
    for a in ph:
        np.testing.assert_array_equal(prune.tail_bound(np.sort(a)),
                                      ref_prune.tail_bound(np.sort(a)))


@pytest.mark.parametrize("gq,hits,blocks", [(1, 0, 0), (16, 9824975, 76793),
                                            (3, 1234, 17)])
def test_cost_model_matches_reference(gq, hits, blocks, calibrated,
                                      monkeypatch):
    args = (480189, 56, gq)
    assert cost_model.dense_sweep_cost(*args) == ref_cost.dense_sweep_cost(*args)
    assert (cost_model.pruned_path_cost(hits, 56, gq, blocks=blocks)
            == ref_cost.pruned_path_cost(hits, 56, gq, blocks=blocks))
    monkeypatch.undo()
    ref_cost.set_calibration(None)
    assert cost_model.dense_sweep_cost(*args) == ref_cost.dense_sweep_cost(*args)
    assert (cost_model.pruned_path_cost(hits, 56, gq, blocks=blocks)
            == ref_cost.pruned_path_cost(hits, 56, gq, blocks=blocks))


def test_cost_constants_match_reference():
    for name in ("DENSE_COST_PER_SLOT", "PRUNE_COST_PER_HIT",
                 "PRUNE_COST_PER_CAND_SLOT", "PRUNE_FIXED_PER_QUERY",
                 "PRUNE_COST_PER_BLOCK"):
        assert getattr(cost_model, name) == getattr(ref_cost, name), name
    assert cost_model.pruned_path_cost(10, 2, 1, blocks=3) == \
        2048.0 + 6.0 * 10 + 12.0 * 3 + 3.0 * 10 * 2
    assert cost_model.dense_sweep_cost(5, 0, 0) == 5.0


@pytest.mark.parametrize("plan", ["auto", "dense", "pruned"])
@pytest.mark.parametrize("t", (0.0,) + THRESHOLDS)
def test_choose_plan_matches_reference(corpus, ref_index, port_index, plan, t):
    _, _, queries = corpus
    _, ph, pb, _ = _plan_inputs(port_index, queries)
    _, rh, rb, _ = _plan_inputs(ref_index, queries)
    s = port_index.core.sketches
    got = planner.choose_plan(port_index._postings(), ph, pb, t,
                              s.num_records, s.capacity, plan=plan)
    want = ref_planner.choose_plan(ref_index._postings(), rh, rb, t,
                                   s.num_records, s.capacity, plan=plan)
    for f in ("path", "est_dense", "est_pruned", "hits", "reason", "blocks",
              "tail_blocks", "tail_dense_blocks"):
        assert getattr(got, f) == getattr(want, f), f
    if want.per_query_hits is None:
        assert got.per_query_hits is None
    else:
        np.testing.assert_array_equal(got.per_query_hits, want.per_query_hits)
    assert planner.probe_hits(port_index._postings(), ph, pb) == \
        ref_planner.plan.probe_hits(ref_index._postings(), rh, rb)
    assert planner.probe_block_stats(port_index._postings(), ph, pb) == \
        ref_planner.probe_block_stats(ref_index._postings(), rh, rb)


def test_auto_plan_follows_calibration(corpus, ref_index, port_index,
                                       calibrated):
    _, _, queries = corpus
    _, ph, pb, _ = _plan_inputs(port_index, queries)
    s = port_index.core.sketches
    got = planner.choose_plan(port_index._postings(), ph, pb, 0.7,
                              s.num_records, s.capacity)
    assert got.path == "pruned"
    # backend="torch" takes the device route, as the reference's "jnp"
    # does: neither makes candidate sets. "numpy" takes the host route.
    recs, budget, _ = corpus
    ref_device = ref_api.get_engine("gbkmv").build(recs, budget,
                                                   backend="jnp")
    for backend, ref in (("torch", ref_device), ("numpy", ref_index)):
        port_index.backend = backend
        try:
            for t in THRESHOLDS:
                got = port_index.batch_query(queries, t)
                want = ref.batch_query(queries, t)
                assert port_index.last_plan.path == ref.last_plan.path == \
                    "pruned"
                assert port_index.last_candidate_sizes == \
                    ref.last_candidate_sizes
                assert (ref.last_candidate_sizes is None) == \
                    (backend == "torch")
                dense = port_index.batch_query(queries, t, plan="dense")
                for a, b, c in zip(got, want, dense):
                    np.testing.assert_array_equal(a, b)
                    np.testing.assert_array_equal(a, c)
        finally:
            port_index.backend = "torch"


@pytest.mark.parametrize("t", (0.0,) + THRESHOLDS)
def test_candidates_match_reference(corpus, ref_index, port_index, t):
    _, _, queries = corpus
    _, ph, pb, ps = _plan_inputs(port_index, queries)
    skipped = 0
    for qh, qb, qs in zip(ph, pb, ps):
        got = prune.candidates_for(port_index._postings(), qh, qb, t, int(qs))
        want = ref_prune.candidates_for(ref_index._postings(), qh, qb, t,
                                        int(qs))
        for f in ("rec_ids", "counts", "o1"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=f)
        for f in ("hits", "pruned", "blocks", "skipped_blocks"):
            assert getattr(got, f) == getattr(want, f), f
        skipped += got.skipped_blocks
    if t == 1.0:
        assert skipped > 0                 # the header bound did skip


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_pruned_batch_matches_reference_and_dense(corpus, ref_index,
                                                  port_index, backend):
    _, _, queries = corpus
    qp, ph, pb, ps = _plan_inputs(port_index, queries)
    port_index.backend = backend
    try:
        score_fn = port_index._pair_score_fn(qp)
        rqp, rh, rb, rs = _plan_inputs(ref_index, queries)
        ref_fn = ref_index._pair_score_fn(rqp)
        for t in THRESHOLDS + ((0.2, 0.5, 0.9, 0.4, 0.6, 0.8, 0.3, 0.7,
                                0.95, 0.1),):
            got, gc = planner.pruned_batch(port_index._postings(), ph, pb, ps,
                                           t, score_fn)
            want, wc = ref_planner.pruned_batch(ref_index._postings(), rh, rb,
                                                rs, t, ref_fn)
            dense = port_index.batch_query(queries, t, plan="dense")
            for a, b, c in zip(got, want, dense):
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(a, c)
            assert [len(c.rec_ids) for c in gc] == [len(c.rec_ids) for c in wc]
    finally:
        port_index.backend = "torch"


@pytest.mark.parametrize("chunk", [None, 3])
def test_pruned_topk_matches_reference(corpus, ref_index, port_index, chunk):
    _, _, queries = corpus
    m = port_index.num_records
    for q in queries:
        one_qp, oh, ob, osz = _plan_inputs(port_index, [q])
        ref_qp, _, _, _ = _plan_inputs(ref_index, [q])
        for k in (1, 7, 40, m + 5):
            got = planner.pruned_topk(port_index._postings(), oh[0], ob[0],
                                      int(osz[0]), k,
                                      port_index._pair_score_fn(one_qp), m,
                                      chunk=chunk)
            want = ref_planner.pruned_topk(ref_index._postings(), oh[0],
                                           ob[0], int(osz[0]), k,
                                           ref_index._pair_score_fn(ref_qp),
                                           m, chunk=chunk)
            dense = port_index.topk(q, k, plan="dense")
            for a, b, c in zip(got, want, dense):
                assert a.dtype == b.dtype == c.dtype
                np.testing.assert_array_equal(a.view(np.uint32)
                                              if a.dtype == np.float32 else a,
                                              b.view(np.uint32)
                                              if b.dtype == np.float32 else b)
                np.testing.assert_array_equal(a, c)


class _Scorer:
    """A score_fn that counts the calls and pairs it is given. With
    ``prefetch`` it asks ``pruned_topk`` for the card's path (growing
    prefixes, then the replay), which then runs here through the plain
    scorer it wraps."""

    def __init__(self, fn, prefetch: bool):
        self.fn = fn
        self.prefetch = prefetch
        self.calls = 0
        self.pairs = 0

    def __call__(self, cand_rec, cand_q):
        self.calls += 1
        self.pairs += len(cand_rec)
        return self.fn(cand_rec, cand_q)


def _zero_scores(cand_rec, _cand_q):
    return np.zeros(len(cand_rec), np.float32)


def _prefix_calls(end: int, n: int, chunk: int) -> int:
    """Calls a prefetching scorer takes to cover the first ``end`` of n
    entries: PREFIX_GROWTH chunks, then PREFIX_GROWTH× all fetched."""
    calls, got = 0, 0
    while got < end:
        got = min(n, planner.plan.PREFIX_GROWTH * max(got, chunk))
        calls += 1
    return calls


@pytest.mark.parametrize("scores", ["plain", "zeros"])
@pytest.mark.parametrize("chunk", [None, 1, 7, 64])
def test_prefetched_topk_replays_the_chunk_loop(corpus, ref_index,
                                                port_index, chunk, scores):
    """The prefetching top-k (the card's path, run here through the plain
    scorer) equals ``repro.planner.pruned_topk`` (ids, and scores bit for
    bit), and its replay consumes exactly the pairs the chunked loop
    consumes: a query with no candidates, all-zero scores, k from 1 to
    past n, and stops after the first chunk among them."""
    _, _, queries = corpus
    m = port_index.num_records
    post = port_index._postings()
    unseen = np.arange(10**6, 10**6 + 20)          # no candidate at all
    first_chunk_stops = empty = 0
    for q in queries + [unseen]:
        one_qp, oh, ob, osz = _plan_inputs(port_index, [q])
        ref_qp, _, _, _ = _plan_inputs(ref_index, [q])
        ranked, ub = planner.topk_candidates(post, oh[0], ob[0], int(osz[0]))
        n = len(ranked)
        empty += n == 0
        plain = scores == "plain"
        for k in (1, 10, n + 3):
            ref_fn = _Scorer(ref_index._pair_score_fn(ref_qp) if plain
                             else _zero_scores, False)
            want = ref_planner.pruned_topk(ref_index._postings(), oh[0],
                                           ob[0], int(osz[0]), k, ref_fn, m,
                                           chunk=chunk)
            chunked = _Scorer(port_index._pair_score_fn(one_qp) if plain
                              else _zero_scores, False)
            pre = _Scorer(port_index._pair_score_fn(one_qp) if plain
                          else _zero_scores, True)
            for fn in (chunked, pre):
                got = planner.pruned_topk(post, oh[0], ob[0], int(osz[0]), k,
                                          fn, m, chunk=chunk)
                np.testing.assert_array_equal(got[0], want[0])
                assert got[1].dtype == want[1].dtype == np.float32
                np.testing.assert_array_equal(got[1].view(np.uint32),
                                              want[1].view(np.uint32))
            kk = min(k, m)
            c = int(chunk) if chunk else max(4 * kk, 64)
            assert chunked.pairs == ref_fn.pairs
            whole = np.asarray(chunked.fn(ranked.astype(np.int32),
                                          np.zeros(n, np.int32)), np.float32)
            end = len(planner.scored_prefix(ub, kk, c,
                                            lambda lo, hi: whole[lo:hi]))
            assert end == ref_fn.pairs
            assert pre.calls == _prefix_calls(end, n, c)
            assert pre.pairs >= end
            first_chunk_stops += c == end < n
    assert empty, "a query has no candidates"
    if plain:
        assert first_chunk_stops, "some top-k stops after its first chunk"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scored_prefix_matches_the_partition_loop(seed):
    """The running k-th score is the value the reference's partition over
    everything scored gives, ties and repeated scores included, so the
    loop stops at the same chunk."""
    rng = np.random.default_rng(seed)
    n = 500
    # Scores and bounds on one grid of eighths, so that a bound often
    # equals the running k-th score: the loop goes on while it is not
    # strictly below.
    s = rng.integers(0, 12, size=n).astype(np.float32) / 8
    ub = np.sort(rng.integers(0, 16, size=n) / 8)[::-1]
    for k in (1, 5, 40, 600):
        for chunk in (1, 7, 64):
            done, kth, parts = 0, -np.inf, []
            while done < n:            # repro.planner.pruned_topk's loop
                if done >= k and ub[done] < kth:
                    break
                parts.append(s[done:done + chunk])
                done += len(parts[-1])
                if done >= k:
                    alls = np.concatenate(parts)
                    kth = float(np.partition(alls, len(alls) - k)
                                [len(alls) - k])
            got = planner.scored_prefix(ub, k, chunk,
                                        lambda lo, hi: s[lo:hi])
            np.testing.assert_array_equal(got.view(np.uint32),
                                          s[:done].view(np.uint32))


def test_pair_scorer_prefetches_only_on_a_card(corpus, port_index):
    """Off the card the scorer keeps the chunked loop (no prefetch), and
    it scores as ``score_pairs`` does."""
    _, _, queries = corpus
    qp = _plan_inputs(port_index, queries[:2])[0]
    rec = np.arange(12, dtype=np.int32)
    q = (rec % 2).astype(np.int32)
    for backend in ("torch", "numpy"):
        port_index.backend = backend
        try:
            scorer = port_index._pair_score_fn(qp)
        finally:
            port_index.backend = "torch"
        assert scorer.prefetch is False
        want = gs_mod.score_pairs(port_index._scoring_pack(), qp, rec, q,
                                  backend=backend)
        np.testing.assert_array_equal(scorer(rec, q).view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_api_planned_routes_match_reference(corpus, backend):
    recs, budget, queries = corpus
    port = api.build("gbkmv", recs, budget, backend=backend, device="cpu")
    # The port's "torch" is the reference's device backend "jnp": the
    # device route for pruned batches, with no candidate sets.
    ref = ref_api.get_engine("gbkmv").build(
        recs, budget, backend="jnp" if backend == "torch" else "numpy")
    for t in THRESHOLDS:
        for plan in ("auto", "pruned"):
            for a, b in zip(port.batch_query(queries, t, plan=plan),
                            ref.batch_query(queries, t, plan=plan)):
                np.testing.assert_array_equal(a, b)
            assert port.last_plan.path == ref.last_plan.path
            assert port.last_plan.hits == ref.last_plan.hits
            if plan == "pruned":
                assert port.last_candidate_sizes == ref.last_candidate_sizes
                assert (port.last_candidate_sizes is None) == \
                    (backend == "torch")
        np.testing.assert_array_equal(port.query(queries[0], t, plan="pruned"),
                                      ref.query(queries[0], t, plan="pruned"))
    for q in queries:
        for plan in ("auto", "pruned"):
            ids, sc = port.topk(q, 10, plan=plan)
            rids, rsc = ref.topk(q, 10, plan=plan)
            np.testing.assert_array_equal(ids, rids)
            np.testing.assert_array_equal(sc.view(np.uint32),
                                          rsc.view(np.uint32))
            assert port.last_plan.path == ref.last_plan.path
            assert port.last_plan.reason == ref.last_plan.reason
