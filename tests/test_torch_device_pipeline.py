"""The port's device pruned pipeline against ``repro``'s, on CPU tensors.

The plain versions of the probe (B3) and of the block decode (B4) against
the reference's jnp twins and its Pallas kernels in interpret mode; the
K∩ counts against the reference planner's merge counts; the pipeline's
score matrix, packed hit words and top-k against the reference's fused
device pipeline at ``backend="jnp"`` and against the dense sweep; the
device encode of the tail postings against the reference's and the host
build; the api's planned routes; and the staging pool. Tolerance 0
throughout: ids, counts, words and score bits are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.data.synth import generate_dataset, make_query_workload
from repro.kernels import hash_threshold as ref_ht
from repro.kernels import postings_merge as ref_pm
from repro.planner import device as ref_device
from repro.planner import prune as ref_prune
from repro_torch import api
from repro_torch.core.hashing import PAD, to_numpy, to_tensor
from repro_torch.kernels import postings_merge as pm, ref
from repro_torch.kernels.hash_threshold import fused_encode_postings
from repro_torch.planner import device as pd
from repro_torch.planner import postings as P

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def corpus():
    recs = generate_dataset(m=300, n_elems=3000, alpha_freq=1.05,
                            alpha_size=1.8, size_min=4, size_max=80, seed=7)
    total = sum(len(r) for r in recs)
    queries = make_query_workload(recs, 5, seed=1)
    rng = np.random.default_rng(3)
    queries += [rng.choice(3000, size=s, replace=False) for s in (6, 40)]
    queries += [np.arange(5000, 5004)]       # shares nothing: PAD hashes
    return recs, int(total * 0.12), queries


def dense_corpus():
    """The reference's recipe (tests/test_device_pipeline.py): tiny records
    sharing near-ubiquitous small elements kept in the tail, so their
    posting lists run over consecutive ids and encode as bitmap blocks."""
    rng = np.random.default_rng(7)
    recs = []
    for _ in range(600):
        base = rng.choice(3000, size=rng.integers(2, 5), replace=False) + 100
        common = [c for c in range(10) if rng.random() < 0.85]
        recs.append(np.unique(np.concatenate([common, base]).astype(np.int64)))
    return recs


def _pair(recs, budget, **kw):
    """(port index on CPU, reference index at backend="jnp"), both with
    eager postings."""
    port = api.build("gbkmv", recs, budget, device="cpu", postings="eager",
                     **kw)
    refi = ref_api.get_engine("gbkmv").build(recs, budget, backend="jnp",
                                             postings="eager", **kw)
    return port, refi


@pytest.fixture(scope="module")
def indexes(corpus):
    recs, budget, _ = corpus
    return _pair(recs, budget)


@pytest.fixture(scope="module")
def dense_indexes():
    return _pair(dense_corpus(), 20_000, r=2)


def _words(a):
    return np.asarray(a, np.uint32)


# ---------------------------------------------------------------------------
# B3: the probe's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("u", [0, 1, 700])
def test_probe_ref_matches_reference(u):
    rng = np.random.default_rng(u)
    keys = np.unique(rng.integers(1000, 2**32 - 1000, size=u,
                                  dtype=np.uint64)).astype(np.uint32)
    q = rng.integers(0, 2**32, size=300, dtype=np.uint64).astype(np.uint32)
    extra = [0, 999, 2**32 - 2, PAD, PAD]          # below, above, PAD twice
    if u:
        extra += [keys[0], keys[-1], keys[u // 2], keys[u // 2],
                  keys[0] - 1, keys[-1] + 1]
    q = np.concatenate([q, np.asarray(extra, np.uint32)])
    pos, hit = ref.postings_probe_ref(to_tensor(keys), to_tensor(q))
    assert pos.dtype == torch.int32 and hit.dtype == torch.bool
    want = ref_pm._probe_jnp(jnp.asarray(keys), jnp.asarray(q))
    forms = [want]
    if u:
        forms.append(ref_pm._probe_pallas(jnp.asarray(keys), jnp.asarray(q),
                                          interpret=True))
    for wpos, whit in forms:
        np.testing.assert_array_equal(pos.numpy(), np.asarray(wpos))
        np.testing.assert_array_equal(hit.numpy(), np.asarray(whit))
    assert not hit[-5 - (6 if u else 0):][3:5].any()     # PAD never hits


def _reference_cum(keys, pos, hit, row_blocks):
    """The block-task prefix as the reference's ``_pipeline_scores`` forms
    it after the probe (src/repro/kernels/postings_merge.py)."""
    u = keys.shape[0]
    pos_c = jnp.clip(pos, 0, max(u - 1, 0))
    if u:
        rs = jnp.where(hit, row_blocks[pos_c], 0)
        re = jnp.where(hit, row_blocks[pos_c + 1], 0)
    else:
        rs = jnp.zeros(pos.shape, jnp.int32)
        re = rs
    return jnp.cumsum(re - rs)


@pytest.mark.parametrize("n", [0, 311])
@pytest.mark.parametrize("u", [0, 1, 700])
def test_probe_tasks_ref_matches_reference(u, n):
    rng = np.random.default_rng(u + 10 * n)
    keys = np.unique(rng.integers(1000, 2**32 - 1000, size=u,
                                  dtype=np.uint64)).astype(np.uint32)
    row_blocks = np.concatenate([[0], np.cumsum(
        rng.integers(1, 4, size=u))]).astype(np.int32)
    q = rng.integers(0, 2**32, size=max(n - 8, 0),
                     dtype=np.uint64).astype(np.uint32)
    if n:
        extra = [0, PAD, PAD, 2**32 - 2]
        extra += [keys[0], keys[-1], keys[u // 2], keys[u // 2]] if u \
            else [1, 2, 3, 4]
        q = np.concatenate([q, np.asarray(extra, np.uint32)])
    assert q.shape[0] == n
    pos, hit, cum = ref.probe_tasks_ref(to_tensor(keys), to_tensor(q),
                                        torch.from_numpy(row_blocks))
    assert cum.dtype == torch.int32 and cum.shape == (n,)
    wpos, whit = ref_pm._probe_jnp(jnp.asarray(keys), jnp.asarray(q))
    forms = [(wpos, whit)]
    if u and n:
        forms.append(ref_pm._probe_pallas(jnp.asarray(keys), jnp.asarray(q),
                                          interpret=True))
    for fpos, fhit in forms:
        np.testing.assert_array_equal(pos.numpy(), np.asarray(fpos))
        np.testing.assert_array_equal(hit.numpy(), np.asarray(fhit))
    want = _reference_cum(jnp.asarray(keys), wpos, whit,
                          jnp.asarray(row_blocks))
    np.testing.assert_array_equal(cum.numpy(), np.asarray(want))
    if u and n:
        assert int(cum[-1]) > 0          # the repeated keys own blocks
    # The wrapper takes the plain version on CPU tensors and launches
    # nothing; a row_blocks of the wrong length raises.
    before = pm.postings_probe.launches
    got = pm.probe_tasks(to_tensor(keys), to_tensor(q),
                         torch.from_numpy(row_blocks))
    assert all(torch.equal(a, b) for a, b in zip(got, (pos, hit, cum)))
    assert pm.postings_probe.launches == before
    with pytest.raises(ValueError):
        pm.probe_tasks(to_tensor(keys), to_tensor(q),
                       torch.from_numpy(row_blocks[:-1]).contiguous())


# ---------------------------------------------------------------------------
# B4: the decode's plain versions and the K∩ counts
# ---------------------------------------------------------------------------


def _synthetic_store():
    """A tail store of hand-made rows: one-entry blocks, a row of repeated
    ids (bw = 0), a 31-bit delta, widths that straddle words (7, 13, 25),
    a 300-entry row (three blocks) and a dense run."""
    rows = [np.asarray([5]), np.asarray([7, 7, 7, 7]),
            np.asarray([1, 2, 3, 3 + 2**30, 4 + 2**30 + 5]),
            np.cumsum(np.full(40, 100)), np.cumsum(np.full(90, 5000)),
            np.cumsum(np.arange(1, 61) % 7 + 2**24),
            np.cumsum(np.arange(300) % 3),
            40 + np.cumsum(1 + (np.arange(160) % 4 == 0))]
    offsets = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    return P.encode_store(offsets, np.concatenate(rows).astype(np.int32))


def _sparse_tasks(store):
    meta = store.meta.astype(np.int64)
    sel = np.nonzero(((meta >> 13) & 1) == 0)[0]
    return (store.first[sel].astype(np.int32),
            store.off[sel].astype(np.int32),
            ((meta[sel] >> 8) & 0x1F).astype(np.int32),
            ((meta[sel] & 0x7F) + 1).astype(np.int32))


def test_decode_sparse_ref_matches_reference():
    store = _synthetic_store()
    first, off, bw, cnt = _sparse_tasks(store)
    assert {0, 31}.issubset(set(bw.tolist())) and 1 in set(cnt.tolist())
    pay = np.concatenate([store.payload,
                          np.zeros(ref.DECODE_WINDOW, np.uint32)])
    got = ref.decode_sparse_ref(*(torch.from_numpy(a) for a in
                                  (first, off, bw, cnt)), to_tensor(pay))
    args = [jnp.asarray(a) for a in (first, off, bw, cnt)] + [jnp.asarray(pay)]
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref_pm._decode_sparse_jnp(*args)))
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(ref_pm._decode_sparse_pallas(*args, interpret=True)))
    # And the decoded entries are the ids that were encoded.
    ids, counts = P.decode_blocks(store, np.nonzero(
        ((store.meta >> 13) & 1) == 0)[0])
    lanes = np.arange(128)[None, :] < counts[:, None]
    np.testing.assert_array_equal(got.numpy()[lanes], ids)


def test_decode_dense_ref_matches_reference(dense_indexes):
    port, _ = dense_indexes
    tail = port._postings().tail
    meta = tail.meta.astype(np.int64)
    sel = np.nonzero((meta >> 13) & 1)[0]
    assert len(sel) > 1
    first = np.concatenate([tail.first[sel], [123]]).astype(np.int32)
    off = np.concatenate([tail.off[sel], [tail.off[-1]]]).astype(np.int32)
    wcnt = np.concatenate([tail.off[sel + 1] - tail.off[sel], [0]]) \
        .astype(np.int32)                           # plus a zero-word task
    pay = np.concatenate([tail.payload, np.zeros(128, np.uint32)])
    m = port.num_records
    got = ref.decode_dense_ref(torch.from_numpy(first), torch.from_numpy(off),
                               torch.from_numpy(wcnt), to_tensor(pay), m=m)
    want = ref_pm._decode_dense_jnp(jnp.asarray(first), jnp.asarray(off),
                                    jnp.asarray(wcnt), jnp.asarray(pay), m=m)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[-1] == m).all()


def _merge_counts(refi, queries, m):
    """K∩ per (record, query) from the reference planner's host merge."""
    qp, hrows, brows, sizes = refi._plan_queries(queries)
    want = np.zeros((m, len(queries)), np.int32)
    for g, (qh, qb, qs) in enumerate(zip(hrows, brows, sizes)):
        c = ref_prune.candidates_for(refi._postings(), qh, qb, 0.0, int(qs))
        want[c.rec_ids, g] = c.counts
    return want


@pytest.mark.parametrize("which", ["corpus", "dense"])
def test_kcount_ref_matches_reference_merge(which, corpus, indexes,
                                            dense_indexes):
    port, refi = indexes if which == "corpus" else dense_indexes
    queries = corpus[2] if which == "corpus" else \
        [r[: max(2, len(r) // 2)] for r in dense_corpus()[:6]]
    arena = port.core.sketches
    dpost = arena.device_postings(CPU)
    assert dpost.has_dense == (which == "dense")
    qp, _, _, _ = port._plan_queries(queries)
    gq, cq = qp.values.shape
    pos, hit = pm.postings_probe(dpost.keys, qp.values.reshape(-1))
    got = pm.block_decode(pos, hit, dpost.row_blocks, dpost.first,
                          dpost.meta, dpost.off, dpost.payload, gq=gq, cq=cq,
                          m=port.num_records)
    assert got.dtype == torch.int32
    want = _merge_counts(refi, queries, port.num_records)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0


@pytest.mark.parametrize("gq", [1, 3, 17])
def test_block_decode_matches_reference_merge_at_odd_lane_counts(
        gq, corpus, indexes):
    # Gq queries cut from the corpus queries from the third on (the first
    # to share tail hashes with many records; taken again from the start
    # past their end): n = Gq · Cq lanes, not a multiple of 32.
    port, refi = indexes
    qs = corpus[2]
    queries = [qs[(2 + i) % len(qs)] for i in range(gq)]
    dpost = port.core.sketches.device_postings(CPU)
    qp, _, _, _ = port._plan_queries(queries)
    cq = qp.values.shape[1]
    assert qp.values.shape[0] == gq and (gq * cq) % 32 != 0
    pos, hit, cum = pm.probe_tasks(dpost.keys, qp.values.reshape(-1),
                                   dpost.row_blocks)
    got = pm.block_decode(pos, hit, dpost.row_blocks, dpost.first,
                          dpost.meta, dpost.off, dpost.payload, gq=gq, cq=cq,
                          m=port.num_records, cum=cum)
    assert got.dtype == torch.int32 and got.shape == (port.num_records, gq)
    want = _merge_counts(refi, queries, port.num_records)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0


@pytest.mark.parametrize("which", ["corpus", "dense"])
def test_block_decode_takes_the_probe_prefix(which, corpus, indexes,
                                             dense_indexes):
    port, refi = indexes if which == "corpus" else dense_indexes
    queries = corpus[2] if which == "corpus" else \
        [r[: max(2, len(r) // 2)] for r in dense_corpus()[:6]]
    dpost = port.core.sketches.device_postings(CPU)
    qp, _, _, _ = port._plan_queries(queries)
    gq, cq = qp.values.shape
    pos, hit, cum = pm.probe_tasks(dpost.keys, qp.values.reshape(-1),
                                   dpost.row_blocks)
    blocks = (dpost.row_blocks, dpost.first, dpost.meta, dpost.off,
              dpost.payload)
    got = pm.block_decode(pos, hit, *blocks, gq=gq, cq=cq,
                          m=port.num_records, cum=cum)
    np.testing.assert_array_equal(
        got.numpy(), pm.block_decode(pos, hit, *blocks, gq=gq, cq=cq,
                                     m=port.num_records).numpy())
    np.testing.assert_array_equal(
        got.numpy(), _merge_counts(refi, queries, port.num_records))
    with pytest.raises(ValueError):
        pm.block_decode(pos, hit, *blocks, gq=gq, cq=cq, m=port.num_records,
                        cum=cum[:-1])


# ---------------------------------------------------------------------------
# The pipeline against the reference's and the dense sweep
# ---------------------------------------------------------------------------


def _staged(port, refi, queries, thr=None):
    qp, _, _, _ = port._plan_queries(queries)
    rqp, _, _, _ = refi._plan_queries(queries)
    mine = pd.stage_query_inputs(port.core.sketches, qp, thr, device=CPU)
    theirs = ref_device.stage_query_inputs(refi._sketch_pack(), rqp, thr)
    return mine, theirs


@pytest.mark.parametrize("which", ["corpus", "dense"])
def test_fused_scores_match_reference_and_dense(which, corpus, indexes,
                                                dense_indexes):
    port, refi = indexes if which == "corpus" else dense_indexes
    queries = corpus[2] if which == "corpus" else \
        [r[: max(2, len(r) // 2)] for r in dense_corpus()[:6]]
    mine, theirs = _staged(port, refi, queries)
    got = pd.pruned_scores(*mine).numpy()
    want = np.asarray(ref_device.pruned_scores(
        *theirs, m=port.num_records, backend="jnp"))[:, : len(queries)]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    dense = port.batch_scores(queries)
    np.testing.assert_array_equal(got.view(np.uint32), dense.view(np.uint32))


def test_pipeline_scores_equal_dense_past_one_tile(corpus, indexes):
    """More query-hash lanes than the probe kernel's CTA width (1,024):
    probe_tasks then block_decode with its prefix, bit-equal to the dense
    sweep."""
    port, _ = indexes
    queries = list(corpus[0][:100])
    qp, _, _, _ = port._plan_queries(queries)
    assert qp.values.numel() > 1024
    staged = pd.stage_query_inputs(port.core.sketches, qp, device=CPU)
    got = pd.pruned_scores(*staged).numpy()
    dense = port.batch_scores(queries)
    np.testing.assert_array_equal(got.view(np.uint32), dense.view(np.uint32))


@pytest.mark.parametrize("thr", [0.5, "vector"])
def test_hit_words_match_reference(thr, corpus, indexes):
    port, refi = indexes
    queries = corpus[2]
    t = np.linspace(0.2, 0.9, len(queries)) if thr == "vector" else thr
    mine, theirs = _staged(port, refi, queries, t)
    m = port.num_records
    got = to_numpy(pd.fused_mask_words(*mine))
    want = _words(ref_device.fused_mask_words(*theirs, m=m, backend="jnp"))
    np.testing.assert_array_equal(got, want[:, : len(queries)])
    hits = ref_prune.mask_to_hits(pd.unpack_hit_words(got, m))
    tt = np.broadcast_to(np.asarray(t, np.float64), (len(queries),))
    for g, (q, tg) in enumerate(zip(queries, tt)):
        np.testing.assert_array_equal(
            hits[g], port.batch_query([q], float(tg), plan="dense")[0])


@pytest.mark.parametrize("k", [1, 9, 700])
def test_topk_matches_reference(k, corpus, indexes):
    port, refi = indexes
    queries = corpus[2]
    qp, _, _, _ = port._plan_queries(queries)
    rqp, _, _, _ = refi._plan_queries(queries)
    got = pd.pruned_topk_device(port.core.sketches, qp, k, device=CPU)
    want = ref_device.pruned_topk_device(refi._sketch_pack(), rqp, k,
                                         backend="jnp")
    for (gi, gs), (wi, ws), q in zip(got, want, queries):
        assert gi.dtype == np.int64 and gs.dtype == np.float32
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gs.view(np.uint32), ws.view(np.uint32))
        di, ds = port.topk(q, k, plan="dense")
        np.testing.assert_array_equal(gi, di)
        np.testing.assert_array_equal(gs.view(np.uint32), ds.view(np.uint32))


def test_empty_tail_postings_leave_only_o1():
    """Every element is a buffer bit (r = 32 over 20 elements): the tail
    has no keys and no blocks, so the scores are the o1 base."""
    rng = np.random.default_rng(5)
    recs = [np.sort(rng.choice(20, size=6, replace=False)) for _ in range(40)]
    port, refi = _pair(recs, 400, r=32)
    dpost = port.core.sketches.device_postings(CPU)
    assert dpost.keys.numel() == 0 and dpost.first.numel() == 0
    queries = [recs[0], recs[7][:3], np.arange(30, 34)]
    mine, theirs = _staged(port, refi, queries)
    got = pd.pruned_scores(*mine).numpy()
    want = np.asarray(ref_device.pruned_scores(
        *theirs, m=40, backend="jnp"))[:, :3]
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(got, port.batch_scores(queries))
    for t in (0.3, 0.9):
        for a, b in zip(port.batch_query(queries, t, plan="pruned"),
                        refi.batch_query(queries, t, plan="pruned")):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The device encode and the mirror
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["corpus", "dense"])
def test_device_encode_matches_reference(which, indexes, dense_indexes):
    port, refi = indexes if which == "corpus" else dense_indexes
    arena = port.core.sketches
    m, cap = arena.num_records, arena.capacity
    got = fused_encode_postings(arena.values, arena.lengths, m=m, cap=cap)
    rs = refi._sketch_pack()
    want = ref_ht.fused_encode_postings(np.asarray(rs.values),
                                        np.asarray(rs.lengths), m=m, cap=cap)
    for name in ("keys", "meta", "payload"):
        np.testing.assert_array_equal(to_numpy(got[name]),
                                      np.asarray(want[name]), err_msg=name)
    for name in ("row_blocks", "first", "last", "off"):
        assert got[name].dtype == torch.int32
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    # Through the api's eager build: the installed postings equal the host
    # build's, and the adopted mirror equals one made from them.
    post, dpost = P.build_postings_device(arena)
    host = P.build_postings(arena)
    assert P.postings_equal(post, host) and P.postings_equal(port._postings(),
                                                             host)
    assert P.postings_equal(port._postings(), refi._postings())
    mirror = type(dpost).from_postings(host, CPU)
    for a, b in zip(arena._dev_post.arrays(), mirror.arrays()):
        assert torch.equal(a, b)
    assert arena._dev_post.has_dense == mirror.has_dense == (which == "dense")
    rmirror = refi._sketch_pack().device_postings()
    for a, b in zip(mirror.arrays(), (rmirror.keys, rmirror.row_blocks,
                                      rmirror.first, rmirror.meta,
                                      rmirror.off, rmirror.payload)):
        np.testing.assert_array_equal(a.numpy().view(np.asarray(b).dtype)
                                      if np.asarray(b).dtype == np.uint32
                                      else a.numpy(), np.asarray(b))


def test_mirror_lifecycle_and_bytes(corpus):
    recs, budget, _ = corpus
    idx = api.build("gbkmv", recs, budget, device="cpu")
    arena = idx.core.sketches
    base = arena.nbytes()
    dpost = arena.device_postings(CPU)
    assert arena.device_postings(CPU) is dpost           # resident
    assert arena.nbytes() == base + arena._post.nbytes() + dpost.nbytes()
    arena.install_postings(arena._post)
    assert arena._dev_post is None                       # dropped
    arena.device_postings(CPU)
    arena.clear_postings()
    assert arena._dev_post is None and arena.nbytes() == base


# ---------------------------------------------------------------------------
# The api's planned routes and the staging pool
# ---------------------------------------------------------------------------


def test_api_pruned_routes_match_reference(corpus, indexes):
    port, refi = indexes
    queries = corpus[2]
    for t in (0.3, 0.7, 1.0):
        for plan in ("auto", "pruned"):
            got = port.batch_query(queries, t, plan=plan)
            want = refi.batch_query(queries, t, plan=plan)
            assert port.last_plan.path == refi.last_plan.path
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
            if port.last_plan.path == "pruned":
                assert port.last_candidate_sizes is None
                assert refi.last_candidate_sizes is None
    for q in queries[:4]:
        for plan in ("auto", "pruned"):
            gi, gs = port.topk(q, 10, plan=plan)
            wi, ws = refi.topk(q, 10, plan=plan)
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gs.view(np.uint32),
                                          ws.view(np.uint32))


def test_staging_pool_reuses_one_buffer_per_shape(corpus, indexes):
    port, _ = indexes
    queries = corpus[2]
    pd.reset_pipeline_stats()
    for lo in (0, 1, 2):
        port.batch_query(queries[lo:lo + 4], 0.5, plan="pruned")
    st = pd.pipeline_stats()
    assert st["calls"] == 3
    assert st["staging_alloc"] == 1 and st["staging_reuse"] == 2
    assert st["staging_buffers"] == 1
    # A larger batch replaces the blob; a smaller one takes a prefix of it.
    port.batch_query(queries[:5], 0.5, plan="pruned")
    st = pd.pipeline_stats()
    assert st["staging_buffers"] == 1 and st["staging_alloc"] == 2
    got = port.batch_query(queries[:3], 0.5, plan="pruned")
    st = pd.pipeline_stats()
    assert st["staging_buffers"] == 1 and st["staging_alloc"] == 2
    assert st["staging_reuse"] == 3
    want = port.batch_query(queries[:3], 0.5, plan="dense")
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
