"""The port's block postings against ``repro.planner.postings``: encode,
decode and build give the reference's arrays, array for array; the arena
builds them lazily or eagerly and counts their bytes; index files carry
them across the two packages both ways."""

import numpy as np
import pytest

from repro import api as ref_api
from repro.data.synth import generate_dataset, make_query_workload
from repro.planner import postings as RP
from repro_torch import api
from repro_torch.core import gbkmv
from repro_torch.planner import postings as P

STORE_FIELDS = ("row_blocks", "first", "last", "meta", "off", "payload")


def _random_csr(rng, nrows_max=14, len_max=350):
    """Random flat CSR: per-row sorted ids, mixed shapes — one-entry rows,
    duplicate ids (which force sparse blocks), dense runs (which pick
    bitmap blocks), wide-spread ids and empty rows."""
    rows = []
    for _ in range(int(rng.integers(1, nrows_max))):
        n = int(rng.integers(0, len_max))
        style = int(rng.integers(0, 5))
        if style == 0:
            ids = np.sort(rng.integers(0, 8000, size=n))          # dups ok
        elif style == 1:                                          # dense run
            ids = (np.sort(rng.choice(2 * n + 1, size=n, replace=False))
                   + int(rng.integers(0, 64)))
        elif style == 2:
            ids = np.sort(rng.choice(2**30, size=n, replace=False))
        elif style == 3:
            ids = np.sort(rng.integers(0, 40, size=n))            # heavy dups
        else:
            ids = rng.integers(0, 5000, size=min(n, 1))           # one entry
        rows.append(ids.astype(np.int64))
    offsets = np.concatenate(
        [[0], np.cumsum([len(r) for r in rows])]).astype(np.int64)
    rec = (np.concatenate(rows).astype(np.int32)
           if offsets[-1] else np.zeros(0, np.int32))
    return offsets, rec


def _assert_store_equal(got, want):
    for f in STORE_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _assert_postings_equal(got, want):
    """Port postings against reference postings, array for array."""
    assert got.num_records == want.num_records
    assert np.uint32(got.tau) == np.uint32(want.tau)
    np.testing.assert_array_equal(got.keys, want.keys)
    assert got.keys.dtype == want.keys.dtype == np.uint32
    _assert_store_equal(got.tail, want.tail)
    _assert_store_equal(got.buf, want.buf)


@pytest.mark.parametrize("seed", range(6))
def test_encode_store_matches_reference(seed):
    rng = np.random.default_rng(seed)
    kinds = set()
    for _ in range(20):
        offsets, rec = _random_csr(rng)
        got, want = P.encode_store(offsets, rec), RP.encode_store(offsets, rec)
        _assert_store_equal(got, want)
        kinds.update(((got.meta >> np.uint32(13)) & 1).tolist())
        np.testing.assert_array_equal(got.row_lengths(), np.diff(offsets))
        off2, rec2 = P.decode_store(got)
        np.testing.assert_array_equal(off2, offsets)
        np.testing.assert_array_equal(rec2, rec)
    assert kinds == {0, 1}                 # both block bodies were chosen


def test_encode_store_block_kinds():
    # A one-entry block, duplicates (sparse only), a dense run (bitmap).
    rows = [np.asarray([7]), np.repeat(np.arange(100), 2),
            300 + np.flatnonzero(np.arange(384) % 3 != 1)]
    offsets = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    rec = np.concatenate(rows)
    got = P.encode_store(offsets, rec)
    _assert_store_equal(got, RP.encode_store(offsets, rec))
    kind = (got.meta >> np.uint32(13)) & 1
    cnt = got.counts()
    assert cnt[0] == 1 and kind[0] == 0
    assert not kind[got.row_blocks[1]:got.row_blocks[2]].any()
    assert kind[got.row_blocks[2]:].all()
    empty = np.zeros(3, np.int64)
    _assert_store_equal(P.encode_store(empty, np.zeros(0, np.int32)),
                        RP.encode_store(empty, np.zeros(0, np.int32)))


@pytest.mark.parametrize("seed", range(3))
def test_decode_blocks_with_repeats_matches_reference(seed):
    rng = np.random.default_rng(10 + seed)
    offsets, rec = _random_csr(rng, nrows_max=20)
    got_store = P.encode_store(offsets, rec)
    want_store = RP.encode_store(offsets, rec)
    nb = got_store.num_blocks
    blks = np.concatenate([rng.integers(0, nb, size=3 * nb),
                           np.arange(nb)[::-1], [0, 0]]) if nb else []
    ids, cnt = P.decode_blocks(got_store, blks)
    wids, wcnt = RP.decode_blocks(want_store, blks)
    np.testing.assert_array_equal(ids, wids)
    np.testing.assert_array_equal(cnt, wcnt)
    assert ids.dtype == wids.dtype and cnt.dtype == wcnt.dtype


@pytest.fixture(scope="module")
def corpus():
    recs = generate_dataset(m=300, n_elems=2500, alpha_freq=1.1,
                            alpha_size=2.0, size_min=4, size_max=60, seed=5)
    budget = int(0.15 * sum(len(r) for r in recs))
    return recs, budget, make_query_workload(recs, 6, seed=3)


@pytest.mark.parametrize("build_backend", ["numpy", "torch"])
def test_build_postings_matches_reference(corpus, build_backend):
    recs, budget, _ = corpus
    port = gbkmv.build_gbkmv(recs, budget, build_backend=build_backend,
                             device="cpu")
    ref = ref_api.get_engine("gbkmv").build(recs, budget, backend="numpy")
    want = RP.build_postings(ref.core.sketches)
    got = P.build_postings(port.sketches)
    _assert_postings_equal(got, want)
    assert P.postings_equal(got, got) and got.nbytes() == want.nbytes()
    offsets, rec_ids = P.decode_store(got.tail)
    np.testing.assert_array_equal(rec_ids, want.rec_ids)
    np.testing.assert_array_equal(offsets, want.offsets)
    buf_offsets, buf_rec_ids = P.decode_store(got.buf)
    np.testing.assert_array_equal(buf_rec_ids, want.buf_rec_ids)
    np.testing.assert_array_equal(buf_offsets, want.buf_offsets)
    np.testing.assert_array_equal(got.tail_row_lengths(),
                                  want.tail_row_lengths())
    np.testing.assert_array_equal(got.buf_row_lengths(),
                                  want.buf_row_lengths())


def test_from_flat_and_equality(corpus):
    recs, budget, _ = corpus
    port = gbkmv.build_gbkmv(recs, budget, device="cpu")
    post = P.build_postings(port.sketches)
    flat = (post.keys, *P.decode_store(post.tail), *P.decode_store(post.buf),
            post.num_records, post.tau)
    again = P.from_flat(*flat)
    assert P.postings_equal(again, post)
    _assert_postings_equal(again, RP.from_flat(*flat))
    other = P.build_postings(gbkmv.build_gbkmv(recs[:-1], budget,
                                               device="cpu").sketches)
    assert not P.postings_equal(other, post)


def test_arena_postings_lazy_eager_and_bytes(corpus):
    recs, budget, queries = corpus
    lazy = api.build("gbkmv", recs, budget, device="cpu")
    arena = lazy.core.sketches
    assert arena._post is None
    assert lazy.nbytes() == arena.sketch_nbytes()
    lazy.batch_query(queries, 0.6, plan="pruned")       # builds them
    post = arena._post
    assert post is not None and arena.postings() is post
    assert arena.postings_nbytes() == post.nbytes() > 0
    # The device route also mirrors the tail store, which nbytes counts.
    assert lazy.nbytes() == (arena.sketch_nbytes() + post.nbytes()
                             + arena._dev_post.nbytes())

    eager = api.build("gbkmv", recs, budget, device="cpu", postings="eager")
    assert eager.core.sketches._post is not None
    assert P.postings_equal(eager.core.sketches._post, post)
    arena.clear_postings()
    assert arena._post is None and lazy.nbytes() == arena.sketch_nbytes()
    arena.install_postings(post)
    assert arena.postings() is post


def test_reference_file_with_postings_loads_in_port(corpus, tmp_path):
    recs, budget, queries = corpus
    ref = ref_api.get_engine("gbkmv").build(recs, budget, backend="numpy",
                                            postings="eager")
    path = str(tmp_path / "ref.npz")
    ref.save(path)
    port = api.load_index(path, device="cpu")
    got = port.core.sketches._post
    assert got is not None
    _assert_postings_equal(got, ref.core.sketches._post)
    for t in (0.4, 0.8):
        for a, b in zip(port.batch_query(queries, t, plan="pruned"),
                        ref.batch_query(queries, t, plan="pruned")):
            np.testing.assert_array_equal(a, b)


def test_port_file_with_postings_loads_in_reference(corpus, tmp_path):
    recs, budget, queries = corpus
    port = api.build("gbkmv", recs, budget, device="cpu", postings="eager")
    path = str(tmp_path / "port.npz")
    port.save(path)
    with np.load(path) as f:
        assert "post_blk_payload" in f.files and "post_buf_blk_meta" in f.files
    ref = ref_api.load_index(path)
    want = ref.core.sketches._post
    assert want is not None
    _assert_postings_equal(port.core.sketches._post, want)
    again = api.load_index(path, device="cpu")
    assert P.postings_equal(again.core.sketches._post, port.core.sketches._post)
    for a, b in zip(again.batch_query(queries, 0.5, plan="pruned"),
                    ref.batch_query(queries, 0.5, plan="pruned")):
        np.testing.assert_array_equal(a, b)


def test_version2_flat_postings_load(corpus, tmp_path):
    """A file with flat-CSR postings keys (format version 2) loads with
    the postings encoded into blocks on load."""
    recs, budget, _ = corpus
    port = api.build("gbkmv", recs, budget, device="cpu", postings="eager")
    post = port.core.sketches._post
    d = api.index_to_arrays(port)
    for k in [k for k in d if k.startswith("post_")]:
        del d[k]
    offsets, rec_ids = P.decode_store(post.tail)
    buf_offsets, buf_rec_ids = P.decode_store(post.buf)
    d.update(arena_version=np.int64(2), post_keys=post.keys,
             post_tau=np.uint32(post.tau), post_offsets=offsets,
             post_rec_ids=rec_ids, post_buf_offsets=buf_offsets,
             post_buf_rec_ids=buf_rec_ids)
    path = str(tmp_path / "v2.npz")
    np.savez(path, engine="gbkmv", **d)
    back = api.load_index(path, device="cpu")
    assert P.postings_equal(back.core.sketches._post, post)
    ref = ref_api.load_index(path)
    _assert_postings_equal(back.core.sketches._post, ref.core.sketches._post)
