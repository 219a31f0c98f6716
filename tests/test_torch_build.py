"""The port's index construction against the JAX reference's, column for
column (tolerance 0): the host build and the device build's plain version
against ``repro.core.gbkmv.build_gbkmv`` on its host (``None``) and
device (``"jnp"``) routes, in both τ modes, plus the host pieces."""

import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis", reason="property fuzzing needs hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from repro.core import cost_model as ref_cost  # noqa: E402
from repro.core import gbkmv as ref_gbkmv  # noqa: E402
from repro.core import gkmv as ref_gkmv  # noqa: E402
from repro.core import sketches as ref_sk  # noqa: E402
from repro.data import datasets as ref_datasets  # noqa: E402
from repro.data import synth as ref_synth  # noqa: E402
from repro.sketchindex.build import histogram_tau as ref_histogram_tau  # noqa: E402
from repro_torch.core import cost_model, gbkmv, gkmv, sketches  # noqa: E402
from repro_torch.core.hashing import to_numpy  # noqa: E402
from repro_torch.data import datasets, synth  # noqa: E402
from repro_torch.sketchindex.build import histogram_tau  # noqa: E402


def _records(seed=4, m=48):
    return synth.generate_dataset(m=m, n_elems=900, alpha_freq=1.1,
                                  alpha_size=2.0, size_min=4, size_max=30,
                                  seed=seed)


def _columns(pack):
    """Packed columns as numpy, u32 columns as uint32, from either package."""
    cols = (pack.values, pack.lengths, pack.thresh, pack.buf, pack.sizes)
    if isinstance(pack.values, torch.Tensor):
        return [to_numpy(c) if i in (0, 2, 3) else c.cpu().numpy()
                for i, c in enumerate(cols)]
    return [np.asarray(c) for c in cols]


def _assert_same_index(port, want):
    for name, a, b in zip(("values", "lengths", "thresh", "buf", "sizes"),
                          _columns(port.sketches), _columns(want.sketches)):
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=name)
    assert np.uint32(port.tau) == np.uint32(want.tau)
    np.testing.assert_array_equal(port.top_elems, want.top_elems)
    assert port.buffer_bits == want.buffer_bits and port.seed == want.seed


BUILDS = [("numpy", None), ("numpy", "jnp"), ("torch", None), ("torch", "jnp")]


@pytest.mark.parametrize("tau_mode", ["exact", "histogram"])
@pytest.mark.parametrize("port_backend,ref_backend", BUILDS)
def test_build_matches_reference(port_backend, ref_backend, tau_mode):
    recs = _records()
    budget = int(0.2 * sum(len(r) for r in recs))
    want = ref_gbkmv.build_gbkmv(recs, budget, seed=3, tau_mode=tau_mode,
                                 build_backend=ref_backend)
    got = gbkmv.build_gbkmv(recs, budget, seed=3, tau_mode=tau_mode,
                            build_backend=port_backend, device="cpu")
    _assert_same_index(got, want)
    assert got.buffer_bits > 0   # the case covers the bitmap buffer


@pytest.mark.parametrize("port_backend", ["numpy", "torch"])
@pytest.mark.parametrize("kw", [
    {"capacity": 8, "frac": 0.9},     # rows overflow the capacity
    {"r": 0, "frac": 0.3},            # no buffer
    {"r": 40, "frac": 2.0},           # budget covers every element
    {"r": 16, "frac": 0.25, "pin": True},
], ids=["capacity", "r0", "keep_all", "pinned_top"])
def test_build_options_match_reference(port_backend, kw):
    recs = _records(seed=9)
    kw = dict(kw)
    budget = int(kw.pop("frac") * sum(len(r) for r in recs))
    if kw.pop("pin", False):
        kw["top_elems"] = np.arange(5, 30, dtype=np.int64)
    want = ref_gbkmv.build_gbkmv(recs, budget, seed=1, **kw)
    got = gbkmv.build_gbkmv(recs, budget, seed=1, build_backend=port_backend,
                            device="cpu", **kw)
    _assert_same_index(got, want)


@pytest.mark.parametrize("port_backend", ["numpy", "torch"])
def test_empty_records_match_reference(port_backend):
    rng = np.random.default_rng(0)
    recs = [rng.choice(200, size=n, replace=False) if n else
            np.zeros(0, np.int64) for n in [0, 5, 0, 12, 1, 0, 30, 7]]
    for ref_backend in (None, "jnp"):
        want = ref_gbkmv.build_gbkmv(recs, 20, r=8, build_backend=ref_backend)
        got = gbkmv.build_gbkmv(recs, 20, r=8, build_backend=port_backend,
                                device="cpu")
        _assert_same_index(got, want)
    empty = [np.zeros(0, np.int64)] * 4
    _assert_same_index(
        gbkmv.build_gbkmv(empty, 10, build_backend=port_backend, device="cpu"),
        ref_gbkmv.build_gbkmv(empty, 10, build_backend="jnp"))


def test_unknown_build_options_rejected():
    recs = _records()
    with pytest.raises(ValueError):
        gbkmv.build_gbkmv(recs, 100, build_backend="jnp", device="cpu")
    with pytest.raises(ValueError):
        gbkmv.build_gbkmv(recs, 100, tau_mode="median", device="cpu")


def test_host_pieces_match_reference():
    recs = _records(seed=12)
    batch, ref_batch = (sketches.RaggedBatch.from_records(recs),
                        ref_sk.RaggedBatch.from_records(recs))
    np.testing.assert_array_equal(batch.ids, ref_batch.ids)
    np.testing.assert_array_equal(batch.offsets, ref_batch.offsets)
    uniq, counts = gbkmv.element_frequencies_csr(batch)
    ru, rc = ref_gbkmv.element_frequencies_csr(ref_batch)
    np.testing.assert_array_equal(uniq, ru)
    np.testing.assert_array_equal(counts, rc)
    for r in (0, 7, 32, 10_000):
        np.testing.assert_array_equal(
            gbkmv.choose_top_elements_csr(uniq, counts, r),
            ref_gbkmv.choose_top_elements_csr(ru, rc, r))
    budget = int(0.1 * batch.total)
    assert (cost_model.choose_buffer_size(counts, batch.sizes, budget, 48)
            == ref_cost.choose_buffer_size(rc, ref_batch.sizes, budget, 48))
    top = gbkmv.choose_top_elements_csr(uniq, counts, 40)
    np.testing.assert_array_equal(sketches.make_bitmaps(batch, top),
                                  ref_sk.make_bitmaps(ref_batch, top))
    sparse_top = np.asarray([3, 10**9, 77], np.int64)   # sorted-search path
    for a, b in zip(sketches.top_membership(batch.ids, sparse_top),
                    ref_sk.top_membership(ref_batch.ids, sparse_top)):
        np.testing.assert_array_equal(a, b)


def test_pack_csr_matches_reference():
    rng = np.random.default_rng(1)
    h = rng.integers(0, 2**32, size=400, dtype=np.uint64).astype(np.uint32)
    row = rng.integers(0, 20, size=400)
    thr = np.full(20, 2**31, np.uint32)
    sizes = rng.integers(1, 50, size=20).astype(np.int32)
    bm = rng.integers(0, 2**32, size=(20, 2), dtype=np.uint64).astype(np.uint32)
    for cap in (None, 8, 16):
        got = sketches.pack_csr(h, row, 20, thr, sizes, bitmaps=bm,
                                capacity=cap)
        want = ref_sk.pack_csr(h, row, 20, thr, sizes, bitmaps=bm,
                               capacity=cap)
        for a, b in zip(_columns(got), _columns(want)):
            np.testing.assert_array_equal(a, b)


def test_query_sketch_matches_reference():
    recs = _records(seed=5)
    budget = int(0.2 * sum(len(r) for r in recs))
    idx = gbkmv.build_gbkmv(recs, budget, build_backend="numpy", device="cpu")
    ref_idx = ref_gbkmv.build_gbkmv(recs, budget)
    queries = synth.make_query_workload(recs, 4, seed=2) + [np.zeros(0, int)]
    got = gbkmv.sketch_query_batch(idx, queries)
    want = ref_gbkmv.sketch_query_batch(ref_idx, queries)
    for a, b in zip(_columns(got), _columns(want)):
        np.testing.assert_array_equal(a, b)
    tau = np.uint32(2**31)
    for a, b in zip(_columns(gkmv.sketch_query_batch(queries, tau, seed=2)),
                    _columns(ref_gkmv.sketch_query_batch(queries, tau, seed=2))):
        np.testing.assert_array_equal(a, b)


def test_tau_selectors_match_reference():
    rng = np.random.default_rng(2)
    h = rng.integers(0, 2**32, size=3000, dtype=np.uint64).astype(np.uint32)
    for budget in (1, 500, 2999, 3000, 10_000):
        for mode in ("exact", "histogram"):
            assert (gkmv.select_tau_flat(h, budget, tau_mode=mode)
                    == ref_gkmv.select_tau_flat(h, budget, tau_mode=mode))
    rows = [h[:10], h[10:400], h[400:]]
    assert (gkmv.select_global_threshold(rows, 700)
            == ref_gkmv.select_global_threshold(rows, 700))


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 2**16), n=st.integers(1, 2000),
       frac=st.floats(0.0, 1.0), narrow=st.booleans())
def test_histogram_tau_matches_reference(seed, n, frac, narrow):
    rng = np.random.default_rng(seed)
    hi = 2**22 if narrow else 2**32      # narrow: every hash in one bin
    h = rng.integers(0, hi, size=n, dtype=np.uint64).astype(np.uint32)
    budget = max(1, int(frac * n))
    want = int(ref_histogram_tau(jnp.asarray(h), budget))
    assert int(histogram_tau(torch.from_numpy(h.astype(np.int64)), budget)) == want


def test_data_generators_match_reference():
    args = dict(m=40, n_elems=500, alpha_freq=1.14, alpha_size=4.95,
                size_min=10, size_max=120, seed=11)
    got, want = synth.generate_dataset(**args), ref_synth.generate_dataset(**args)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert all(np.array_equal(a, b) for a, b in zip(
        synth.make_query_workload(got, 9, seed=2),
        ref_synth.make_query_workload(want, 9, seed=2)))
    assert datasets.SPECS == {k: datasets.DatasetSpec(*v.__dict__.values())
                              for k, v in ref_datasets.SPECS.items()}
    small = datasets.load("NETFLIX", scale=0.01)
    assert all(np.array_equal(a, b) for a, b in zip(
        small, ref_datasets.load("NETFLIX", scale=0.01)))
