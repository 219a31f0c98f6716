"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor ``repro``, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q

Tolerance 0 for B1-B5: the kernels must give the plain versions' bits.
B6 (flash attention) sums in another order than its plain version: 2e-5
in f32 and 2e-2 in bf16, the tolerances of tests/test_flash_kernel.py; in
bf16 also a relative RMS error of at most 2**-10 (the limit of
chip_smoke.py), which one bf16 rounding of the probabilities would exceed.
"""

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import gbkmv, gkmv, kmv
from repro_torch.core.arena import DevicePostings
from repro_torch.core.hashing import (PAD, as_u64, seed_offset, to_numpy,
                                      to_tensor)
from repro_torch.data.synth import generate_dataset, make_query_workload
from repro_torch.kernels import gather_score as gs_mod
from repro_torch.kernels import gbkmv_score as score_mod, library, ops, ref
from repro_torch.kernels import postings_merge as pm
from repro_torch.kernels.flash_attention import body_launches, flash_attention
from repro_torch.kernels.hash_threshold import hash_threshold
from repro_torch.planner import device as planner_device
from repro_torch.planner import pruned_topk as planner_topk
from repro_torch.planner import topk_candidates as planner_candidates
from repro_torch.planner import postings as P

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rows(rng, m, c, hi, full=False):
    values = np.full((m, c), PAD, np.uint32)
    for i, n in enumerate(rng.integers(c if full else 0, c + 1, size=m)):
        v = np.unique(rng.integers(0, hi, size=2 * int(n) + 1,
                                   dtype=np.uint64).astype(np.uint32))[:n]
        values[i, : len(v)] = v
    return values


def _thresholds(rng, rows, hi, mode):
    """Per-row thresholds: "random" draws, "row_values" one of the row's own
    values, "below" a global τ = hi / 2 with every third row's at or under
    one of its values below τ (a row that overflowed its capacity)."""
    if mode == "random":
        return np.minimum(rng.integers(0, hi + 8, size=len(rows)), PAD - 1)
    lengths = (rows != PAD).sum(1)
    pick = np.asarray([r[rng.integers(n)] if n else rng.integers(0, hi)
                       for r, n in zip(rows, lengths)], np.int64)
    if mode == "row_values":
        return pick
    t = np.full(len(rows), hi // 2, np.int64)
    cut = np.arange(len(rows)) % 3 == 0
    t[cut] = np.minimum(hi // 2, pick[cut])
    return t


def _score_inputs(seed, m, c, gq, cq, w, hi, device, full=False,
                  thr="random"):
    rng = np.random.default_rng(seed)
    xv = _rows(rng, m, c, hi, full)
    xt = _thresholds(rng, xv, hi, thr)
    xb = rng.integers(0, 2**32, size=(m, w), dtype=np.uint64)
    qv = _rows(rng, gq, cq, hi, full)
    cols = [xv, xt, xb, qv, _thresholds(rng, qv, hi, thr),
            rng.integers(0, 2**32, size=(gq, w), dtype=np.uint64)]
    out = [to_tensor(np.asarray(a).astype(np.uint32)) for a in cols]
    out.append(torch.from_numpy(rng.integers(0, 60, size=gq).astype(np.int32)))
    return [t.to(device) for t in out]


def test_hash_threshold_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(11)
    ids = np.concatenate([
        np.asarray([0, 1, 2**31, 2**32 - 1, 2**32, 2**32 + 5, 2**40 + 7]),
        rng.integers(0, 2**34, size=100_003)]).astype(np.int64)
    ids32 = to_tensor((ids.astype(np.uint64) & np.uint64(0xFFFFFFFF))
                      .astype(np.uint32)).to(cuda_device)
    ids64 = torch.from_numpy(ids).to(cuda_device)
    for tau in (0, 2**31, int(PAD)):
        before = hash_threshold.launches
        h, keep = hash_threshold(ids32, 9, tau)
        assert hash_threshold.launches == before + 1
        h_ref, keep_ref = ref.hash_threshold_ref(ids64, 9, tau)
        assert torch.equal(as_u64(h), h_ref)
        assert torch.equal(keep.bool(), keep_ref)
    before = hash_threshold.launches
    h, keep = hash_threshold(ids32, 9)                 # hashes only
    assert hash_threshold.launches == before + 1 and keep is None
    assert torch.equal(as_u64(h), ref.hash_threshold_ref(ids64, 9, None)[0])
    empty = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    assert hash_threshold(empty, 0, 5)[0].numel() == 0


B2_EDGE_IDS = np.asarray([0, 1, 2**31, 2**32 - 1, 2**32, 2**32 + 5, 2**40 + 7])


def _b2_ids(n, lead, device):
    """(ids as u32 bit patterns, the same ids as int64) on ``device``: n
    ids ``lead`` words past the start of their allocation, so ``lead``
    words past a 16-B boundary."""
    rng = np.random.default_rng(1000 * n + lead)
    ids = rng.integers(0, 2**34, size=n + lead)
    k = min(len(B2_EDGE_IDS), n)
    ids[lead:lead + k] = B2_EDGE_IDS[:k]
    ids32 = to_tensor((ids.astype(np.uint64) & np.uint64(0xFFFFFFFF))
                      .astype(np.uint32)).to(device)
    return ids32[lead:], torch.from_numpy(ids).to(device)[lead:]


@pytest.mark.parametrize("lead", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 255, 257, 100_010])
def test_hash_threshold_kernel_lengths_and_offsets(cuda_device, n, lead):
    """B2 at lengths around its four-id vectors, with the ids 0-3 words
    past a 16-B boundary (the outputs are aligned, so a lead of 1-3 takes
    the scalar body), in both forms, at τ = 0, a build's τ and PAD."""
    ids32, ids64 = _b2_ids(n, lead, cuda_device)
    assert ids32.data_ptr() % 16 == 4 * lead
    h_want = ref.hash_threshold_ref(ids64, 9, None)[0]
    # The exact τ of a budget of a tenth of the ids, as the build picks it.
    tau_build = int(torch.sort(h_want).values[n // 10])
    for tau in (None, 0, tau_build, int(PAD)):
        before = hash_threshold.launches
        h, keep = hash_threshold(ids32, 9, tau)
        assert hash_threshold.launches == before + 1
        assert torch.equal(as_u64(h), h_want)
        if tau is None:
            assert keep is None
        else:
            assert torch.equal(keep.bool(),
                               ref.hash_threshold_ref(ids64, 9, tau)[1])


@pytest.mark.parametrize("ids_lead,h_lead,k_lead", [
    (0, 0, 0), (1, 1, 1), (3, 3, 3), (2, 2, 0), (0, 0, 3), (0, 1, 1),
    (1, 0, 0), (2, 3, 1)])
def test_hash_threshold_entry_takes_outputs_at_an_offset(
        cuda_device, ids_lead, h_lead, k_lead):
    """The C entry with ids and outputs that are views 0-3 words into
    their buffers (the wrapper allocates its own outputs, so this calls the
    entry): the vector body where all three sit at one offset from a 16-B
    boundary, the scalar body where they do not. Equal to the plain
    version, and nothing is written outside the views."""
    n, tau, fill = 1_027, 2**31, 0x5A5A5A5A
    ids32, ids64 = _b2_ids(n, ids_lead, cuda_device)
    h_want, keep_want = ref.hash_threshold_ref(ids64, 9, tau)
    lib = library.library()
    card = ids32.device.index
    for form in ("hashes", "keep"):
        hbuf = torch.full((n + 8,), fill, dtype=torch.int32,
                          device=cuda_device)
        kbuf = torch.full_like(hbuf, fill)
        h, k = hbuf[h_lead:h_lead + n], kbuf[k_lead:k_lead + n]
        library.check(lib.hash_threshold_launch(
            ids32.data_ptr(), h.data_ptr(),
            k.data_ptr() if form == "keep" else None, n, seed_offset(9), tau,
            card, library.current_stream_ptr(card)), "hash_threshold_launch")
        torch.cuda.synchronize()
        assert torch.equal(as_u64(h), h_want)
        assert ((hbuf[:h_lead] == fill).all()
                and (hbuf[h_lead + n:] == fill).all())
        if form == "keep":
            assert torch.equal(k.bool(), keep_want)
            assert ((kbuf[:k_lead] == fill).all()
                    and (kbuf[k_lead + n:] == fill).all())
        else:
            assert (kbuf == fill).all()


def test_hash_threshold_kernel_past_2_31_ids(cuda_device):
    """2^31 + 7 ids: the C entry launches in chunks of 2^30 ids and takes
    any length, as the reference does. Hashes and keep flags equal the plain
    version's on every id (compared in pieces of 2^24); the hashes-only
    form around each chunk boundary and at both ends."""
    n, tau = 2**31 + 7, 2**31 + 12_345
    free, _ = torch.cuda.mem_get_info(cuda_device)
    if free < 28 * 2**30:
        pytest.skip(f"needs 28 GB free on the card, has {free / 2**30:.1f}")
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    ids = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32,
                        device=cuda_device, generator=gen)
    h, keep = hash_threshold(ids, 9, tau)
    step = 2**24
    for s in range(0, n, step):
        hw, kw = ref.hash_threshold_ref(ids[s:s + step], 9, tau)
        assert torch.equal(as_u64(h[s:s + step]), hw), s
        assert torch.equal(keep[s:s + step].bool(), kw), s
    del h, keep
    h, keep = hash_threshold(ids, 9)
    assert keep is None
    for s in (0, 2**30 - 64, 2**31 - 64, n - 64):
        assert torch.equal(as_u64(h[s:s + 128]),
                           ref.hash_threshold_ref(ids[s:s + 128], 9, None)[0])


@pytest.mark.parametrize("seed,m,c,gq,cq,w,hi,full,thr", [
    (0, 8, 16, 1, 16, 1, 64, False, "random"),
    (1, 13, 16, 3, 24, 2, 64, False, "random"),  # odd M, query wider
    (2, 40, 32, 4, 8, 4, 2**32, False, "random"),
    (3, 64, 8, 2, 8, 0, 64, False, "random"),    # no buffer words
    (4, 5001, 56, 16, 56, 1, 2**12, False, "random"),
    (5, 300, 7, 5, 9, 1, 64, False, "random"),   # C, Cq not multiples of 4
    (6, 517, 8, 17, 13, 3, 2**10, False, "random"),  # Gq 17, M % 256 != 0
    (7, 1000, 56, 33, 56, 1, 2**9, False, "random"),  # Gq over 32
    (8, 700, 20, 16, 16, 1, 2**16, True, "random"),   # rows full
    (9, 600, 12, 6, 12, 1, 2**8, False, "row_values"),  # τ = a row value
    (10, 900, 56, 16, 56, 1, 2**12, True, "below"),   # thresholds below τ
    (11, 257, 24, 1, 20, 0, 2**8, False, "below"),    # Gq 1, W 0, M 257
])
def test_score_kernel_matches_plain(cuda_device, seed, m, c, gq, cq, w, hi,
                                    full, thr):
    cols = _score_inputs(seed, m, c, gq, cq, w, hi, cuda_device, full, thr)
    before = score_mod.gbkmv_score.launches
    got = ops.score_index(*cols)
    assert score_mod.gbkmv_score.launches == before + 1
    assert torch.equal(got, ref.gbkmv_score_ref(*cols))


def test_score_kernel_query_pack_over_48kb(cuda_device):
    """A pack that needs the opt-in shared memory (> 48 KB) still scores."""
    cols = _score_inputs(5, 300, 16, 16, 1024, 1, 2**16, cuda_device)
    assert score_mod.query_pack_bytes(16, 1024, 1) > 48 * 1024
    assert torch.equal(ops.score_index(*cols), ref.gbkmv_score_ref(*cols))


def test_score_pack_budget_comes_from_the_kernel(cuda_device):
    """The wrapper's pack size and limit are the kernel library's: values,
    buffers and four words a query, within the block's 232,448 B less the
    8,192-B filter. ``ops.score_index`` splits at that limit: a part of
    ``queries_per_launch`` queries launches, one query more is refused."""
    for gq, cq, w in ((1, 1, 0), (16, 56, 1), (60, 1024, 9)):
        assert score_mod.query_pack_bytes(gq, cq, w) == (
            gq * cq + gq * w + 4 * gq) * 4
    assert score_mod.max_pack_bytes() == 232448 - 8192
    gq, cq, w = 60, 1024, 1
    cols = _score_inputs(12, 300, 16, gq, cq, w, 2**16, cuda_device)
    step = score_mod.queries_per_launch(cols[0].device, gq, cq, w)
    assert step == (232448 - 8192) // ((cq + w + 4) * 4) < gq
    before = score_mod.gbkmv_score.launches
    assert torch.equal(ops.score_index(*cols), ref.gbkmv_score_ref(*cols))
    assert score_mod.gbkmv_score.launches == before + 2
    fits = cols[:3] + [t[:step].contiguous() for t in cols[3:]]
    assert torch.equal(score_mod.gbkmv_score(*fits),
                       ref.gbkmv_score_ref(*fits))
    over = cols[:3] + [t[:step + 1].contiguous() for t in cols[3:]]
    with pytest.raises(RuntimeError):
        score_mod.gbkmv_score(*over)


@pytest.mark.parametrize("tau_mode", ["exact", "histogram"])
def test_device_build_matches_host_build(cuda_device, tau_mode):
    recs = generate_dataset(m=3000, n_elems=4000, alpha_freq=1.14,
                            alpha_size=4.95, size_min=10, size_max=300,
                            seed=11)
    budget = int(0.1 * sum(len(r) for r in recs))
    host = gbkmv.build_gbkmv(recs, budget, tau_mode=tau_mode,
                             build_backend="numpy", device="cpu")
    before = hash_threshold.launches
    dev = gbkmv.build_gbkmv(recs, budget, tau_mode=tau_mode)
    assert hash_threshold.launches == before + 1
    assert dev.sketches.device.type == "cuda"
    for a, b in zip(dev.sketches.columns(), host.sketches.columns()):
        assert torch.equal(a.cpu(), b)
    assert dev.tau == host.tau and dev.buffer_bits == host.buffer_bits > 0


def test_card_index_answers_like_cpu_index(cuda_device, tmp_path):
    recs = generate_dataset(m=2000, n_elems=3000, alpha_freq=1.14,
                            alpha_size=2.5, size_min=5, size_max=80, seed=3)
    budget = int(0.15 * sum(len(r) for r in recs))
    queries = make_query_workload(recs, 16, seed=2)
    card = api.build("gbkmv", recs, budget)
    cpu = api.build("gbkmv", recs, budget, device="cpu")
    before = score_mod.gbkmv_score.launches
    for t in (0.3, 0.5, 0.9):
        for a, b in zip(card.batch_query(queries, t, plan="dense"),
                        cpu.batch_query(queries, t)):
            np.testing.assert_array_equal(a, b)
    for q in queries[:4]:
        for x, y in zip(card.topk(q, 10, plan="dense"), cpu.topk(q, 10)):
            np.testing.assert_array_equal(x, y)
    assert score_mod.gbkmv_score.launches == before + 3 + 4
    path = str(tmp_path / "card.npz")
    card.save(path)
    back = api.load_index(path, device="cpu")
    np.testing.assert_array_equal(back.batch_scores(queries),
                                  card.batch_scores(queries))
    np.testing.assert_array_equal(to_numpy(back.core.sketches.values),
                                  to_numpy(card.core.sketches.values))


def test_arena_residency(cuda_device):
    recs = generate_dataset(m=200, n_elems=900, alpha_freq=1.1, alpha_size=2.0,
                            size_min=4, size_max=40, seed=4)
    arena = gbkmv.build_gbkmv(recs, 400).sketches
    dev_values = arena.values
    assert arena.device_pack(cuda_device) is arena     # adopted, no copy
    arena.ensure_host()
    assert arena.device.type == "cpu"
    pack = arena.device_pack(cuda_device)
    assert pack.values is dev_values                   # the kept original
    assert torch.equal(pack.values.cpu(), arena.values)
    assert arena.nbytes() == 2 * pack.nbytes()


@pytest.mark.parametrize("seed,m,c,gq,cq,w,hi,p", [
    (0, 8, 16, 1, 16, 1, 64, 37),
    (1, 13, 16, 3, 24, 2, 64, 200),       # query wider than records
    (2, 40, 32, 4, 8, 4, 2**32, 1000),
    (3, 64, 8, 2, 8, 0, 64, 300),         # no buffer words
    (4, 5001, 56, 16, 56, 1, 2**12, 70_001),
])
def test_gather_kernel_matches_plain(cuda_device, seed, m, c, gq, cq, w, hi,
                                     p):
    cols = _score_inputs(seed, m, c, gq, cq, w, hi, cuda_device)
    rng = np.random.default_rng(seed + 50)
    rec = torch.from_numpy(rng.integers(0, m, size=p).astype(np.int32))
    q = torch.from_numpy(rng.integers(0, gq, size=p).astype(np.int32))
    rec, q = rec.to(cuda_device), q.to(cuda_device)
    before = gs_mod.gather_score.launches
    got = gs_mod.gather_score(*cols, rec, q)
    assert gs_mod.gather_score.launches == before + 1
    assert torch.equal(got, ref.gather_score_ref(*cols, rec, q))
    # Each pair scores what the dense kernel gives it.
    dense = ops.score_index(*cols)
    assert torch.equal(got, dense[rec.long(), q.long()])
    empty = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    assert gs_mod.gather_score(*cols, empty, empty).numel() == 0
    assert gs_mod.gather_score.launches == before + 1


def test_gather_kernel_out_of_range_index_writes_nan(cuda_device):
    """An index outside the rows reads nothing and scores NaN; the pairs
    in range score as usual."""
    cols = _score_inputs(6, 20, 8, 3, 8, 1, 64, cuda_device)
    rec = torch.tensor([0, 20, -1, 5, 19], dtype=torch.int32,
                       device=cuda_device)
    q = torch.tensor([0, 1, 2, 3, 2], dtype=torch.int32, device=cuda_device)
    got = gs_mod.gather_score(*cols, rec, q)
    torch.cuda.synchronize()
    assert torch.isnan(got[1:4]).all()
    keep = torch.tensor([0, 4], device=cuda_device)
    assert torch.equal(got[keep], ref.gather_score_ref(*cols, rec[keep],
                                                       q[keep]))


@pytest.mark.parametrize("seed,m,c,gq,cq,w,p,unaligned", [
    (7, 50, 7, 3, 8, 1, 13, False),       # c % 4 != 0: scalar loads
    (8, 60, 13, 2, 5, 2, 301, False),     # c % 4 != 0, W > 1
    (9, 40, 16, 4, 16, 0, 97, False),     # W = 0
    (10, 30, 8, 2, 8, 1, 1, False),       # P = 1
    (11, 70, 16, 3, 16, 1, 8 * 37 + 5, False),  # P not a multiple of 128
    (12, 90, 56, 5, 56, 9, 1001, False),  # W past the lane group
    (13, 50, 8, 2, 8, 1, 211, True),      # c % 4 == 0, rows not 16-B aligned
])
def test_gather_kernel_edge_shapes(cuda_device, seed, m, c, gq, cq, w, p,
                                   unaligned):
    """Each row-load path and lane-group edge equals the plain version and
    B1's matrix entries."""
    cols = _score_inputs(seed, m, c, gq, cq, w, 2**7, cuda_device)
    if unaligned:            # the same rows, 4 B past a 16-B boundary
        flat = torch.empty(m * c + 1, dtype=torch.int32, device=cuda_device)
        flat[1:] = cols[0].reshape(-1)
        cols[0] = flat[1:].view(m, c)
        assert cols[0].data_ptr() % 16 == 4 and cols[0].is_contiguous()
    rng = np.random.default_rng(seed + 50)
    rec = torch.from_numpy(rng.integers(0, m, size=p).astype(np.int32))
    q = torch.from_numpy(rng.integers(0, gq, size=p).astype(np.int32))
    rec, q = rec.to(cuda_device), q.to(cuda_device)
    got = gs_mod.gather_score(*cols, rec, q)
    assert torch.equal(got, ref.gather_score_ref(*cols, rec, q))
    assert torch.equal(got, ops.score_index(*cols)[rec.long(), q.long()])


def test_gather_kernel_long_query_rows(cuda_device):
    """Query rows of 1,024 values (a 64 KB pack; deep binary searches)
    score what the plain version and B1 give."""
    cols = _score_inputs(5, 300, 16, 16, 1024, 1, 2**16, cuda_device)
    rng = np.random.default_rng(55)
    rec = torch.from_numpy(rng.integers(0, 300, size=5003).astype(np.int32))
    q = torch.from_numpy(rng.integers(0, 16, size=5003).astype(np.int32))
    rec, q = rec.to(cuda_device), q.to(cuda_device)
    got = gs_mod.gather_score(*cols, rec, q)
    assert torch.equal(got, ref.gather_score_ref(*cols, rec, q))
    assert torch.equal(got, ops.score_index(*cols)[rec.long(), q.long()])


def test_card_host_topk_scores_in_a_few_launches(cuda_device):
    """The planner's host-route top-10 with the card's scorer equals the
    dense top-10 and launches B5 at most twice per query here (n ≤ 2,000:
    a prefix of 1,024 candidates, then the rest if the stop rule asks),
    and not at all for a query with no candidates."""
    recs = generate_dataset(m=2000, n_elems=3000, alpha_freq=1.14,
                            alpha_size=2.5, size_min=5, size_max=80, seed=3)
    budget = int(0.15 * sum(len(r) for r in recs))
    card = api.build("gbkmv", recs, budget, postings="eager")
    post = card._postings()
    for q in make_query_workload(recs, 16, seed=2):
        qp, h, b, sz = card._plan_queries([q])
        scorer = card._pair_score_fn(qp)
        assert scorer.prefetch
        before = gs_mod.gather_score.launches
        ids, sc = planner_topk(post, h[0], b[0], int(sz[0]), 10, scorer,
                               card.num_records)
        launches = gs_mod.gather_score.launches - before
        n = len(planner_candidates(post, h[0], b[0], int(sz[0]))[0])
        assert (n > 0) <= launches <= (1 if n <= 1024 else 2)
        want = card.topk(q, 10, plan="dense")
        np.testing.assert_array_equal(ids, want[0])
        np.testing.assert_array_equal(sc.view(np.uint32),
                                      want[1].view(np.uint32))


def test_card_pruned_route_answers_like_cpu(cuda_device, tmp_path):
    recs = generate_dataset(m=2000, n_elems=3000, alpha_freq=1.14,
                            alpha_size=2.5, size_min=5, size_max=80, seed=3)
    budget = int(0.15 * sum(len(r) for r in recs))
    queries = make_query_workload(recs, 16, seed=2)
    card = api.build("gbkmv", recs, budget, postings="eager")
    cpu = api.build("gbkmv", recs, budget, device="cpu")
    assert card.core.sketches.device_pack(cuda_device).device.type == "cuda"
    counters = (pm.postings_probe, pm.block_decode, gs_mod.gather_score)
    before = [c.launches for c in counters]
    for t in (0.3, 0.5, 0.9):
        got = card.batch_query(queries, t, plan="pruned")
        assert card.last_candidate_sizes is None     # the device route
        for a, b, c in zip(got, cpu.batch_query(queries, t, plan="pruned"),
                           cpu.batch_query(queries, t, plan="dense")):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    # One probe and one decode per batch; no host verify.
    assert [c.launches for c in counters] == [before[0] + 3, before[1] + 3,
                                              before[2]]
    for t in (0.3, 0.9):
        for a, b in zip(card.batch_query(queries, t),
                        cpu.batch_query(queries, t, plan="dense")):
            np.testing.assert_array_equal(a, b)
    for q in queries[:4]:
        for x, y in zip(card.topk(q, 10, plan="pruned"),
                        cpu.topk(q, 10, plan="dense")):
            np.testing.assert_array_equal(x, y)
    path = str(tmp_path / "card.npz")
    card.save(path)
    back = api.load_index(path)
    for a, b in zip(back.batch_query(queries, 0.5, plan="pruned"),
                    card.batch_query(queries, 0.5, plan="pruned")):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The gkmv and kmv engines on the card
# ---------------------------------------------------------------------------


def _sketch_corpus():
    recs = generate_dataset(m=3000, n_elems=4000, alpha_freq=1.14,
                            alpha_size=4.95, size_min=10, size_max=300,
                            seed=11)
    return recs, int(0.1 * sum(len(r) for r in recs))


def _columns_equal(a, b) -> bool:
    return all(torch.equal(x.cpu(), y.cpu())
               for x, y in zip(a.columns(), b.columns()))


@pytest.mark.parametrize("tau_mode", ["exact", "histogram"])
def test_gkmv_device_build_matches_host_build(cuda_device, tau_mode):
    recs, budget = _sketch_corpus()
    host = gkmv.build_gkmv(recs, budget, tau_mode=tau_mode,
                           build_backend="numpy", device="cpu")
    before = hash_threshold.launches
    dev = gkmv.build_gkmv(recs, budget, tau_mode=tau_mode)
    assert hash_threshold.launches == before + 1
    assert dev.device.type == "cuda" and dev.buf_words == 0
    assert _columns_equal(dev, host)


def test_score_kernel_at_width_0_on_a_gkmv_index(cuda_device):
    """B1 with no buffer words ([m, 0] and [Gq, 0] buffers) on a G-KMV
    index's long rows, through the api's door, against its plain version."""
    recs, budget = _sketch_corpus()
    index = api.build("gkmv", recs, budget)
    x = index.sketches.device_pack(cuda_device)
    qp = index._query_pack(make_query_workload(recs, 16, seed=2)).to(
        cuda_device)
    cols = (x.values, x.thresh, x.buf, qp.values, qp.thresh, qp.buf,
            qp.sizes)
    assert x.buf.shape == (len(recs), 0) and qp.buf.shape == (16, 0)
    before = score_mod.gbkmv_score.launches
    got = ops.score_index(*cols)
    assert score_mod.gbkmv_score.launches == before + 1
    assert torch.equal(got, ref.gbkmv_score_ref(*cols))


def test_gkmv_device_pipeline_at_width_0_answers_as_dense(cuda_device):
    recs, budget = _sketch_corpus()
    queries = make_query_workload(recs, 16, seed=2)
    card = api.build("gkmv", recs, budget, postings="eager")
    cpu = api.build("gkmv", recs, budget, device="cpu")
    arena = card.sketches
    qp = card._query_pack(queries)
    staged = planner_device.stage_query_inputs(arena, qp, device=cuda_device)
    s = planner_device.pruned_scores(*staged)
    dense = card.batch_scores(queries)
    assert np.array_equal(s.cpu().numpy().view(np.uint32),
                          dense.view(np.uint32))
    counters = (pm.postings_probe, pm.block_decode, gs_mod.gather_score)
    before = [c.launches for c in counters]
    for t in (0.3, 0.5, 0.9):
        got = card.batch_query(queries, t, plan="pruned")
        assert card.last_candidate_sizes is None     # the device route
        for a, b in zip(got, cpu.batch_query(queries, t, plan="dense")):
            np.testing.assert_array_equal(a, b)
    assert [c.launches for c in counters] == [before[0] + 3, before[1] + 3,
                                              before[2]]
    for q in queries[:4]:
        for x, y in zip(card.topk(q, 10, plan="pruned"),
                        cpu.topk(q, 10, plan="dense")):
            np.testing.assert_array_equal(x, y)


def test_kmv_device_build_matches_host_build(cuda_device):
    recs, budget = _sketch_corpus()
    for b in (budget, 2 * len(recs), 40 * len(recs)):
        host = kmv.build_kmv(recs, b, build_backend="numpy", device="cpu")
        before = hash_threshold.launches
        dev = kmv.build_kmv(recs, b)
        assert hash_threshold.launches == before + 1
        assert dev.device.type == "cuda" and _columns_equal(dev, host)


def test_kmv_scores_on_card_equal_cpu(cuda_device):
    recs, budget = _sketch_corpus()
    queries = make_query_workload(recs, 16, seed=2)
    card = api.build("kmv", recs, budget)
    cpu = api.build("kmv", recs, budget, device="cpu")
    np.testing.assert_array_equal(card.batch_scores(queries).view(np.uint32),
                                  cpu.batch_scores(queries).view(np.uint32))
    counters = (pm.postings_probe, pm.block_decode, gs_mod.gather_score)
    before = [c.launches for c in counters]
    for t in (0.5, 0.9):
        for plan in ("dense", "pruned"):
            for a, b in zip(card.batch_query(queries, t, plan=plan),
                            cpu.batch_query(queries, t, plan="dense")):
                np.testing.assert_array_equal(a, b)
    for q in queries[:4]:
        for x, y in zip(card.topk(q, 10, plan="pruned"),
                        cpu.topk(q, 10, plan="dense")):
            np.testing.assert_array_equal(x, y)
    assert [c.launches for c in counters] == before   # no B3, B4 or B5


# ---------------------------------------------------------------------------
# B3 and B4: the device pruned pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("u", [0, 1, 700, 5000])
def test_probe_kernel_matches_plain(cuda_device, u):
    rng = np.random.default_rng(u + 1)
    keys = np.unique(rng.integers(1000, 2**32 - 1000, size=u,
                                  dtype=np.uint64)).astype(np.uint32)
    q = rng.integers(0, 2**32, size=3000, dtype=np.uint64).astype(np.uint32)
    extra = [0, 999, 2**32 - 2, PAD, PAD]
    if u:
        extra += [keys[0], keys[-1], keys[u // 2], keys[u // 2],
                  keys[0] - 1, keys[-1] + 1] + list(keys[::7])
    q = np.concatenate([q, np.asarray(extra, np.uint32)])
    k, qt = to_tensor(keys).to(cuda_device), to_tensor(q).to(cuda_device)
    before = pm.postings_probe.launches
    pos, hit = pm.postings_probe(k, qt)
    assert pm.postings_probe.launches == before + (1 if u else 0)
    wpos, whit = ref.postings_probe_ref(k, qt)
    assert torch.equal(pos, wpos) and torch.equal(hit, whit)
    assert bool(hit.any()) == bool(u)
    empty = qt[:0]
    assert pm.postings_probe(k, empty)[0].numel() == 0
    assert pm.postings_probe.launches == before + (1 if u else 0)


@pytest.mark.parametrize("n", [1, 896, 1025, 16_384])
@pytest.mark.parametrize("u", [0, 1, 700, 5000, 60_000])
def test_probe_tasks_kernel_matches_plain(cuda_device, u, n):
    """pos, hit and the block-task prefix in one launch, against the plain
    version: n across the CTA's 1,024-lane tiles, U past the shared-memory
    budget (60,000 keys: fence stride 1), with repeated hits, misses and
    PAD lanes."""
    rng = np.random.default_rng(u + n)
    keys = np.unique(rng.integers(1000, 2**32 - 1000, size=u + u // 8,
                                  dtype=np.uint64)).astype(np.uint32)[:u]
    assert keys.shape[0] == u
    row_blocks = np.concatenate([[0], np.cumsum(
        rng.integers(1, 4, size=u))]).astype(np.int32)
    q = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    if u:
        q[::2] = keys[rng.integers(0, u, size=q[::2].shape[0])]
        q[1::7] = keys[u // 2]                  # one key many times
    q[3::11] = PAD
    k = to_tensor(keys).to(cuda_device)
    qt = to_tensor(q).to(cuda_device)
    rb = torch.from_numpy(row_blocks).to(cuda_device)
    before = pm.postings_probe.launches
    got = pm.probe_tasks(k, qt, rb)
    assert pm.postings_probe.launches == before + (1 if u else 0)
    if u:
        assert pm.postings_probe.last_fence_shift == pm.fence_shift(u)
        assert (pm.postings_probe.last_fence_shift > 0) == (u == 60_000)
    want = ref.probe_tasks_ref(k, qt, rb)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert bool(got[1].any()) == bool(u)
    # The pos/hit door runs the same kernel without the prefix.
    pos, hit = pm.postings_probe(k, qt)
    assert torch.equal(pos, want[0]) and torch.equal(hit, want[1])


# The probe's shared-memory budget: 232,448 B less 1 KB, 4 B a key.
PROBE_SMEM_KEYS = 57_856


@pytest.mark.parametrize("u,s", [(0, 0), (2424, 0), (PROBE_SMEM_KEYS, 0),
                                 (PROBE_SMEM_KEYS + 1, 1), (60_000, 1),
                                 (250_000, 3), (10**7, 8)])
def test_fence_shift_keeps_the_fences_in_shared_memory(cuda_device, u, s):
    """The C entry's fence stride is the smallest whose fences fit."""
    assert pm.fence_shift(u) == s
    assert -(-u // 2**s) <= PROBE_SMEM_KEYS
    assert s == 0 or -(-u // 2**(s - 1)) > PROBE_SMEM_KEYS


@pytest.mark.parametrize("corpus", ["synthetic", "netflix_like"])
def test_block_decode_takes_the_probe_prefix(cuda_device, corpus):
    if corpus == "synthetic":
        dpost = _synthetic_postings(cuda_device)
        q_flat = to_tensor(np.asarray([10, 11, 12, 13, 14, 15, 16, 17,
                                       17, 12, 99, PAD, 10, 13, PAD, 16],
                                      np.uint32)).to(cuda_device)
        gq, cq, m = 2, 8, 600_000
    else:
        recs = generate_dataset(m=4000, n_elems=3000, alpha_freq=1.14,
                                alpha_size=2.5, size_min=5, size_max=80,
                                seed=3)
        index = api.build("gbkmv", recs, int(0.15 * sum(map(len, recs))),
                          postings="eager")
        dpost = index.core.sketches.device_postings(cuda_device)
        qp = gbkmv.sketch_query_batch(
            index.core, make_query_workload(recs, 16, seed=2)).to(cuda_device)
        gq, cq = qp.values.shape
        q_flat, m = qp.values.reshape(-1), index.num_records
    pos, hit, cum = pm.probe_tasks(dpost.keys, q_flat, dpost.row_blocks)
    blocks = (dpost.row_blocks, dpost.first, dpost.meta, dpost.off,
              dpost.payload)
    before = pm.block_decode.launches
    got = pm.block_decode(pos, hit, *blocks, gq=gq, cq=cq, m=m, cum=cum)
    assert pm.block_decode.launches == before + 1
    assert torch.equal(got, pm.block_decode(pos, hit, *blocks, gq=gq, cq=cq,
                                            m=m))
    assert torch.equal(got, ref.kcount_ref(pos, hit, *blocks, gq=gq, cq=cq,
                                           m=m))
    assert int(got.sum()) > 0
    # The counts are zeroed on the card before every decode: a call into
    # memory that held other values (the allocator hands back the block
    # just freed) gives the same counts.
    junk = torch.full((m, gq), 7, dtype=torch.int32, device=cuda_device)
    del junk
    assert torch.equal(got, pm.block_decode(pos, hit, *blocks, gq=gq, cq=cq,
                                            m=m, cum=cum))


def _synthetic_postings(device) -> DevicePostings:
    """Hand-made tail rows (one key each): one-entry blocks, repeated ids
    (bw = 0), a 31-bit delta, widths that straddle words (7, 13, 25), a
    row of three blocks and a dense-bitmap block."""
    rows = [np.asarray([5]), np.asarray([7, 7, 7, 7]),
            np.asarray([1, 2, 3, 3 + 2**30, 4 + 2**30 + 5]),
            np.cumsum(np.full(40, 100)), np.cumsum(np.full(90, 5000)),
            np.cumsum(np.arange(1, 61) % 7 + 2**24),
            np.cumsum(np.arange(300) % 3),
            40 + np.cumsum(1 + (np.arange(160) % 4 == 0))]
    offsets = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    tail = P.encode_store(offsets, np.concatenate(rows).astype(np.int32))
    post = P.PostingsIndex(
        keys=np.arange(10, 10 + len(rows), dtype=np.uint32), tail=tail,
        buf=P.encode_store(np.zeros(1, np.int64), np.zeros(0, np.int32)),
        num_records=600_000, tau=np.uint32(0))
    return DevicePostings.from_postings(post, device)


def _kcount_both(dpost, q_flat, gq, cq, m):
    pos, hit = pm.postings_probe(dpost.keys, q_flat)
    args = (pos, hit, dpost.row_blocks, dpost.first, dpost.meta, dpost.off,
            dpost.payload)
    before = pm.block_decode.launches
    got = pm.block_decode(*args, gq=gq, cq=cq, m=m)
    assert pm.block_decode.launches == before + 1
    return got, ref.kcount_ref(*args, gq=gq, cq=cq, m=m)


def test_block_decode_kernel_matches_plain_on_synthetic_blocks(cuda_device):
    dpost = _synthetic_postings(cuda_device)
    assert dpost.has_dense
    # Two queries of 8 lanes: every key, one twice, a miss and PAD.
    lanes = np.asarray([10, 11, 12, 13, 14, 15, 16, 17,
                        17, 12, 99, PAD, 10, 13, PAD, 16], np.uint32)
    got, want = _kcount_both(dpost, to_tensor(lanes).to(cuda_device),
                             2, 8, 600_000)
    assert torch.equal(got, want)
    assert int(got.sum()) > 700          # ids past m were dropped, not all


@pytest.mark.parametrize("corpus", ["netflix_like", "dense_blocks"])
def test_block_decode_kernel_matches_plain_on_an_index(cuda_device, corpus):
    if corpus == "dense_blocks":
        rng = np.random.default_rng(7)
        recs = []
        for _ in range(600):
            base = rng.choice(3000, size=rng.integers(2, 5),
                              replace=False) + 100
            common = [c for c in range(10) if rng.random() < 0.85]
            recs.append(np.unique(np.concatenate([common, base])))
        index = api.build("gbkmv", recs, 20_000, r=2, postings="eager")
        queries = [r[: max(2, len(r) // 2)] for r in recs[:16]]
    else:
        recs = generate_dataset(m=4000, n_elems=3000, alpha_freq=1.14,
                                alpha_size=2.5, size_min=5, size_max=80,
                                seed=3)
        index = api.build("gbkmv", recs, int(0.15 * sum(map(len, recs))),
                          postings="eager")
        queries = make_query_workload(recs, 16, seed=2)
    dpost = index.core.sketches.device_postings(cuda_device)
    assert dpost.has_dense == (corpus == "dense_blocks")
    qp = gbkmv.sketch_query_batch(index.core, queries).to(cuda_device)
    gq, cq = qp.values.shape
    got, want = _kcount_both(dpost, qp.values.reshape(-1), gq, cq,
                             index.num_records)
    assert torch.equal(got, want) and int(got.sum()) > 0
    # Pruned answers equal the dense route's on the card.
    for t in (0.3, 0.7):
        for a, b in zip(index.batch_query(queries, t, plan="pruned"),
                        index.batch_query(queries, t, plan="dense")):
            np.testing.assert_array_equal(a, b)
    for q in queries[:3]:
        for x, y in zip(index.topk(q, 9, plan="pruned"),
                        index.topk(q, 9, plan="dense")):
            np.testing.assert_array_equal(x, y)


# B4's grid: 132 · 4 CTAs of four warps, one task a warp at a time
# (csrc/block_decode.cu, kDecodeBlocks and kThreads).
B4_GRID_WARPS = 132 * 4 * 4


def _tail_store(device, rows, m, dense_words=None) -> DevicePostings:
    """A tail store of one key a row (keys 10, 11, ...) over ``m`` records;
    ``dense_words`` (first id, u32 words) appends one more row of one
    dense-bitmap block with that body, which the encoder would not make
    at 124 words (it takes a bitmap only where it is the smaller body)."""
    offsets = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    rec = (np.concatenate(rows) if offsets[-1] else np.zeros(0)).astype(
        np.int32)
    tail = P.encode_store(offsets, rec)
    if dense_words is not None:
        first, words = dense_words
        nb = tail.num_blocks
        tail = P.BlockStore(
            row_blocks=np.append(tail.row_blocks, nb + 1).astype(np.int32),
            first=np.append(tail.first, first).astype(np.int32),
            last=np.append(tail.last, first + 32 * len(words) - 1
                           ).astype(np.int32),
            meta=np.append(tail.meta, (P.BLOCK - 1) | (1 << 13)
                           ).astype(np.uint32),
            off=np.append(tail.off, tail.off[-1] + len(words)),
            payload=np.concatenate([tail.payload, words]).astype(np.uint32))
    post = P.PostingsIndex(
        keys=np.arange(10, 10 + tail.num_rows, dtype=np.uint32), tail=tail,
        buf=P.encode_store(np.zeros(1, np.int64), np.zeros(0, np.int32)),
        num_records=m, tau=np.uint32(0))
    return DevicePostings.from_postings(post, device)


def _decode_both(dpost, lanes, gq, cq):
    """(kernel's counts, plain version's, block tasks) for query-hash
    ``lanes``; the wrapper must count one launch."""
    q = to_tensor(np.asarray(lanes, np.uint32)).to(dpost.device)
    pos, hit, cum = pm.probe_tasks(dpost.keys, q, dpost.row_blocks)
    args = (pos, hit, dpost.row_blocks, dpost.first, dpost.meta, dpost.off,
            dpost.payload)
    before = pm.block_decode.launches
    got = pm.block_decode(*args, gq=gq, cq=cq, m=dpost.num_records, cum=cum)
    assert pm.block_decode.launches == before + 1
    want = ref.kcount_ref(*args, gq=gq, cq=cq, m=dpost.num_records)
    return got, want, int(cum[-1])


def _lanes(rng, keys, n, miss=0.35):
    """n query hashes drawn from ``keys``, about ``miss`` of them misses (a
    hash below every key, or PAD) scattered between them."""
    lanes = rng.choice(np.asarray(keys, np.uint32), size=n)
    lost = rng.random(n) < miss
    return np.where(lost, np.where(rng.random(n) < 0.5, PAD, 5), lanes)


@pytest.mark.parametrize("gq, cq", [(1, 20), (1, 37), (3, 350), (5, 301),
                                    (17, 77)])
def test_block_decode_kernel_edge_shapes(cuda_device, gq, cq):
    # m · Gq is not a multiple of 4 and n = Gq · Cq not one of 32: n = 20
    # is one search level, 37 two, 1,050, 1,505 and 1,309 two past a
    # partial first level. Rows mix sparse and dense blocks, some ids ≥ m.
    rng = np.random.default_rng(1000 * gq + cq)
    m = 1001
    rows = [np.sort(rng.choice(m + 40, size=int(rng.integers(1, 500)),
                               replace=False)) for _ in range(60)]
    dpost = _tail_store(cuda_device, rows, m)
    got, want, tasks = _decode_both(dpost, _lanes(rng, range(10, 70),
                                                  gq * cq), gq, cq)
    assert (m * gq) % 4 != 0 and (gq * cq) % 32 != 0 and tasks > 0
    assert torch.equal(got, want) and int(got.sum()) > 0


def test_block_decode_kernel_strides_past_its_grid(cuda_device):
    rng = np.random.default_rng(41)
    m = 20_000
    rows = [np.sort(rng.choice(m, size=int(rng.integers(1, 1000)),
                               replace=False)) for _ in range(3000)]
    dpost = _tail_store(cuda_device, rows, m)
    got, want, tasks = _decode_both(dpost, _lanes(rng, range(10, 3010),
                                                  16 * 300, 0.1), 16, 300)
    assert tasks > 4 * B4_GRID_WARPS
    assert torch.equal(got, want)


def test_block_decode_kernel_extreme_blocks(cuda_device):
    m = 5000
    rng = np.random.default_rng(5)
    # A 124-word dense body with more than 128 set bits (only the first
    # 128 are ids) running past m.
    j = np.arange(124)
    words = ((1 << (j * 7 % 32)) | (1 << ((j * 13 + 5) % 32))).astype(
        np.uint64)
    rows = [np.asarray([7]),                                  # one entry
            np.full(P.BLOCK, 9),                              # 128, bw 0
            np.concatenate([np.full(P.BLOCK, 3), [4]]),       # 128 + 1
            np.concatenate([np.arange(0, 254, 2), [2**30 + 300]]),  # bw 31
            np.asarray([0, 2**31 - 1]),                       # bw 31
            np.concatenate([[1, 2 + 2**30], 3 + 2**30 + np.arange(126)])]
    dpost = _tail_store(cuda_device, rows, m, dense_words=(m - 1500, words))
    meta = dpost.meta.cpu().numpy().astype(np.uint32)
    cnt, bw = (meta & 0x7F) + 1, (meta >> 8) & 31
    sparse = (meta >> 13) & 1 == 0
    assert {1, P.BLOCK} <= set(cnt[sparse & (bw == 0)].tolist())
    assert P.BLOCK in cnt[sparse & (bw == 31)]
    off = dpost.off.cpu().numpy()
    assert off[-1] - off[-2] == 124 and not sparse[-1]
    keys = np.arange(10, 17)
    got, want, _ = _decode_both(
        dpost, np.concatenate([keys, keys[::-1], [PAD, 5], keys[2:5], keys[:5]]),
        3, 8)
    assert torch.equal(got, want) and int(got.sum()) > 0
    assert int(got[m - 1500:].sum()) > 0          # the dense block's ids


def _random_csr(rng, nrows_max=20, len_max=350):
    """The repeats store of tests/test_torch_postings.py: per-row sorted
    ids, one-entry rows, duplicate ids (which force sparse blocks), dense
    runs (which pick bitmap blocks), wide-spread ids and empty rows."""
    rows = []
    for _ in range(int(rng.integers(1, nrows_max))):
        n = int(rng.integers(0, len_max))
        style = int(rng.integers(0, 5))
        if style == 0:
            ids = np.sort(rng.integers(0, 8000, size=n))
        elif style == 1:
            ids = (np.sort(rng.choice(2 * n + 1, size=n, replace=False))
                   + int(rng.integers(0, 64)))
        elif style == 2:
            ids = np.sort(rng.choice(2**30, size=n, replace=False))
        elif style == 3:
            ids = np.sort(rng.integers(0, 40, size=n))
        else:
            ids = rng.integers(0, 5000, size=min(n, 1))
        rows.append(ids.astype(np.int64))
    return rows


@pytest.mark.parametrize("seed", range(3))
def test_block_decode_kernel_on_repeated_ids(cuda_device, seed):
    rng = np.random.default_rng(10 + seed)
    rows = _random_csr(rng)
    dpost = _tail_store(cuda_device, rows, 8000)
    got, want, tasks = _decode_both(
        dpost, _lanes(rng, range(10, 10 + len(rows)), 3 * 45), 3, 45)
    assert torch.equal(got, want)


def test_block_decode_entry_refuses_shapes_past_32_bit_indices(cuda_device):
    # The kernel indexes lanes and count cells in 32 bits: its C entry
    # refuses n ≥ 2^31 or m · Gq ≥ 2^31 before it launches anything (so
    # the null pointers here are never read).
    from repro_torch.kernels.library import library
    invalid = 1                                   # cudaErrorInvalidValue
    dev = cuda_device.index or 0
    for n, gq, cq, m in ((2**31, 2, 2**30, 10), (16, 8, 2, 2**28),
                         (16, 1, 16, 2**31)):
        assert library().block_decode_launch(
            None, None, n, None, None, None, None, 1, None, 1, gq, cq, m,
            None, 1, dev, None) == invalid


def test_block_decode_zeroes_the_counts_before_every_decode(cuda_device):
    rng = np.random.default_rng(17)
    m = 3001
    rows = [np.sort(rng.choice(m, size=int(rng.integers(1, 600)),
                               replace=False)) for _ in range(200)]
    dpost = _tail_store(cuda_device, rows, m)
    q = to_tensor(_lanes(rng, range(10, 210), 5 * 61)).to(cuda_device)
    pos, hit, cum = pm.probe_tasks(dpost.keys, q, dpost.row_blocks)
    args = (pos, hit, dpost.row_blocks, dpost.first, dpost.meta, dpost.off,
            dpost.payload)
    kw = {"gq": 5, "cq": 61, "m": m}
    want = ref.kcount_ref(*args, **kw)
    # Calls one after another on one stream, each into the counts the
    # last one freed (the allocator hands the block back), no sync
    # between: a decode that ran ahead of its zeroing would count twice.
    junk = torch.full((m, 5), 7, dtype=torch.int32, device=cuda_device)
    del junk
    outs = []
    for _ in range(4):
        got = pm.block_decode(*args, cum=cum, **kw)
        outs.append(got.clone())
        del got
    assert all(torch.equal(o, want) for o in outs)
    # One call captured in a CUDA graph, replayed twice onto its counts.
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    before = pm.block_decode.launches
    with torch.cuda.graph(graph, stream=side):
        got = pm.block_decode(*args, cum=cum, **kw)
    assert pm.block_decode.launches == before + 1
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_device_encoded_postings_equal_host_postings(cuda_device):
    recs = generate_dataset(m=3000, n_elems=4000, alpha_freq=1.14,
                            alpha_size=4.95, size_min=10, size_max=300,
                            seed=11)
    budget = int(0.1 * sum(len(r) for r in recs))
    card = api.build("gbkmv", recs, budget, postings="eager")
    arena = card.core.sketches
    dpost = arena._dev_post
    assert dpost is not None and dpost.device.type == "cuda"
    host = P.build_postings(arena)
    assert P.postings_equal(arena._post, host)
    mirror = DevicePostings.from_postings(host, cuda_device)
    for a, b in zip(dpost.arrays(), mirror.arrays()):
        assert torch.equal(a, b)
    assert dpost.has_dense == mirror.has_dense


def test_pipeline_middle_makes_no_host_sync(cuda_device):
    recs = generate_dataset(m=2000, n_elems=3000, alpha_freq=1.14,
                            alpha_size=2.5, size_min=5, size_max=80, seed=3)
    index = api.build("gbkmv", recs, int(0.15 * sum(map(len, recs))),
                      postings="eager")
    queries = make_query_workload(recs, 16, seed=2)
    arena = index.core.sketches
    qp = gbkmv.sketch_query_batch(index.core, queries)
    staged = planner_device.stage_query_inputs(arena, qp, 0.5,
                                               device=cuda_device)
    planner_device.fused_mask_words(*staged)                 # warm-up
    outs = []
    for head in ("scores", "words", "topk"):
        staged = planner_device.stage_query_inputs(arena, qp, 0.5,
                                                   device=cuda_device)
        torch.cuda.synchronize()
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            if head == "scores":
                outs.append(planner_device.pruned_scores(*staged))
            elif head == "words":
                outs.append(planner_device.fused_mask_words(*staged))
            else:
                outs.append(planner_device.fused_topk_scores(*staged, k=10))
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    s, words, (vals, ids) = outs
    dense = torch.from_numpy(index.batch_scores(queries))
    assert torch.equal(s.cpu(), dense)
    mask = planner_device.unpack_hit_words(words, index.num_records)
    assert np.array_equal(mask, dense.numpy() >= np.float32(0.5))
    for g, q in enumerate(queries[:4]):
        di, ds = index.topk(q, 10, plan="dense")
        assert np.array_equal(ids[g].cpu().numpy(), di)
        assert np.array_equal(vals[g].cpu().numpy(), ds)


# ---------------------------------------------------------------------------
# B6: causal GQA flash attention
# ---------------------------------------------------------------------------


FLASH_BF16_REL_RMS = 2.0 ** -10


def _launched_bodies(fn):
    """fn()'s result and the B6 bodies that ran meanwhile, by the kernels'
    own count on the card."""
    before = body_launches()
    out = fn()
    after = body_launches()
    return out, {k: n - before[k] for k, n in after.items() if n > before[k]}


@pytest.mark.parametrize("b,s,hq,hkv,d,dtype", [
    (1, 256, 4, 2, 64, torch.float32),
    (2, 256, 8, 8, 32, torch.float32),      # MHA (G=1)
    (2, 512, 4, 1, 64, torch.float32),      # MQA (G=4)
    (1, 256, 4, 2, 64, torch.bfloat16),
    (2, 1, 16, 8, 128, torch.bfloat16),     # S = 1
    (2, 100, 16, 8, 128, torch.float32),    # S not a tile multiple
    (1, 777, 4, 2, 16, torch.bfloat16),
    # The tensor-core body (bf16, D = 128): G = 1, 2, 4, 8; S = 1, 100,
    # 777, 4,096; B = 2 (rows of one batch must not reach the other's).
    (1, 256, 8, 8, 128, torch.bfloat16),    # G = 1
    (1, 256, 16, 8, 128, torch.bfloat16),   # G = 2
    (1, 256, 16, 4, 128, torch.bfloat16),   # G = 4
    (1, 256, 16, 2, 128, torch.bfloat16),   # G = 8
    (1, 1, 16, 8, 128, torch.bfloat16),     # S = 1
    (1, 100, 16, 8, 128, torch.bfloat16),   # S = 100
    (1, 777, 16, 8, 128, torch.bfloat16),   # S = 777
    (1, 4096, 16, 8, 128, torch.bfloat16),  # S = 4,096
    (2, 777, 8, 2, 128, torch.bfloat16),    # B = 2
])
def test_flash_kernel_matches_plain(cuda_device, b, s, hq, hkv, d, dtype):
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s, h, d)).astype(
        np.float32)).to(cuda_device, dtype) for h in (hq, hkv, hkv))
    before = flash_attention.launches
    got, bodies = _launched_bodies(lambda: flash_attention(q, k, v))
    assert flash_attention.launches == before + 1
    want = ref.flash_attention_ref(q, k, v)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    tensor_cores = dtype == torch.bfloat16 and d in (64, 128)
    assert bodies == {"wgmma" if tensor_cores else "cuda-core": 1}
    if dtype == torch.bfloat16:
        err = (got.float() - want.float()).pow(2).mean().sqrt()
        assert err <= FLASH_BF16_REL_RMS * want.float().pow(2).mean().sqrt()


@pytest.mark.parametrize("hq,hkv,d,dtype,cut", [
    (2, 2, 32, torch.float32, 128),
    (4, 2, 128, torch.bfloat16, 100),   # tensor cores, cut inside a tile
], ids=["f32", "bf16"])
def test_flash_kernel_is_causal(cuda_device, hq, hkv, d, dtype, cut):
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 256, h, d)).astype(
        np.float32)).to(cuda_device, dtype) for h in (hq, hkv, hkv))
    out1, bodies = _launched_bodies(lambda: flash_attention(q, k, v))
    tensor_cores = dtype == torch.bfloat16
    assert bodies == {"wgmma" if tensor_cores else "cuda-core": 1}
    k[:, cut:] = 99.0
    v[:, cut:] = -99.0
    out2 = flash_attention(q, k, v)
    torch.testing.assert_close(out1[:, :cut], out2[:, :cut], rtol=1e-6,
                               atol=1e-6)


def test_flash_kernel_takes_unaligned_views(cuda_device):
    """TMA reads only 16-byte aligned tensors: a contiguous view at an odd
    offset gives the output of its aligned copy."""
    rng = np.random.default_rng(3)
    n = 1 * 128 * 4 * 128
    flat = torch.from_numpy(rng.normal(size=n + 1).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    q = flat[1:].view(1, 128, 4, 128)
    assert q.is_contiguous() and q.data_ptr() % 16
    k, v = (torch.from_numpy(rng.normal(size=(1, 128, 2, 128)).astype(
        np.float32)).to(cuda_device, torch.bfloat16) for _ in range(2))
    torch.testing.assert_close(flash_attention(q, k, v),
                               flash_attention(q.clone(), k, v),
                               rtol=0, atol=0)

