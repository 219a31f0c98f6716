#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of GB-KMV on one NVIDIA card and check it.

    python3 chip_smoke.py

Runs the port's main path (``repro_torch.api``) at the NETFLIX deployment:
the repo's NETFLIX spec (α1 1.14, α2 4.95, sizes 10-1200, seed 11) at the
published record count of paper Table II (480,189 records over 17,770
elements), budget 10 % of all element ids (the rule of
benchmarks/bench_planner.py). Each phase prints one JSON line:

  card     the card's name and power limit, versions, the kernels' build
  build    device build (B2 kernel) bit-identical to the host build, in
           both τ modes; host and device seconds
  query    64 batches of 16 queries at t ∈ {0.5, 0.7, 0.9} and top-10 for
           64 queries; hits and rankings of 4 batches checked against the
           host numpy route over all records; batch latency and QPS
  save     save/load round trip answers identically
  parity   each kernel against its plain PyTorch version on the card, at
           the main path's shapes and on edge cases, exact equality
  kernels  per kernel: launches on the main path, error, times, bound

The launch counts are set to 0 just before the main path (build, query,
save) and read just after; the parity phase's launches do not count. Any
failed check raises, so the script exits non-zero and prints no result.
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.core import gbkmv  # noqa: E402
from repro_torch.core.estimators import gbkmv_containment_np  # noqa: E402
from repro_torch.core.hashing import PAD, as_u64, to_numpy, to_tensor  # noqa: E402
from repro_torch.core.sketches import RaggedBatch  # noqa: E402
from repro_torch.data.datasets import SPECS  # noqa: E402
from repro_torch.data.synth import generate_dataset, make_query_workload  # noqa: E402
from repro_torch.kernels import library, ref  # noqa: E402
from repro_torch.kernels.gbkmv_score import gbkmv_score  # noqa: E402
from repro_torch.kernels.hash_threshold import (  # noqa: E402
    fused_build_columns, hash_threshold)
from repro_torch.planner import topk_select  # noqa: E402

NUM_RECORDS = 480_189      # paper Table II, Netflix
UNIVERSE = 17_770
BUDGET_FRACTION = 0.10
GQ = 16
NUM_BATCHES = 64
THRESHOLDS = (0.5, 0.7, 0.9)
TOPK = 10
CHECK_BATCHES = 4

# Published H100 SXM peaks: HBM rate, and the
# float32 rate outside the tensor cores, used for the kernels' ALU work.
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12

KERNELS = {
    "hash_threshold": {
        "source": "src/repro_torch/kernels/csrc/hash_threshold.cu",
        "replaces": "src/repro/kernels/hash_threshold.py:38",
    },
    "gbkmv_score": {
        "source": "src/repro_torch/kernels/csrc/gbkmv_score.cu",
        "replaces": "src/repro/kernels/gbkmv_score.py:43",
    },
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def sync() -> None:
    torch.cuda.synchronize()


def cuda_ms(fn, reps: int) -> float:
    """Median device milliseconds of one call, from CUDA events around
    each of ``reps`` calls after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def pctl(xs, q) -> float:
    return float(np.percentile(np.asarray(xs), q))


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_card() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    lib_path = library.build()
    library.library()
    build_s = time.perf_counter() - t0
    log = (lib_path.parent / "build.log").read_text()
    regs = [line.split("ptxas info    : ")[-1] for line in log.splitlines()
            if "registers" in line]
    out = {"phase": "card", "nvidia_smi": smi,
           "name": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(), "python": sys.version.split()[0],
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "kernel_build_s": build_s, "ptxas": regs}
    emit(out)
    return out


def make_records():
    spec = SPECS["NETFLIX"]
    t0 = time.perf_counter()
    recs = generate_dataset(m=NUM_RECORDS, n_elems=UNIVERSE,
                            alpha_freq=spec.alpha_freq,
                            alpha_size=spec.alpha_size,
                            size_min=spec.size_min, size_max=spec.size_max,
                            seed=spec.seed)
    return recs, time.perf_counter() - t0


def _host_columns(s) -> dict:
    """An arena's columns as numpy (u32 columns as uint32)."""
    return {"values": to_numpy(s.values), "lengths": s.lengths.cpu().numpy(),
            "thresh": to_numpy(s.thresh), "buf": to_numpy(s.buf),
            "sizes": s.sizes.cpu().numpy()}


def phase_build(batch: RaggedBatch, budget: int):
    """The api's device build in both τ modes, each checked bit for bit
    against the host build; the exact-mode index serves the queries."""
    # The host half of construction, timed on its own.
    t0 = time.perf_counter()
    uniq, counts = gbkmv.element_frequencies_csr(batch)
    r = gbkmv._auto_buffer_bits(counts, batch.sizes.astype(np.int64), budget,
                                batch.num_records)
    top = gbkmv.choose_top_elements_csr(uniq, counts, r)
    is_top, bit = gbkmv.top_membership(batch.ids, top)
    bitmaps = gbkmv.make_bitmaps(batch, top, membership=(is_top, bit))
    host_part_s = time.perf_counter() - t0
    tail_budget = max(budget - batch.num_records * (-(-r // 32) if r else 0),
                      batch.num_records)

    # The tail budget is floored at one slot per record; where the buffer
    # words take most of the budget, the floor is what the tail gets.
    out = {"phase": "build", "records": batch.num_records,
           "element_ids": batch.total, "budget": budget, "r": r,
           "tail_ids": int((~is_top).sum()), "tail_budget": tail_budget,
           "tail_budget_at_floor": tail_budget == batch.num_records,
           "host_part_s": host_part_s}
    serving = None
    for tau_mode in ("exact", "histogram"):
        t0 = time.perf_counter()
        dev = api.build("gbkmv", batch, budget, tau_mode=tau_mode)
        sync()
        api_build_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        fused_build_columns(batch, ~is_top, tail_budget, tau_mode=tau_mode,
                            bitmaps=bitmaps, device="cuda")
        sync()
        device_part_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        host = gbkmv.build_gbkmv(batch, budget, tau_mode=tau_mode,
                                 build_backend="numpy", device="cpu")
        host_build_s = time.perf_counter() - t0

        require(dev.core.sketches.device.type == "cuda",
                "device build left its columns on the card")
        dcols = _host_columns(dev.core.sketches)
        hcols = _host_columns(host.sketches)
        for name in dcols:
            require(dcols[name].shape == hcols[name].shape
                    and np.array_equal(dcols[name], hcols[name]),
                    f"{tau_mode} device build column {name} equals host build")
        require(np.uint32(dev.core.tau) == np.uint32(host.tau),
                f"{tau_mode} τ equal")
        require(np.array_equal(dev.core.top_elems, host.top_elems)
                and dev.core.buffer_bits == host.buffer_bits == r,
                f"{tau_mode} buffer elements equal")
        lengths = dcols["lengths"]
        out[tau_mode] = {"tau": int(dev.core.tau),
                         "capacity": dev.core.sketches.capacity,
                         "mean_length": float(lengths.mean()),
                         "rows_by_length": np.bincount(
                             np.minimum(lengths, 4)).tolist(),
                         "buf_words": dev.core.sketches.buf_words,
                         "arena_bytes": dev.core.sketches.nbytes(),
                         "api_build_s": api_build_s,
                         "device_part_s": device_part_s,
                         "host_build_s": host_build_s,
                         "identical_to_host_build": True}
        if tau_mode == "exact":
            serving = dev
    emit(out)
    return serving, ~is_top


def numpy_scores(index, queries) -> np.ndarray:
    """The host numpy route: the reference's estimator over all records."""
    cols = SimpleNamespace(**_host_columns(index.core.sketches))
    qp = gbkmv.sketch_query_batch(index.core, queries)
    qv, qt, qb = to_numpy(qp.values), to_numpy(qp.thresh), to_numpy(qp.buf)
    qs = qp.sizes.numpy()
    return np.stack([gbkmv_containment_np(qv[g], qt[g], qb[g], qs[g], cols)
                     for g in range(len(queries))], axis=-1)


def query_breakdown(index, batches, t) -> dict:
    """Median host-clock ms of each layer a dense batch passes through,
    called as ``batch_query`` calls them, with a sync after the device
    work; and the same split for top-k (scores, then the host head)."""
    from repro_torch.core.estimators import containment_matrix
    from repro_torch.planner import f32_threshold, mask_to_hits

    x = index.core.sketches.device_pack(index.device)
    thr = torch.tensor([float(f32_threshold(t))], device=x.device)
    rows = []
    for b in batches:
        t0 = time.perf_counter()
        qp = gbkmv.sketch_query_batch(index.core, b)
        t1 = time.perf_counter()
        s = containment_matrix(qp, x, as_numpy=False)
        sync()
        t2 = time.perf_counter()
        mask = (s >= thr[None, :]).cpu().numpy()
        t3 = time.perf_counter()
        mask_to_hits(mask)
        t4 = time.perf_counter()
        rows.append((t1 - t0, t2 - t1, t3 - t2, t4 - t3))
    med = np.median(np.asarray(rows) * 1e3, axis=0)
    topk_rows = []
    for q in batches[0]:
        t0 = time.perf_counter()
        sc = index.scores(q)
        t1 = time.perf_counter()
        topk_select(np.arange(len(sc)), sc, TOPK, len(sc))
        topk_rows.append((t1 - t0, time.perf_counter() - t1))
    tmed = np.median(np.asarray(topk_rows) * 1e3, axis=0)
    return {"threshold": t, "sketch_ms": med[0], "score_ms": med[1],
            "mask_fetch_ms": med[2], "hits_ms": med[3],
            "score_share": med[1] / med.sum(),
            "topk_scores_ms": tmed[0], "topk_select_ms": tmed[1]}


def phase_query(index, batches):
    lat_ms, hits_seen = [], {}
    index.batch_query(batches[0], THRESHOLDS[0], plan="dense")   # warm-up
    sync()
    t_all = time.perf_counter()
    for t in THRESHOLDS:
        for i, b in enumerate(batches):
            t0 = time.perf_counter()
            hits = index.batch_query(b, t, plan="dense")
            lat_ms.append((time.perf_counter() - t0) * 1e3)
            if i < CHECK_BATCHES:
                hits_seen[(i, t)] = hits
            require(len(hits) == GQ, "one hit list per query")
    wall_s = time.perf_counter() - t_all
    n_queries = len(THRESHOLDS) * len(batches) * GQ

    topk_queries = [q for b in batches[:CHECK_BATCHES] for q in b]
    topk_ms, topk_seen = [], []
    for q in topk_queries:
        t0 = time.perf_counter()
        topk_seen.append(index.topk(q, TOPK))
        topk_ms.append((time.perf_counter() - t0) * 1e3)
    require(index.last_plan.reason == "planner not yet ported",
            "dense route recorded")
    breakdown = query_breakdown(index, batches, THRESHOLDS[1])

    # Hits and rankings against the host numpy route over all records.
    m = index.num_records
    hit_total = 0
    for i in range(CHECK_BATCHES):
        s_np = numpy_scores(index, batches[i])
        require(s_np.shape == (m, GQ) and np.isfinite(s_np).all(),
                "numpy route scores finite")
        for t in THRESHOLDS:
            for g in range(GQ):
                # Hits are Ĉ ≥ t with t a double (the reference's
                # contract); a bare float32 compare would round t first.
                want = np.nonzero(s_np[:, g].astype(np.float64) >= t)[0]
                require(np.array_equal(hits_seen[(i, t)][g], want),
                        f"hits of batch {i} query {g} at t={t}")
                hit_total += len(want)
        for g in range(GQ):
            ids, sc = topk_seen[i * GQ + g]
            wids, wsc = topk_select(np.arange(m), s_np[:, g], TOPK, m)
            require(np.array_equal(ids, wids)
                    and np.array_equal(sc.view(np.uint32), wsc.view(np.uint32)),
                    f"top-{TOPK} of batch {i} query {g}")
    out = {"phase": "query", "batches": len(THRESHOLDS) * len(batches),
           "gq": GQ, "thresholds": list(THRESHOLDS),
           "batch_ms_p50": pctl(lat_ms, 50), "batch_ms_p90": pctl(lat_ms, 90),
           "batch_ms_p99": pctl(lat_ms, 99), "samples": len(lat_ms),
           "qps": n_queries / wall_s, "topk_k": TOPK,
           "topk_queries": len(topk_queries),
           "topk_ms_p50": pctl(topk_ms, 50), "topk_ms_p90": pctl(topk_ms, 90),
           "checked_batches": CHECK_BATCHES, "checked_hits": hit_total,
           "checked_topk": len(topk_queries), "matches_numpy_route": True,
           "breakdown": breakdown}
    emit(out)
    return hits_seen, topk_seen, topk_queries


def phase_save(index, batches, hits_seen, topk_seen, topk_queries):
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "netflix.npz")
        t0 = time.perf_counter()
        index.save(path)
        save_s = time.perf_counter() - t0
        size = Path(path).stat().st_size
        t0 = time.perf_counter()
        again = api.load_index(path)
        load_s = time.perf_counter() - t0
    for (i, t), hits in hits_seen.items():
        got = again.batch_query(batches[i], t)
        require(all(np.array_equal(a, b) for a, b in zip(got, hits)),
                f"reloaded hits of batch {i} at t={t}")
    for q, (ids, sc) in zip(topk_queries[:GQ], topk_seen):
        rids, rsc = again.topk(q, TOPK)
        require(np.array_equal(ids, rids) and np.array_equal(sc, rsc),
                "reloaded top-k")
    emit({"phase": "save", "file_bytes": size, "save_s": save_s,
          "load_s": load_s, "identical_after_reload": True})


def _edge_score_inputs():
    """B1 edge cases: k < 2, K∩ = 0, all-PAD rows, threshold-0 (padded)
    records, an empty buffer word, odd M, a query of size 0."""
    xv = np.full((9, 8), PAD, np.uint32)
    xv[0, :1] = [5]
    xv[1, :3] = [1, 2, 3]
    xv[2, :4] = [5, 9, 17, 30]
    xv[4, :2] = [5, 9]
    xv[5, :2] = [0, 5]
    xv[6, :3] = [5, 9, 40]
    xv[8, :8] = [2, 5, 9, 11, 13, 30, 31, 32]
    xt = np.asarray([5, 50, 50, 50, 0, 0, PAD - 1, 0, 31], np.uint32)
    qv = np.full((3, 8), PAD, np.uint32)
    qv[0, :1] = [5]
    qv[1, :6] = [0, 5, 9, 30, 31, 32]
    xb = np.zeros((9, 1), np.uint32)
    xb[2, 0] = 0b1011
    qb = np.asarray([[0b0011], [0b1111], [0]], np.uint32)
    qt = np.asarray([50, PAD - 1, 50], np.uint32)
    qs = np.asarray([4, 7, 0], np.int32)
    cols = [to_tensor(a) for a in (xv, xt, xb, qv, qt, qb)]
    return [c.cuda() for c in cols] + [torch.from_numpy(qs).cuda()]


def phase_parity(index, batch, tail_mask, query_batch) -> dict:
    """Each kernel against its plain version on the same card tensors,
    exact equality; then their times at the main path's shapes."""
    results = {}

    # -- B2 over the slice's tail-id stream plus edge ids --------------------
    tail = batch.ids[tail_mask]
    edge = np.asarray([0, 1, 2**31, 2**32 - 1, 2**32, 2**32 + 5, 2**40 + 7],
                      np.int64)
    ids = np.concatenate([tail, edge])
    ids32 = to_tensor((ids.astype(np.uint64) & np.uint64(0xFFFFFFFF))
                      .astype(np.uint32)).cuda()
    ids64 = torch.from_numpy(ids).cuda()
    err = 0
    for tau in (0, int(index.core.tau), int(PAD)):
        h, keep = hash_threshold(ids32, 0, tau)
        h_want, keep_want = ref.hash_threshold_ref(ids64, 0, tau)
        sync()
        require(torch.equal(as_u64(h), h_want)
                and torch.equal(keep.bool(), keep_want),
                f"hash_threshold kernel equals plain version at tau={tau}")
        err = max(err, int((as_u64(h) - h_want).abs().max()))
    h, keep = hash_threshold(ids32, 0)       # the device build's form
    sync()
    require(keep is None and torch.equal(as_u64(h), h_want),
            "hash_threshold kernel (hashes only) equals plain version")
    tail32 = ids32[: len(tail)]
    n = tail32.numel()
    # Timed as the device build calls it: hashes only, 4 B in, 4 B out.
    results["hash_threshold"] = {
        "shape": [n], "max_abs_err": float(err), "parity": "exact",
        "ms": cuda_ms(lambda: hash_threshold(tail32, 0), 50),
        "plain_ms": cuda_ms(lambda: ref.hash_threshold_ref(tail32, 0, None), 5),
        "bytes": 8 * n, "ops": 11 * n,
    }

    # -- B1 at the main path's shapes plus edge cases --------------------------
    x = index.core.sketches.device_pack("cuda")
    qp = gbkmv.sketch_query_batch(index.core, query_batch).to("cuda")
    args = (x.values, x.thresh, x.buf, qp.values, qp.thresh, qp.buf, qp.sizes)
    got = gbkmv_score(*args)
    want = ref.gbkmv_score_ref(*args)
    sync()
    require(torch.equal(got, want),
            "gbkmv_score kernel equals plain version at the slice's shapes")
    err = float((got - want).abs().max())
    edge_args = _edge_score_inputs()
    for cut in (9, 8, 4, 1):               # odd and even M
        e = [t[:cut] for t in edge_args[:3]] + edge_args[3:]
        require(torch.equal(gbkmv_score(*e), ref.gbkmv_score_ref(*e)),
                f"gbkmv_score kernel equals plain version on edge cases M={cut}")
    nobuf = list(edge_args)
    nobuf[2] = nobuf[2][:, :0].contiguous()
    nobuf[5] = nobuf[5][:, :0].contiguous()
    require(torch.equal(gbkmv_score(*nobuf), ref.gbkmv_score_ref(*nobuf)),
            "gbkmv_score kernel equals plain version with no buffer words")

    m, c = x.values.shape
    gq, cq = qp.values.shape
    w = x.buf.shape[1]
    xu = as_u64(x.values)
    tau_pair = torch.minimum(as_u64(x.thresh)[:, None],
                             as_u64(qp.thresh)[None, :])       # [m, gq]
    live_x = sum(int((xu <= tau_pair[:, g:g + 1]).sum()) for g in range(gq))
    live = live_x + sum(int((as_u64(qp.values[g])[None, :]
                             <= tau_pair[:, g:g + 1]).sum()) for g in range(gq))
    # Bytes the function must move. A record row is read only up to its
    # first value above τ_pair (or its end): with the largest τ_pair of the
    # batch, that is min(C, n + 1) values, in whole 32-B sectors (rows start
    # on a sector, as C is a multiple of 8). Then the thresholds, buffers,
    # the query pack, and the f32[M, Gq] output written once.
    tau_row = torch.minimum(as_u64(x.thresh), as_u64(qp.thresh).max())
    reads = torch.clamp_max((xu <= tau_row[:, None]).sum(1) + 1, c)
    start = torch.arange(m, device=xu.device) * (4 * c)
    sectors = int(((start + 4 * reads - 1) // 32 - start // 32 + 1).sum())
    results["gbkmv_score"] = {
        "shape": [m, c, gq, cq, w], "max_abs_err": err, "parity": "exact",
        "ms": cuda_ms(lambda: gbkmv_score(*args), 50),
        "plain_ms": cuda_ms(lambda: ref.gbkmv_score_ref(*args), 3),
        "live_x_per_pair": live_x / (m * gq),
        "row_values_read_per_record": float(reads.float().mean()),
        "row_bytes": 32 * sectors,
        "bytes": 32 * sectors + 4 * (m * (1 + w) + gq * (cq + 2 + w) + m * gq),
        # Per pair: the live-prefix counts and the merge (each at most
        # n_x + n_q steps), an AND and a popcount per buffer word, and
        # about a dozen float operations in the tail.
        "ops": 2 * live + m * gq * (2 * w + 12),
    }
    emit({"phase": "parity", **{k: {"shape": v["shape"], "parity": "exact",
                                    "max_abs_err": v["max_abs_err"]}
                                for k, v in results.items()},
          "gbkmv_score_load": {k: results["gbkmv_score"][k] for k in (
              "live_x_per_pair", "row_values_read_per_record", "row_bytes")}})
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = phase_card()

    recs, gen_s = make_records()
    batch = RaggedBatch.from_records(recs)
    budget = int(batch.total * BUDGET_FRACTION)
    queries = make_query_workload(recs, NUM_BATCHES * GQ, seed=2)
    batches = [queries[i * GQ:(i + 1) * GQ] for i in range(NUM_BATCHES)]
    emit({"phase": "data", "records": len(recs), "universe": UNIVERSE,
          "element_ids": batch.total,
          "mean_length": batch.total / len(recs),
          "max_length": int(batch.sizes.max()), "generate_s": gen_s})

    # The main path: launch counts from 0, read right after.
    hash_threshold.launches = 0
    gbkmv_score.launches = 0
    index, tail_mask = phase_build(batch, budget)
    hits_seen, topk_seen, topk_queries = phase_query(index, batches)
    phase_save(index, batches, hits_seen, topk_seen, topk_queries)
    sync()
    launches = {"hash_threshold": hash_threshold.launches,
                "gbkmv_score": gbkmv_score.launches}
    for name, count in launches.items():
        require(count > 0, f"{name} launched on the main path")

    results = phase_parity(index, batch, tail_mask, batches[0])
    kernels = []
    for name, r in results.items():
        bytes_ms = r["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = r["ops"] / ALU_OPS_PER_S * 1e3
        kernels.append({
            "name": name, "route": "cuda", **KERNELS[name],
            "launches": launches[name], "parity": r["parity"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
            "library_note": "no single PyTorch call computes this function",
            "shape": r["shape"], "bytes": r["bytes"], "ops": r["ops"],
            "card": card["nvidia_smi"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
