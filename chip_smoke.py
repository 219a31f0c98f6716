#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of GB-KMV on one NVIDIA card and check it.

    python3 chip_smoke.py

Runs the port's main paths (``repro_torch.api``) at the NETFLIX
deployment: the repo's NETFLIX spec (α1 1.14, α2 4.95, sizes 10-1200,
seed 11) at the published record count of paper Table II (480,189 records
over 17,770 elements), budget 10 % of all element ids (the rule of
benchmarks/bench_planner.py). Each phase prints one JSON line:

  card     the card's name and power limit, versions, the kernels' build
  build    device build (B2 kernel) bit-identical to the host build, in
           both τ modes; host and device seconds, and the device part's
           stages one by one with a sync after each (``device_split_ms``,
           taken before the counted run and held equal to the whole
           function's pack)
  query    64 batches of 16 queries at t ∈ {0.5, 0.7, 0.9} and top-10 for
           64 queries on the dense route; hits and rankings of 4 batches
           checked against the host numpy route over all records; batch
           latency and QPS
  save     save/load round trip answers identically
  pruned   the device pruned route (backend="torch"): postings built
           lazily on the host and eagerly by the device encode (equal, and
           their device mirrors equal), plan="auto" on one batch, forced
           plan="pruned" on every batch at each t (hits of 4 batches equal
           the dense route's; p50/p99 batch latency), pruned top-10 of the
           64 checked queries equal to dense, batch 0's raw scores equal to
           B1's matrix bit for bit, one batch's middle under
           torch.cuda.set_sync_debug_mode("error"), a stage breakdown with
           CUDA events, and a save/load round trip carrying the postings
  host_pruned  the planner's host route (planner.pruned_batch /
           pruned_topk with the index's B5 verify) on 4 batches at each t
           and 16 top-10s, equal to the dense and device routes; its stages,
           and per top-10 its B5 launches (one to four growing prefixes of
           the bound-ordered list) and n, its threshold-0 candidates
  gkmv     the G-KMV engine at the same records and budget (the whole
           budget in the KMV tail, no buffer words): the core build on the
           card and on the host in both τ modes, bit-identical; 8 batches
           at each t on the dense route (B1 at W = 0) and the forced
           device pruned route (B3, B4 on long posting lists and dense
           blocks), one plan="auto" batch, 8 top-10s on both; the host
           route (B5) on 2 batches at t = 0.7 and 4 top-10s; every route's
           hits and top-10 orders equal, 2 batches also against the numpy
           route over all records; the postings encoded on the card equal
           the host's; capacity, tail keys, blocks, dense blocks, longest
           posting list, p50/p99 per route, B5's launches and n per top-10
  kmv      the plain-KMV engine (k = max(budget // m, 2)): the api's device
           build (the row_cap route, B2 hashes only) bit-identical to the
           host build; 8 batches at t ∈ {0.5, 0.9} on the dense and pruned
           (host) routes and 8 top-10s on both, kmv's estimator as torch
           ops on the card, all equal to the numpy backend's
  lm       LM serving (``repro_torch.launch.serve``'s functions): qwen3-0.6b
           at full width, weights drawn from --seed on the card in bf16,
           prefill of 4 × 4,096 tokens (causal attention by the B6 kernel)
           and 16 greedy decode steps; prefill seconds and decode tokens/s;
           the last-token logits against the same prefill with the plain
           chunked attention on the card; decode after prefill against the
           full forward at 2 × 256 (tests/test_archs_smoke.py): 2e-2 in f32;
           in bf16, on the B6 route and on the plain route, an absolute
           limit that a one-slot-early cache write (run as a control)
           exceeds; a torch.profiler breakdown of one
           prefill and three decode steps (device busy and idle share);
           B6's tensor-core body must have run once per layer, as the
           kernels count their own launches on the card
  parity   each kernel against its plain PyTorch version on the card, at
           the main paths' shapes and on edge cases: exact equality for
           B1-B5 (B2 in both forms also on the tail stream 1-3 words off
           16-B alignment and at lengths 5, 257 and n - 1, with its bare
           time in both forms, registers and SASS; B1 also at Gq = 1, 3
           and 17 through ops.score_index and with record and query thresholds below the global τ, at
           NETFLIX's M, and at W = 0 on the gkmv index; B3 and B4 also on
           the gkmv tail; B5 also at the gkmv host route's pairs; B5 and
           B1's entries also at the first top-10's whole
           bound-ordered list, and on B5's own edges: c % 4 != 0, W = 0,
           W = 9, P = 1, P not a multiple of its CTA's pairs, unaligned
           rows, and query rows of 1,024 values; B3's pos, hit and block-task prefix also past one CTA
           tile and on key columns past its shared-memory budget, with the
           fence stride each ran with; B4 also on an index whose tail has
           dense-bitmap blocks and on synthetic blocks, with how its C entry
           zeroes the counts, its registers and its SASS instruction
           count, timed bare and as the decode alone; the fused front end
           against the probe + torch prefix, timed in turns with it and
           with torch.searchsorted), 2e-2 (bf16) and 2e-5 (f32) for B6 on
           each case, with the body that ran (tensor cores, "wgmma", or
           CUDA cores, as the kernels count their own launches on the
           card, and required to be the one its dtype and D call for)
           and, in bf16, a relative RMS error limit with a
           truncated-output control that exceeds it; causality on both
           bodies; SDPA's error beside B6's; the HGMMA and TMA-load
           instructions in the tensor-core body's SASS
  kernels  per kernel: launches on the main paths, error, times, bound

Eight main paths are counted: the dense path (build, query, save), the
device pruned path (the pruned phase's api calls), the host pruned path
(the host_pruned phase's planner calls), the gkmv phase's three (build
and dense, device pruned, host) and the kmv phase's, and the LM path
(prefill and decode). The launch counts are set to 0
just before each and read just after. The checks and stage-by-stage
re-runs come after that read, and the parity phase's launches do not
count either. Any failed check raises, so the script exits non-zero and
prints no result. The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.core import gbkmv, gkmv, kmv  # noqa: E402
from repro_torch.core.arena import DevicePostings  # noqa: E402
from repro_torch.core.estimators import (  # noqa: E402
    containment_matrix, gbkmv_containment_np)
from repro_torch.core.hashing import (  # noqa: E402
    PAD, as_bits, as_u64, seed_offset, to_numpy, to_tensor)
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.sketches import (  # noqa: E402
    RaggedBatch, _resolve_capacity)
from repro_torch.data.datasets import SPECS  # noqa: E402
from repro_torch.data.synth import generate_dataset, make_query_workload  # noqa: E402
from repro_torch.kernels import library, postings_merge, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    body_launches as flash_body_launches, flash_attention)
from repro_torch.kernels.gather_score import (  # noqa: E402
    fetch_scores, gather_score, stage_pairs)
from repro_torch.kernels.gbkmv_score import gbkmv_score  # noqa: E402
from repro_torch.kernels.ops import score_index  # noqa: E402
from repro_torch.kernels.hash_threshold import (  # noqa: E402
    _fused_pack, fused_build_columns, fused_encode_postings, hash_threshold)
from repro_torch.kernels.postings_merge import (  # noqa: E402
    block_decode, fence_shift, postings_probe, probe_tasks)
from repro_torch.planner import (  # noqa: E402
    PostingsIndex, candidates_for, choose_plan, encode_store,
    f32_threshold, mask_to_hits, postings_equal, pruned_batch, pruned_topk,
    threshold_hits_packed, topk_candidates, topk_select)
from repro_torch.planner.postings import build_postings_device  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import common as model_common  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.attention import (  # noqa: E402
    causal_attention, causal_attention_plain)
from repro_torch.planner import device as planner_device  # noqa: E402
from repro_torch.sketchindex.build import histogram_tau  # noqa: E402

NUM_RECORDS = 480_189      # paper Table II, Netflix
UNIVERSE = 17_770
BUDGET_FRACTION = 0.10
GQ = 16
NUM_BATCHES = 64
THRESHOLDS = (0.5, 0.7, 0.9)
TOPK = 10
CHECK_BATCHES = 4

# The LM path: qwen3-0.6b at full width. Batch and sequence are cut from
# prefill_32k's 32 × 32,768 (its KV cache, ~120 GB, is over one card) to
# 4 × 4,096, the seq of train_4k (src/repro/configs/shapes.py).
LM_ARCH = "qwen3-0.6b"
LM_BATCH = 4
LM_SEQ = 4_096
LM_DECODE_STEPS = 16
LM_CHECK_BATCH = 2          # the decode-after-prefill check's prompt
LM_CHECK_SEQ = 256
# Tolerances of tests/test_flash_kernel.py (and of
# tests/test_archs_smoke.py's decode check).
LM_TOL = 2e-2               # bf16
F32_TOL = 2e-5              # f32
# In bf16 at full depth, decode after prefill and the full forward round
# their GEMMs at different shapes through 28 layers, and part by ~0.06
# on either attention route, over LM_TOL. A sound decode is held to this
# absolute limit instead; a decode whose cache write is one slot early
# (the control the lm phase also runs) parts by ~0.6 and must exceed it.
LM_BF16_DECODE_LIMIT = 0.2
# B6 in bf16: the RMS of its error over the RMS of the plain version's
# output. The two round the same f32 sums, so they differ in under 0.1 %
# of outputs; an output truncated to bf16 instead of rounded reads ~4e-3.
FLASH_BF16_REL_RMS = 2.0 ** -10

# The card every phase runs on.
DEV = torch.device("cuda")

# Published H100 SXM peaks: HBM rate, and the
# float32 rate outside the tensor cores, used for the kernels' ALU work.
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
# The bf16 dense tensor-core rate (NVIDIA H100 SXM data sheet, without
# sparsity): the bound of the attention kernel's two products.
TENSOR_BF16_FLOPS = 989e12

KERNELS = {
    "hash_threshold": {
        "source": "src/repro_torch/kernels/csrc/hash_threshold.cu",
        "replaces": "src/repro/kernels/hash_threshold.py:38",
    },
    "gbkmv_score": {
        "source": "src/repro_torch/kernels/csrc/gbkmv_score.cu",
        "replaces": "src/repro/kernels/gbkmv_score.py:43",
    },
    "gather_score": {
        "source": "src/repro_torch/kernels/csrc/gather_score.cu",
        "replaces": "src/repro/kernels/gather_score.py:41",
    },
    "postings_probe": {
        "source": "src/repro_torch/kernels/csrc/postings_probe.cu",
        "replaces": "src/repro/kernels/postings_merge.py:104",
    },
    "block_decode": {
        "source": "src/repro_torch/kernels/csrc/block_decode.cu",
        "replaces": "src/repro/kernels/postings_merge.py:177",
    },
    "flash_attention": {
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:40",
    },
}
# The kernels each main path must launch: the dense route (build, query,
# save), the device pruned route of the api, the planner's host route, and
# LM prefill + decode.
PATH_KERNELS = {"dense": ("hash_threshold", "gbkmv_score"),
                "pruned": ("postings_probe", "block_decode"),
                "host_pruned": ("gather_score",),
                "gkmv_dense": ("hash_threshold", "gbkmv_score"),
                "gkmv_pruned": ("postings_probe", "block_decode"),
                "gkmv_host": ("gather_score",),
                "kmv": ("hash_threshold",),
                "lm": ("flash_attention",)}
# And the kernels a path must not launch: the dense and device routes
# verify no pairs, the host routes run no device pipeline, and kmv scores
# with its own estimator (torch ops).
PATH_NOT_LAUNCHED = (("dense", "gather_score"), ("pruned", "gather_score"),
                     ("host_pruned", "postings_probe"),
                     ("host_pruned", "block_decode"),
                     ("gkmv_dense", "gather_score"),
                     ("gkmv_pruned", "gather_score"),
                     ("gkmv_host", "postings_probe"),
                     ("gkmv_host", "block_decode"),
                     ("kmv", "postings_probe"), ("kmv", "block_decode"),
                     ("kmv", "gather_score"))
COUNTERS = {"hash_threshold": hash_threshold, "gbkmv_score": gbkmv_score,
            "gather_score": gather_score, "postings_probe": postings_probe,
            "block_decode": block_decode, "flash_attention": flash_attention}


# The script's start on the host clock; every phase line carries the
# seconds since (``elapsed_s``).
T0 = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - T0}
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


def graph_ms(launch, reps: int = 20) -> float:
    """Device milliseconds of one bare kernel launch (no wrapper, no host
    issue time): a CUDA graph of ``reps`` launches, replayed between two
    events. ``launch(stream)`` calls the C entry point and returns its
    error code."""
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            library.check(launch(torch.cuda.current_stream().cuda_stream),
                          "graph capture")
    g.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def turns_ms(fns: dict, reps: int) -> dict:
    """Median device milliseconds of one call of each function, CUDA
    events around each call, the functions called in turns (every rep
    calls each once, in reversed order on odd reps) after one warm-up
    call each."""
    for fn in fns.values():
        fn()
    times = {k: [] for k in fns}
    names = list(fns)
    for r in range(reps):
        for k in (names if r % 2 == 0 else names[::-1]):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fns[k]()
            b.record()
            b.synchronize()
            times[k].append(a.elapsed_time(b))
    return {k: float(np.median(v)) for k, v in times.items()}


def median_host_us(fn, calls: int = 1000) -> float:
    """Median host microseconds of one call of ``fn``: the host clock
    around each of ``calls`` calls after a warm-up, no synchronisation
    inside the timed span (the card is synchronised every 50 calls)."""
    fn()
    sync()
    ts = np.empty(calls)
    for i in range(calls):
        t0 = time.perf_counter_ns()
        fn()
        ts[i] = time.perf_counter_ns() - t0
        if (i + 1) % 50 == 0:
            sync()
    sync()
    return float(np.median(ts)) / 1e3


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


def host_part(batch: RaggedBatch, budget: int, r="auto") -> SimpleNamespace:
    """The host half of a GB-KMV build, as ``gbkmv.build_gbkmv`` runs it
    before the fused device build: r (the cost model's, unless given), the
    buffer elements' membership of every element id, the bitmaps and the
    tail budget (floored at one slot per record), with its host seconds."""
    t0 = time.perf_counter()
    uniq, counts = gbkmv.element_frequencies_csr(batch)
    if r == "auto":
        r = gbkmv._auto_buffer_bits(counts, batch.sizes.astype(np.int64),
                                    budget, batch.num_records)
    top = gbkmv.choose_top_elements_csr(uniq, counts, r)
    is_top, bit = gbkmv.top_membership(batch.ids, top)
    bitmaps = gbkmv.make_bitmaps(batch, top, membership=(is_top, bit))
    seconds = time.perf_counter() - t0
    tail_budget = max(budget - batch.num_records * (-(-r // 32) if r else 0),
                      batch.num_records)
    return SimpleNamespace(r=r, is_top=is_top, bitmaps=bitmaps,
                           tail_budget=tail_budget, seconds=seconds)


def u32_ids(ids: np.ndarray) -> torch.Tensor:
    """An id stream as the device build hands it to B2: u32 bit patterns
    (int32), each id cut to its low 32 bits, on the CPU."""
    return to_tensor((np.asarray(ids).astype(np.uint64)
                      & np.uint64(0xFFFFFFFF)).astype(np.uint32))


TAU_MODES = ("exact", "histogram")


def device_split(batch: RaggedBatch, hp: SimpleNamespace, tau_mode: str
                 ) -> dict:
    """Host-clock ms of each stage of ``fused_build_columns`` (the device
    part of a build), called one by one here in the order the function
    calls them, with a sync after each. The function runs whole first
    (which also warms the stages), and the split's pack and τ must equal
    its own."""
    want, tau_want = fused_build_columns(
        batch, ~hp.is_top, hp.tail_budget, tau_mode=tau_mode,
        bitmaps=hp.bitmaps, device=DEV)
    m, budget = batch.num_records, hp.tail_budget
    ms = {}
    sync()
    t = [time.perf_counter()]

    def lap(stage):
        sync()
        now = time.perf_counter()
        ms[stage] = (now - t[0]) * 1e3
        t[0] = now

    tail_mask = ~hp.is_top
    ids32 = u32_ids(np.asarray(batch.ids)[tail_mask])
    row32 = torch.from_numpy(batch.row_index()[tail_mask].astype(np.int32))
    lap("host_mask_row_u32")
    ids32, row_t = ids32.to(DEV), row32.to(DEV)
    lap("h2d")
    h32, _ = hash_threshold(ids32, 0)
    lap("b2")
    h = as_u64(h32)
    lap("as_u64")
    n = h.numel()
    if budget >= n:
        tau = torch.tensor(int(PAD) - 1, dtype=torch.int64, device=DEV)
    elif tau_mode == "histogram":
        tau = histogram_tau(h, budget)
    else:
        tau = torch.sort(h).values[budget - 1]
    lap("tau")
    keep = torch.ones_like(h, dtype=torch.bool) if budget >= n else h <= tau
    rkey = torch.where(keep, row_t.to(torch.int64), m)
    hkey = torch.where(keep, h, int(PAD))
    key = torch.sort((rkey << 32) | hkey).values
    rs, hs = key >> 32, key & 0xFFFFFFFF
    lap("keep_sort")
    counts = torch.zeros(m + 1, dtype=torch.int64, device=DEV).index_add_(
        0, rs, torch.ones_like(rs))[:m]
    starts = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    lap("counts_prefix")
    max_count, tau_h = torch.stack([counts.max(), tau]).tolist()
    lap("host_read")
    values, lengths, thresh = _fused_pack(
        hs, rs, counts, starts, tau, m=m,
        cap=_resolve_capacity(max_count, None, 8))
    lap("pack")
    buf = to_tensor(hp.bitmaps).to(DEV)
    sizes = torch.from_numpy(batch.sizes).to(DEV)
    lap("buffer_upload")
    got = (values, lengths, thresh, buf, sizes)
    require(all(torch.equal(a, b) for a, b in zip(got, want.columns()))
            and np.uint32(tau_h) == tau_want,
            f"{tau_mode} build's stages one by one equal fused_build_columns")
    return {**ms, "total": sum(ms.values())}


def phase_build(batch: RaggedBatch, budget: int, hp: SimpleNamespace,
                split: dict):
    """The api's device build in both τ modes, each checked bit for bit
    against the host build; the exact-mode index serves the queries.
    ``hp`` is the build's host half (:func:`host_part`), ``split`` each τ
    mode's :func:`device_split`, both taken before the counted run."""
    r, is_top, bitmaps, tail_budget = hp.r, hp.is_top, hp.bitmaps, \
        hp.tail_budget

    # The tail budget is floored at one slot per record; where the buffer
    # words take most of the budget, the floor is what the tail gets.
    out = {"phase": "build", "records": batch.num_records,
           "element_ids": batch.total, "budget": budget, "r": r,
           "tail_ids": int((~is_top).sum()), "tail_budget": tail_budget,
           "tail_budget_at_floor": tail_budget == batch.num_records,
           "host_part_s": hp.seconds}
    serving = None
    for tau_mode in TAU_MODES:
        t0 = time.perf_counter()
        dev = api.build("gbkmv", batch, budget, tau_mode=tau_mode)
        sync()
        api_build_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        fused_build_columns(batch, ~is_top, tail_budget, tau_mode=tau_mode,
                            bitmaps=bitmaps, device=DEV)
        sync()
        device_part_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        host = gbkmv.build_gbkmv(batch, budget, tau_mode=tau_mode,
                                 build_backend="numpy", device="cpu")
        host_build_s = time.perf_counter() - t0

        require(dev.core.sketches.device.type == DEV.type,
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
                         "device_split_ms": split[tau_mode],
                         "host_build_s": host_build_s,
                         "identical_to_host_build": True}
        if tau_mode == "exact":
            serving = dev
    emit(out)
    return serving, ~is_top


def numpy_scores(index, queries) -> np.ndarray:
    """The host numpy route of a gbkmv or gkmv index: the reference's
    estimator over all records on host columns, a query a thread (numpy
    lets go of the GIL in its array operations)."""
    cols = SimpleNamespace(**_host_columns(index._sketch_pack()))
    qp = index._query_pack(queries)
    qv, qt, qb = to_numpy(qp.values), to_numpy(qp.thresh), to_numpy(qp.buf)
    qs = qp.sizes.numpy()
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        parts = pool.map(lambda g: gbkmv_containment_np(qv[g], qt[g], qb[g],
                                                        qs[g], cols),
                         range(len(queries)))
        return np.stack(list(parts), axis=-1)


def query_breakdown(index, batches, t) -> dict:
    """Median host-clock ms of each layer a dense batch passes through,
    called as ``batch_query`` calls them, with a sync after the device
    work; and the same split for top-k (scores, then the host head).
    Any engine: its own query sketch and score matrix."""
    thr = torch.tensor([float(f32_threshold(t))], device=index.device)
    rows = []
    for b in batches:
        t0 = time.perf_counter()
        qp = index._query_pack(b)
        t1 = time.perf_counter()
        s = index._score_matrix(b, as_numpy=False, qp=qp)
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

    require(index.last_plan.path == "dense"
            and index.last_plan.reason == "forced", "dense route recorded")
    topk_queries = [q for b in batches[:CHECK_BATCHES] for q in b]
    topk_ms, topk_seen = [], []
    for q in topk_queries:
        t0 = time.perf_counter()
        topk_seen.append(index.topk(q, TOPK, plan="dense"))
        topk_ms.append((time.perf_counter() - t0) * 1e3)
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
        got = again.batch_query(batches[i], t, plan="dense")
        require(all(np.array_equal(a, b) for a, b in zip(got, hits)),
                f"reloaded hits of batch {i} at t={t}")
    for q, (ids, sc) in zip(topk_queries[:GQ], topk_seen):
        rids, rsc = again.topk(q, TOPK, plan="dense")
        require(np.array_equal(ids, rids) and np.array_equal(sc, rsc),
                "reloaded top-k")
    emit({"phase": "save", "file_bytes": size, "save_s": save_s,
          "load_s": load_s, "identical_after_reload": True})


def phase_pruned(index, batch: RaggedBatch, budget: int, batches,
                 topk_queries) -> dict:
    """The device pruned route on the serving index, through the api
    alone: postings built lazily (host) and eagerly (device encode),
    plan="auto" on one batch, forced plan="pruned" on every batch at each
    t, pruned top-k for the checked queries, and a save/load round trip
    carrying the postings. Records what :func:`check_pruned` holds against
    the dense route; that runs after the launch counts are read."""
    arena = index.core.sketches
    require(arena._post is None, "no postings before the planned path")
    t0 = time.perf_counter()
    post = index._postings()
    lazy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eager = api.build("gbkmv", batch, budget, postings="eager")
    sync()
    eager_s = time.perf_counter() - t0
    run = {"post": post, "eager_post": eager.core.sketches._post,
           "eager_dev_post": eager.core.sketches._dev_post,
           "postings": {
               "nbytes": post.nbytes(), "keys": len(post.keys),
               "tail_entries": post.tail.nnz,
               "tail_blocks": post.tail.num_blocks,
               "buf_entries": post.buf.nnz, "buf_blocks": post.buf.num_blocks,
               "lazy_build_s": lazy_s, "eager_index_build_s": eager_s}}
    del eager

    t0 = time.perf_counter()
    run["auto_hits"] = index.batch_query(batches[0], THRESHOLDS[1])
    run["auto_ms"] = (time.perf_counter() - t0) * 1e3
    run["auto_plan"] = index.last_plan

    index.batch_query(batches[0], THRESHOLDS[0], plan="pruned")   # warm-up
    sync()
    run["forced"], run["forced_ms"] = {}, []
    for t in THRESHOLDS:
        for i, b in enumerate(batches):
            t0 = time.perf_counter()
            got = index.batch_query(b, t, plan="pruned")
            run["forced_ms"].append((time.perf_counter() - t0) * 1e3)
            require(index.last_plan.path == "pruned"
                    and index.last_candidate_sizes is None,
                    "forced pruned batches take the device route")
            if i < CHECK_BATCHES:
                run["forced"][(i, t)] = got

    run["topk"] = []
    for q in topk_queries:
        t0 = time.perf_counter()
        ids, sc = index.topk(q, TOPK, plan="pruned")
        run["topk"].append((ids, sc, (time.perf_counter() - t0) * 1e3))

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "netflix_postings.npz")
        t0 = time.perf_counter()
        index.save(path)
        save_s = time.perf_counter() - t0
        with np.load(path) as f:
            post_keys = sorted(k for k in f.files if k.startswith("post_"))
        size = Path(path).stat().st_size
        t0 = time.perf_counter()
        again = api.load_index(path)
        load_s = time.perf_counter() - t0
    run["reloaded_post"] = again.core.sketches._post
    run["reloaded_hits"] = {t: again.batch_query(batches[0], t, plan="pruned")
                            for t in THRESHOLDS}
    run["reloaded_topk"] = again.topk(batches[0][0], TOPK, plan="pruned")
    run["save"] = {"file_bytes": size, "post_keys": len(post_keys),
                   "save_s": save_s, "load_s": load_s}
    require("post_blk_payload" in post_keys and "post_buf_blk_meta" in post_keys,
            "saved file carries the postings")
    return run


DEVICE_STAGES = ("stage_ms", "probe_b3_ms", "decode_b4_ms", "estimator_ms",
                 "pack_ms", "fetch_ms", "unpack_hits_ms")


def device_stages(index, b, t):
    """One forced-pruned batch on the device route, stage by stage as
    ``pruned_batch_device`` runs it: CUDA events between the stages on the
    device timeline (staging upload, B3 with the block-task prefix, B4,
    the o1 popcount and estimator, the hit-word packing, the fetch), then the
    host clock for unpacking the words and ``mask_to_hits``. Returns
    (ms per stage, host ms of the query sketch and of the planner probe,
    hits)."""
    arena = index._sketch_pack()
    m = arena.num_records
    t0 = time.perf_counter()
    qp, hash_rows, bit_rows, _ = index._plan_queries(b)
    t1 = time.perf_counter()
    choose_plan(index._postings(), hash_rows, bit_rows, t, m, arena.capacity,
                plan="pruned")
    t2 = time.perf_counter()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    ev[0].record()
    dpost, x, sq = planner_device.stage_query_inputs(arena, qp, t,
                                                     device=index.device)
    ev[1].record()
    qv, qt, qb, qs, thr = postings_merge.carve_query_blob(
        sq.blob, gq=sq.gq, cq=sq.cq, w=sq.w)
    pos, hit, cum = probe_tasks(dpost.keys, qv.reshape(-1), dpost.row_blocks)
    ev[2].record()
    kcap = block_decode(pos, hit, dpost.row_blocks, dpost.first, dpost.meta,
                        dpost.off, dpost.payload, gq=sq.gq, cq=sq.cq, m=m,
                        cum=cum)
    ev[3].record()
    o1 = postings_merge.bitmap_o1(x.buf, qb)
    s = postings_merge.estimate_scores(kcap, o1, x.values, x.thresh, qv, qt,
                                       qs)
    ev[4].record()
    words = postings_merge.pack_hit_words(s, thr)
    ev[5].record()
    words_h = to_numpy(words)
    ev[6].record()
    h0 = time.perf_counter()
    hits = mask_to_hits(planner_device.unpack_hit_words(words_h, m))
    h1 = time.perf_counter()
    ev[6].synchronize()
    ms = [ev[k].elapsed_time(ev[k + 1]) for k in range(6)] + [(h1 - h0) * 1e3]
    return (dict(zip(DEVICE_STAGES, ms)),
            {"sketch_ms": (t1 - t0) * 1e3, "probe_ms": (t2 - t1) * 1e3}, hits)


def check_pruned(index, batches, run, hits_seen, topk_seen) -> dict:
    """Hold the device route's answers against the dense route's (from the
    query phase, already held against the numpy route), its raw scores
    against B1's matrix, its postings against the host build, and run one
    batch's middle under the sync-debug mode; then time its stages."""
    post = run["post"]
    require(postings_equal(run["eager_post"], post),
            "eager (device-encoded) postings equal lazy (host) postings")
    mirror = DevicePostings.from_postings(post, DEV)
    require(all(torch.equal(a, b) for a, b in
                zip(run["eager_dev_post"].arrays(), mirror.arrays()))
            and run["eager_dev_post"].has_dense == mirror.has_dense,
            "device-encoded mirror equals the mirror of the host postings")
    arena = index.core.sketches
    m = arena.num_records
    x = arena.device_pack(index.device)
    t0 = time.perf_counter()
    fused_encode_postings(x.values, x.lengths, m=m, cap=x.capacity)
    sync()
    encode_s = time.perf_counter() - t0
    out = {"phase": "pruned",
           "postings": {**run["postings"], "lazy_equals_eager": True,
                        "device_mirror_equal": True,
                        "has_dense": mirror.has_dense,
                        "mirror_bytes": mirror.nbytes(),
                        "device_encode_s": encode_s}}

    t_mid = THRESHOLDS[1]
    require(all(np.array_equal(a, b) for a, b in
                zip(run["auto_hits"], hits_seen[(0, t_mid)])),
            "plan='auto' hits equal the dense route's")
    lp = run["auto_plan"]
    out["auto"] = {"threshold": t_mid, "path": lp.path, "hits": lp.hits,
                   "blocks": lp.blocks, "tail_blocks": lp.tail_blocks,
                   "tail_dense_blocks": lp.tail_dense_blocks,
                   "est_dense": lp.est_dense, "est_pruned": lp.est_pruned,
                   "ms": run["auto_ms"], "equals_dense": True}

    for (i, t), got in run["forced"].items():
        require(all(np.array_equal(a, b)
                    for a, b in zip(got, hits_seen[(i, t)])),
                f"device-route hits of batch {i} at t={t} equal dense hits")
    lat = run["forced_ms"]
    out["forced"] = {"batches": len(lat), "ms_p50": pctl(lat, 50),
                     "ms_p90": pctl(lat, 90), "ms_p99": pctl(lat, 99),
                     "checked_pairs": len(run["forced"]),
                     "equals_dense": True}

    # The raw score matrix of batch 0 against B1's, bit for bit.
    qp = gbkmv.sketch_query_batch(index.core, batches[0])
    staged = planner_device.stage_query_inputs(arena, qp, device=index.device)
    s = planner_device.pruned_scores(*staged)
    dense = containment_matrix(qp, x, as_numpy=False)
    require(torch.equal(s.view(torch.int32), dense.view(torch.int32)),
            "device-route scores of batch 0 equal B1's dense matrix")

    # Residency: the middle of one batch under the sync-debug mode.
    staged = planner_device.stage_query_inputs(arena, qp, t_mid,
                                               device=index.device)
    sync()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        words = planner_device.fused_mask_words(*staged)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    require(all(np.array_equal(a, b) for a, b in zip(
        mask_to_hits(planner_device.unpack_hit_words(words, m)),
        hits_seen[(0, t_mid)])), "the sync-free middle answers as dense")
    out["residency"] = {"sync_debug_mode": "error", "raised": False}

    stage_rows, host_rows = [], []
    for i in range(CHECK_BATCHES):
        for t in THRESHOLDS:
            stages, host, hits = device_stages(index, batches[i], t)
            require(all(np.array_equal(a, b)
                        for a, b in zip(hits, hits_seen[(i, t)])),
                    f"staged device batch {i} at t={t} equals dense")
            stage_rows.append(stages)
            host_rows.append(host)
    med = {k: float(np.median([r[k] for r in stage_rows]))
           for k in DEVICE_STAGES}
    hmed = {k: float(np.median([r[k] for r in host_rows]))
            for k in host_rows[0]}
    total = sum(med.values()) + sum(hmed.values())
    out["breakdown"] = {"batches": len(stage_rows), **hmed, **med,
                        "shares": {k: v / total for k, v in
                                   {**hmed, **med}.items()}}
    # Part of estimator_ms: the per-batch sign flip of the value and
    # threshold columns that puts them in u32 order for torch.searchsorted.
    sign = -(1 << 31)
    out["breakdown"]["estimator_sign_flip_ms"] = cuda_ms(
        lambda: (x.values ^ sign, x.thresh ^ sign), 20)

    # topk_seen holds the dense top-k of the same queries, in order.
    for (ids, sc, _), (dids, dsc) in zip(run["topk"], topk_seen):
        require(np.array_equal(ids, dids)
                and np.array_equal(sc.view(np.uint32), dsc.view(np.uint32)),
                f"device pruned top-{TOPK} equals dense top-{TOPK}")
    topk_ms = [r[2] for r in run["topk"]]
    out["topk"] = {"k": TOPK, "queries": len(run["topk"]),
                   "ms_p50": pctl(topk_ms, 50), "ms_p90": pctl(topk_ms, 90),
                   "equals_dense": True}

    require(postings_equal(run["reloaded_post"], post),
            "reloaded postings equal")
    for t in THRESHOLDS:
        require(all(np.array_equal(a, b) for a, b in
                    zip(run["reloaded_hits"][t], hits_seen[(0, t)])),
                f"reloaded pruned hits at t={t}")
    ids, sc, _ = run["topk"][0]
    rids, rsc = run["reloaded_topk"]
    require(np.array_equal(ids, rids) and np.array_equal(sc, rsc),
            "reloaded pruned top-k")
    out["save"] = {**run["save"], "identical_after_reload": True}
    emit(out)
    return out


def phase_host_pruned(index, batches, topk_queries,
                      thresholds=THRESHOLDS) -> dict:
    """The planner's host route, driven directly as ``ShardedIndex`` drives
    it off its device route: ``planner.pruned_batch``/``pruned_topk``
    with ``index._pair_score_fn(qp)``, whose verify is B5 (in growing
    prefixes of each top-10's bound-ordered list), on ``batches`` at each
    of ``thresholds`` and a top-10 of each of ``topk_queries``."""
    post = index._postings()
    m = index.num_records
    run = {"forced": [], "topk": []}
    for i, b in enumerate(batches):
        qp, hash_rows, bit_rows, sizes = index._plan_queries(b)
        score_fn = index._pair_score_fn(qp)
        for t in thresholds:
            t0 = time.perf_counter()
            ids, cands = pruned_batch(post, hash_rows, bit_rows, sizes, t,
                                      score_fn)
            ms = (time.perf_counter() - t0) * 1e3
            run["forced"].append((i, t, ids, ms,
                                  int(sum(len(c.rec_ids) for c in cands))))
    for q in topk_queries:
        qp, hash_rows, bit_rows, sizes = index._plan_queries([q])
        before = gather_score.launches
        t0 = time.perf_counter()
        ids, sc = pruned_topk(post, hash_rows[0], bit_rows[0], int(sizes[0]),
                              TOPK, index._pair_score_fn(qp), m)
        run["topk"].append((ids, sc, (time.perf_counter() - t0) * 1e3,
                            gather_score.launches - before))
    return run


HOST_STAGES = ("sketch_ms", "probe_ms", "candidates_ms", "upload_ms", "b5_ms",
               "fetch_ms", "cut_ms")


def host_stages(index, b, t):
    """Host-clock ms of each stage of one batch on the host route, with a
    sync after the device work (the upload is the door's one pinned blob,
    the fetch its pinned copy); with the batch's hits and candidate list."""
    post = index._postings()
    s = index.core.sketches
    x = s.device_pack(index.device)
    t0 = time.perf_counter()
    qp, hash_rows, bit_rows, sizes = index._plan_queries(b)
    t1 = time.perf_counter()
    choose_plan(post, hash_rows, bit_rows, t, s.num_records, s.capacity,
                plan="pruned")
    t2 = time.perf_counter()
    cands = [candidates_for(post, qh, qb, t, int(qs))
             for qh, qb, qs in zip(hash_rows, bit_rows, sizes)]
    lens = [len(c.rec_ids) for c in cands]
    cand_rec = np.concatenate([c.rec_ids for c in cands]).astype(np.int32)
    cand_q = np.repeat(np.arange(len(b), dtype=np.int32), lens)
    t3 = time.perf_counter()
    q = qp.to(x.device)
    rec_d, q_d = stage_pairs(cand_rec, cand_q, x.device)
    sync()
    t4 = time.perf_counter()
    out = gather_score(x.values, x.thresh, x.buf, q.values, q.thresh,
                       q.buf, q.sizes, rec_d, q_d)
    sync()
    t5 = time.perf_counter()
    scores = fetch_scores(out)
    t6 = time.perf_counter()
    thr32 = f32_threshold(t)
    hits, pos = [], 0
    for c, n in zip(cands, lens):
        hits.append(c.rec_ids[scores[pos:pos + n] >= thr32])
        pos += n
    t7 = time.perf_counter()
    ms = np.diff([t0, t1, t2, t3, t4, t5, t6, t7]) * 1e3
    return dict(zip(HOST_STAGES, ms.tolist())), hits, cand_rec, cand_q


def check_host_pruned(index, batches, run, dev_run, hits_seen, topk_seen,
                      topk_queries):
    """The host route's answers against the dense route's and the device
    route's; its stages timed on batch 0 at each t; B5 launches and n per
    top-10. Returns the candidate list (cand_rec, cand_q) of batch 0 at the
    middle threshold, and (query pack, bound-ordered candidate list) of the
    first top-10 query."""
    forced, stage_rows = [], []
    for i, t, got, ms, cands in run["forced"]:
        require(all(np.array_equal(a, b) for a, b in
                    zip(got, hits_seen[(i, t)])),
                f"host-route hits of batch {i} at t={t} equal dense hits")
        require(all(np.array_equal(a, b) for a, b in
                    zip(got, dev_run["forced"][(i, t)])),
                f"host-route hits of batch {i} at t={t} equal device hits")
        forced.append({"batch": i, "threshold": t, "candidates": cands,
                       "hits": int(sum(len(h) for h in got)), "ms": ms})
        if i == 0:
            stages, hits, rec, qq = host_stages(index, batches[0], t)
            require(all(np.array_equal(a, b) for a, b in zip(hits, got))
                    and len(rec) == cands,
                    f"staged host batch 0 at t={t} equals the route")
            stage_rows.append(stages)
            if t == THRESHOLDS[1]:
                cand_list = (rec, qq)
    for (ids, sc, _, _), (dids, dsc), (vids, vsc, _) in zip(
            run["topk"], topk_seen, dev_run["topk"]):
        require(np.array_equal(ids, dids) and np.array_equal(ids, vids)
                and np.array_equal(sc.view(np.uint32), dsc.view(np.uint32))
                and np.array_equal(sc.view(np.uint32), vsc.view(np.uint32)),
                f"host pruned top-{TOPK} equals dense and device top-{TOPK}")
    # n per top-10 (its threshold-0 candidates), outside the timed run;
    # query 0's bound-ordered list is the parity phase's top-k list.
    post = index._postings()
    ns = []
    for j, q in enumerate(topk_queries[:GQ]):
        qp, hash_rows, bit_rows, sizes = index._plan_queries([q])
        ranked, _ = topk_candidates(post, hash_rows[0], bit_rows[0],
                                    int(sizes[0]))
        ns.append(len(ranked))
        if j == 0:
            topk_list = (qp, ranked.astype(np.int32))
    med = {k: float(np.median([r[k] for r in stage_rows]))
           for k in HOST_STAGES}
    total = sum(med.values())
    topk_ms = [r[2] for r in run["topk"]]
    b5 = [r[3] for r in run["topk"]]
    require(all(n == 0 or 1 <= b <= 4 for n, b in zip(ns, b5)),
            f"each host-route top-{TOPK} launches B5 one to four times")
    emit({"phase": "host_pruned", "forced": forced,
          "forced_ms_p50": pctl([r["ms"] for r in forced], 50),
          "forced_equal_dense_and_device": len(forced),
          "breakdown": {"batches": len(stage_rows), **med,
                        "candidates_share": med["candidates_ms"] / total,
                        "b5_share": med["b5_ms"] / total},
          "topk": {"k": TOPK, "queries": len(run["topk"]),
                   "ms_p50": pctl(topk_ms, 50), "ms": topk_ms,
                   "b5_launches": b5, "b5_launches_p50": pctl(b5, 50),
                   "b5_launches_total": int(sum(b5)), "n": ns,
                   "n_p50": pctl(ns, 50),
                   "equals_dense_and_device": True}})
    return cand_list, topk_list


# ---------------------------------------------------------------------------
# The gkmv and kmv engines at the NETFLIX deployment
# ---------------------------------------------------------------------------

# Their traffic: the first batches of the gbkmv phases' workload (seed 2)
# and a top-10 of each query of the first half of batch 0. The gkmv host
# route walks posting lists of ~10^5 entries a frequent query hash, so it
# takes two batches at one t and four top-10s. The numpy routes over all
# records (the host estimator for gkmv, kmv's estimator on the CPU) take
# 0.1-1 s a query on the card machine's host, so they check two batches.
SKETCH_BATCHES = 8
SKETCH_TOPK = 8
GKMV_HOST_BATCHES = 2
GKMV_HOST_TOPK = 4
GKMV_HOST_T = 0.7
NUMPY_BATCHES = 2
KMV_THRESHOLDS = (0.5, 0.9)
# B5's long-row case: the gkmv records with the most live values.
LONG_ROWS = 16_384


def _ms_since(t0: float) -> float:
    return (time.perf_counter() - t0) * 1e3


def _all_equal(got, want) -> bool:
    return len(got) == len(want) and all(
        np.array_equal(a, b) for a, b in zip(got, want))


def _same_topk(a, b) -> bool:
    return np.array_equal(a[0], b[0]) and np.array_equal(
        np.asarray(a[1]).view(np.uint32), np.asarray(b[1]).view(np.uint32))


def _latency(ms: list) -> dict:
    return {"batches": len(ms), "ms_p50": pctl(ms, 50), "ms_p90": pctl(ms, 90),
            "ms_p99": pctl(ms, 99)}


def _timed_batches(index, batches, thresholds, plan: str):
    """{(i, t): hits} and the batch latencies of ``batch_query`` on each
    batch at each t (one warm-up batch first)."""
    index.batch_query(batches[0], thresholds[0], plan=plan)
    sync()
    hits, ms = {}, []
    for t in thresholds:
        for i, b in enumerate(batches):
            t0 = time.perf_counter()
            hits[(i, t)] = index.batch_query(b, t, plan=plan)
            ms.append(_ms_since(t0))
    return hits, ms


def _timed_topk(index, queries, plan: str):
    out, ms = [], []
    for q in queries:
        t0 = time.perf_counter()
        out.append(index.topk(q, TOPK, plan=plan))
        ms.append(_ms_since(t0))
    return out, ms


def postings_shape(post) -> dict:
    """The tail store's size: keys, blocks, the dense ones, the longest
    posting list and how many lists pass one block."""
    lens = post.tail_row_lengths().astype(np.int64)
    dense = (np.asarray(post.tail.meta, np.uint32) >> np.uint32(13)) & 1
    return {"tail_keys": len(post.keys), "tail_entries": int(post.tail.nnz),
            "tail_blocks": int(post.tail.num_blocks),
            "dense_blocks": int(dense.sum()),
            "longest_list": int(lens.max()) if len(lens) else 0,
            "lists_over_one_block": int((lens > 128).sum()),
            "bytes": post.nbytes()}


def gkmv_dense(batch: RaggedBatch, budget: int, batches, topk_queries
               ) -> dict:
    """The gkmv engine's build and dense route (the ``gkmv_dense`` path):
    the core build on the card and on the host in both τ modes (their
    columns kept as numpy for :func:`check_gkmv`), the api's device build
    (exact τ), and the dense route at each t and for each top-10."""
    run = {"builds": {}, "budget": budget}
    for mode in TAU_MODES:
        t0 = time.perf_counter()
        dev = gkmv.build_gkmv(batch, budget, tau_mode=mode, device=DEV)
        sync()
        dev_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        host = gkmv.build_gkmv(batch, budget, tau_mode=mode,
                               build_backend="numpy", device="cpu")
        host_s = time.perf_counter() - t0
        run["builds"][mode] = {"device": _host_columns(dev),
                               "host": _host_columns(host),
                               "on_card": dev.device.type == DEV.type,
                               "device_build_s": dev_s,
                               "host_build_s": host_s}
        del dev, host
    t0 = time.perf_counter()
    index = api.build("gkmv", batch, budget)
    sync()
    run["api_build_s"] = time.perf_counter() - t0
    run["index"] = index
    run["hits"], run["ms"] = _timed_batches(index, batches, THRESHOLDS,
                                            "dense")
    run["topk"], run["topk_ms"] = _timed_topk(index, topk_queries, "dense")
    return run


def gkmv_pruned(index, batches, topk_queries) -> dict:
    """The gkmv engine's device pruned route (the ``gkmv_pruned`` path):
    the postings built on the host and encoded on the card, one
    plan="auto" batch, forced plan="pruned" on every batch at each t, and
    the pruned top-10s."""
    t0 = time.perf_counter()
    post = index._postings()
    run = {"post": post, "lazy_build_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    run["encoded"] = build_postings_device(index.sketches.device_pack(DEV))
    sync()
    run["device_encode_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run["auto_hits"] = index.batch_query(batches[0], GKMV_HOST_T)
    run["auto_ms"] = _ms_since(t0)
    run["auto_plan"] = index.last_plan
    run["hits"], run["ms"] = _timed_batches(index, batches, THRESHOLDS,
                                            "pruned")
    run["device_route"] = (index.last_plan.path == "pruned"
                           and index.last_candidate_sizes is None)
    run["topk"], run["topk_ms"] = _timed_topk(index, topk_queries, "pruned")
    return run


def candidate_list(index, b, t):
    """(cand_rec, cand_q) int32 of one batch on the host route at t."""
    post = index._postings()
    _, hash_rows, bit_rows, sizes = index._plan_queries(b)
    cands = [candidates_for(post, qh, qb, t, int(qs))
             for qh, qb, qs in zip(hash_rows, bit_rows, sizes)]
    lens = [len(c.rec_ids) for c in cands]
    return (np.concatenate([c.rec_ids for c in cands]).astype(np.int32),
            np.repeat(np.arange(len(b), dtype=np.int32), lens))


def host_route_split(index, b, t) -> dict:
    """Host-clock ms of each step of one batch on the host route, as
    ``planner.pruned_batch`` runs it with the index's own scorer: the
    query sketch, candidate generation, the scorer's call (upload, score,
    fetch) and the cut; any engine."""
    post = index._postings()
    t0 = time.perf_counter()
    qp, hash_rows, bit_rows, sizes = index._plan_queries(b)
    t1 = time.perf_counter()
    cands = [candidates_for(post, qh, qb, t, int(qs))
             for qh, qb, qs in zip(hash_rows, bit_rows, sizes)]
    lens = [len(c.rec_ids) for c in cands]
    cand_rec = np.concatenate([c.rec_ids for c in cands]).astype(np.int32)
    cand_q = np.repeat(np.arange(len(b), dtype=np.int32), lens)
    t2 = time.perf_counter()
    scores = index._pair_score_fn(qp)(cand_rec, cand_q)
    t3 = time.perf_counter()
    thr32, pos = f32_threshold(t), 0
    for c, n in zip(cands, lens):
        c.rec_ids[scores[pos:pos + n] >= thr32]
        pos += n
    t4 = time.perf_counter()
    ms = np.diff([t0, t1, t2, t3, t4]) * 1e3
    return {"threshold": t, "pairs": len(cand_rec),
            **dict(zip(("sketch_ms", "candidates_ms", "score_ms", "cut_ms"),
                       ms.tolist()))}


def median_device_stages(index, batches) -> dict:
    """:func:`device_stages` of each batch at each t, medians; each
    batch's hits held to the api's device route."""
    rows = []
    for b in batches:
        for t in THRESHOLDS:
            stages, host, hits = device_stages(index, b, t)
            require(_all_equal(hits, index.batch_query(b, t, plan="pruned")),
                    f"staged {index.engine} device batch at t={t} equals "
                    "the route")
            rows.append({**host, **stages})
    return {"batches": len(rows),
            **{k: float(np.median([r[k] for r in rows])) for k in rows[0]}}


def check_gkmv(dense: dict, pruned: dict, host: dict, batches,
               topk_queries, seconds: dict) -> dict:
    """Hold the gkmv phase's runs to one another and to the host builds
    and the numpy route; emit its line. Returns the parity phase's inputs:
    the index and the host route's candidate pairs of batch 0."""
    t_check = time.perf_counter()
    index = dense["index"]
    m = index.num_records
    out = {"phase": "gkmv", "records": m, "budget": dense["budget"],
           "builds": {}}
    for mode, b in dense["builds"].items():
        dcols, hcols = b["device"], b["host"]
        require(b["on_card"], f"gkmv {mode} device build on the card")
        for name in dcols:
            require(dcols[name].shape == hcols[name].shape
                    and np.array_equal(dcols[name], hcols[name]),
                    f"gkmv {mode} device build column {name} equals host")
        lengths = dcols["lengths"]
        out["builds"][mode] = {
            "tau": int(dcols["thresh"].max()), "capacity":
            dcols["values"].shape[1],
            "mean_length": float(lengths.mean()),
            "longest_row": int(lengths.max()),
            "empty_rows": int((lengths == 0).sum()),
            "device_build_s": b["device_build_s"],
            "host_build_s": b["host_build_s"],
            "identical_to_host_build": True}
    s = index.sketches
    exact = dense["builds"]["exact"]["device"]
    require(int(index.tau) == int(exact["thresh"].max())
            and all(np.array_equal(a, b) for a, b in
                    zip(_host_columns(s).values(), exact.values())),
            "the api's gkmv index is the exact-mode build")
    out.update({"tau": int(index.tau), "tau_share": int(index.tau) / 2**32,
                "capacity": s.capacity, "buf_words": s.buf_words,
                "column_bytes": int(exact["values"].nbytes),
                "api_build_s": dense["api_build_s"]})

    post = pruned["post"]
    e_post, e_dev = pruned["encoded"]
    require(postings_equal(e_post, post),
            "gkmv device-encoded postings equal the host postings")
    mirror = DevicePostings.from_postings(post, DEV)
    require(all(torch.equal(a, b) for a, b in
                zip(e_dev.arrays(), mirror.arrays()))
            and e_dev.has_dense == mirror.has_dense,
            "gkmv device-encoded mirror equals the host postings' mirror")
    out["postings"] = {**postings_shape(post),
                       "lazy_build_s": pruned["lazy_build_s"],
                       "device_encode_s": pruned["device_encode_s"],
                       "device_encoded_equal": True}

    # Dense hits and top-10s against the numpy host route over all records.
    for i in range(NUMPY_BATCHES):
        s_np = numpy_scores(index, batches[i])
        require(s_np.shape == (m, GQ) and np.isfinite(s_np).all(),
                "gkmv numpy route scores finite")
        for t in THRESHOLDS:
            want = [np.nonzero(s_np[:, g].astype(np.float64) >= t)[0]
                    for g in range(GQ)]
            require(_all_equal(dense["hits"][(i, t)], want),
                    f"gkmv dense hits of batch {i} at t={t} equal numpy")
        if i == 0:
            for g, got in enumerate(dense["topk"]):
                require(_same_topk(got, topk_select(np.arange(m), s_np[:, g],
                                                    TOPK, m)),
                        f"gkmv dense top-{TOPK} of query {g} equals numpy")
    # Every route against the dense route.
    for key, hits in pruned["hits"].items():
        require(_all_equal(hits, dense["hits"][key]),
                f"gkmv device-route hits {key} equal dense")
    require(pruned["device_route"], "gkmv forced pruned takes the device route")
    require(_all_equal(pruned["auto_hits"],
                       dense["hits"][(0, GKMV_HOST_T)]),
            "gkmv plan='auto' hits equal dense")
    for i, t, got, _, _ in host["forced"]:
        require(_all_equal(got, dense["hits"][(i, t)]),
                f"gkmv host-route hits of batch {i} at t={t} equal dense")
    for a, b in zip(pruned["topk"], dense["topk"]):
        require(_same_topk(a, b), f"gkmv device pruned top-{TOPK} equals dense")
    for (ids, sc, _, _), b in zip(host["topk"], dense["topk"]):
        require(_same_topk((ids, sc), b),
                f"gkmv host pruned top-{TOPK} equals dense")

    # The device pipeline's raw scores of batch 0 against B1's matrix.
    qp = index._query_pack(batches[0])
    staged = planner_device.stage_query_inputs(s, qp, device=DEV)
    dev_s = planner_device.pruned_scores(*staged)
    dense_s = containment_matrix(qp, s.device_pack(DEV), as_numpy=False)
    require(torch.equal(dev_s.view(torch.int32), dense_s.view(torch.int32)),
            "gkmv device-route scores of batch 0 equal B1's dense matrix")

    ns = []
    for q in topk_queries[:GKMV_HOST_TOPK]:
        _, hash_rows, bit_rows, sizes = index._plan_queries([q])
        ranked, _ = topk_candidates(post, hash_rows[0], bit_rows[0],
                                    int(sizes[0]))
        ns.append(len(ranked))
    b5 = [r[3] for r in host["topk"]]
    require(all(n == 0 or 1 <= b <= 4 for n, b in zip(ns, b5)),
            f"each gkmv host-route top-{TOPK} launches B5 one to four times")
    lp = pruned["auto_plan"]
    breakdown = {"dense": query_breakdown(index, batches, GKMV_HOST_T),
                 "device_pruned": median_device_stages(
                     index, batches[:NUMPY_BATCHES]),
                 "host_pruned": host_route_split(index, batches[0],
                                                 GKMV_HOST_T)}
    out.update({
        "queries": {"batches": SKETCH_BATCHES, "gq": GQ,
                    "thresholds": list(THRESHOLDS),
                    "query_hashes_batch0": int(qp.lengths.sum()),
                    "numpy_checked_batches": NUMPY_BATCHES},
        "dense": {**_latency(dense["ms"]),
                  "topk_ms_p50": pctl(dense["topk_ms"], 50),
                  "topk_ms_p99": pctl(dense["topk_ms"], 99),
                  "equals_numpy": True},
        "device_pruned": {**_latency(pruned["ms"]),
                          "topk_ms_p50": pctl(pruned["topk_ms"], 50),
                          "topk_ms_p99": pctl(pruned["topk_ms"], 99),
                          "scores_equal_b1": True, "equals_dense": True},
        "auto": {"threshold": GKMV_HOST_T, "path": lp.path, "hits": lp.hits,
                 "tail_blocks": lp.tail_blocks,
                 "tail_dense_blocks": lp.tail_dense_blocks,
                 "est_dense": lp.est_dense, "est_pruned": lp.est_pruned,
                 "ms": pruned["auto_ms"], "equals_dense": True},
        "host_pruned": {
            "threshold": GKMV_HOST_T,
            **_latency([r[3] for r in host["forced"]]),
            "candidates": [r[4] for r in host["forced"]],
            "topk_ms": [r[2] for r in host["topk"]],
            "topk_b5_launches": b5, "topk_n": ns, "equals_dense": True},
        "topk_queries": len(topk_queries), "breakdown": breakdown,
        "seconds": {**seconds, "check_s": time.perf_counter() - t_check}})
    emit(out)
    return index, candidate_list(index, batches[0], GKMV_HOST_T)


def kmv_run(batch: RaggedBatch, budget: int, batches, topk_queries) -> dict:
    """The kmv engine (the ``kmv`` path): the api's device build (the
    row_cap route, B2 hashes only), the host build, the dense route and
    the pruned route (the host filter-and-verify with kmv's own pair
    scorer on the card) at each t, and the top-10s on both."""
    t0 = time.perf_counter()
    index = api.build("kmv", batch, budget)
    sync()
    run = {"index": index, "api_build_s": time.perf_counter() - t0,
           "on_card": index.sketches.device.type == DEV.type}
    t0 = time.perf_counter()
    run["host"] = kmv.build_kmv(batch, budget, build_backend="numpy",
                                device="cpu")
    run["host_build_s"] = time.perf_counter() - t0
    run["dense"], run["dense_ms"] = _timed_batches(
        index, batches, KMV_THRESHOLDS, "dense")
    run["pruned"], run["pruned_ms"] = _timed_batches(
        index, batches, KMV_THRESHOLDS, "pruned")
    run["host_route"] = (index.last_plan.path == "pruned"
                         and index.last_candidate_sizes is not None)
    run["candidates"] = int(sum(index.last_candidate_sizes))
    run["topk_dense"], run["topk_dense_ms"] = _timed_topk(
        index, topk_queries, "dense")
    run["topk_pruned"], run["topk_pruned_ms"] = _timed_topk(
        index, topk_queries, "pruned")
    return run


def check_kmv(run: dict, batches, topk_queries, run_s: float) -> None:
    """The kmv runs against the host build and the numpy backend (kmv's
    estimator on the CPU over the host build's columns); emit its line."""
    t_check = time.perf_counter()
    index, host = run["index"], run["host"]
    m = index.num_records
    require(run["on_card"], "kmv device build on the card")
    dcols, hcols = _host_columns(index.sketches), _host_columns(host)
    for name in dcols:
        require(dcols[name].shape == hcols[name].shape
                and np.array_equal(dcols[name], hcols[name]),
                f"kmv device build column {name} equals host")
    require(run["host_route"], "kmv forced pruned takes the host route")
    for key, hits in run["pruned"].items():
        require(_all_equal(hits, run["dense"][key]),
                f"kmv pruned hits {key} equal dense")
    for g, (a, b) in enumerate(zip(run["topk_dense"], run["topk_pruned"])):
        require(_same_topk(a, b),
                f"kmv pruned top-{TOPK} of query {g} equals dense")
    cpu = api.get_engine("kmv").wrap(host, backend="numpy", device="cpu")
    for i, b in enumerate(batches[:NUMPY_BATCHES]):
        s_np = cpu.batch_scores(b)
        require(s_np.shape == (m, GQ) and np.isfinite(s_np).all(),
                "kmv numpy scores finite")
        for t in KMV_THRESHOLDS:
            require(_all_equal(run["dense"][(i, t)],
                               threshold_hits_packed(s_np, t)),
                    f"kmv dense hits of batch {i} at t={t} equal numpy")
        if i == 0:
            for g, (a, b) in enumerate(zip(run["topk_dense"],
                                           run["topk_pruned"])):
                want = topk_select(np.arange(m), s_np[:, g], TOPK, m)
                require(_same_topk(a, want) and _same_topk(b, want),
                        f"kmv top-{TOPK} of query {g}, dense and pruned, "
                        "equal numpy")
    lengths = dcols["lengths"]
    breakdown = {"dense": query_breakdown(index, batches[:NUMPY_BATCHES],
                                          KMV_THRESHOLDS[0]),
                 "host_pruned": host_route_split(index, batches[0],
                                                 KMV_THRESHOLDS[0])}
    emit({"phase": "kmv", "records": m, "k": int(lengths.max()),
          "capacity": index.sketches.capacity,
          "mean_length": float(lengths.mean()),
          "column_bytes": int(dcols["values"].nbytes),
          "api_build_s": run["api_build_s"],
          "host_build_s": run["host_build_s"],
          "identical_to_host_build": True,
          "postings": postings_shape(index._postings()),
          "thresholds": list(KMV_THRESHOLDS),
          "dense": {**_latency(run["dense_ms"]),
                    "topk_ms_p50": pctl(run["topk_dense_ms"], 50)},
          "host_pruned": {**_latency(run["pruned_ms"]),
                          "candidates_last_batch": run["candidates"],
                          "topk_ms_p50": pctl(run["topk_pruned_ms"], 50)},
          "topk_queries": len(topk_queries), "pruned_equals_dense": True,
          "numpy_checked_batches": NUMPY_BATCHES, "equals_numpy": True,
          "breakdown": breakdown,
          "seconds": {"run_s": run_s,
                      "check_s": time.perf_counter() - t_check}})


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
    return [c.to(DEV) for c in cols] + [torch.from_numpy(qs).to(DEV)]


def _edge_pair_cases():
    """B5 edge cases: B1's edge records and queries (empty rows, k < 2,
    threshold-0 rows, a query of size 0) with W = 1, the same with W = 3,
    and with repeated values in a record row and a query row; every
    (record, query) pair of each."""
    base = _edge_score_inputs()
    rng = np.random.default_rng(0)
    wide = list(base)
    for i, n in ((2, 9), (5, 3)):
        wide[i] = to_tensor(rng.integers(0, 2**32, size=(n, 3), dtype=np.uint64)
                            .astype(np.uint32)).to(DEV)
    rep = list(base)
    xv, qv = to_numpy(base[0]), to_numpy(base[3])
    xv[2, :4] = [5, 9, 9, 30]
    qv[1, :6] = [0, 5, 5, 9, 30, 31]
    rep[0], rep[3] = to_tensor(xv).to(DEV), to_tensor(qv).to(DEV)
    rec = torch.arange(9, dtype=torch.int32).repeat_interleave(3).to(DEV)
    q = torch.arange(3, dtype=torch.int32).repeat(9).to(DEV)
    return [base, wide, rep], rec, q


def _sorted_rows(rng, m, c, hi):
    """[m, c] u32 rows, each sorted, distinct values below ``hi`` then PAD."""
    values = np.full((m, c), PAD, np.uint32)
    for i, n in enumerate(rng.integers(0, c + 1, size=m)):
        v = np.unique(rng.integers(0, hi, size=2 * int(n) + 1,
                                   dtype=np.uint64).astype(np.uint32))[:n]
        values[i, : len(v)] = v
    return values


def _edge_gather_shapes() -> dict:
    """B5 inputs (columns, cand_rec, cand_q) at the kernel's own edges: c %
    4 != 0 (scalar row loads), W = 0, W past the lane group, P = 1, P not a
    multiple of a CTA's 128 pairs, record rows 4 B past a 16-B boundary,
    and long query rows (16 × 1,024 values)."""
    rng = np.random.default_rng(21)
    out = {}
    for name, (m, c, gq, cq, w, p) in {
            "c7": (50, 7, 3, 8, 1, 301), "w0": (40, 16, 4, 16, 0, 97),
            "w9": (90, 56, 5, 56, 9, 1001), "p1": (30, 8, 2, 8, 1, 1),
            "p301": (70, 16, 3, 16, 1, 301), "unaligned": (50, 8, 2, 8, 1, 211),
            "cq1024": (300, 16, 16, 1024, 1, 5003)}.items():
        hi = 2**16 if cq > 64 else 2**7
        cols = [_sorted_rows(rng, m, c, hi),
                rng.integers(0, hi + 8, size=m),
                rng.integers(0, 2**32, size=(m, w), dtype=np.uint64),
                _sorted_rows(rng, gq, cq, hi),
                rng.integers(0, hi + 8, size=gq),
                rng.integers(0, 2**32, size=(gq, w), dtype=np.uint64)]
        cols = [to_tensor(np.asarray(a).astype(np.uint32)).to(DEV)
                for a in cols]
        cols.append(torch.from_numpy(rng.integers(0, 60, size=gq)
                                     .astype(np.int32)).to(DEV))
        if name == "unaligned":
            flat = torch.empty(m * c + 1, dtype=torch.int32, device=DEV)
            flat[1:] = cols[0].reshape(-1)
            cols[0] = flat[1:].view(m, c)
            require(cols[0].data_ptr() % 16 == 4, "rows off a 16-B boundary")
        rec = torch.from_numpy(rng.integers(0, m, size=p).astype(np.int32))
        q = torch.from_numpy(rng.integers(0, gq, size=p).astype(np.int32))
        out[name] = (cols, rec.to(DEV), q.to(DEV))
    return out


def _edge_probe_cases():
    """B3 edge cases (keys, queries, row_blocks): no keys; queries below
    the first key, above the last, equal to PAD, and repeated."""
    keys = np.asarray([1000, 2000, 3000, 2**32 - 3], np.uint32)
    q = np.asarray([0, 999, 1000, 1500, 2000, 2000, 3000, 3001, 2**32 - 3,
                    2**32 - 2, PAD, PAD], np.uint32)
    row_blocks = np.asarray([0, 2, 3, 6, 7], np.int32)
    return [(to_tensor(keys[:u]).to(DEV), to_tensor(q).to(DEV),
             torch.from_numpy(row_blocks[:u + 1]).to(DEV))
            for u in (4, 0, 1)]


def _probe_task_cases(keys, row_blocks) -> dict:
    """Inputs (keys, queries, row_blocks) past batch 0's: n over one CTA
    tile at the serving keys, and key columns past the shared-memory
    budget (fence stride s > 0), each with hits, repeated hits, misses
    and PAD lanes; query hashes and keys from a fixed seed."""
    rng = np.random.default_rng(18)

    def lanes(k, n):
        hits = k[rng.integers(0, len(k), size=n // 2)]
        rand = rng.integers(0, 2**32, size=n - n // 2 - 2, dtype=np.uint64)
        q = np.concatenate([hits, rand.astype(np.uint32),
                            np.asarray([PAD, PAD], np.uint32)])
        return to_tensor(rng.permutation(q)).to(DEV)

    out = {}
    k = to_numpy(keys)
    for n in (1_025, 16_384):
        out[f"serving_keys_n{n}"] = (keys, lanes(k, n), row_blocks)
    for u in (60_000, 250_000):
        big = np.unique(rng.integers(0, 2**32 - 1, size=u + u // 8,
                                     dtype=np.uint64).astype(np.uint32))[:u]
        rb = np.concatenate([[0], np.cumsum(rng.integers(1, 4, size=len(big)))])
        out[f"u{len(big)}_n4096"] = (to_tensor(big).to(DEV), lanes(big, 4_096),
                                     torch.from_numpy(rb.astype(np.int32))
                                     .to(DEV))
    return out


def _synthetic_postings() -> DevicePostings:
    """Hand-made tail rows, one key each (10..17): one-entry blocks,
    repeated ids (bw = 0), a 31-bit delta, widths that straddle words (7,
    13, 25), a row of three blocks and a dense-bitmap block."""
    rows = [np.asarray([5]), np.asarray([7, 7, 7, 7]),
            np.asarray([1, 2, 3, 3 + 2**30, 4 + 2**30 + 5]),
            np.cumsum(np.full(40, 100)), np.cumsum(np.full(90, 5000)),
            np.cumsum(np.arange(1, 61) % 7 + 2**24),
            np.cumsum(np.arange(300) % 3),
            40 + np.cumsum(1 + (np.arange(160) % 4 == 0))]
    offsets = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    tail = encode_store(offsets, np.concatenate(rows).astype(np.int32))
    require({0, 31}.issubset(set(((tail.meta >> 8) & 31).tolist()))
            and bool(np.any((tail.meta >> 13) & 1)),
            "synthetic blocks cover bw 0, bw 31 and a dense block")
    empty = encode_store(np.zeros(1, np.int64), np.zeros(0, np.int32))
    post = PostingsIndex(keys=np.arange(10, 18, dtype=np.uint32), tail=tail,
                         buf=empty, num_records=600_000, tau=np.uint32(0))
    return DevicePostings.from_postings(post, DEV)


def _task_blocks(pos, hit, row_blocks):
    """The block id of every decode task of a probe, in task order."""
    cum = ref.task_prefix_ref(pos, hit, row_blocks).long()
    nblk = torch.diff(cum, prepend=cum.new_zeros(1))
    rs = row_blocks.long()[pos.long().clamp(0, max(row_blocks.numel() - 2, 0))]
    lane = torch.repeat_interleave(torch.arange(pos.numel(), device=pos.device),
                                   nblk)
    t = torch.arange(lane.numel(), device=pos.device)
    return rs[lane] + t - (cum[lane] - nblk[lane])


# The dense-block deployment's build: r and budget.
DENSE_BLOCK_R = 2
DENSE_BLOCK_BUDGET = 20_000


def dense_block_records() -> list:
    """The records of :func:`dense_block_index`, by the reference's recipe
    (tests/test_device_pipeline.py:40, ``dense_corpus``)."""
    rng = np.random.default_rng(7)
    recs = []
    for _ in range(600):
        base = rng.choice(3000, size=rng.integers(2, 5), replace=False) + 100
        common = [c for c in range(10) if rng.random() < 0.85]
        recs.append(np.unique(np.concatenate([common, base]).astype(np.int64)))
    return recs


def dense_block_index():
    """(index, queries): an index whose tail has dense-bitmap blocks
    (:func:`dense_block_records`), r = 2, budget 20,000, eager postings,
    and a batch of GQ queries (the first half of each of its first
    records)."""
    recs = dense_block_records()
    index = api.build("gbkmv", recs, DENSE_BLOCK_BUDGET, r=DENSE_BLOCK_R,
                      postings="eager")
    return index, [r[: max(2, len(r) // 2)] for r in recs[:GQ]]


def _dense_store_check() -> dict:
    """B4 against its plain version on the dense-block store
    (:func:`dense_block_index`)."""
    index, queries = dense_block_index()
    dpost = index.core.sketches.device_postings(DEV)
    require(dpost.has_dense, "the dense-block store has dense blocks")
    qp = gbkmv.sketch_query_batch(index.core, queries).to(DEV)
    gq, cq = qp.values.shape
    pos, hit = postings_probe(dpost.keys, qp.values.reshape(-1))
    args = (pos, hit, dpost.row_blocks, dpost.first, dpost.meta, dpost.off,
            dpost.payload)
    got = block_decode(*args, gq=gq, cq=cq, m=index.num_records)
    require(torch.equal(got, ref.kcount_ref(*args, gq=gq, cq=cq,
                                            m=index.num_records)),
            "block_decode kernel equals plain version on dense blocks")
    blk = _task_blocks(pos, hit, dpost.row_blocks)
    dense_tasks = int(((dpost.meta[blk] >> 13) & 1).sum())
    require(dense_tasks > 0, "the dense-block batch decodes dense blocks")
    for a, b in zip(index.batch_query(queries, 0.5, plan="pruned"),
                    index.batch_query(queries, 0.5, plan="dense")):
        require(np.array_equal(a, b), "dense-block index: pruned = dense")
    return {"records": index.num_records, "tasks": int(blk.numel()),
            "dense_tasks": dense_tasks, "equal": True}


def parity_gkmv(index, query_batch, pairs) -> dict:
    """B1, B3, B4 and B5 on the gkmv index against their plain versions on
    the card, exact equality, with their wrapper and bare times: B1 at
    buffer width 0 on batch 0, B3 and B4 on its tail store (long posting
    lists, dense blocks) at batch 0's query hashes, B5 on the host route's
    pairs of batch 0 at t = 0.7 (rows of up to the capacity's live values).
    Returns one entry per kernel."""
    lib = library.library()
    x = index.sketches.device_pack(DEV)
    qp = index._query_pack(query_batch).to(DEV)
    args = (x.values, x.thresh, x.buf, qp.values, qp.thresh, qp.buf, qp.sizes)
    m, c = x.values.shape
    gq, cq = qp.values.shape
    require(x.buf.shape == (m, 0) and qp.buf.shape == (gq, 0),
            "the gkmv index and its queries have no buffer words")
    got = gbkmv_score(*args)
    want = ref.gbkmv_score_ref(*args)
    sync()
    require(torch.equal(got, want) and torch.equal(score_index(*args), want),
            "gbkmv_score kernel equals plain version at W = 0 (gkmv)")
    out_b1 = torch.empty((m, gq), dtype=torch.float32, device=DEV)
    xu = as_u64(x.values)
    tau_pair = torch.minimum(as_u64(x.thresh)[:, None],
                             as_u64(qp.thresh)[None, :])
    live_x = sum(int((xu <= tau_pair[:, g:g + 1]).sum()) for g in range(gq))
    out = {"gbkmv_score": {
        "shape": [m, c, gq, cq, 0], "equal": True,
        "ms": cuda_ms(lambda: gbkmv_score(*args), 20),
        "kernel_graph_ms": graph_ms(lambda st: lib.gbkmv_score_launch(
            x.values.data_ptr(), x.thresh.data_ptr(), x.buf.data_ptr(), m, c,
            0, qp.values.data_ptr(), qp.thresh.data_ptr(), qp.buf.data_ptr(),
            qp.sizes.data_ptr(), gq, cq, out_b1.data_ptr(), x.values.device.index,
            st)),
        "plain_ms": cuda_ms(lambda: ref.gbkmv_score_ref(*args), 3),
        "live_x_per_pair": live_x / (m * gq),
        "query_hashes": int(qp.lengths.sum())}}

    # B3 and B4 on the gkmv tail store.
    dpost = index.sketches.device_postings(DEV)
    keys, rb = dpost.keys, dpost.row_blocks
    q_flat = qp.values.reshape(-1)
    pos, hit, cum = probe_tasks(keys, q_flat, rb)
    shift = postings_probe.last_fence_shift
    sync()
    require(all(torch.equal(a, b) for a, b in zip(
        (pos, hit, cum), ref.probe_tasks_ref(keys, q_flat, rb)))
        and all(torch.equal(a, b) for a, b in zip(
            postings_probe(keys, q_flat), ref.postings_probe_ref(keys,
                                                                 q_flat))),
        "probe kernels equal plain version on the gkmv tail")
    n, u = q_flat.numel(), keys.numel()
    p_o, h_o, c_o = (torch.empty_like(pos), torch.empty_like(hit),
                     torch.empty_like(cum))
    out["postings_probe"] = {
        "shape": [n, u], "equal": True, "fence_shift": shift,
        "hit_lanes": int(hit.sum()), "tasks": int(cum[-1]) if n else 0,
        "ms": cuda_ms(lambda: probe_tasks(keys, q_flat, rb), 20),
        "kernel_graph_ms": graph_ms(lambda st: lib.postings_probe_launch(
            keys.data_ptr(), u, q_flat.data_ptr(), n, rb.data_ptr(),
            p_o.data_ptr(), h_o.data_ptr(), c_o.data_ptr(), None,
            keys.device.index, st)),
        "plain_ms": cuda_ms(lambda: ref.probe_tasks_ref(keys, q_flat, rb), 5)}
    blocks = (rb, dpost.first, dpost.meta, dpost.off, dpost.payload)
    kw = {"gq": gq, "cq": cq, "m": m}
    kargs = (pos, hit) + blocks
    kc = block_decode(*kargs, cum=cum, **kw)
    want = ref.kcount_ref(*kargs, **kw)
    sync()
    require(torch.equal(kc, want) and torch.equal(block_decode(*kargs, **kw),
                                                  want),
            "block_decode kernel equals plain version on the gkmv tail")
    blk = _task_blocks(pos, hit, rb)
    dense_tasks = int(((dpost.meta[blk] >> 13) & 1).sum())
    kc_o = torch.empty_like(kc)

    def bare_decode(zero_counts: int):
        return lambda st: lib.block_decode_launch(
            pos.data_ptr(), cum.data_ptr(), n, rb.data_ptr(),
            dpost.first.data_ptr(), dpost.meta.data_ptr(),
            dpost.off.data_ptr(), dpost.first.numel(),
            dpost.payload.data_ptr(), dpost.payload.numel(), gq, cq, m,
            kc_o.data_ptr(), zero_counts, keys.device.index, st)

    words = int((dpost.off[blk + 1] - dpost.off[blk]).sum())
    entries = int(((dpost.meta[blk] & 0x7F) + 1).sum())
    body_bytes = (4 * words + 12 * int(blk.numel()) + 8 * n
                  + 4 * int(hit.sum()) + 4 * entries)
    out["block_decode"] = {
        "shape": [n, int(blk.numel()), m, gq], "equal": True,
        "store_has_dense": dpost.has_dense, "dense_tasks": dense_tasks,
        "entries": entries, "payload_words": words,
        "ms": cuda_ms(lambda: block_decode(*kargs, cum=cum, **kw), 20),
        "kernel_graph_ms": graph_ms(bare_decode(1)),
        "body_graph_ms": graph_ms(bare_decode(0)),
        "body_bound_ms": body_bytes / HBM_BYTES_PER_S * 1e3,
        "bound_ms": (body_bytes + 4 * m * gq) / HBM_BYTES_PER_S * 1e3,
        "plain_ms": cuda_ms(lambda: ref.kcount_ref(*kargs, **kw), 3)}

    # B5 on the host route's pairs.
    rec = torch.from_numpy(pairs[0]).to(DEV)
    qq = torch.from_numpy(pairs[1]).to(DEV)
    pargs = args + (rec, qq)
    got = gather_score(*pargs)
    sync()
    require(torch.equal(got, ref.gather_score_ref(*pargs))
            and torch.equal(got, gbkmv_score(*args)[rec.long(), qq.long()]),
            "gather_score kernel equals plain version and B1 at the gkmv "
            "host route's pairs")
    p = rec.numel()
    o_b5 = torch.empty(p, dtype=torch.float32, device=DEV)
    tau_p = torch.minimum(as_u64(x.thresh[rec.long()]),
                          as_u64(qp.thresh[qq.long()]))
    nx = (as_u64(x.values[rec.long()]) <= tau_p[:, None]).sum(1)
    nq = (as_u64(qp.values[qq.long()]) <= tau_p[:, None]).sum(1)
    reads = torch.clamp_max(nx + 1, c)
    start = rec.long() * (4 * c)
    sectors = int(((start + 4 * reads - 1) // 32 - start // 32 + 1).sum())
    b5_bytes = 32 * sectors + 4 * (p * 3 + gq * (cq + 2))
    b5_ops = 2 * int((nx + nq).sum()) + 12 * p
    out["gather_score"] = {
        "shape": [p, m, c, gq, cq, 0], "equal": True,
        "live_x_per_pair": float(nx.float().mean()) if p else 0.0,
        "live_q_per_pair": float(nq.float().mean()) if p else 0.0,
        "ms": cuda_ms(lambda: gather_score(*pargs), 20),
        "kernel_graph_ms": graph_ms(lambda st: lib.gather_score_launch(
            x.values.data_ptr(), x.thresh.data_ptr(), x.buf.data_ptr(), m, c,
            0, qp.values.data_ptr(), qp.thresh.data_ptr(), qp.buf.data_ptr(),
            qp.sizes.data_ptr(), gq, cq, rec.data_ptr(), qq.data_ptr(), p,
            o_b5.data_ptr(), x.values.device.index, st)),
        "plain_ms": cuda_ms(lambda: ref.gather_score_ref(*pargs), 3),
        "bytes": b5_bytes, "ops": b5_ops,
        "bound_ms": max(b5_bytes / HBM_BYTES_PER_S,
                        b5_ops / ALU_OPS_PER_S) * 1e3}
    # The host route's pairs hold few live values (most candidates share
    # one frequent hash and keep one or two); B5 on long rows: the
    # LONG_ROWS records with the most live values, each with every query.
    long_rec = torch.sort(x.lengths.long(), descending=True,
                          stable=True).indices[:LONG_ROWS]
    lrec = long_rec.to(torch.int32).repeat_interleave(gq)
    lq = torch.arange(gq, dtype=torch.int32, device=DEV).repeat(
        long_rec.numel())
    largs = args + (lrec, lq)
    got = gather_score(*largs)
    sync()
    require(torch.equal(got, ref.gather_score_ref(*largs))
            and torch.equal(got, gbkmv_score(*args)[lrec.long(), lq.long()]),
            "gather_score kernel equals plain version and B1 on the gkmv "
            "index's longest rows")
    lp = lrec.numel()
    o_long = torch.empty(lp, dtype=torch.float32, device=DEV)
    lx = x.lengths[lrec.long()].long()
    lbytes = 4 * int(torch.clamp_max(lx + 1, c).sum()) + 4 * lp * 3
    out["gather_score"]["long_rows"] = {
        "pairs": lp, "live_x_per_pair": float(lx.float().mean()),
        "shortest_row": int(lx.min()),
        "ms": cuda_ms(lambda: gather_score(*largs), 20),
        "kernel_graph_ms": graph_ms(lambda st: lib.gather_score_launch(
            x.values.data_ptr(), x.thresh.data_ptr(), x.buf.data_ptr(), m, c,
            0, qp.values.data_ptr(), qp.thresh.data_ptr(), qp.buf.data_ptr(),
            qp.sizes.data_ptr(), gq, cq, lrec.data_ptr(), lq.data_ptr(), lp,
            o_long.data_ptr(), x.values.device.index, st)),
        "bytes": lbytes,
        "bound_ms": lbytes / HBM_BYTES_PER_S * 1e3}
    return out


def phase_parity(index, batch, tail_mask, query_batch, cand_rec,
                 cand_q, topk_list, gkmv_index, gkmv_pairs) -> dict:
    """Each kernel against its plain version on the same card tensors,
    exact equality; then their times at the main path's shapes."""
    results = {}

    # -- B2 over the slice's tail-id stream plus edge ids --------------------
    tail = batch.ids[tail_mask]
    edge = np.asarray([0, 1, 2**31, 2**32 - 1, 2**32, 2**32 + 5, 2**40 + 7],
                      np.int64)
    ids = np.concatenate([tail, edge])
    ids32 = u32_ids(ids).to(DEV)
    ids64 = torch.from_numpy(ids).to(DEV)
    tau_i = int(index.core.tau)
    err, cases = 0, []
    # The whole stream; the stream 1-3 words in (its pointer off 16-B
    # alignment, the outputs on it: the scalar body); lengths that are not
    # multiples of four.
    for lead, stop in ((0, len(ids)), (1, len(ids)), (2, len(ids)),
                       (3, len(ids)), (0, 5), (0, 257), (0, len(ids) - 1)):
        v32, v64 = ids32[lead:stop], ids64[lead:stop]
        for tau in (None, 0, tau_i, int(PAD)):
            h, keep = hash_threshold(v32, 0, tau)
            h_want, keep_want = ref.hash_threshold_ref(v64, 0, tau)
            sync()
            require(torch.equal(as_u64(h), h_want)
                    and (keep is None if tau is None
                         else torch.equal(keep.bool(), keep_want)),
                    f"hash_threshold kernel equals plain version at "
                    f"ids[{lead}:{stop}], tau={tau}")
            err = max(err, int((as_u64(h) - h_want).abs().max()))
        cases.append({"lead": lead, "n": v32.numel(),
                      "words_past_16B": v32.data_ptr() % 16 // 4})
    tail32 = ids32[: len(tail)]
    n = tail32.numel()
    lib = library.library()
    h_o, k_o = torch.empty_like(tail32), torch.empty_like(tail32)

    def bare_b2(keep: bool):
        return lambda st: lib.hash_threshold_launch(
            tail32.data_ptr(), h_o.data_ptr(),
            k_o.data_ptr() if keep else None, n, seed_offset(0), tau_i,
            tail32.device.index, st)

    # Timed as the device build calls it: hashes only, 4 B in, 4 B out; the
    # bare launch also with the keep flags (4 B more out).
    results["hash_threshold"] = {
        "shape": [n], "max_abs_err": float(err), "parity": "exact",
        "ms": cuda_ms(lambda: hash_threshold(tail32, 0), 50),
        "kernel_graph_ms": graph_ms(bare_b2(False)),
        "kernel_graph_keep_ms": graph_ms(bare_b2(True)),
        "keep_bound_ms": 12 * n / HBM_BYTES_PER_S * 1e3,
        "host_us": median_host_us(lambda: hash_threshold(tail32, 0)),
        "registers": ptxas_usage("hash_threshold.cu"),
        "sass": {k: v for k, v in sass_instructions(library.build()).items()
                 if "hash_threshold" in k},
        "plain_ms": cuda_ms(lambda: ref.hash_threshold_ref(tail32, 0, None), 5),
        "cases": cases, "bytes": 8 * n, "ops": 11 * n,
    }

    # -- B1 at the main path's shapes plus edge cases --------------------------
    x = index.core.sketches.device_pack(DEV)
    qp = gbkmv.sketch_query_batch(index.core, query_batch).to(DEV)
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
    # Packs of 1, 3 and 17 queries through score_index (17: batch 0's
    # and its first query again), at NETFLIX's M.
    for n in (1, 3, 17):
        q_n = [t[:n] if n <= gq else torch.cat([t, t[:n - gq]])
               for t in args[3:]]
        require(torch.equal(score_index(*args[:3], *q_n),
                            ref.gbkmv_score_ref(*args[:3], *q_n)),
                f"gbkmv_score kernel equals plain version at Gq={n}")
    # Thresholds below the global τ, as on rows that overflowed capacity:
    # every third record's at its first value, and every other query's at
    # half of τ (so each side's threshold is the smaller on some pairs).
    tau_u = int(index.core.tau)
    xt_low = as_u64(x.thresh)
    xt_low[::3] = torch.minimum(xt_low[::3], as_u64(x.values[::3, 0]))
    qt_low = as_u64(qp.thresh)
    qt_low[1::2] = tau_u // 2
    low = (x.values, as_bits(xt_low), x.buf, qp.values, as_bits(qt_low),
           qp.buf, qp.sizes)
    require(torch.equal(gbkmv_score(*low), ref.gbkmv_score_ref(*low)),
            "gbkmv_score kernel equals plain version with thresholds below "
            "the global tau")
    lib = library.library()
    out_b1 = torch.empty((m, gq), dtype=torch.float32, device=DEV)

    def bare_b1(st):
        return lib.gbkmv_score_launch(
            x.values.data_ptr(), x.thresh.data_ptr(), x.buf.data_ptr(), m, c,
            w, qp.values.data_ptr(), qp.thresh.data_ptr(), qp.buf.data_ptr(),
            qp.sizes.data_ptr(), gq, cq, out_b1.data_ptr(),
            x.values.device.index, st)
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
        "kernel_graph_ms": graph_ms(bare_b1),
        "host_us": median_host_us(lambda: gbkmv_score(*args)),
        "plain_ms": cuda_ms(lambda: ref.gbkmv_score_ref(*args), 3),
        "records_below_tau_checked": int((xt_low < tau_u).sum()),
        "live_x_per_pair": live_x / (m * gq),
        "row_values_read_per_record": float(reads.float().mean()),
        "row_bytes": 32 * sectors,
        "bytes": 32 * sectors + 4 * (m * (1 + w) + gq * (cq + 2 + w) + m * gq),
        # Per pair: the live-prefix counts and the merge (each at most
        # n_x + n_q steps), an AND and a popcount per buffer word, and
        # about a dozen float operations in the tail.
        "ops": 2 * live + m * gq * (2 * w + 12),
    }
    # -- B5 at a real batch's candidate list, the top-k's list, edge cases -----
    rec = torch.from_numpy(cand_rec).to(DEV)
    qq = torch.from_numpy(cand_q).to(DEV)
    pargs = args + (rec, qq)
    got = gather_score(*pargs)
    want = ref.gather_score_ref(*pargs)
    sync()
    require(torch.equal(got, want),
            "gather_score kernel equals plain version at a real candidate list")
    require(torch.equal(got, gbkmv_score(*args)[rec.long(), qq.long()]),
            "gather_score kernel equals the dense kernel's entries")
    err = float((got - want).abs().max())
    # The first top-10 query's whole bound-ordered list (a one-query pack).
    tqp, tlist = topk_list
    tq = tqp.to(DEV)
    targs = (x.values, x.thresh, x.buf, tq.values, tq.thresh, tq.buf,
             tq.sizes)
    trec = torch.from_numpy(tlist).to(DEV)
    tzero = torch.zeros_like(trec)
    tgot = gather_score(*targs, trec, tzero)
    require(torch.equal(tgot, ref.gather_score_ref(*targs, trec, tzero))
            and torch.equal(tgot, gbkmv_score(*targs)[trec.long(), 0]),
            "gather_score kernel equals plain version and the dense kernel's "
            "entries at the top-k's whole list")
    err = max(err, float((tgot - ref.gather_score_ref(*targs, trec, tzero))
                         .abs().max()))
    cases, erec, eq = _edge_pair_cases()
    for e in cases:
        require(torch.equal(gather_score(*e, erec, eq),
                            ref.gather_score_ref(*e, erec, eq)),
                "gather_score kernel equals plain version on edge cases")
    for name, (ecols, r_e, q_e) in _edge_gather_shapes().items():
        e_got = gather_score(*ecols, r_e, q_e)
        require(torch.equal(e_got, ref.gather_score_ref(*ecols, r_e, q_e))
                and torch.equal(e_got, gbkmv_score(*ecols)[r_e.long(),
                                                           q_e.long()]),
                f"gather_score kernel equals plain version and B1 ({name})")

    def bare(cols, r, q):
        o = torch.empty(r.numel(), dtype=torch.float32, device=DEV)
        xv, xt, xb, qv, qt, qb, qs = cols
        return lambda st: lib.gather_score_launch(
            xv.data_ptr(), xt.data_ptr(), xb.data_ptr(), m, c, w,
            qv.data_ptr(), qt.data_ptr(), qb.data_ptr(), qs.data_ptr(),
            qv.shape[0], qv.shape[1], r.data_ptr(), q.data_ptr(), r.numel(),
            o.data_ptr(), xv.device.index, st)

    p = rec.numel()
    xr = as_u64(x.values[rec.long()])
    tau_p = torch.minimum(as_u64(x.thresh[rec.long()]),
                          as_u64(qp.thresh[qq.long()]))
    nx = (xr <= tau_p[:, None]).sum(1)
    nq = (as_u64(qp.values[qq.long()]) <= tau_p[:, None]).sum(1)
    # Bytes per pair: the record row's sectors up to its first value above
    # τ_pair, its threshold and buffer, the two indices and the f32 out;
    # the query pack once.
    reads = torch.clamp_max(nx + 1, c)
    start = rec.long() * (4 * c)
    sectors = int(((start + 4 * reads - 1) // 32 - start // 32 + 1).sum())
    results["gather_score"] = {
        "shape": [p, m, c, gq, cq, w], "max_abs_err": err, "parity": "exact",
        "ms": cuda_ms(lambda: gather_score(*pargs), 50),
        "kernel_graph_ms": graph_ms(bare(args, rec, qq)),
        "host_us": median_host_us(lambda: gather_score(*pargs)),
        "topk_list_pairs": trec.numel(),
        "topk_list_ms": cuda_ms(lambda: gather_score(*targs, trec, tzero),
                                50),
        "topk_list_kernel_graph_ms": graph_ms(bare(targs, trec, tzero)),
        "plain_ms": cuda_ms(lambda: ref.gather_score_ref(*pargs), 3),
        "row_bytes": 32 * sectors,
        "bytes": 32 * sectors + 4 * (p * (1 + w + 3) + gq * (cq + 2 + w)),
        "ops": 2 * int((nx + nq).sum()) + p * (2 * w + 12),
    }
    # -- B3 at batch 0's flat query hashes, plus edge cases ---------------------
    dpost = index.core.sketches.device_postings(DEV)
    keys, rb = dpost.keys, dpost.row_blocks
    q_flat = qp.values.reshape(-1)
    pos, hit = postings_probe(keys, q_flat)
    wpos, whit, wcum = ref.probe_tasks_ref(keys, q_flat, rb)
    sync()
    require(torch.equal(pos, wpos) and torch.equal(hit, whit),
            "postings_probe kernel equals plain version at batch 0")
    tpos, thit, cum = probe_tasks(keys, q_flat, rb)
    batch0_shift = postings_probe.last_fence_shift
    sync()
    require(torch.equal(tpos, wpos) and torch.equal(thit, whit)
            and torch.equal(cum, wcum),
            "probe_tasks kernel (pos, hit, cum) equals plain version at "
            "batch 0")
    err = float((tpos - wpos).abs().max() + (cum - wcum).abs().max())
    for ekeys, qs, erb in _edge_probe_cases():
        require(all(torch.equal(a, b) for a, b in zip(
            postings_probe(ekeys, qs), ref.postings_probe_ref(ekeys, qs))),
            "postings_probe kernel equals plain version on edge cases")
        require(all(torch.equal(a, b) for a, b in zip(
            probe_tasks(ekeys, qs, erb), ref.probe_tasks_ref(ekeys, qs, erb))),
            "probe_tasks kernel equals plain version on edge cases")
    cases = {"batch0": {"n": q_flat.numel(), "u": keys.numel(),
                        "fence_shift": batch0_shift}}
    for name, (ckeys, cq_flat, crb) in _probe_task_cases(keys, rb).items():
        got = probe_tasks(ckeys, cq_flat, crb)
        shift = postings_probe.last_fence_shift
        want = ref.probe_tasks_ref(ckeys, cq_flat, crb)
        sync()
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"probe_tasks kernel equals plain version ({name})")
        require(shift == fence_shift(ckeys.numel()),
                f"probe_tasks ran with the fence stride of its keys ({name})")
        cases[name] = {"n": cq_flat.numel(), "u": ckeys.numel(),
                       "fence_shift": shift, "hit_lanes": int(got[1].sum())}
    require(max(c["fence_shift"] for c in cases.values()) > 0
            and max(c["n"] for c in cases.values()) > 1024,
            "the probe ran past the shared-memory budget and past one tile")
    n, u = q_flat.numel(), keys.numel()
    sign = -(1 << 31)       # u32 order as int32: flip the sign bit
    ks, qs = keys ^ sign, q_flat ^ sign
    require(torch.equal(torch.searchsorted(ks, qs).to(torch.int32), pos),
            "torch.searchsorted gives the kernel's pos")
    lib = library.library()
    pos_o, hit_o, cum_o = (torch.empty_like(pos), torch.empty_like(hit),
                           torch.empty_like(cum))
    hit_lanes = int(hit.sum())
    blocks = (rb, dpost.first, dpost.meta, dpost.off, dpost.payload)
    kw = {"gq": gq, "cq": cq, "m": m}

    def front():            # the pipeline's front end: B3 then B4
        p, h, c = probe_tasks(keys, q_flat, rb)
        return block_decode(p, h, *blocks, cum=c, **kw)

    def front_old():        # before the fused probe: the prefix by torch ops
        p, h = postings_probe(keys, q_flat)
        return block_decode(p, h, *blocks, **kw)

    require(torch.equal(front(), front_old()),
            "the fused front end counts as the probe + torch prefix")
    timed = turns_ms({"ms": lambda: probe_tasks(keys, q_flat, rb),
                      "library_ms": lambda: torch.searchsorted(ks, qs),
                      "front_ms": front, "front_old_ms": front_old}, 50)
    results["postings_probe"] = {
        "shape": [n, u], "max_abs_err": err, "parity": "exact",
        **timed,
        "kernel_graph_ms": graph_ms(lambda st: lib.postings_probe_launch(
            keys.data_ptr(), u, q_flat.data_ptr(), n, rb.data_ptr(),
            pos_o.data_ptr(), hit_o.data_ptr(), cum_o.data_ptr(), None,
            keys.device.index, st)),
        "host_us": median_host_us(lambda: probe_tasks(keys, q_flat, rb)),
        "host_us_pos_hit_only": median_host_us(
            lambda: postings_probe(keys, q_flat)),
        "library_host_us": median_host_us(lambda: torch.searchsorted(ks, qs)),
        "plain_ms": cuda_ms(lambda: ref.probe_tasks_ref(keys, q_flat, rb), 20),
        "library_note": "torch.searchsorted on the sign-flipped int32 keys "
                        "and queries: pos only, no hit flag, no prefix",
        "front_note": "front_ms: probe_tasks + block_decode(cum=); "
                      "front_old_ms: postings_probe + block_decode(cum=None), "
                      "whose prefix is the torch ops of ref.task_prefix_ref",
        "hit_lanes": hit_lanes, "cases": cases,
        # Keys and queries read once, row_blocks at each hit lane (two
        # words), pos (4 B), hit (1 B) and cum (4 B) written once; a binary
        # search of about log2(U + 1) compares per lane, and the scan's
        # five shuffle adds and a carry add.
        "bytes": 4 * u + 4 * n + 8 * hit_lanes + 4 * n + n + 4 * n,
        "ops": n * (max(1, int(np.ceil(np.log2(u + 1)))) + 6),
    }

    # -- B4 at batch 0, on a store with dense blocks, on synthetic blocks ------
    kargs = (pos, hit) + blocks
    kc = block_decode(*kargs, cum=cum, **kw)
    want = ref.kcount_ref(*kargs, **kw)
    sync()
    require(torch.equal(kc, want),
            "block_decode kernel equals plain version at batch 0")
    require(torch.equal(block_decode(*kargs, **kw), want),
            "block_decode kernel without the probe's prefix equals plain "
            "version at batch 0")
    err = float((kc - want).abs().max())
    dense_check = _dense_store_check()
    syn = _synthetic_postings()
    lanes = to_tensor(np.asarray([10, 11, 12, 13, 14, 15, 16, 17,
                                  17, 12, 99, PAD, 10, 13, PAD, 16],
                                 np.uint32)).to(DEV)
    spos, shit, scum = probe_tasks(syn.keys, lanes, syn.row_blocks)
    sargs = (spos, shit, syn.row_blocks, syn.first, syn.meta, syn.off,
             syn.payload)
    require(torch.equal(block_decode(*sargs, gq=2, cq=8, m=600_000, cum=scum),
                        ref.kcount_ref(*sargs, gq=2, cq=8, m=600_000)),
            "block_decode kernel equals plain version on synthetic blocks "
            "(one entry, bw = 0, bw = 31, straddled words, a dense block)")
    blk = _task_blocks(pos, hit, rb)
    words = int((dpost.off[blk + 1] - dpost.off[blk]).sum())
    entries = int(((dpost.meta[blk] & 0x7F) + 1).sum())
    kc_o = torch.empty_like(kc)
    b4_sass = {k: v for k, v in sass_instructions(library.build()).items()
               if "block_decode" in k or "zero_counts" in k}

    def bare_decode(zero_counts: int):
        return lambda st: lib.block_decode_launch(
            pos.data_ptr(), cum.data_ptr(), n, rb.data_ptr(),
            dpost.first.data_ptr(), dpost.meta.data_ptr(),
            dpost.off.data_ptr(), dpost.first.numel(),
            dpost.payload.data_ptr(), dpost.payload.numel(), gq, cq, m,
            kc_o.data_ptr(), zero_counts, keys.device.index, st)

    # What the decode body itself must move: the touched blocks' payload
    # words and headers (first, meta, off), pos and the prefix sum per
    # lane, the row start of each hit lane and one 4-B atomic update per
    # decoded entry. The function also writes the [m, gq] counts once (the
    # C entry's zeroing), which ``bytes`` adds.
    body_bytes = (4 * words + 12 * int(blk.numel()) + 8 * n + 4 * hit_lanes
                  + 4 * entries)
    results["block_decode"] = {
        "shape": [n, int(blk.numel()), m, gq], "max_abs_err": err,
        "parity": "exact",
        "ms": cuda_ms(lambda: block_decode(*kargs, cum=cum, **kw), 50),
        # The bare launch as the wrapper makes it: the counts' zeroing and
        # the decode; and the decode body alone (no zeroing).
        "kernel_graph_ms": graph_ms(bare_decode(1)),
        "body_graph_ms": graph_ms(bare_decode(0)),
        "body_bound_ms": body_bytes / HBM_BYTES_PER_S * 1e3,
        "body_bytes": body_bytes, "zeroing_bytes": 4 * m * gq,
        # How the C entry zeroes the counts, as the library shows it: a
        # zeroing kernel of its own (launched before the decode, which
        # runs against it by programmatic dependent launch) or a memset.
        "zeroing": "pdl" if any("zero_counts" in k for k in b4_sass)
                   else "memset",
        "sass": b4_sass, "registers": ptxas_usage("block_decode.cu"),
        "host_us": median_host_us(
            lambda: block_decode(*kargs, cum=cum, **kw)),
        "plain_ms": cuda_ms(lambda: ref.kcount_ref(*kargs, **kw), 5),
        "tasks": int(blk.numel()), "entries": entries,
        "payload_words": words, "hit_lanes": hit_lanes,
        "dense_store": dense_check,
        "bytes": body_bytes + 4 * m * gq,
        # Per entry: the unpack (shift, or, mask), its share of the
        # five-step scan, the id and the atomic: about 16 operations.
        "ops": 16 * entries,
    }
    for name, entry in parity_gkmv(gkmv_index, query_batch,
                                   gkmv_pairs).items():
        results[name]["gkmv"] = entry
    results["flash_attention"] = parity_flash()
    emit({"phase": "parity", **{k: {"shape": v["shape"],
                                    "parity": v["parity"],
                                    "max_abs_err": v["max_abs_err"]}
                                for k, v in results.items()},
          "flash_attention_edge_cases": results["flash_attention"][
              "edge_cases"],
          "gbkmv_score_load": {k: results["gbkmv_score"][k] for k in (
              "live_x_per_pair", "row_values_read_per_record", "row_bytes")},
          "gkmv": {k: results[k]["gkmv"] for k in (
              "gbkmv_score", "postings_probe", "block_decode",
              "gather_score")}})
    return results

def close(got, want, tol: float) -> tuple[float, bool]:
    """(max |got - want|, whether |got - want| <= tol + tol·|want| at every
    element), in f32: numpy's assert_allclose with rtol = atol = tol."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    return float(err.max()), bool((err <= tol + tol * w.abs()).all())


def lm_setup(seed: int) -> dict:
    """qwen3-0.6b's weights and a 4 × 4,096 prompt drawn on the card from
    ``seed``, then a warm-up outside the counted path: a 4 × 256 prefill
    and two decode steps (cuBLAS handles, the kernels' first launches,
    the decode's batch shapes)."""
    cfg = registry.get_module(LM_ARCH).config()
    sync()
    t0 = time.perf_counter()
    params, tokens = serve.make_inputs(cfg, batch=LM_BATCH, seq=LM_SEQ,
                                       seed=seed, device=DEV)
    sync()
    init_s = time.perf_counter() - t0
    serve.generate(params, cfg, tokens[:, :256], 2)
    torch.cuda.reset_peak_memory_stats()
    return {"cfg": cfg, "params": params, "tokens": tokens, "init_s": init_s,
            "seed": seed}


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def rel_rms(got, want) -> float:
    """RMS of got - want over the RMS of want, in f32."""
    g, w = got.float(), want.float()
    return float((g - w).pow(2).mean().sqrt() / w.pow(2).mean().sqrt())


def decode_check(params, cfg, ct, dtype: str, attention=causal_attention,
                 slot: int = 0) -> dict:
    """Prefill ct[:, :-1], decode its last token into cache slot
    ``len + slot`` (0 is right; -1 is the control, a cache write one slot
    early), and compare the decode logits with the full forward's at that
    position, with the weights and activations in ``dtype`` and
    ``attention`` in the prefill and the forward."""
    cfg = dataclasses.replace(cfg, dtype=dtype)
    params = _cast(params, cfg.torch_dtype)
    n = ct.shape[1] - 1
    _, caches = tfm.prefill(params, ct[:, :n], cfg, cache_len=n + 4,
                            attention=attention)
    lengths = torch.full((ct.shape[0],), n + slot, dtype=torch.int64,
                         device=DEV)
    dec, _, new_len = tfm.decode_step(params, caches, ct[:, n:], lengths, cfg)
    require(bool((new_len == lengths + 1).all())
            and bool(torch.isfinite(dec).all()),
            "decode advances the cache and gives finite logits")
    full = tfm.forward(params, ct, cfg, attention=attention)[:, n]
    err, ok = close(dec, full, LM_TOL)
    return {"max_abs_err": err, f"within_{LM_TOL}": ok,
            "rel_rms_err": rel_rms(dec, full),
            "max_abs_logit": float(full.float().abs().max())}


def _device_summary(prof, wall_s: float) -> dict:
    """Device time of a profiled window: the union of its kernels' spans,
    the idle share of the host-clock window, and the kernels that took
    the most device time."""
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    wall_ms = wall_s * 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1 - busy_us / 1e3 / wall_ms,
            "kernel_launches": len(kernels),
            "top_kernels_ms": {name[:60]: us / 1e3 for name, us in top}}


def launched_bodies(fn):
    """fn()'s result and the B6 launches that ran on the card meanwhile,
    per body, as the kernels count them (bodies not launched left out)."""
    before = flash_body_launches()
    out = fn()
    after = flash_body_launches()
    return out, {k: n - before[k] for k, n in after.items() if n > before[k]}


def expected_body(dtype, d: int) -> str:
    """The body B6 is designed to run: tensor cores for bf16 at D 64 or
    128, CUDA cores otherwise."""
    return ("wgmma" if dtype == torch.bfloat16 and d in (64, 128)
            else "cuda-core")


def lm_profile(lm: dict) -> dict:
    """Where the LM path's time goes: torch.profiler over one prefill and
    over three decode steps (after one unprofiled step), device time
    against the host clock."""
    cfg, params, tokens = lm["cfg"], lm["params"], lm["tokens"]
    b, s = tokens.shape
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits, caches = tfm.prefill(params, tokens, cfg, cache_len=s + 4)
        sync()
        wall = time.perf_counter() - t0
    out = {"prefill": _device_summary(prof, wall)}
    tok = logits.argmax(-1, keepdim=True)
    lengths = torch.full((b,), s, dtype=torch.int64, device=DEV)
    logits, caches, lengths = tfm.decode_step(params, caches, tok, lengths,
                                              cfg)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            tok = logits.argmax(-1, keepdim=True)
            logits, caches, lengths = tfm.decode_step(params, caches, tok,
                                                      lengths, cfg)
        sync()
        wall = time.perf_counter() - t0
    out["decode_3_steps"] = _device_summary(prof, wall)
    return out


def check_lm(lm: dict, launches: dict) -> dict:
    """The LM path's outputs: shapes, finiteness and B6's launches; the
    prefill again with the plain chunked attention on the card; decode
    after prefill against the full forward (tests/test_archs_smoke.py's
    test_lm_prefill_decode) at 2 × 256: within 2e-2 in f32; in bf16, on
    the B6 route and with the plain attention on both sides, within
    LM_BF16_DECODE_LIMIT, which a one-slot-early cache write exceeds."""
    cfg, params, tokens, out = lm["cfg"], lm["params"], lm["tokens"], lm["out"]
    peak = torch.cuda.max_memory_allocated()
    b, s = tokens.shape
    logits = out["prefill_logits"]
    require(logits.shape == (b, cfg.vocab) and logits.dtype == torch.bfloat16
            and bool(torch.isfinite(logits).all()),
            "prefill logits are finite bf16 [B, V]")
    picks = out["tokens"]
    require(picks.shape == (b, LM_DECODE_STEPS + 1)
            and bool(((picks >= 0) & (picks < cfg.vocab)).all()),
            "greedy tokens are vocabulary ids")
    require(launches["flash_attention"] == cfg.n_layers,
            "prefill launches B6 once per layer, decode never")
    require(lm["bodies"] == {"wgmma": cfg.n_layers},
            "B6's tensor-core body ran once per layer on the LM path, by "
            f"the kernels' own count ({lm['bodies']})")

    sync()
    t0 = time.perf_counter()
    plain, _ = tfm.prefill(params, tokens, cfg,
                           attention=causal_attention_plain)
    sync()
    plain_s = time.perf_counter() - t0
    require(bool(torch.isfinite(plain).all()), "plain prefill logits finite")
    diff = float((logits.float() - plain.float()).abs().max())
    agree = float((logits.argmax(-1) == plain.argmax(-1)).float().mean())
    del plain

    ct = tokens[:LM_CHECK_BATCH, :LM_CHECK_SEQ + 1]
    checks = {"float32": decode_check(params, cfg, ct, "float32"),
              "bfloat16": decode_check(params, cfg, ct, "bfloat16"),
              "bfloat16_plain": decode_check(params, cfg, ct, "bfloat16",
                                             causal_attention_plain),
              "bfloat16_control_slot_early": decode_check(
                  params, cfg, ct, "bfloat16", slot=-1)}
    require(checks["float32"][f"within_{LM_TOL}"],
            f"f32 decode logits equal the full forward's within {LM_TOL}")
    for name in ("bfloat16", "bfloat16_plain"):
        require(checks[name]["max_abs_err"] <= LM_BF16_DECODE_LIMIT,
                f"{name} decode logits within {LM_BF16_DECODE_LIMIT} of the "
                "full forward's")
    require(checks["bfloat16_control_slot_early"]["max_abs_err"]
            > LM_BF16_DECODE_LIMIT,
            "a one-slot-early cache write exceeds the bf16 decode limit")
    out_line = {
        "phase": "lm", "arch": cfg.name,
        "config": {k: getattr(cfg, k) for k in (
            "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
            "d_ff", "vocab", "qk_norm", "rope_mode", "dtype")},
        "params": model_common.count_params(params), "seed": lm["seed"],
        "batch": b, "seq": s, "decode_steps": LM_DECODE_STEPS,
        "reduced": "batch 32 -> 4 and seq 32,768 -> 4,096 against "
                   "prefill_32k (its KV cache, ~120 GB, is over one card); "
                   "random weights",
        "init_s": lm["init_s"], "prefill_s": out["prefill_s"],
        "prefill_tok_per_s": b * s / out["prefill_s"],
        "decode_s": out["decode_s"],
        "decode_tok_per_s": out["decode_tok_per_s"],
        "flash_attention_launches": launches["flash_attention"],
        "flash_attention_bodies": lm["bodies"],
        "peak_mem_gb": peak / 2**30,
        "plain_prefill_s": plain_s,
        "last_logits_max_abs_diff_vs_plain": diff,
        "last_logits_argmax_agree_vs_plain": agree,
        "decode_check": {"batch": LM_CHECK_BATCH, "seq": LM_CHECK_SEQ,
                         "f32_tol": LM_TOL,
                         "bf16_limit": LM_BF16_DECODE_LIMIT, **checks},
        "greedy_tokens_row0": picks[0].tolist(),
        "profile": lm_profile(lm)}
    emit(out_line)
    return out_line


def _flash_inputs(b, s, hq, hkv, d, dtype, seed):
    gen = torch.Generator(device=DEV).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=DEV).to(dtype)
            for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d))]


# B6 edge cases: (B, S, Hq, Hkv, D, dtype). An f32 run at the main path's
# heads; the shapes of tests/test_flash_kernel.py (G = 2, MHA G = 1, MQA
# G = 4, and bf16); S = 1 and S = 100 (no tile multiple); the reduced
# qwen3 config's head dim; on the tensor-core body (bf16, D 64 or 128)
# G = 1, 3 (not dividing the block's 128 rows), 4 and 8.
FLASH_CASES = {
    "f32_main_heads": (1, 2048, 16, 8, 128, torch.float32),
    "g2_f32": (1, 256, 4, 2, 64, torch.float32),
    "g1_f32": (2, 256, 8, 8, 32, torch.float32),
    "g4_f32": (2, 512, 4, 1, 64, torch.float32),
    "g2_bf16": (1, 256, 4, 2, 64, torch.bfloat16),
    "s1_bf16": (LM_BATCH, 1, 16, 8, 128, torch.bfloat16),
    "s1_f32": (2, 1, 16, 8, 128, torch.float32),
    "s100_bf16": (2, 100, 16, 8, 128, torch.bfloat16),
    "s100_f32": (2, 100, 16, 8, 128, torch.float32),
    "d16_bf16": (2, 100, 4, 2, 16, torch.bfloat16),
    "g1_s777_bf16": (1, 777, 8, 8, 128, torch.bfloat16),
    "g3_bf16": (1, 200, 6, 2, 128, torch.bfloat16),
    "g4_bf16": (2, 512, 16, 4, 128, torch.bfloat16),
    "g8_d64_bf16": (1, 300, 8, 1, 64, torch.bfloat16),
}
# The tensor-core body's kernel at the LM path's head dim, as its SASS
# names it, and the instructions that show tensor cores and TMA.
FLASH_TC_SYMBOL = "flash_attention_tc_kernelILi128E"
SASS_OPS = ("HGMMA", "UTMALDG")
# B6 wrapper calls whose host time is averaged.
WRAPPER_CALLS = 20


def parity_flash() -> dict:
    """B6 against its plain version on the card: at the LM path's shape
    (bf16, 2e-2), on the edge cases (2e-2 bf16, 2e-5 f32) and for
    causality, and in bf16 also its relative RMS error (at most
    FLASH_BF16_REL_RMS); then its time, the plain version's and SDPA's."""
    edge = {}
    for i, (name, (b, s, hq, hkv, d, dtype)) in enumerate(FLASH_CASES.items()):
        q, k, v = _flash_inputs(b, s, hq, hkv, d, dtype, 100 + i)
        tol = LM_TOL if dtype == torch.bfloat16 else F32_TOL
        got, bodies = launched_bodies(lambda: flash_attention(q, k, v))
        require(bool(torch.isfinite(got).all()), f"B6 finite on {name}")
        require(bodies == {expected_body(dtype, d): 1},
                f"B6 runs its {expected_body(dtype, d)} body on {name} "
                f"(counted {bodies})")
        want = ref.flash_attention_ref(q, k, v)
        err, ok = close(got, want, tol)
        require(ok, f"flash_attention kernel within {tol} of plain on {name}")
        edge[name] = {"shape": [b, s, hq, hkv, d], "dtype": str(dtype),
                      "body": next(iter(bodies)), "tol": tol,
                      "max_abs_err": err}
        if dtype == torch.bfloat16:
            edge[name]["rel_rms_err"] = rel_rms(got, want)
            require(edge[name]["rel_rms_err"] <= FLASH_BF16_REL_RMS,
                    f"flash_attention kernel's relative RMS error within "
                    f"{FLASH_BF16_REL_RMS} on {name}")
    # Future keys must not move the first half's outputs.
    q, k, v = _flash_inputs(1, 256, 2, 2, 32, torch.float32, 99)
    k2, v2 = k.clone(), v.clone()
    k2[:, 128:] = 99.0
    v2[:, 128:] = -99.0
    causal_err, ok = close(flash_attention(q, k2, v2)[:, :128],
                           flash_attention(q, k, v)[:, :128], 1e-6)
    require(ok, "flash_attention kernel is causal")
    # The same on the tensor-core body, cut inside a key tile.
    q, k, v = _flash_inputs(1, 256, 4, 2, 128, torch.bfloat16, 98)
    k2, v2 = k.clone(), v.clone()
    k2[:, 100:] = 99.0
    v2[:, 100:] = -99.0
    causal_bf16_err, ok = close(flash_attention(q, k2, v2)[:, :100],
                                flash_attention(q, k, v)[:, :100], 1e-6)
    require(ok, "flash_attention kernel is causal on the tensor-core body")

    b, s, hq, hkv, d = LM_BATCH, LM_SEQ, 16, 8, 128
    q, k, v = _flash_inputs(b, s, hq, hkv, d, torch.bfloat16, 0)
    got, bodies = launched_bodies(lambda: flash_attention(q, k, v))
    require(bodies == {"wgmma": 1},
            f"the LM shape runs B6's tensor-core body (counted {bodies})")
    want = ref.flash_attention_ref(q, k, v)
    err, ok = close(got, want, LM_TOL)
    require(ok and bool(torch.isfinite(got).all()),
            "flash_attention kernel within 2e-2 of plain at the LM shape")
    err_rms = rel_rms(got, want)
    require(err_rms <= FLASH_BF16_REL_RMS,
            f"flash_attention kernel's relative RMS error within "
            f"{FLASH_BF16_REL_RMS} at the LM shape")
    # The control: the plain version's f32 output truncated to bf16.
    exact = ref.flash_attention_ref(q.float(), k.float(), v.float())
    truncated = (exact.view(torch.int32) & ~0xFFFF).view(torch.float32)
    control_rms = rel_rms(truncated.to(torch.bfloat16), want)
    del exact, truncated
    require(control_rms > FLASH_BF16_REL_RMS,
            "an output truncated to bf16 exceeds the relative RMS limit")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    lib_out = sdpa().transpose(1, 2)
    lib_err = float((lib_out.float() - want.float()).abs().max())
    lib_rms = rel_rms(lib_out, want)
    del want, lib_out
    sass = sass_counts(FLASH_TC_SYMBOL)
    for op in SASS_OPS:
        require(sass[op] > 0, f"B6's tensor-core body has {op} in its SASS")
    ops = 4 * b * hq * d * (s * (s + 1) // 2)
    ms = cuda_ms(lambda: flash_attention(q, k, v), 10)
    # Host time of one wrapper call (checks, three tensor maps, launch),
    # issued back to back without a sync.
    sync()
    t0 = time.perf_counter()
    for _ in range(WRAPPER_CALLS):
        flash_attention(q, k, v)
    host_us = (time.perf_counter() - t0) / WRAPPER_CALLS * 1e6
    sync()
    return {
        "shape": [b, s, hq, hkv, d], "dtype": "bfloat16", "max_abs_err": err,
        "parity": "2e-2 bf16, 2e-5 f32", "ms": ms,
        "plain_ms": cuda_ms(lambda: ref.flash_attention_ref(q, k, v), 3),
        "library_ms": cuda_ms(sdpa, 10),
        "library_note": "torch.nn.functional.scaled_dot_product_attention "
                        "(is_causal, enable_gqa) on [B,H,S,D] views of the "
                        "same tensors",
        "library_max_abs_err": lib_err,
        # SDPA rounds p to bf16 once before P·V: the error the hi/lo split
        # avoids.
        "library_rel_rms_err": lib_rms,
        "body": "wgmma", "sass": sass, "wrapper_host_us": host_us,
        # q, k and v read once, o written once; the two products over the
        # causal (q, k) pairs, at the bf16 tensor-core rate.
        "bytes": 2 * (2 * q.numel() + k.numel() + v.numel()),
        "ops": ops, "peak_ops_per_s": TENSOR_BF16_FLOPS,
        "achieved_tflops": ops / ms / 1e9,
        "rel_rms_err": err_rms, "rel_rms_limit": FLASH_BF16_REL_RMS,
        "rel_rms_control_truncated": control_rms,
        "edge_cases": edge, "causality_max_abs_err": causal_err,
        "causality_bf16_max_abs_err": causal_bf16_err,
    }


_SASS_INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s+\S")


def _dump_sass(lib: Path) -> str:
    cuobjdump = Path(library._nvcc()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "--dump-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout


def sass_instructions(lib: Path) -> dict:
    """SASS instructions of each kernel in a built library, by the kernel's
    mangled name (cuobjdump --dump-sass)."""
    counts, name = {}, None
    for line in _dump_sass(lib).splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[-1].strip()
            counts[name] = 0
        elif name is not None and _SASS_INSTRUCTION.search(line):
            counts[name] += 1
    return counts


def ptxas_usage(source: str) -> dict:
    """Registers and spill bytes of each kernel of one source, by mangled
    name, from ptxas's report in the library's ``build.log``."""
    log = (library.build().parent / "build.log").read_text()
    usage, name, inside = {}, None, False
    for line in log.splitlines():
        if line.startswith("== "):
            inside = line[3:].strip() == source
        elif not inside:
            continue
        elif m := re.search(r"Compiling entry function '(\S+)'", line):
            name = m.group(1)
            usage[name] = {}
        elif name is None:
            continue
        elif m := re.search(r"Used (\d+) registers", line):
            usage[name]["registers"] = int(m.group(1))
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            usage[name]["spill_stores"] = int(m.group(1))
            usage[name]["spill_loads"] = int(m.group(2))
    return usage


def sass_counts(symbol: str) -> dict:
    """How many of each of SASS_OPS the built library's kernel whose
    mangled name holds ``symbol`` has (cuobjdump --dump-sass)."""
    counts = dict.fromkeys(SASS_OPS, 0)
    inside = False
    for line in _dump_sass(library.build()).splitlines():
        if "Function : " in line:
            inside = symbol in line
        elif inside:
            for op in SASS_OPS:
                counts[op] += op in line
    return counts


# Keys of a parity result that the kernels line reports on their own.
_ENTRY_KEYS = ("shape", "max_abs_err", "parity", "ms", "plain_ms", "bytes",
               "ops", "library_ms", "library_note", "peak_ops_per_s")
# Keys that a kernel's entry carries beside those, where its result has them.
_EXTRA_KEYS = ("body", "achieved_tflops", "sass", "library_rel_rms_err",
               "kernel_graph_ms", "kernel_graph_keep_ms", "keep_bound_ms",
               "body_graph_ms", "body_bound_ms",
               "zeroing", "registers", "host_us",
               "library_host_us", "front_ms", "front_old_ms",
               "topk_list_pairs", "topk_list_ms", "topk_list_kernel_graph_ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the LM path's weights and prompt")
    args = ap.parse_args(argv)
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

    # The main paths: launch counts from 0 before each, read right after.
    def reset():
        for counter in COUNTERS.values():
            counter.launches = 0

    def read():
        sync()
        return {name: c.launches for name, c in COUNTERS.items()}

    # The build's host half, and its device part stage by stage: before
    # the counted run, as its stages re-run B2.
    hp = host_part(batch, budget)
    split = {mode: device_split(batch, hp, mode) for mode in TAU_MODES}
    reset()
    index, tail_mask = phase_build(batch, budget, hp, split)
    hits_seen, topk_seen, topk_queries = phase_query(index, batches)
    phase_save(index, batches, hits_seen, topk_seen, topk_queries)
    launches = {"dense": read()}
    reset()
    run = phase_pruned(index, batch, budget, batches, topk_queries)
    launches["pruned"] = read()
    check_pruned(index, batches, run, hits_seen, topk_seen)
    reset()
    host_run = phase_host_pruned(index, batches[:CHECK_BATCHES],
                                 topk_queries[:GQ])
    launches["host_pruned"] = read()
    (cand_rec, cand_q), topk_list = check_host_pruned(
        index, batches, host_run, run, hits_seen, topk_seen, topk_queries)
    # The gkmv and kmv engines at the same records and budget.
    sketch_batches = batches[:SKETCH_BATCHES]
    sketch_topk = batches[0][:SKETCH_TOPK]
    seconds = {}
    t0 = time.perf_counter()
    reset()
    g_dense = gkmv_dense(batch, budget, sketch_batches, sketch_topk)
    launches["gkmv_dense"] = read()
    seconds["dense_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    reset()
    g_pruned = gkmv_pruned(g_dense["index"], sketch_batches, sketch_topk)
    launches["gkmv_pruned"] = read()
    seconds["pruned_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    reset()
    g_host = phase_host_pruned(g_dense["index"],
                               sketch_batches[:GKMV_HOST_BATCHES],
                               sketch_topk[:GKMV_HOST_TOPK],
                               thresholds=(GKMV_HOST_T,))
    launches["gkmv_host"] = read()
    seconds["host_s"] = time.perf_counter() - t0
    gkmv_index, gkmv_pairs = check_gkmv(g_dense, g_pruned, g_host,
                                        sketch_batches, sketch_topk, seconds)
    del g_dense, g_pruned, g_host
    t0 = time.perf_counter()
    reset()
    k_run = kmv_run(batch, budget, sketch_batches, sketch_topk)
    launches["kmv"] = read()
    check_kmv(k_run, sketch_batches, sketch_topk, time.perf_counter() - t0)
    del k_run
    lm = lm_setup(args.seed)
    reset()
    lm["out"], lm["bodies"] = launched_bodies(lambda: serve.generate(
        lm["params"], lm["cfg"], lm["tokens"], LM_DECODE_STEPS))
    launches["lm"] = read()
    check_lm(lm, launches["lm"])
    lm.clear()
    torch.cuda.empty_cache()
    for path, names in PATH_KERNELS.items():
        for name in names:
            require(launches[path][name] > 0,
                    f"{name} launched on the {path} path")
    for path, name in PATH_NOT_LAUNCHED:
        require(launches[path][name] == 0,
                f"{name} not launched on the {path} path")

    results = phase_parity(index, batch, tail_mask, batches[0], cand_rec,
                           cand_q, topk_list, gkmv_index, gkmv_pairs)
    kernels = []
    for name, r in results.items():
        bytes_ms = r["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = r["ops"] / r.get("peak_ops_per_s", ALU_OPS_PER_S) * 1e3
        kernels.append({
            "name": name, "route": "cuda", **KERNELS[name],
            "launches": sum(launches[path][name] for path in launches),
            "launches_by_path": {path: launches[path][name]
                                 for path in launches},
            "parity": r["parity"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": r.get("library_ms"),
            "library_note": r.get(
                "library_note",
                "no single PyTorch call computes this function"),
            "shape": r["shape"], "bytes": r["bytes"], "ops": r["ops"],
            **{k: r[k] for k in _EXTRA_KEYS if k in r},
            "detail": {k: v for k, v in r.items()
                       if k not in _ENTRY_KEYS + _EXTRA_KEYS},
            "card": card["nvidia_smi"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
