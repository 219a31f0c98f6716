#!/usr/bin/env python3
"""Host time of each step of the B5 pair scorer's doors on the card, its
bare launch, and the planner's host-route top-10 that calls it.

    python3 tools/pair_score_steps.py [--calls 1000] [--tag run]

Builds ``chip_smoke.py``'s NETFLIX deployment (480,189 records, budget 10 %
of the element ids, the 16-query batches of seed 2) and takes two pair
lists: batch 0's candidate list at t = 0.7 (the host route's batch verify)
and the first 64 pairs of query 0's bound-ordered top-k list (one chunk of
the top-k's chunked loop). For each it times, alone and as whole calls:

  door_steps    the steps of ``score_pairs``: the index checks, the
                buffer alignment and the pack's placement, two pageable
                uploads of the indices and a pageable fetch (the door
                before the staged one); one pinned blob filled and copied
                up in one transfer, a pinned fetch and a stream sync; and
                the staged door's ``stage_pairs`` and ``fetch_scores``
                whole
  wrapper_steps the steps of the ``gather_score`` wrapper: its argument
                checks, ``torch.empty``, ``with torch.cuda.device``,
                ``torch.cuda.current_stream().cuda_stream`` against the raw
                stream handle, and the ctypes call
  whole         ``gather_score``, ``score_pairs`` and the index's scorer
                (``GBKMVApiIndex._pair_score_fn``), each called whole
  device        the wrapper's event-timed ms and the bare kernel as one
                launch of a CUDA graph of 20 (``chip_smoke.graph_ms``), also
                at query 0's whole bound-ordered top-k list

and then the host route's top-10 (``planner.pruned_topk`` with the index's
scorer, as ``chip_smoke.py``'s host_pruned phase runs it) for batch 0's 16
queries: per query its host ms, its B5 launches, n (its threshold-0
candidates) and the host ms of its candidate generation alone.

Each step is timed by ``chip_smoke.median_host_us``: the median host µs of
one call over ``--calls`` calls after a warm-up, no synchronisation inside
the timed span unless the step holds one. Prints one JSON object and writes it to
``chiprun_out/pair_score_steps_<tag>.json``. Needs an NVIDIA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402  (puts src/ on the path)
from repro_torch import api  # noqa: E402
from repro_torch.core.estimators import _align_buf_widths  # noqa: E402
from repro_torch.core.sketches import RaggedBatch  # noqa: E402
from repro_torch.data.synth import make_query_workload  # noqa: E402
from repro_torch.kernels import gather_score as gs_mod, library  # noqa: E402
from repro_torch.kernels.gbkmv_score import _check_inputs  # noqa: E402
from repro_torch.planner import (  # noqa: E402
    candidates_for, pruned_topk, topk_candidates)

T_BATCH = 0.7
CHUNK = 64


def setup():
    """(index, batch 0's queries, its pair list at T_BATCH)."""
    recs, _ = smoke.make_records()
    batch = RaggedBatch.from_records(recs)
    index = api.build("gbkmv", batch, int(batch.total * smoke.BUDGET_FRACTION))
    queries = make_query_workload(recs, smoke.NUM_BATCHES * smoke.GQ,
                                  seed=2)[:smoke.GQ]
    post = index._postings()
    _, hash_rows, bit_rows, sizes = index._plan_queries(queries)
    cands = [candidates_for(post, h, b, T_BATCH, int(s))
             for h, b, s in zip(hash_rows, bit_rows, sizes)]
    rec = np.concatenate([c.rec_ids for c in cands]).astype(np.int32)
    q = np.repeat(np.arange(len(queries), dtype=np.int32),
                  [len(c.rec_ids) for c in cands])
    return index, queries, rec, q


def ranked_list(index, query) -> np.ndarray:
    """Query's threshold-0 candidates in the top-k's bound order."""
    _, h, b, s = index._plan_queries([query])
    return topk_candidates(index._postings(), h[0], b[0],
                           int(s[0]))[0].astype(np.int32)


def launch_fn(cols, rec_d, q_d, out):
    """``launch(stream)``: one bare call of the C entry."""
    xv, xt, xb, qv, qt, qb, qs = cols
    m, c = xv.shape
    gq, cq = qv.shape
    lib = library.library()
    return lambda st: lib.gather_score_launch(
        xv.data_ptr(), xt.data_ptr(), xb.data_ptr(), m, c, xb.shape[1],
        qv.data_ptr(), qt.data_ptr(), qb.data_ptr(), qs.data_ptr(), gq, cq,
        rec_d.data_ptr(), q_d.data_ptr(), rec_d.numel(), out.data_ptr(),
        xv.device.index, st)


def steps_at(index, qpack, rec, q, calls) -> dict:
    """Every step of the doors and the wrapper at one pair list."""
    dev = torch.device("cuda", torch.cuda.current_device())
    x = index.core.sketches.device_pack(dev)
    qa, xa = _align_buf_widths(qpack, x)
    qd = qa.to(dev)
    cols = (xa.values, xa.thresh, xa.buf, qd.values, qd.thresh, qd.buf,
            qd.sizes)
    p = len(rec)
    rec_d = torch.from_numpy(rec).to(dev)
    q_d = torch.from_numpy(q).to(dev)
    out = gs_mod.gather_score(*cols, rec_d, q_d)
    launch = launch_fn(cols, rec_d, q_d, out)
    scorer = index._pair_score_fn(qpack)
    host_out = torch.empty(p, dtype=torch.float32, pin_memory=True)

    def checks():
        a = np.asarray(rec, dtype=np.int32)
        b = np.asarray(q, dtype=np.int32)
        return (a.min() < 0 or a.max() >= x.num_records
                or b.min() < 0 or b.max() >= qpack.num_records)

    def blob_fill():
        blob = torch.empty(2 * p, dtype=torch.int32, pin_memory=True)
        v = blob.numpy()
        v[:p] = rec
        v[p:] = q
        return blob

    blob = blob_fill()

    def fetch_pinned():
        host_out.copy_(out, non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
        return host_out.numpy()

    def wrapper_checks():
        _check_inputs(*cols)
        return any(t.dtype != torch.int32 or t.dim() != 1
                   or not t.is_contiguous() or t.device != xa.values.device
                   for t in (rec_d, q_d))

    def ctx():
        with torch.cuda.device(dev):
            pass

    door = {
        "index_checks": checks,
        "align_and_place": lambda: _align_buf_widths(qd, xa)[0].to(dev),
        "upload_rec_pageable": lambda: torch.from_numpy(rec).to(dev),
        "upload_q_pageable": lambda: torch.from_numpy(q).to(dev),
        "fetch_pageable": lambda: out.cpu().numpy(),
        "pinned_blob_fill": blob_fill,
        "pinned_blob_upload": lambda: blob.to(dev, non_blocking=True),
        "fetch_pinned_and_sync": fetch_pinned,
        "stage_pairs": lambda: gs_mod.stage_pairs(rec, q, dev),
        "fetch_scores": lambda: gs_mod.fetch_scores(out),
    }
    wrapper = {
        "checks": wrapper_checks,
        "empty_out": lambda: torch.empty(p, dtype=torch.float32, device=dev),
        "device_context": ctx,
        "current_stream": lambda: torch.cuda.current_stream().cuda_stream,
        "raw_stream": lambda: library.current_stream_ptr(dev.index),
        "ctypes_launch": lambda: launch(
            library.current_stream_ptr(dev.index)),
    }
    whole = {
        "gather_score": lambda: gs_mod.gather_score(*cols, rec_d, q_d),
        "score_pairs": lambda: gs_mod.score_pairs(x, qd, rec, q),
        "index_scorer": lambda: scorer(rec, q),
    }
    return {
        "pairs": p,
        "door_steps": {k: smoke.median_host_us(f, calls)
                       for k, f in door.items()},
        "wrapper_steps": {k: smoke.median_host_us(f, calls)
                          for k, f in wrapper.items()},
        "whole": {k: smoke.median_host_us(f, calls)
                  for k, f in whole.items()},
        "device": {"ms": smoke.cuda_ms(
                       lambda: gs_mod.gather_score(*cols, rec_d, q_d), 50),
                   "kernel_graph_ms": smoke.graph_ms(launch)},
    }


def host_topk(index, queries) -> dict:
    """The host route's top-10 of each query, as chip_smoke drives it."""
    post = index._postings()
    m = index.num_records
    rows = []
    for query in queries:
        qp, h, b, s = index._plan_queries([query])
        before = gs_mod.gather_score.launches
        t0 = time.perf_counter()
        pruned_topk(post, h[0], b[0], int(s[0]), smoke.TOPK,
                    index._pair_score_fn(qp), m)
        ms = (time.perf_counter() - t0) * 1e3
        launches = gs_mod.gather_score.launches - before
        t0 = time.perf_counter()
        n = len(candidates_for(post, h[0], b[0], 0.0, int(s[0])).rec_ids)
        rows.append({"ms": ms, "b5_launches": launches, "n": n,
                     "candidates_ms": (time.perf_counter() - t0) * 1e3})
    col = {k: [r[k] for r in rows] for k in rows[0]}
    return {"queries": len(rows), "rows": rows,
            **{f"{k}_p50": float(np.median(v)) for k, v in col.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=1000)
    ap.add_argument("--tag", default="run",
                    help="suffix of the output file's name")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pair_score_steps: needs an NVIDIA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    library.library()                 # build the kernels before any timing
    index, queries, rec, q = setup()
    host_topk(index, queries[:1])     # warm-up: first launch, allocators
    qp_batch = index._plan_queries(queries)[0]
    qp0 = index._plan_queries([queries[0]])[0]
    ranked = ranked_list(index, queries[0])
    zeros = np.zeros(len(ranked), np.int32)
    out = {"card": smi, "torch": torch.__version__, "calls": args.calls,
           "host_topk": host_topk(index, queries),
           "batch": steps_at(index, qp_batch, rec, q, args.calls),
           "chunk": steps_at(index, qp0, ranked[:CHUNK], zeros[:CHUNK],
                             args.calls),
           "topk_list": steps_at(index, qp0, ranked, zeros,
                                 max(args.calls // 10, 20))}
    line = json.dumps(out)
    print(line, flush=True)
    dest = ROOT / "chiprun_out" / f"pair_score_steps_{args.tag}.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
