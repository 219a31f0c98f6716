#!/usr/bin/env python3
"""Host time of each step of the pruned pipeline's front end on the card:
the B3 probe's wrapper and the B4 decode's wrapper, and the torch-op
prefix sequence they replace.

    python3 tools/probe_wrapper_steps.py [--calls 1000] [--tag run]

Builds ``chip_smoke.py``'s NETFLIX deployment (480,189 records, budget 10 %
of the element ids), takes its batch 0 (16 queries) and the index's tail
postings on the card, and times, each alone and as whole calls:

  front_end     ``probe_tasks`` (pos, hit and the block-task prefix in one
                launch) and ``block_decode(cum=)``: the argument checks,
                each ``torch.empty``, the stream handle, the ctypes call
                and the error check; then the two together
  old_sequence  the sequence the pipeline ran before the fused probe, as
                this tree still runs it: ``postings_probe``, the prefix by
                torch ops (``ref.task_prefix_ref``, and each of its ops),
                ``block_decode(cum=None)``; and the steps the older
                wrappers took besides (``torch.zeros`` fills of the outputs
                and of the [m, 16] counts, ``with torch.cuda.device``,
                ``torch.cuda.current_stream().cuda_stream``)
  primitives    steps a leaner wrapper could take instead, and
                ``torch.searchsorted``

Each step is timed by ``chip_smoke.median_host_us``: the median host µs of
one call over ``--calls`` calls after a warm-up, no synchronisation inside
the timed span. Prints one JSON object and writes it to
``chiprun_out/probe_wrapper_steps_<tag>.json``. Needs an NVIDIA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402  (puts src/ on the path)
from repro_torch import api  # noqa: E402
from repro_torch.core import gbkmv  # noqa: E402
from repro_torch.core.sketches import RaggedBatch  # noqa: E402
from repro_torch.data.synth import make_query_workload  # noqa: E402
from repro_torch.kernels import library, postings_merge as pm, ref  # noqa: E402


def batch0():
    """(device postings, batch 0's flat query hashes, m, gq, cq)."""
    recs, _ = smoke.make_records()
    batch = RaggedBatch.from_records(recs)
    index = api.build("gbkmv", batch, int(batch.total * smoke.BUDGET_FRACTION))
    queries = make_query_workload(recs, smoke.NUM_BATCHES * smoke.GQ,
                                  seed=2)[:smoke.GQ]
    dev = torch.device("cuda")
    qp = gbkmv.sketch_query_batch(index.core, queries).to(dev)
    dpost = index.core.sketches.device_postings(dev)
    gq, cq = qp.values.shape
    return dpost, qp.values.reshape(-1).contiguous(), index.num_records, gq, cq


def timed(steps: dict, calls: int) -> dict:
    return {k: smoke.median_host_us(f, calls) for k, f in steps.items()}


def front_end_steps(dpost, q, m, gq, cq, calls) -> dict:
    """Each step of ``probe_tasks`` and ``block_decode(cum=)``."""
    keys, rb = dpost.keys, dpost.row_blocks
    dev = keys.device
    n, u = q.numel(), keys.numel()
    lib = library.library()
    stream = library.current_stream_ptr(dev.index)
    pos, hit, cum = pm.probe_tasks(keys, q, rb)
    po, ho, co = torch.empty_like(pos), torch.empty_like(hit), \
        torch.empty_like(cum)
    args = (keys.data_ptr(), u, q.data_ptr(), n, rb.data_ptr(),
            po.data_ptr(), ho.data_ptr(), co.data_ptr(), pm._SHIFT_OUT,
            dev.index, stream)
    kc = torch.empty((m, gq), dtype=torch.int32, device=dev)
    bargs = (pos.data_ptr(), cum.data_ptr(), n, rb.data_ptr(),
             dpost.first.data_ptr(), dpost.meta.data_ptr(),
             dpost.off.data_ptr(), dpost.first.numel(),
             dpost.payload.data_ptr(), dpost.payload.numel(), gq, cq, m,
             kc.data_ptr(), 1, dev.index, stream)
    blocks = (rb, dpost.first, dpost.meta, dpost.off, dpost.payload)

    def require_b4():
        pm._require("pos", pos, torch.int32, dev)
        pm._require("hit", hit, torch.bool, dev)
        for t in blocks:
            pm._require("block", t, torch.int32, dev)
        pm._require("cum", cum, torch.int32, dev)

    probe = {
        "require_3": lambda: (pm._require("keys", keys, torch.int32, dev),
                              pm._require("q_flat", q, torch.int32, dev),
                              pm._require("row_blocks", rb, torch.int32,
                                          dev)),
        "empty_pos": lambda: torch.empty(n, dtype=torch.int32, device=dev),
        "empty_hit": lambda: torch.empty(n, dtype=torch.bool, device=dev),
        "empty_cum": lambda: torch.empty(n, dtype=torch.int32, device=dev),
        "stream_ptr": lambda: library.current_stream_ptr(dev.index),
        "library_lookup": library.library,
        "data_ptrs": lambda: (keys.data_ptr(), q.data_ptr(), rb.data_ptr(),
                              pos.data_ptr(), hit.data_ptr(),
                              cum.data_ptr()),
        "ctypes_launch": lambda: lib.postings_probe_launch(*args),
        "check": lambda: library.check(0, "postings_probe_launch"),
        "whole_call": lambda: pm.probe_tasks(keys, q, rb),
        "whole_call_pos_hit_only": lambda: pm.postings_probe(keys, q),
    }
    decode = {
        "require_8": require_b4,
        "empty_kcount": lambda: torch.empty((m, gq), dtype=torch.int32,
                                            device=dev),
        "stream_ptr": lambda: library.current_stream_ptr(dev.index),
        "ctypes_launch_with_memset": lambda: lib.block_decode_launch(*bargs),
        "whole_call": lambda: pm.block_decode(
            pos, hit, *blocks, gq=gq, cq=cq, m=m, cum=cum),
    }

    def front():
        p, h, c = pm.probe_tasks(keys, q, rb)
        return pm.block_decode(p, h, *blocks, gq=gq, cq=cq, m=m, cum=c)

    return {"probe_tasks": timed(probe, calls),
            "block_decode": timed(decode, calls),
            "whole": smoke.median_host_us(front, calls)}


def old_sequence_steps(dpost, q, m, gq, cq, calls) -> dict:
    """The probe, the torch-op prefix and the decode without the probe's
    prefix, and the steps the wrappers took before the fused probe."""
    keys, rb = dpost.keys, dpost.row_blocks
    dev = keys.device
    n = q.numel()
    pos, hit = pm.postings_probe(keys, q)
    blocks = (rb, dpost.first, dpost.meta, dpost.off, dpost.payload)
    pos_c = pos.long().clamp(0, keys.numel() - 1)
    nblk = torch.where(hit, rb[pos_c + 1] - rb[pos_c], 0)

    def ctx():
        with torch.cuda.device(dev):
            pass

    def require_7():
        pm._require("pos", pos, torch.int32, dev)
        pm._require("hit", hit, torch.bool, dev)
        for t in blocks:
            pm._require("block", t, torch.int32, dev)

    prefix = {
        "long": lambda: pos.long(),
        "clamp": lambda: pos.long().clamp(0, keys.numel() - 1),
        "gather_end": lambda: rb[pos_c + 1],
        "gather_start": lambda: rb[pos_c],
        "where_sub": lambda: torch.where(hit, rb[pos_c + 1] - rb[pos_c], 0),
        "cumsum": lambda: torch.cumsum(nblk, 0, dtype=torch.int32),
        "whole_call": lambda: ref.task_prefix_ref(pos, hit, rb),
    }
    wrapper_steps = {
        "require_2": lambda: (pm._require("keys", keys, torch.int32, dev),
                              pm._require("q_flat", q, torch.int32, dev)),
        "require_7": require_7,
        "zeros_pos": lambda: torch.zeros(n, dtype=torch.int32, device=dev),
        "zeros_hit": lambda: torch.zeros(n, dtype=torch.bool, device=dev),
        "zeros_kcount": lambda: torch.zeros((m, gq), dtype=torch.int32,
                                            device=dev),
        "device_context": ctx,
        "current_stream": lambda: torch.cuda.current_stream().cuda_stream,
    }

    def sequence():
        p, h = pm.postings_probe(keys, q)
        return pm.block_decode(p, h, *blocks, gq=gq, cq=cq, m=m)

    return {"postings_probe": smoke.median_host_us(
                lambda: pm.postings_probe(keys, q), calls),
            "task_prefix": timed(prefix, calls),
            "block_decode_cum_none": smoke.median_host_us(
                lambda: pm.block_decode(pos, hit, *blocks, gq=gq, cq=cq,
                                        m=m), calls),
            "wrapper_steps": timed(wrapper_steps, calls),
            "whole": smoke.median_host_us(sequence, calls)}


def primitives(dpost, q, calls) -> dict:
    """Steps a leaner wrapper could take instead."""
    keys = dpost.keys
    dev = keys.device
    n = q.numel()
    sign = -(1 << 31)
    ks, qs = keys ^ sign, q ^ sign

    def one_buffer():
        buf = torch.empty(2 * n + (n + 3) // 4, dtype=torch.int32, device=dev)
        return buf[:n], buf[n:2 * n], buf[2 * n:].view(torch.bool)[:n]

    return timed({
        "empty_n_i32": lambda: torch.empty(n, dtype=torch.int32, device=dev),
        "empty_n_bool": lambda: torch.empty(n, dtype=torch.bool, device=dev),
        "one_buffer_three_views": one_buffer,
        "tensor_device": lambda: keys.device,
        "is_contiguous": lambda: keys.is_contiguous(),
        "current_device": torch.cuda.current_device,
        "raw_stream": lambda: library.current_stream_ptr(dev.index),
        "torch_searchsorted": lambda: torch.searchsorted(ks, qs),
    }, calls)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=1000)
    ap.add_argument("--tag", default="run",
                    help="suffix of the output file's name")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_wrapper_steps: needs an NVIDIA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    dpost, q, m, gq, cq = batch0()
    out = {"card": smi, "torch": torch.__version__,
           "shape": {"n": q.numel(), "u": dpost.keys.numel(), "m": m,
                     "gq": gq, "cq": cq},
           "calls": args.calls,
           "primitives": primitives(dpost, q, args.calls),
           "front_end": front_end_steps(dpost, q, m, gq, cq, args.calls),
           "old_sequence": old_sequence_steps(dpost, q, m, gq, cq,
                                              args.calls)}
    line = json.dumps(out)
    print(line, flush=True)
    dest = ROOT / "chiprun_out" / f"probe_wrapper_steps_{args.tag}.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
