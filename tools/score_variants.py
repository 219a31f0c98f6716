#!/usr/bin/env python3
"""Bare launch time of B1, B2, B4 or B5 kernel sources side by side, in
turns, on the card.

    python3 tools/score_variants.py \
        --kernel gbkmv_score|gather_score|block_decode|hash_threshold \
        NAME=DIR [NAME=DIR ...] [--tag X]

Each DIR holds the kernel's source (``gbkmv_score.cu`` for the dense
scorer B1, ``gather_score.cu`` for the candidate verify B5,
``block_decode.cu`` for the block decode and K∩ scatter B4,
``hash_threshold.cu`` for the build's fingerprint hash and τ filter B2)
and the headers it includes: the ``src/repro_torch/kernels/csrc`` of any tree, for
example a ``git archive`` of another commit unpacked under ``build/``,
edited there if a variant is wanted. Each is built alone with the kernel
library's nvcc flags into ``build/score_variants/KERNEL/NAME/`` (all
builds started together) and called through its own C entry
(``<kernel>_launch``), whose arguments are passed by the names and types
its source declares (an edited copy may drop the card index, for one).
``library`` is this tree's own kernel and is always timed.

Inputs: ``pair_score_steps.py``'s NETFLIX deployment (480,189 records,
budget 10 % of the element ids) and batch 0's 16-query pack. B1 scores
that pack against every record; B5 scores two pair lists (batch 0's
72,018 candidates at t = 0.7 and query 0's whole bound-ordered top-k
list); B4 decodes batch 0's probe output (``probe_tasks``) and that of
``chip_smoke.dense_block_index``'s batch, whose tail has dense-bitmap
blocks, each both as the wrapper launches it (``NAME/bare``: the counts'
zeroing and the decode) and without the zeroing (``NAME/body``: the
decode adding onto the counts as they are). B2 hashes the build's tail-id
stream (``chip_smoke.host_part``: 4,244,346 ids), that stream sliced at
offsets of 1, 2 and 3 words (its pointer off 16-B alignment, the outputs
aligned), and the tail stream of ``chip_smoke.dense_block_records`` (r =
2, budget 20,000), in both forms (``hashes``: hashes only, as the device
build calls it; ``keep``: hashes and keep flags at the exact τ of the
stream's build), each as ``NAME/warm`` (the 20 launches on one set of
buffers, as ``chip_smoke.py`` times it) and ``NAME/cold`` (the launches
cycling through 4 copies of inputs and outputs, 4 × 8 or 12 B an id, so
that at NETFLIX's stream no launch finds its bytes in the 50 MB L2).
Every variant's output is compared bit for bit with this tree's wrapper
(B4's and B2's with the plain version, ``ref.kcount_ref`` and
``ref.hash_threshold_ref``, on the card) (``equal``: a variant that
differs, such as a yardstick that only stores, is still timed and is
flagged there), then each is timed as one launch of a CUDA graph of 20
(``chip_smoke.graph_ms``) in 7 rounds, the order reversed every other
round. Also per variant: its ptxas register
and spill lines and the SASS instruction count of each of its kernels
(``cuobjdump --dump-sass``). Prints one JSON object and writes it to
``chiprun_out/score_variants_<kernel>_<tag>.json``. Needs an NVIDIA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import pair_score_steps as steps  # noqa: E402  (puts the repo on the path)
from chip_smoke import (  # noqa: E402
    dense_block_index, dense_block_records, graph_ms, host_part,
    make_records, sass_instructions, u32_ids, BUDGET_FRACTION,
    DENSE_BLOCK_BUDGET, DENSE_BLOCK_R, HBM_BYTES_PER_S)
from repro_torch.core import gbkmv  # noqa: E402
from repro_torch.core.estimators import _align_buf_widths  # noqa: E402
from repro_torch.core.hashing import PAD, as_u64, seed_offset  # noqa: E402
from repro_torch.core.sketches import RaggedBatch  # noqa: E402
from repro_torch.kernels import gather_score as gs_mod, library  # noqa: E402
from repro_torch.kernels import gbkmv_score as score_mod  # noqa: E402
from repro_torch.kernels import postings_merge as pm, ref  # noqa: E402

ROUNDS = 7
KERNELS = ("gbkmv_score", "gather_score", "block_decode", "hash_threshold")
# B2: copies of each input and output that the cold timing cycles through.
COLD_SETS = 4


def entry_params(source: str, kernel: str) -> list[tuple[str, type]]:
    """(name, ctypes type) of each parameter of a source's
    ``<kernel>_launch``: pointers (and the stream) as void*, ``int64_t``
    as a 64-bit int, ``uint32_t`` as an unsigned 32-bit int, anything
    else as an int."""
    m = re.search(rf'extern "C" int {kernel}_launch\(([^)]*)\)', source)
    if m is None:
        raise ValueError(f"no {kernel}_launch in the source")
    params = []
    for p in m.group(1).split(","):
        decl = p.split()
        params.append((decl[-1].lstrip("*"),
                       ctypes.c_void_p if "*" in p else
                       ctypes.c_int64 if "int64_t" in decl else
                       ctypes.c_uint32 if "uint32_t" in decl else
                       ctypes.c_int))
    return params


def build(kernel: str, variants: dict[str, Path]) -> dict:
    """name -> (ctypes entry, parameter names, ptxas register and spill
    lines, SASS instruction counts)."""
    procs = {}
    for name, src_dir in variants.items():
        out = ROOT / "build" / "score_variants" / kernel / name
        out.mkdir(parents=True, exist_ok=True)
        procs[name] = (out, subprocess.Popen(
            [library._nvcc(), *library.NVCC_FLAGS, "-shared",
             "-I", str(src_dir), "-o", str(out / "lib.so"),
             str(src_dir / f"{kernel}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name} does not build:\n{log}")
        params = entry_params(
            (variants[name] / f"{kernel}.cu").read_text(), kernel)
        names = [n for n, _ in params]
        fn = getattr(ctypes.CDLL(str(out / "lib.so")), f"{kernel}_launch")
        fn.argtypes = [t for _, t in params]
        fn.restype = ctypes.c_int
        built[name] = (fn, names,
                       [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln],
                       sass_instructions(out / "lib.so"))
    return built


def launcher(fn, names, cols, out, rec=None, q=None):
    """``launch(stream)``: the variant's C entry with its arguments by
    name."""
    xv, xt, xb, qv, qt, qb, qs = cols
    args = {"xv": xv.data_ptr(), "xt": xt.data_ptr(), "xb": xb.data_ptr(),
            "m": xv.shape[0], "c": xv.shape[1], "w": xb.shape[1],
            "qv": qv.data_ptr(), "qt": qt.data_ptr(), "qb": qb.data_ptr(),
            "qs": qs.data_ptr(), "gq": qv.shape[0], "cq": qv.shape[1],
            "out": out.data_ptr(), "device": xv.device.index}
    if rec is not None:
        args.update(cand_rec=rec.data_ptr(), cand_q=q.data_ptr(),
                    p=rec.numel())
    return lambda st: fn(*[st if n == "stream" else args[n] for n in names])


def time_in_turns(built: dict, cols, want, rec=None, q=None) -> dict:
    """Each variant's output against ``want``, then its bare launch times
    over ROUNDS rounds in turns."""
    dev = want.device
    # Each variant writes its own output, kept alive while its launches
    # are timed (a CUDA graph's capture empties the allocator's cache).
    outs = {k: torch.full_like(want, float("nan")) for k in built}
    launch, equal = {}, {}
    for name, (fn, names, _, _) in built.items():
        launch[name] = launcher(fn, names, cols, outs[name], rec, q)
        library.check(launch[name](library.current_stream_ptr(dev.index)),
                      f"{name} launch")
        torch.cuda.synchronize()
        equal[name] = bool(torch.equal(outs[name], want))
    return in_turns(launch, equal)


def in_turns(launch: dict, equal: dict) -> dict:
    """Each launch's bare time over ROUNDS rounds in turns."""
    times = {k: [] for k in launch}
    order = list(launch)
    for rnd in range(ROUNDS):
        for name in order if rnd % 2 == 0 else order[::-1]:
            times[name].append(graph_ms(launch[name]))
    return {"equal": equal, "graph_ms": times,
            "median": {k: float(np.median(v)) for k, v in times.items()},
            "min": {k: min(v) for k, v in times.items()},
            "max": {k: max(v) for k, v in times.items()}}


def decode_turns(built: dict, dpost, pos, hit, cum, gq: int, cq: int
                 ) -> dict:
    """B4: every variant bare and body, its counts against the plain
    version's on the card, in turns."""
    dev = pos.device
    m = dpost.num_records
    want = ref.kcount_ref(pos, hit, dpost.row_blocks, dpost.first,
                          dpost.meta, dpost.off, dpost.payload, gq=gq, cq=cq,
                          m=m, cum=cum)
    args = {"pos": pos.data_ptr(), "cum": cum.data_ptr(), "n": pos.numel(),
            "row_blocks": dpost.row_blocks.data_ptr(),
            "first": dpost.first.data_ptr(), "meta": dpost.meta.data_ptr(),
            "off": dpost.off.data_ptr(), "nb": dpost.first.numel(),
            "payload": dpost.payload.data_ptr(),
            "p_words": dpost.payload.numel(), "gq": gq, "cq": cq, "m": m,
            "device": dev.index}
    # Each variant writes its own counts, kept alive while its launches
    # are timed (a CUDA graph's capture empties the allocator's cache).
    outs = {k: torch.full((m, gq), 7, dtype=torch.int32, device=dev)
            for k in built}
    launch, equal = {}, {}
    for name, (fn, names, _, _) in built.items():
        for zero in (1, 0):
            a = {**args, "kcount": outs[name].data_ptr(), "zero_counts": zero}
            launch[f"{name}/{'bare' if zero else 'body'}"] = (
                lambda st, fn=fn, names=names, a=a:
                fn(*[st if n == "stream" else a[n] for n in names]))
        library.check(launch[f"{name}/bare"](
            library.current_stream_ptr(dev.index)), f"{name} launch")
        torch.cuda.synchronize()
        equal[name] = bool(torch.equal(outs[name], want))
    res = in_turns(launch, equal)
    res.update(n=pos.numel(), m=m, gq=gq, cq=cq, tasks=int(cum[-1]))
    return res


def hash_streams(dev) -> dict:
    """B2's inputs: name -> (u32 ids on the card, the exact τ of the
    stream's build). The offset streams are slices of the NETFLIX one and
    keep its τ."""
    recs, _ = make_records()
    out = {}
    for name, batch, budget, r in (
            ("netflix", RaggedBatch.from_records(recs), None, "auto"),
            ("dense_store", RaggedBatch.from_records(dense_block_records()),
             DENSE_BLOCK_BUDGET, DENSE_BLOCK_R)):
        if budget is None:
            budget = int(batch.total * BUDGET_FRACTION)
        hp = host_part(batch, budget, r)
        ids = u32_ids(batch.ids[~hp.is_top]).to(dev)
        h = as_u64(ref.hash_threshold_ref(ids, 0, None)[0])
        tau = (int(torch.sort(h).values[hp.tail_budget - 1])
               if hp.tail_budget < h.numel() else int(PAD) - 1)
        out[name] = (ids, tau)
    ids, tau = out["netflix"]
    for k in (1, 2, 3):
        out[f"netflix_off{k}"] = (ids[k:], tau)
    return out


def hash_turns(built: dict, ids, tau: int) -> dict:
    """B2: every variant in both forms, warm and cold, its outputs against
    the plain version's on the card, in turns."""
    dev = ids.device
    n = ids.numel()
    h_want, keep_want = ref.hash_threshold_ref(ids, 0, tau)
    lead = ids.storage_offset()
    # The cold sets: copies of the whole stream, sliced as ``ids`` is, so
    # that each keeps its alignment.
    base = ids.as_strided((lead + n,), (1,), 0)
    ins = [ids] + [base.clone()[lead:] for _ in range(COLD_SETS - 1)]
    launch, equal = {}, {}
    for name, (fn, names, _, _) in built.items():
        outs = [(torch.empty(n, dtype=torch.int32, device=dev),
                 torch.empty(n, dtype=torch.int32, device=dev))
                for _ in range(COLD_SETS)]

        def call(st, i, form, fn=fn, names=names, outs=outs):
            h, k = outs[i]
            a = {"ids": ins[i].data_ptr(), "h_out": h.data_ptr(),
                 "keep_out": k.data_ptr() if form == "keep" else None,
                 "n": n, "offset": seed_offset(0), "tau": tau,
                 "device": dev.index}
            return fn(*[st if p == "stream" else a[p] for p in names])

        ok = True
        for form in ("hashes", "keep"):
            outs[0][0].fill_(-1)
            outs[0][1].fill_(-1)
            library.check(call(library.current_stream_ptr(dev.index), 0,
                               form), f"{name} launch")
            torch.cuda.synchronize()
            ok = ok and torch.equal(as_u64(outs[0][0]), h_want)
            if form == "keep":
                ok = ok and torch.equal(outs[0][1].bool(), keep_want)
            launch[f"{name}/{form}/warm"] = (
                lambda st, call=call, form=form: call(st, 0, form))
            turn = iter(range(1 << 30))
            launch[f"{name}/{form}/cold"] = (
                lambda st, call=call, form=form, turn=turn:
                call(st, next(turn) % COLD_SETS, form))
        equal[name] = ok
    res = in_turns(launch, equal)
    res.update(n=n, tau=tau, misaligned_words=(ids.data_ptr() % 16) // 4,
               bound_ms={f: b * n / HBM_BYTES_PER_S * 1e3
                         for f, b in (("hashes", 8), ("keep", 12))})
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=KERNELS, required=True)
    ap.add_argument("variants", nargs="*", metavar="NAME=DIR")
    ap.add_argument("--tag", default="run",
                    help="suffix of the output file's name")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("score_variants: needs an NVIDIA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    variants = {"library": library.CSRC}
    for spec in args.variants:
        name, _, path = spec.partition("=")
        variants[name] = Path(path).resolve()
    built = build(args.kernel, variants)
    dev = torch.device("cuda", torch.cuda.current_device())
    result = {"card": smi, "kernel": args.kernel,
              "ptxas": {k: v[2] for k, v in built.items()},
              "sass_instructions": {k: v[3] for k, v in built.items()}}
    if args.kernel == "hash_threshold":
        for sname, (ids, tau) in hash_streams(dev).items():
            result[sname] = hash_turns(built, ids, tau)
        return finish(result, args)
    index, queries, rec, q = steps.setup()
    x = index.core.sketches.device_pack(dev)
    if args.kernel == "block_decode":
        dense_index, dense_queries = dense_block_index()
        for lname, (idx, qs) in {"batch0": (index, queries),
                                 "dense_store": (dense_index,
                                                 dense_queries)}.items():
            dpost = idx.core.sketches.device_postings(dev)
            qp = gbkmv.sketch_query_batch(idx.core, qs).to(dev)
            gq, cq = qp.values.shape
            pos, hit, cum = pm.probe_tasks(dpost.keys, qp.values.reshape(-1),
                                           dpost.row_blocks)
            result[lname] = decode_turns(built, dpost, pos, hit, cum, gq, cq)
    elif args.kernel == "gbkmv_score":
        qa, xa = _align_buf_widths(index._plan_queries(queries)[0], x)
        qa = qa.to(dev)
        cols = (xa.values, xa.thresh, xa.buf, qa.values, qa.thresh, qa.buf,
                qa.sizes)
        result["shape"] = [*xa.values.shape, *qa.values.shape,
                           xa.buf.shape[1]]
        result["batch"] = time_in_turns(built, cols,
                                        score_mod.gbkmv_score(*cols))
    else:
        ranked = steps.ranked_list(index, queries[0])
        lists = {"batch": (index._plan_queries(queries)[0], rec, q),
                 "topk_list": (index._plan_queries([queries[0]])[0], ranked,
                               np.zeros(len(ranked), np.int32))}
        for lname, (qpack, r, qq) in lists.items():
            qa, xa = _align_buf_widths(qpack, x)
            qa = qa.to(dev)
            cols = (xa.values, xa.thresh, xa.buf, qa.values, qa.thresh,
                    qa.buf, qa.sizes)
            rd = torch.from_numpy(r).to(dev)
            qd = torch.from_numpy(qq).to(dev)
            result[lname] = {"pairs": rd.numel(), **time_in_turns(
                built, cols, gs_mod.gather_score(*cols, rd, qd), rd, qd)}
    return finish(result, args)


def finish(result: dict, args) -> int:
    """Print the result and write it to chiprun_out/."""
    line = json.dumps(result)
    print(line, flush=True)
    dest = (ROOT / "chiprun_out"
            / f"score_variants_{args.kernel}_{args.tag}.json")
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
