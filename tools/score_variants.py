#!/usr/bin/env python3
"""Bare launch time of B1 or B5 kernel sources side by side, in turns, on
the card.

    python3 tools/score_variants.py --kernel gbkmv_score|gather_score \
        NAME=DIR [NAME=DIR ...] [--tag X]

Each DIR holds the kernel's source (``gbkmv_score.cu`` for the dense
scorer B1, ``gather_score.cu`` for the candidate verify B5) and the
headers it includes: the ``src/repro_torch/kernels/csrc`` of any tree, for
example a ``git archive`` of another commit unpacked under ``build/``,
edited there if a variant is wanted. Each is built alone with the kernel
library's nvcc flags into ``build/score_variants/KERNEL/NAME/`` (all
builds started together) and called through its own C entry
(``gbkmv_score_launch`` or ``gather_score_launch``), whose arguments are
passed by the names its source declares (an edited copy may drop the
card index, for one).
``library`` is this tree's own kernel and is always timed.

Inputs: ``pair_score_steps.py``'s NETFLIX deployment (480,189 records,
budget 10 % of the element ids) and batch 0's 16-query pack. B1 scores
that pack against every record; B5 scores two pair lists (batch 0's
72,018 candidates at t = 0.7 and query 0's whole bound-ordered top-k
list). Every variant's output is compared bit for bit with this tree's
wrapper (``equal``: a variant that differs, such as a yardstick that only
stores, is still timed and is flagged there), then each is timed as one
launch of a CUDA graph of 20 (``chip_smoke.graph_ms``) in 7 rounds, the
order reversed every other round. Also per variant: its ptxas register
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
from chip_smoke import graph_ms  # noqa: E402
from repro_torch.core.estimators import _align_buf_widths  # noqa: E402
from repro_torch.kernels import gather_score as gs_mod, library  # noqa: E402
from repro_torch.kernels import gbkmv_score as score_mod  # noqa: E402

ROUNDS = 7
KERNELS = ("gbkmv_score", "gather_score")
_POINTERS = {"xv", "xt", "xb", "qv", "qt", "qb", "qs", "cand_rec", "cand_q",
             "out", "stream"}
_INT64 = {"m", "p"}
_SASS_INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s+\S")


def entry_names(source: str, kernel: str) -> list[str]:
    """The parameter names of a source's ``<kernel>_launch``."""
    m = re.search(rf'extern "C" int {kernel}_launch\(([^)]*)\)', source)
    if m is None:
        raise ValueError(f"no {kernel}_launch in the source")
    return [p.split()[-1].lstrip("*") for p in m.group(1).split(",")]


def sass_counts(lib: Path) -> dict:
    """SASS instructions of each kernel in a built library."""
    cuobjdump = Path(library._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[-1].strip()
            counts[name] = 0
        elif name is not None and _SASS_INSTRUCTION.search(line):
            counts[name] += 1
    return counts


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
        names = entry_names((variants[name] / f"{kernel}.cu").read_text(),
                            kernel)
        fn = getattr(ctypes.CDLL(str(out / "lib.so")), f"{kernel}_launch")
        fn.argtypes = [ctypes.c_void_p if n in _POINTERS else
                       ctypes.c_int64 if n in _INT64 else ctypes.c_int
                       for n in names]
        fn.restype = ctypes.c_int
        built[name] = (fn, names,
                       [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln],
                       sass_counts(out / "lib.so"))
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
    times = {k: [] for k in built}
    order = list(built)
    for rnd in range(ROUNDS):
        for name in order if rnd % 2 == 0 else order[::-1]:
            times[name].append(graph_ms(launch[name]))
    return {"equal": equal, "graph_ms": times,
            "median": {k: float(np.median(v)) for k, v in times.items()},
            "min": {k: min(v) for k, v in times.items()},
            "max": {k: max(v) for k, v in times.items()}}


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
    index, queries, rec, q = steps.setup()
    dev = torch.device("cuda", torch.cuda.current_device())
    x = index.core.sketches.device_pack(dev)
    result = {"card": smi, "kernel": args.kernel,
              "ptxas": {k: v[2] for k, v in built.items()},
              "sass_instructions": {k: v[3] for k, v in built.items()}}
    if args.kernel == "gbkmv_score":
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
    line = json.dumps(result)
    print(line, flush=True)
    dest = (ROOT / "chiprun_out"
            / f"score_variants_{args.kernel}_{args.tag}.json")
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
