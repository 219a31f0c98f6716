#!/usr/bin/env python3
"""Bare launch time of B5 kernel sources side by side, in turns, on the
card.

    python3 tools/gather_score_variants.py NAME=DIR [NAME=DIR ...] [--tag X]

Each DIR holds a ``gather_score.cu`` and the headers it includes (the
``src/repro_torch/kernels/csrc`` of any tree, for example a ``git
archive`` of another commit unpacked under ``build/``, edited there if a
variant is wanted). Each is built alone with the kernel library's nvcc
flags into ``build/gather_score_variants/NAME/`` (all builds started
together) and called through its own ``gather_score_launch``, whose
arguments are passed by the names its source declares, so sources whose C
entry takes more or fewer arguments (a card index, a body report) run side
by side. ``library`` is this tree's own kernel and is always timed.

At ``pair_score_steps.py``'s two NETFLIX pair lists (batch 0's 72,018
candidates at t = 0.7 and query 0's whole bound-ordered top-k list) every
variant's scores are held bit-equal to this tree's wrapper, then each is
timed as one launch of a CUDA graph of 20 (``chip_smoke.graph_ms``) in 7
rounds, the order reversed every other round. Prints one JSON object
(per list: each variant's times, median, min and max, and its ptxas
register line) and writes it to ``chiprun_out/gather_score_variants_X.json``.
Needs an NVIDIA card.
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

ROUNDS = 7
_ENTRY = re.compile(r'extern "C" int gather_score_launch\(([^)]*)\)')
_POINTERS = {"xv", "xt", "xb", "qv", "qt", "qb", "qs", "cand_rec", "cand_q",
             "out", "body_out", "stream"}


def entry_names(source: str) -> list[str]:
    """The parameter names of a source's ``gather_score_launch``."""
    m = _ENTRY.search(source)
    if m is None:
        raise ValueError("no gather_score_launch in the source")
    return [p.split()[-1].lstrip("*") for p in m.group(1).split(",")]


def build(variants: dict[str, Path]) -> dict:
    """name -> (ctypes entry, parameter names, ptxas register lines)."""
    procs = {}
    for name, src_dir in variants.items():
        out = ROOT / "build" / "gather_score_variants" / name
        out.mkdir(parents=True, exist_ok=True)
        procs[name] = (out, subprocess.Popen(
            [library._nvcc(), *library.NVCC_FLAGS, "-shared",
             "-I", str(src_dir), "-o", str(out / "lib.so"),
             str(src_dir / "gather_score.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name} does not build:\n{log}")
        names = entry_names((variants[name] / "gather_score.cu").read_text())
        fn = ctypes.CDLL(str(out / "lib.so")).gather_score_launch
        fn.argtypes = [ctypes.c_void_p if n in _POINTERS else
                       ctypes.c_int64 if n in ("m", "p") else ctypes.c_int
                       for n in names]
        fn.restype = ctypes.c_int
        built[name] = (fn, names, [ln.strip() for ln in log.splitlines()
                                   if "registers" in ln])
    return built


def launcher(fn, names, cols, rec, q, out):
    """``launch(stream)``: the variant's C entry with its arguments by
    name (a body report, where declared, goes nowhere)."""
    xv, xt, xb, qv, qt, qb, qs = cols
    args = {"xv": xv.data_ptr(), "xt": xt.data_ptr(), "xb": xb.data_ptr(),
            "m": xv.shape[0], "c": xv.shape[1], "w": xb.shape[1],
            "qv": qv.data_ptr(), "qt": qt.data_ptr(), "qb": qb.data_ptr(),
            "qs": qs.data_ptr(), "gq": qv.shape[0], "cq": qv.shape[1],
            "cand_rec": rec.data_ptr(), "cand_q": q.data_ptr(),
            "p": rec.numel(), "out": out.data_ptr(), "body_out": None,
            "device": xv.device.index}
    return lambda st: fn(*[st if n == "stream" else args[n] for n in names])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*", metavar="NAME=DIR")
    ap.add_argument("--tag", default="run",
                    help="suffix of the output file's name")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gather_score_variants: needs an NVIDIA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    variants = {"library": library.CSRC}
    for spec in args.variants:
        name, _, path = spec.partition("=")
        variants[name] = Path(path).resolve()
    built = build(variants)
    index, queries, rec, q = steps.setup()
    dev = torch.device("cuda", torch.cuda.current_device())
    x = index.core.sketches.device_pack(dev)
    ranked = steps.ranked_list(index, queries[0])
    lists = {"batch": (index._plan_queries(queries)[0], rec, q),
             "topk_list": (index._plan_queries([queries[0]])[0], ranked,
                           np.zeros(len(ranked), np.int32))}
    result = {"card": smi, "ptxas": {k: v[2] for k, v in built.items()}}
    for lname, (qpack, r, qq) in lists.items():
        qa, xa = _align_buf_widths(qpack, x)
        qa = qa.to(dev)
        cols = (xa.values, xa.thresh, xa.buf, qa.values, qa.thresh, qa.buf,
                qa.sizes)
        rd = torch.from_numpy(r).to(dev)
        qd = torch.from_numpy(qq).to(dev)
        want = gs_mod.gather_score(*cols, rd, qd)
        launch = {}
        for name, (fn, names, _) in built.items():
            got = torch.empty_like(want)
            launch[name] = launcher(fn, names, cols, rd, qd, got)
            library.check(launch[name](library.current_stream_ptr(dev.index)),
                          f"{name} launch")
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"{name} differs from the library at "
                                   f"{lname}")
        times = {k: [] for k in built}
        order = list(built)
        for rnd in range(ROUNDS):
            for name in order if rnd % 2 == 0 else order[::-1]:
                times[name].append(graph_ms(launch[name]))
        result[lname] = {
            "pairs": rd.numel(), "graph_ms": times,
            "median": {k: float(np.median(v)) for k, v in times.items()},
            "min": {k: min(v) for k, v in times.items()},
            "max": {k: max(v) for k, v in times.items()}}
    line = json.dumps(result)
    print(line, flush=True)
    dest = ROOT / "chiprun_out" / f"gather_score_variants_{args.tag}.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
