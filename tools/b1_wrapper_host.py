#!/usr/bin/env python3
"""Host time of one call of the dense scorer's wrapper (B1, ``gbkmv_score``)
at the NETFLIX deployment's shapes, for the checkout at DIR.

    python3 tools/b1_wrapper_host.py DIR [DIR ...] [--tag X]

Each DIR is a checkout of this repository (this tree, or a ``git archive``
of another commit unpacked under ``build/``); each is timed in a process of
its own, with its own ``src/repro_torch`` and its own ``chip_smoke.py``
timers, in the order given, so that two trees can be timed in turns
(``A B B A``). Inputs, made on the card from seed 0: M = 480,189 record
rows of C = 56 sorted values below 2^30 with threshold 2^28 (about 14
values of a row live), W = 1 buffer word, and a 16-query pack with
Cq = 56 and threshold 2^28. Per tree: ``host_us``, three medians of the
wrapper's host time (``chip_smoke.median_host_us``, 1,000 calls each),
and ``ms``, the wrapper's CUDA-event time (``chip_smoke.cuda_ms``, 50
calls). Prints one JSON line per tree and writes the list to
``chiprun_out/b1_wrapper_host_<tag>.json``. Needs an NVIDIA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# Run in the tree's own interpreter process: its chip_smoke and its
# repro_torch first on the path.
_MEASURE = r"""
import json, sys
from pathlib import Path
tree = Path(sys.argv[1]).resolve()
sys.path[:0] = [str(tree / "src"), str(tree)]
import torch
from chip_smoke import cuda_ms, median_host_us
from repro_torch.kernels import library
from repro_torch.kernels.gbkmv_score import gbkmv_score
library.library()
g = torch.Generator(device="cuda").manual_seed(0)
m, c, gq, cq = 480_189, 56, 16, 56


def rows(n, k):
    v = torch.randint(0, 2**30, (n, k), device="cuda", generator=g)
    return v.sort(1).values.to(torch.int32)


def full(n, v):
    return torch.full((n,), v, dtype=torch.int32, device="cuda")


def buf(n):
    return torch.randint(0, 2**16, (n, 1), device="cuda", generator=g,
                         dtype=torch.int32)


cols = (rows(m, c), full(m, 2**28), buf(m), rows(gq, cq), full(gq, 2**28),
        buf(gq), full(gq, 12))
us = [median_host_us(lambda: gbkmv_score(*cols)) for _ in range(3)]
print(json.dumps({"tree": sys.argv[1], "host_us": us,
                  "ms": cuda_ms(lambda: gbkmv_score(*cols), 50)}))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--tag", default="run")
    args = ap.parse_args()
    results = []
    for tree in args.trees:
        out = subprocess.run([sys.executable, "-c", _MEASURE, tree],
                             capture_output=True, text=True, check=True,
                             timeout=600, cwd=tree)
        line = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        results.append(line)
    path = ROOT / "chiprun_out" / f"b1_wrapper_host_{args.tag}.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(results, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
