#!/usr/bin/env python3
"""Host time of each step of the B2 wrapper (``hash_threshold``, the build's
fingerprint hash and τ filter) on the card, for the checkout at DIR.

    python3 tools/b2_wrapper_steps.py DIR [DIR ...] [--calls 1000] [--tag X]

Each DIR is a checkout of this repository (this tree, or a ``git archive``
of another commit unpacked under ``build/``); each is timed in a process of
its own, with its own ``src/repro_torch`` and its own ``chip_smoke.py``
timers, in the order given, so that two trees can be timed in turns
(``A B B A``). Input: 4,244,346 ids (the NETFLIX build's tail-id stream's
length), drawn on the card from seed 0. Steps, each timed alone:

  checks              the wrapper's argument checks (dtype, rank,
                      contiguity, τ's range, the device's type)
  empty_like, empty   ``torch.empty_like(ids)`` and ``torch.empty(n, ...)``
  device_context      ``with torch.cuda.device(ids.device): pass``
  current_stream      ``torch.cuda.current_stream().cuda_stream``
  current_stream_ptr  ``library.current_stream_ptr(index)``
  library_lookup      ``library.library()``
  seed_offset         the seed's additive constant
  ctypes_call         the C entry alone, with the tree's own signature
  whole_call          ``hash_threshold(ids, 0)`` (hashes only, as the
                      device build calls it)
  whole_call_keep     ``hash_threshold(ids, 0, tau)``

Each step is timed by ``chip_smoke.median_host_us``: the median host µs of
one call over ``--calls`` calls after a warm-up, no synchronisation inside
the timed span; the whole calls three times. Prints one JSON line per tree
and writes the list to ``chiprun_out/b2_wrapper_steps_<tag>.json``. Needs
an NVIDIA card.
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
calls = int(sys.argv[2])
sys.path[:0] = [str(tree / "src"), str(tree)]
import torch
from chip_smoke import median_host_us
from repro_torch.core.hashing import PAD, seed_offset
from repro_torch.kernels import library
from repro_torch.kernels.hash_threshold import hash_threshold
lib = library.library()
n, tau = 4_244_346, 2**31
g = torch.Generator(device="cuda").manual_seed(0)
ids = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device="cuda",
                    generator=g)
dev = ids.device
h, keep = torch.empty_like(ids), torch.empty_like(ids)
stream = library.current_stream_ptr(dev.index)
args = [ids.data_ptr(), h.data_ptr(), None, n, seed_offset(0), 0]
with_device = len(library._SIGNATURES["hash_threshold_launch"][0]) == 8
args += [dev.index, stream] if with_device else [stream]


def checks():
    bad = ids.dtype != torch.int32 or ids.dim() != 1 \
        or not ids.is_contiguous()
    return bad, 0 <= int(tau) <= int(PAD), ids.device.type == "cpu", \
        ids.device.type != "cuda"


def device_context():
    with torch.cuda.device(dev):
        pass


steps = {
    "checks": checks,
    "empty_like": lambda: torch.empty_like(ids),
    "empty": lambda: torch.empty(n, dtype=torch.int32, device=dev),
    "device_context": device_context,
    "current_stream": lambda: torch.cuda.current_stream().cuda_stream,
    "current_stream_ptr": lambda: library.current_stream_ptr(dev.index),
    "library_lookup": library.library,
    "seed_offset": lambda: seed_offset(0),
    "ctypes_call": lambda: lib.hash_threshold_launch(*args),
}
out = {k: median_host_us(f, calls) for k, f in steps.items()}
for _ in range(3):
    for k, f in (("whole_call", lambda: hash_threshold(ids, 0)),
                 ("whole_call_keep", lambda: hash_threshold(ids, 0, tau))):
        out.setdefault(k, []).append(median_host_us(f, calls))
print(json.dumps({"tree": sys.argv[1], "torch": torch.__version__,
                  "entry_takes_device": with_device, "host_us": out}))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--calls", type=int, default=1000)
    ap.add_argument("--tag", default="run")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("b2_wrapper_steps: needs an NVIDIA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    results = []
    for tree in args.trees:
        out = subprocess.run(
            [sys.executable, "-c", _MEASURE, tree, str(args.calls)],
            capture_output=True, text=True, check=True, timeout=600, cwd=tree)
        line = {"card": smi, **json.loads(out.stdout.strip().splitlines()[-1])}
        print(json.dumps(line), flush=True)
        results.append(line)
    path = ROOT / "chiprun_out" / f"b2_wrapper_steps_{args.tag}.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(results, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
