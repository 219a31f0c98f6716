"""Build and load the port's CUDA kernels: nvcc into one shared library
with a plain C interface, loaded with ctypes.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, then linked into ``librepro_torch_kernels.so`` under
``build/repro_torch_kernels/<key>/`` at the repository root, where
``<key>`` hashes the sources, the shared headers and the flags: an edited
file builds anew, an unchanged one loads what is there. Nothing is built
at import; the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
SOURCES = ("hash_threshold.cu", "gbkmv_score.cu", "gather_score.cu",
           "postings_probe.cu", "block_decode.cu", "flash_attention.cu")
HEADERS = ("gbkmv_pair.cuh", "wgmma_sm90.cuh", "cta_scan.cuh",
           "launch_util.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
LIB_NAME = "librepro_torch_kernels.so"

_P = ctypes.c_void_p
_I32 = ctypes.c_int
_I64 = ctypes.c_int64
_U32 = ctypes.c_uint32
_F32 = ctypes.c_float
# Every C entry point, with its argument types (pointers and the stream
# as void*, so ctypes never cuts them to 32 bits).
_SIGNATURES = {
    "hash_threshold_launch": ([_P, _P, _P, _I64, _U32, _U32, _I32, _P],
                              _I32),
    "gbkmv_score_launch": ([_P, _P, _P, _I64, _I32, _I32, _P, _P, _P, _P,
                            _I32, _I32, _P, _I32, _P], _I32),
    "gbkmv_score_pack_bytes": ([_I32, _I32, _I32], _I64),
    "gbkmv_score_max_pack_bytes": ([], _I64),
    "gather_score_launch": ([_P, _P, _P, _I64, _I32, _I32, _P, _P, _P, _P,
                             _I32, _I32, _P, _P, _I64, _P, _I32, _P], _I32),
    "postings_probe_launch": ([_P, _I64, _P, _I64, _P, _P, _P, _P, _P,
                               _I32, _P], _I32),
    "postings_probe_fence_shift": ([_I64], _I32),
    "block_decode_launch": ([_P, _P, _I64, _P, _P, _P, _P, _I64, _P, _I64,
                             _I32, _I32, _I64, _P, _I32, _I32, _P], _I32),
    "flash_attention_launch": ([_P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32,
                                _I32, _F32, _P], _I32),
    "flash_attention_body_launches": ([_P], _I32),
    "repro_cuda_error_string": ([_I32], ctypes.c_char_p),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {path}); "
                           "the CUDA kernels need the CUDA toolkit")
    return path


def build_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (in parallel) and link the library, unless a
    library for these exact sources and flags exists. Returns its path;
    the compiler's output (register and shared-memory use per kernel) is
    kept beside it as ``build.log``."""
    out = BUILD_ROOT / build_key() / LIB_NAME
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for name in SOURCES:
            obj = os.path.join(tmp, name + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", obj]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        for name, _, p in procs:
            log = p.communicate()[0]
            logs.append(f"== {name}\n{log}")
            if p.returncode:
                raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lib_tmp = os.path.join(tmp, LIB_NAME)
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", lib_tmp, *(obj for _, obj, _ in procs)],
            capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"linking {LIB_NAME} failed:\n"
                               f"{link.stdout}{link.stderr}")
        (out.parent / "build.log").write_text("\n".join(logs))
        os.replace(lib_tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use in this process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
    return _lib


def current_stream_ptr(index: int) -> int:
    """The raw handle of card ``index``'s current stream, as
    ``torch.cuda.current_stream(index).cuda_stream`` gives it, without
    building the Stream object: 0.16 µs a call against 4.2 µs on the H100
    (``tools/probe_wrapper_steps.py``). It calls the private binding
    ``torch._C._cuda_getCurrentRawStream`` that ``torch.cuda`` itself uses
    for this; a PyTorch without it fails here, at the first launch."""
    return torch._C._cuda_getCurrentRawStream(index)


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
