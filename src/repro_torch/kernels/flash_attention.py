"""Causal GQA flash attention, forward: the B6 kernel's wrapper.

Port of ``repro.kernels.flash_attention`` (the Pallas ``_flash_kernel``).
On CUDA tensors it launches ``csrc/flash_attention.cu``; on CPU tensors it
runs the plain version :func:`repro_torch.kernels.ref.flash_attention_ref`.
The kernel takes any S >= 1 (the Pallas wrapper asks S to be a multiple
of its blocks) and has no block-shape arguments: its tiles are fixed.

The kernel has two bodies, chosen by dtype and head dim: bf16 at D = 64 or
128 runs on the tensor cores (``"wgmma"``: TMA loads of K/V, both products
by wgmma, P·V as two bf16 products of P's high and low halves); f32 at
every D and bf16 at D = 16 or 32 run on the CUDA cores (``"cuda-core"``,
f32 products). Each kernel counts its own launches on the card, so
:func:`body_launches` shows which body ran. A launch that fails raises;
there is no fallback from one body to the other.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.library import check, library

#: Head dims the kernel is built for, and the most query heads per kv head.
HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 128
#: The kernel's bodies, in the order it counts their launches.
BODIES = ("cuda-core", "wgmma")


def _check_inputs(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q must be [B,S,Hq,D] and k, v [B,S,Hkv,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if k.shape != (b, s, hkv, d) or hkv == 0 or hq % hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (Hq a multiple of Hkv)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in (torch.bfloat16, torch.float32) or t.dtype != q.dtype:
            raise TypeError(f"{name} must be bf16 or f32 like q, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def flash_attention(q, k, v, *, scale: float | None = None) -> torch.Tensor:
    """Causal attention [B,S,Hq,D] of q [B,S,Hq,D] against k, v
    [B,S,Hkv,D] (G = Hq/Hkv query heads per kv head), in q's dtype.

    All three contiguous, bf16 or f32, on one device; ``scale`` defaults to
    D**-0.5. On the card D must be one of :data:`HEAD_DIMS` and G at most
    :data:`MAX_GROUP`.
    """
    _check_inputs(q, k, v)
    b, s, hq, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    hkv = k.shape[2]
    if d not in HEAD_DIMS or hq // hkv > MAX_GROUP:
        raise ValueError(f"the kernel takes D in {HEAD_DIMS} and at most "
                         f"{MAX_GROUP} query heads per kv head; got D={d}, "
                         f"G={hq // hkv}")
    # TMA reads from 16-byte aligned addresses only; a contiguous view at
    # an odd offset is copied (fresh allocations are always aligned).
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    out = torch.empty_like(q)
    if b and s:
        lib = library()
        with torch.cuda.device(q.device):
            err = lib.flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, s, hq, hkv, d, int(q.dtype == torch.bfloat16), scale,
                torch.cuda.current_stream().cuda_stream)
        check(err, "flash_attention_launch")
        flash_attention.launches += 1
    return out


flash_attention.launches = 0


def body_launches(device=None) -> dict[str, int]:
    """The kernel's launches that ran on ``device`` (a CUDA device, the
    current one by default) since the library was loaded, per body, as
    the kernels count them on the card. Waits for the device first."""
    counts = (ctypes.c_ulonglong * len(BODIES))()
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        check(library().flash_attention_body_launches(counts),
              "flash_attention_body_launches")
    return dict(zip(BODIES, counts))
