"""Dense GB-KMV containment scoring: the B1 kernel's wrapper.

Port of ``repro.kernels.gbkmv_score`` (the Pallas ``_score_kernel``). On
CUDA tensors it launches ``csrc/gbkmv_score.cu``; on CPU tensors it runs
the plain version :func:`repro_torch.kernels.ref.gbkmv_score_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.library import check, current_stream_ptr, library

def query_pack_bytes(gq: int, cq: int, w: int) -> int:
    """Shared memory a launch stages for a [gq, cq] query pack with w
    buffer words, as the kernel lays it out. Asks the kernel library, so
    needs the card's toolchain."""
    return library().gbkmv_score_pack_bytes(gq, cq, w)


def max_pack_bytes() -> int:
    """The most shared memory a launch may stage for its query pack (what
    one block may use on Hopper less the kernel's filter). Asks the kernel
    library."""
    return library().gbkmv_score_max_pack_bytes()


def queries_per_launch(device: torch.device, gq: int, cq: int, w: int) -> int:
    """How many of a batch's gq queries one call on ``device`` takes: all
    of them on the CPU, whose plain version stages nothing; on a card as
    many as the kernel's pack holds, at least one."""
    if device.type != "cuda":
        return gq
    return max(1, min(gq, max_pack_bytes() // query_pack_bytes(1, cq, w)))


def _check_inputs(x_values, x_thresh, x_buf, q_values, q_thresh, q_buf,
                  q_sizes) -> None:
    ts = (x_values, x_thresh, x_buf, q_values, q_thresh, q_buf, q_sizes)
    names = ("x_values", "x_thresh", "x_buf", "q_values", "q_thresh",
             "q_buf", "q_sizes")
    for name, t in zip(names, ts):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 (u32 bit pattern), "
                            f"got {t.dtype}")
        if t.device != x_values.device:
            raise ValueError(f"{name} is on {t.device}, x_values on "
                             f"{x_values.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    m, gq = x_values.shape[0], q_values.shape[0]
    w = x_buf.shape[1] if x_buf.dim() == 2 else -1
    if (x_values.dim() != 2 or x_thresh.shape != (m,)
            or x_buf.shape != (m, w) or q_values.dim() != 2
            or q_thresh.shape != (gq,) or q_buf.shape != (gq, w)
            or q_sizes.shape != (gq,)):
        raise ValueError(
            "shapes must be x_values[M,C], x_thresh[M], x_buf[M,W], "
            "q_values[Gq,Cq], q_thresh[Gq], q_buf[Gq,W], q_sizes[Gq]; got "
            f"{[tuple(t.shape) for t in ts]}")


def gbkmv_score(x_values, x_thresh, x_buf,
                q_values, q_thresh, q_buf, q_sizes) -> torch.Tensor:
    """f32[M, Gq] containment scores of a query pack against the records.

    All inputs int32 (u32 columns as bit patterns), contiguous, on one
    device; record rows and query rows sorted ascending and PAD-filled.
    On a card the query pack must fit the block's shared memory
    (:func:`query_pack_bytes` ≤ :func:`max_pack_bytes`; the C entry
    refuses more); ``ops.score_index`` splits larger batches."""
    _check_inputs(x_values, x_thresh, x_buf, q_values, q_thresh, q_buf,
                  q_sizes)
    if x_values.device.type == "cpu":
        return ref.gbkmv_score_ref(x_values, x_thresh, x_buf, q_values,
                                   q_thresh, q_buf, q_sizes)
    if x_values.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_values.device}")
    m, c = x_values.shape
    gq, cq = q_values.shape
    w = x_buf.shape[1]
    dev = x_values.device
    out = torch.empty((m, gq), dtype=torch.float32, device=dev)
    if m and gq:
        check(library().gbkmv_score_launch(
            x_values.data_ptr(), x_thresh.data_ptr(), x_buf.data_ptr(), m, c,
            w, q_values.data_ptr(), q_thresh.data_ptr(), q_buf.data_ptr(),
            q_sizes.data_ptr(), gq, cq, out.data_ptr(), dev.index,
            current_stream_ptr(dev.index)), "gbkmv_score_launch")
        gbkmv_score.launches += 1
    return out


gbkmv_score.launches = 0
