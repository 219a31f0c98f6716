"""GQA attention: causal (prefill) and cached decode (port of
``repro.models.attention``).

On a CUDA tensor :func:`causal_attention` is the B6 kernel
(:func:`repro_torch.kernels.flash_attention.flash_attention`); on a CPU
tensor it is :func:`causal_attention_plain`, a copy of the reference's
chunked route: a full softmax for ``s <= chunk_q``, query chunks of
``chunk_q`` rows otherwise. The plain route runs on any device when a
caller asks for it by name (``chip_smoke.py`` compares the two on the
card); nothing falls back to it. :func:`decode_attention` is torch ops, as
the reference's is a jnp program.

The reference's mesh layout hints (``constrain`` on the scores and the
``_flat_heads`` layout choice) and its per-chunk remat have no port: the
port runs on one device and does not train yet.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention

NEG_INF = -2.0e38


def _gqa_scores(q, k):
    """q [B,T,Hq,D], k [B,S,Hkv,D] -> grouped scores [B,Hkv,G,T,S] (f32)."""
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, t, hkv, hq // hkv, d)
    return torch.einsum("bthgd,bshd->bhgts", qg.float(), k.float())


def _gqa_out(p, v):
    """p [B,Hkv,G,T,S] (f32), v [B,S,Hkv,D] -> [B,T,Hq,D] in v's dtype.
    p is cast to v's dtype before the product, as the reference does."""
    b, hkv, g, t, s = p.shape
    o = torch.einsum("bhgts,bshd->bthgd", p.to(v.dtype), v)
    return o.reshape(b, t, hkv * g, v.shape[3])


def causal_attention_plain(q, k, v, *, chunk_q: int = 512,
                           scale: float | None = None):
    """The reference's chunked causal attention in torch ops.
    q [B,S,Hq,D], k/v [B,S,Hkv,D] -> [B,S,Hq,D]; S <= chunk_q or a
    multiple of it."""
    b, s, hq, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    qs = q * scale
    if s <= chunk_q:
        scores = _gqa_scores(qs, k)                      # [B,Hkv,G,S,S]
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, NEG_INF)
        return _gqa_out(torch.softmax(scores, dim=-1), v)
    if s % chunk_q:
        raise ValueError(f"sequence {s} is over chunk_q={chunk_q} and not a "
                         "multiple of it")
    kpos = torch.arange(s, device=q.device)
    outs = []
    for i in range(s // chunk_q):
        qc = qs[:, i * chunk_q:(i + 1) * chunk_q]        # [B,cq,Hq,D]
        scores = _gqa_scores(qc, k)                      # [B,Hkv,G,cq,S]
        qpos = i * chunk_q + torch.arange(chunk_q, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]            # [cq, S]
        scores = torch.where(mask, scores, NEG_INF)
        outs.append(_gqa_out(torch.softmax(scores, dim=-1), v))
    return torch.cat(outs, dim=1)


def causal_attention(q, k, v, *, chunk_q: int = 512,
                     scale: float | None = None):
    """Causal self-attention: q [B,S,Hq,D], k/v [B,S,Hkv,D] -> [B,S,Hq,D].
    The B6 kernel on a CUDA tensor (any S), the chunked route on a CPU
    tensor."""
    if q.device.type == "cuda":
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               scale=scale)
    return causal_attention_plain(q, k, v, chunk_q=chunk_q, scale=scale)


def decode_attention(q, k_cache, v_cache, lengths, *,
                     scale: float | None = None):
    """One-token decode against a KV cache.

    q [B,1,Hq,D]; k/v_cache [B,S,Hkv,D]; lengths int[B] = live cache fill
    (the new token is already written at index lengths-1).
    """
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    scores = _gqa_scores(q * scale, k_cache)             # [B,Hkv,G,1,S]
    spos = torch.arange(k_cache.shape[1], device=q.device)
    mask = spos[None, :] < lengths[:, None]              # [B,S]
    scores = torch.where(mask[:, None, None, None, :], scores, NEG_INF)
    return _gqa_out(torch.softmax(scores, dim=-1), v_cache)
