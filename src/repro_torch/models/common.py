"""Shared model substrate: norms, rotary embeddings, initializers (port of
``repro.models.common``).

Params are plain dicts of tensors, as the reference's are nested dicts of
jnp arrays. Left out: ``softmax_cross_entropy`` (training, a later slice)
and ``layer_norm`` (the families that use it are not ported yet).
"""

from __future__ import annotations

import torch


def truncated_normal(shape, stddev: float, dtype=torch.float32, *,
                     generator: torch.Generator, device) -> torch.Tensor:
    """``stddev`` times a standard normal truncated to [-2, 2], drawn in
    f32 on ``device`` from ``generator`` and cast to ``dtype``. The draws
    are not the reference's (another generator); the distribution is."""
    x = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (x * stddev).to(dtype)


def rms_norm(x, scale, eps: float = 1e-6):
    """RMS norm in f32 with the reference's ``(1 + scale)`` gain; the
    result in x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


# Rotary position embeddings.
#   mode "full": rotate the whole head dim (llama / qwen style)
#   mode "2d":   rotate only the first half of the head dim (chatglm's
#                2D-RoPE: half carries rotary position, half is NoPE)

def rope_frequencies(head_dim: int, rope_dim: int, base: float = 10000.0,
                     device=None) -> torch.Tensor:
    exponent = torch.arange(0, rope_dim, 2, dtype=torch.float32,
                            device=device) / rope_dim
    return 1.0 / (base ** exponent)                      # [rope_dim/2]


def apply_rope(x, positions, mode: str = "full", base: float = 10000.0):
    """x [..., T, H, D]; positions [..., T] int. sin/cos in f32, the
    rotation in f32, the result cast back to x's dtype."""
    d = x.shape[-1]
    rope_dim = d if mode == "full" else d // 2
    inv = rope_frequencies(d, rope_dim, base, device=x.device)
    ang = positions[..., :, None].float() * inv          # [..., T, rd/2]
    sin = torch.sin(ang)[..., :, None, :]                # [..., T, 1, rd/2]
    cos = torch.cos(ang)[..., :, None, :]
    rot, rest = x[..., :rope_dim].float(), x[..., rope_dim:]
    r1, r2 = rot.chunk(2, dim=-1)
    out = torch.cat([r1 * cos - r2 * sin, r2 * cos + r1 * sin], dim=-1)
    if rest.shape[-1]:
        out = torch.cat([out, rest.float()], dim=-1)
    return out.to(x.dtype)


def count_params(params) -> int:
    """Elements of every tensor in a (nested) params dict."""
    if isinstance(params, dict):
        return sum(count_params(p) for p in params.values())
    return params.numel()
