"""Decoder-only transformer LM, dense stack (port of
``repro.models.transformer``).

Plain functions over a params dict with the reference's tree: ``embed``
[V, d], ``unembed`` [d, V], ``final_ln`` [d], and ``dense`` whose leaves are
stacked over layers ([L, ...]), so :func:`params_from_numpy` carries the
reference's weights across leaf by leaf. A layer is rms_norm → q/k/v →
qk-norm → RoPE → causal attention → ``wo``, then rms_norm → SwiGLU MLP,
each added to the residual; the stack ends in the final norm and the
unembed.

Against the reference: only the dense stack is ported (a config with
``moe`` raises); ``forward`` returns the logits alone (the reference's aux
loss is 0 without experts, and its KV caches come from ``prefill``);
``prefill`` writes its caches into buffers of ``cache_len`` positions and
unembeds the last position only; ``decode_step`` writes the new token's
k/v into the caches in place. ``param_axes``, ``cache_axes`` and the
remat policies name mesh axes and training choices that one device
serving does not need.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models import common
from repro_torch.models.attention import causal_attention, decode_attention


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    rope_mode: str = "full"            # "full" | "2d"
    qk_norm: bool = False
    moe: Optional[Any] = None
    dense_d_ff: Optional[int] = None   # dense-layer FFN width when interleaved
    dtype: str = "bfloat16"
    chunk_q: int = 512
    remat: bool = True
    remat_policy: str = "nothing"
    aux_loss_coef: float = 0.01

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def _require_dense(cfg: LMConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name} has experts; models/moe.py is not ported yet "
            "(ROADMAP Queue A, slice 9: MoE)")


def _layer_shapes(cfg: LMConfig) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    f = cfg.dense_d_ff or cfg.d_ff
    shapes = {"ln1": (d,), "ln2": (d,),
              "wq": (d, hq, hd), "wk": (d, hkv, hd), "wv": (d, hkv, hd),
              "wo": (hq, hd, d),
              "w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    if cfg.qk_norm:
        shapes["qn"] = (hd,)
        shapes["kn"] = (hd,)
    return shapes


def init(cfg: LMConfig, *, generator: torch.Generator, device) -> dict:
    """Random params of the reference's shapes and scales (norm gains 0,
    matrices truncated normal with std 1/sqrt(fan_in)), drawn on
    ``device`` from ``generator``."""
    _require_dense(cfg)
    dtype = cfg.torch_dtype
    d, n = cfg.d_model, cfg.n_layers

    def draw(shape, std):
        return common.truncated_normal(shape, std, dtype, generator=generator,
                                       device=device)

    params = {"embed": draw((cfg.vocab, d), 0.02),
              "unembed": draw((d, cfg.vocab), d ** -0.5),
              "final_ln": torch.zeros(d, dtype=dtype, device=device)}
    dense = {}
    for name, shp in sorted(_layer_shapes(cfg).items()):
        if len(shp) == 1:                  # norm gains start at 0 (rms 1+s)
            dense[name] = torch.zeros((n,) + shp, dtype=dtype, device=device)
        else:
            fan_in = shp[0] * (shp[1] if name == "wo" else 1)
            dense[name] = draw((n,) + shp, fan_in ** -0.5)
    params["dense"] = dense
    return params


def params_from_numpy(tree: dict, cfg: LMConfig, device) -> dict:
    """The reference's params tree, as numpy arrays, as the port's params.
    bf16 leaves (``ml_dtypes.bfloat16``, which torch does not read) go
    through float32, which holds every bf16 value exactly."""
    _require_dense(cfg)
    if "moe" in tree:
        raise NotImplementedError("the tree has MoE layers; models/moe.py is "
                                  "not ported yet (ROADMAP Queue A, slice 9)")

    def leaf(a):
        f32 = torch.from_numpy(np.array(a, dtype=np.float32))
        return f32.to(device=device, dtype=cfg.torch_dtype)

    return {"embed": leaf(tree["embed"]), "unembed": leaf(tree["unembed"]),
            "final_ln": leaf(tree["final_ln"]),
            "dense": {k: leaf(v) for k, v in tree["dense"].items()}}


def _layer(params: dict, i: int) -> dict:
    return {k: v[i] for k, v in params["dense"].items()}


def _project_qkv(x, p, cfg: LMConfig, positions):
    b, s, d = x.shape
    q = (x @ p["wq"].reshape(d, -1)).view(b, s, cfg.n_heads, cfg.hd)
    k = (x @ p["wk"].reshape(d, -1)).view(b, s, cfg.n_kv_heads, cfg.hd)
    v = (x @ p["wv"].reshape(d, -1)).view(b, s, cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        q = common.rms_norm(q, p["qn"])
        k = common.rms_norm(k, p["kn"])
    q = common.apply_rope(q, positions, mode=cfg.rope_mode)
    k = common.apply_rope(k, positions, mode=cfg.rope_mode)
    return q, k, v


def _out_proj(o, p):
    b, s, hq, hd = o.shape
    return o.reshape(b, s, hq * hd) @ p["wo"].reshape(hq * hd, -1)


def _silu(x):
    """``jax.nn.silu``'s op order, each op rounded in x's dtype: in bf16
    ``F.silu`` (one rounding) differs from the reference by an ulp."""
    return x * (1 / (1 + torch.exp(-x)))


def _mlp(h, p):
    return (_silu(h @ p["w_gate"]) * (h @ p["w_up"])) @ p["w_down"]


def _blocks(x, params, cfg: LMConfig, positions, attention, caches=None):
    """All layers over x [B,S,d]; with ``caches`` (k, v of [L,B,T,Hkv,hd])
    each layer's k/v are written at positions [0, S)."""
    s = x.shape[1]
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        h = common.rms_norm(x, p["ln1"])
        q, k, v = _project_qkv(h, p, cfg, positions)
        if caches is not None:
            caches[0][i, :, :s] = k
            caches[1][i, :, :s] = v
        o = attention(q, k, v, chunk_q=cfg.chunk_q)
        x = x + _out_proj(o, p)
        x = x + _mlp(common.rms_norm(x, p["ln2"]), p)
    return x


def _positions(tokens):
    b, s = tokens.shape
    return torch.arange(s, device=tokens.device).expand(b, s)


def _unembed(x, params):
    return common.rms_norm(x, params["final_ln"]) @ params["unembed"]


def forward(params, tokens, cfg: LMConfig, *, attention=causal_attention):
    """tokens int[B,S] -> logits [B,S,V] in the config's dtype.

    ``attention`` is :func:`causal_attention` (the B6 kernel on the card).
    Its only other caller is ``chip_smoke.py``, which passes
    ``causal_attention_plain`` to hold B6's route against the plain one
    on the card; no serving path sets it."""
    _require_dense(cfg)
    x = _blocks(params["embed"][tokens], params, cfg, _positions(tokens),
                attention)
    return _unembed(x, params)


def prefill(params, tokens, cfg: LMConfig, *, cache_len: int | None = None,
            attention=causal_attention):
    """Full-sequence forward: (last-token logits [B, V], KV caches
    {"dense": (k, v)} of [L, B, cache_len, Hkv, hd], filled at [0, S)).
    ``cache_len`` defaults to S; decode needs room past it.
    ``attention`` is as in :func:`forward`."""
    _require_dense(cfg)
    b, s = tokens.shape
    shape = (cfg.n_layers, b, cache_len or s, cfg.n_kv_heads, cfg.hd)
    caches = {"dense": tuple(torch.zeros(shape, dtype=cfg.torch_dtype,
                                         device=tokens.device)
                             for _ in range(2))}
    x = _blocks(params["embed"][tokens], params, cfg, _positions(tokens),
                attention, caches["dense"])
    return _unembed(x[:, -1], params), caches


def decode_step(params, caches, token, lengths, cfg: LMConfig):
    """One-token decode. token int[B,1]; lengths int[B] = cache fill.

    Writes the token's k/v into ``caches`` at ``lengths`` (in place) and
    returns (logits [B, V], the caches, lengths + 1).
    """
    _require_dense(cfg)
    b = token.shape[0]
    rows = torch.arange(b, device=token.device)
    kc, vc = caches["dense"]
    x = params["embed"][token]                           # [B,1,d]
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        h = common.rms_norm(x, p["ln1"])
        q, k, v = _project_qkv(h, p, cfg, lengths[:, None])
        kc[i, rows, lengths] = k[:, 0]
        vc[i, rows, lengths] = v[:, 0]
        o = decode_attention(q, kc[i], vc[i], lengths + 1)
        x = x + _out_proj(o, p)
        x = x + _mlp(common.rms_norm(x, p["ln2"]), p)
    return _unembed(x[:, 0], params), caches, lengths + 1
