"""Serving entry point of the port: LM prefill + greedy decode (port of
``repro.launch.serve``'s ``--mode lm``).

    python -m repro_torch.launch.serve --mode lm --arch qwen3-0.6b
    python -m repro_torch.launch.serve --mode lm --reduced --device cpu

Weights are random, drawn from ``--seed`` on the device; the prompt is
``--batch`` × ``--seq`` random token ids from the same seed. Prefill runs
the full prompt (causal attention is the B6 kernel on the card), then
``--decode-steps`` greedy steps extend it. The device defaults to
``cuda`` and raises without a card; ``--device cpu`` runs the plain
PyTorch versions. ``--mode sketch`` (the containment-search service)
waits for the service layer (ROADMAP Queue A, slice 7).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_inputs(cfg: tfm.LMConfig, *, batch: int, seq: int, seed: int,
                device) -> tuple[dict, torch.Tensor]:
    """(params drawn on ``device`` from ``seed``, prompt int64[batch, seq])."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = tfm.init(cfg, generator=gen, device=device)
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, seq)))
    return params, tokens.to(device)


def generate(params, cfg: tfm.LMConfig, tokens, decode_steps: int) -> dict:
    """Prefill ``tokens`` [B, S], then ``decode_steps`` greedy steps.

    Returns the prefill's last-token logits, the B × (decode_steps + 1)
    greedy tokens (the prefill's pick, then each step's), and the host
    seconds of the prefill and of the decode loop, each ended by a sync."""
    device = tokens.device
    b, s = tokens.shape
    _sync(device)
    t0 = time.perf_counter()
    logits, caches = tfm.prefill(params, tokens, cfg,
                                 cache_len=s + decode_steps)
    tok = logits.argmax(-1, keepdim=True)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    picks = [tok]
    lengths = torch.full((b,), s, dtype=torch.int64, device=device)
    t0 = time.perf_counter()
    for _ in range(decode_steps):
        step_logits, caches, lengths = tfm.decode_step(params, caches, tok,
                                                       lengths, cfg)
        tok = step_logits.argmax(-1, keepdim=True)
        picks.append(tok)
    _sync(device)
    decode_s = time.perf_counter() - t0
    return {"prefill_logits": logits, "tokens": torch.cat(picks, dim=1),
            "prefill_s": prefill_s, "decode_s": decode_s,
            "decode_tok_per_s": b * decode_steps / decode_s
            if decode_steps else 0.0}


def serve_lm(args) -> dict:
    device = resolve_device(args.device)
    mod = registry.get_module(args.arch)
    cfg = mod.reduced() if args.reduced else mod.config()
    params, tokens = make_inputs(cfg, batch=args.batch, seq=args.seq,
                                 seed=args.seed, device=device)
    out = generate(params, cfg, tokens, args.decode_steps)
    print(f"[serve-lm] {cfg.name} on {device}: prefill[{args.batch}x"
          f"{args.seq}] {out['prefill_s']:.3f} s + {args.decode_steps} "
          f"decode steps → {out['decode_tok_per_s']:.1f} tok/s")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("sketch", "lm"), default="sketch")
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--decode-steps", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mode == "sketch":
        raise NotImplementedError(
            "--mode sketch serves through the service layer, which is not "
            "ported yet (ROADMAP Queue A, slice 7)")
    return serve_lm(args)


if __name__ == "__main__":
    main()
