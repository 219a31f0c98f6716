"""qwen3-0.6b [dense]: 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936 — qk_norm, GQA (port of ``repro.configs.qwen3_0_6b``, same
numbers). Qwen3 uses head_dim=128 (decoupled from d_model/n_heads = 64).
"""

from repro_torch.models.transformer import LMConfig

ARCH_ID = "qwen3-0.6b"


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID,
        n_layers=28,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        d_ff=3072,
        vocab=151_936,
        head_dim=128,
        qk_norm=True,
        rope_mode="full",
    )


def reduced() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=512,
        head_dim=16,
        qk_norm=True,
        rope_mode="full",
        chunk_q=32,
    )
