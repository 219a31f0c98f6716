"""B6 and the attention layer of the port against the JAX package.

The same numpy inputs (from a seed) go through ``repro`` and
``repro_torch``:

- the port's ``flash_attention`` on CPU tensors (its plain version) against
  the Pallas ``flash_attention`` in interpret mode, at the shapes and the
  block sweep of ``tests/test_flash_kernel.py``, and its causality;
- ``causal_attention`` (the full-softmax and the chunked routes) and
  ``decode_attention`` against ``repro.models.attention``;
- ``rms_norm`` and ``apply_rope`` (both modes) against ``repro.models.common``.

Tolerances: 2e-5 in f32 and 2e-2 in bf16, those of
``tests/test_flash_kernel.py`` (the sums run in another order, and in bf16
the reference rounds the probabilities to bf16 before the P·V product).
Where the port copies the reference's op order in f32 (norms, RoPE,
attention layer) the tolerance is 1e-5, or 1e-6 where no sum is long.
The B6 kernel against its plain version on a card is in
``tests/test_torch_cuda.py``, which runs without jax.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon

_TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _qkv(rng, b, s, hq, hkv, d):
    return (rng.normal(size=(b, s, hq, d)).astype(np.float32),
            rng.normal(size=(b, s, hkv, d)).astype(np.float32),
            rng.normal(size=(b, s, hkv, d)).astype(np.float32))


def _both(arrays, dtype):
    """The same arrays as jnp (in dtype) and torch (the same values)."""
    js = [jnp.asarray(a, dtype) for a in arrays]
    ts = [torch.from_numpy(np.array(j, np.float32)).to(_TORCH[dtype])
          for j in js]
    return js, ts


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("b,s,hq,hkv,d,dtype", [
    (1, 256, 4, 2, 64, jnp.float32),
    (2, 256, 8, 8, 32, jnp.float32),     # MHA (G=1)
    (2, 512, 4, 1, 64, jnp.float32),     # MQA (G=4)
    (1, 256, 4, 2, 64, jnp.bfloat16),
])
def test_flash_matches_pallas_interpret(b, s, hq, hkv, d, dtype):
    rng = np.random.default_rng(0)
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(rng, b, s, hq, hkv, d), dtype)
    want = jax_flash(jq, jk, jv, blk_q=128, blk_k=128, interpret=True)
    got = flash_attention(tq, tk, tv)
    assert got.dtype == _TORCH[dtype] and got.shape == (b, s, hq, d)
    tol = 2e-2 if dtype == jnp.bfloat16 else 2e-5
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("blk_q,blk_k", [(64, 128), (128, 64), (256, 256),
                                         (512, 128)])
def test_flash_block_shape_sweep(blk_q, blk_k):
    rng = np.random.default_rng(1)
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(rng, 1, 512, 2, 2, 32),
                                       jnp.float32)
    want = jax_flash(jq, jk, jv, blk_q=blk_q, blk_k=blk_k, interpret=True)
    np.testing.assert_allclose(_f32(flash_attention(tq, tk, tv)), _f32(want),
                               rtol=2e-5, atol=2e-5)


def test_flash_causality():
    """Future tokens must not influence the output."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 256, 2, 2, 32))
    out1 = flash_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, 128:] = 99.0
    v2[:, 128:] = -99.0
    out2 = flash_attention(q, k2, v2)
    np.testing.assert_allclose(out1[:, :128].numpy(), out2[:, :128].numpy(),
                               rtol=1e-6, atol=1e-6)


def test_flash_takes_any_sequence_length():
    """S = 1 and S = 100 (no block multiple): equal to the chunked route."""
    rng = np.random.default_rng(3)
    for s in (1, 100):
        q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 2, s, 4, 2, 16))
        np.testing.assert_allclose(
            flash_attention(q, k, v).numpy(),
            tattn.causal_attention_plain(q, k, v, chunk_q=128).numpy(),
            rtol=2e-5, atol=2e-5)


def test_flash_rejects_bad_inputs():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16))
    with pytest.raises(TypeError):
        flash_attention(q, q.half(), q.half())
    with pytest.raises(ValueError):
        flash_attention(q.transpose(1, 2), q.transpose(1, 2),
                        q.transpose(1, 2))


@pytest.mark.parametrize("s,chunk_q,dtype", [
    (64, 64, jnp.float32),        # one full softmax
    (128, 32, jnp.float32),       # four query chunks
    (128, 32, jnp.bfloat16),
])
def test_causal_attention_matches_reference(s, chunk_q, dtype):
    rng = np.random.default_rng(4)
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(rng, 2, s, 4, 2, 16), dtype)
    want = jattn.causal_attention(jq, jk, jv, chunk_q=chunk_q)
    got = tattn.causal_attention(tq, tk, tv, chunk_q=chunk_q)
    assert got.dtype == _TORCH[dtype]
    tol = 2e-2 if dtype == jnp.bfloat16 else 1e-5
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_causal_attention_chunked_needs_a_multiple():
    q = torch.zeros(1, 48, 2, 16)
    with pytest.raises(ValueError):
        tattn.causal_attention(q, q, q, chunk_q=32)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_decode_attention_matches_reference(dtype):
    rng = np.random.default_rng(5)
    b, s, hq, hkv, d = 3, 40, 4, 2, 16
    q = rng.normal(size=(b, 1, hq, d)).astype(np.float32)
    kc = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    vc = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    lengths = np.asarray([1, 17, 40], np.int32)
    (jq, jk, jv), (tq, tk, tv) = _both((q, kc, vc), dtype)
    want = jattn.decode_attention(jq, jk, jv, jnp.asarray(lengths))
    got = tattn.decode_attention(tq, tk, tv, torch.from_numpy(lengths))
    tol = 2e-2 if dtype == jnp.bfloat16 else 1e-5
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rms_norm_matches_reference(dtype):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32) * 3
    scale = rng.normal(size=(32,)).astype(np.float32) * 0.1
    (jx, js), (tx, ts) = _both((x, scale), dtype)
    got = tcommon.rms_norm(tx, ts)
    assert got.dtype == _TORCH[dtype]
    # bf16: the two round the same f32 value, so they agree to one ulp.
    tol = 1e-2 if dtype == jnp.bfloat16 else 1e-6
    np.testing.assert_allclose(_f32(got), _f32(jcommon.rms_norm(jx, js)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("mode", ["full", "2d"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_apply_rope_matches_reference(mode, dtype):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    pos = np.stack([np.arange(9), np.arange(100, 109)]).astype(np.int32)
    (jx,), (tx,) = _both((x,), dtype)
    want = jcommon.apply_rope(jx, jnp.asarray(pos), mode=mode)
    got = tcommon.apply_rope(tx, torch.from_numpy(pos), mode=mode)
    assert got.dtype == _TORCH[dtype]
    tol = 1e-2 if dtype == jnp.bfloat16 else 1e-5
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_rope_frequencies_match_reference():
    for rope_dim in (16, 64, 128):
        np.testing.assert_allclose(
            tcommon.rope_frequencies(128, rope_dim).numpy(),
            np.asarray(jcommon.rope_frequencies(128, rope_dim)),
            rtol=1e-6, atol=0)
