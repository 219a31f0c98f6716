"""The LM serving slice of the port against the JAX package.

The reference's reduced qwen3 config, its weights (``tfm.init`` at
PRNGKey(1)) carried across by ``params_from_numpy``, and the same numpy
token ids go through ``repro.models.transformer`` and
``repro_torch.models.transformer``: prefill (last-token logits and the KV
caches) and one decode step, in f32 and in bf16; then the port's
decode-after-prefill cross-check of ``tests/test_archs_smoke.py``
(``test_lm_prefill_decode``); then the serve entry point.

In bf16 the reference runs op by op (``jax.disable_jit``): each op then
rounds as the model code writes it, which is the function the port copies.
Under jit, XLA's CPU fusions keep some bf16 intermediates in f32, which
moves single logits of the reduced model by up to 0.03 against its own
op-by-op run, over the 2e-2 below at S = 64.

Tolerances: f32 1e-5 (logits of size ~3 after two layers whose matmuls
sum in another order; the largest gap seen is 3.3e-6); bf16 2e-2, that of
``test_lm_prefill_decode`` (op by op the port's bf16 logits equal the
reference's).
"""

import contextlib
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import transformer as jtfm
from repro_torch.configs import registry
from repro_torch.launch import serve
from repro_torch.models import common
from repro_torch.models import transformer as tfm

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "qwen3-0.6b"


def _configs(dtype):
    jcfg = dataclasses.replace(jregistry.get_module(ARCH).reduced(),
                               dtype=dtype)
    tcfg = dataclasses.replace(registry.get_module(ARCH).reduced(),
                               dtype=dtype)
    return jcfg, tcfg


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def test_configs_match_reference():
    for fn in ("config", "reduced"):
        want = dataclasses.asdict(getattr(jregistry.get_module(ARCH), fn)())
        got = dataclasses.asdict(getattr(registry.get_module(ARCH), fn)())
        assert got == want
    with pytest.raises(KeyError, match="not yet ported"):
        registry.get_module("stablelm-12b")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_is_exact(dtype):
    jcfg, tcfg = _configs(dtype)
    tree = jax.tree.map(np.asarray, jtfm.init(jax.random.PRNGKey(1), jcfg))
    params = tfm.params_from_numpy(tree, tcfg, "cpu")
    flat_t = {"embed": params["embed"], "unembed": params["unembed"],
              "final_ln": params["final_ln"], **params["dense"]}
    flat_j = {"embed": tree["embed"], "unembed": tree["unembed"],
              "final_ln": tree["final_ln"], **tree["dense"]}
    assert flat_t.keys() == flat_j.keys()
    for name, t in flat_t.items():
        assert t.dtype == tcfg.torch_dtype
        # bf16 → f32 → bf16 loses nothing: equal bit for bit as f32.
        np.testing.assert_array_equal(_f32(t), _f32(flat_j[name]), err_msg=name)
    assert common.count_params(params) == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(tree))
    # The port's own init draws the same shapes and dtypes.
    own = tfm.init(tcfg, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    assert {k: (v.shape, v.dtype) for k, v in own["dense"].items()} == {
        k: (v.shape, v.dtype) for k, v in params["dense"].items()}
    assert own["embed"].shape == params["embed"].shape


@pytest.mark.parametrize("s,dtype,tol", [
    (8, "float32", 1e-5),           # one full softmax
    (64, "float32", 1e-5),          # two query chunks
    (8, "bfloat16", 2e-2),
])
def test_prefill_and_decode_match_reference(s, dtype, tol):
    jcfg, tcfg = _configs(dtype)
    # Remat is a training memory policy: the forward values are the same.
    jcfg = dataclasses.replace(jcfg, remat=False)
    jparams = jtfm.init(jax.random.PRNGKey(1), jcfg)
    params = tfm.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                   "cpu")
    op_by_op = (jax.disable_jit if dtype == "bfloat16"
                else contextlib.nullcontext)
    rng = np.random.default_rng(1)
    b = 2
    toks = rng.integers(0, jcfg.vocab, (b, s + 1)).astype(np.int32)

    with op_by_op():
        want_last, jcaches = jtfm.prefill(jparams, jnp.asarray(toks[:, :s]),
                                          jcfg)
    got_last, caches = tfm.prefill(params, torch.from_numpy(toks[:, :s]).long(),
                                   tcfg, cache_len=s + 4)
    np.testing.assert_allclose(_f32(got_last), _f32(want_last), rtol=tol,
                               atol=tol)
    for jc, tc in zip(jcaches["dense"], caches["dense"]):
        assert tc.shape == (tcfg.n_layers, b, s + 4, tcfg.n_kv_heads, tcfg.hd)
        np.testing.assert_allclose(_f32(tc[:, :, :s]), _f32(jc), rtol=tol,
                                   atol=tol)
        assert not tc[:, :, s:].any()

    jcaches = jax.tree.map(
        lambda c: jnp.pad(c, [(0, 0), (0, 0), (0, 4), (0, 0), (0, 0)]),
        jcaches)
    with op_by_op():
        want_dec, _, _ = jtfm.decode_step(jparams, jcaches,
                                          jnp.asarray(toks[:, s:s + 1]),
                                          jnp.full((b,), s, jnp.int32), jcfg)
    lengths = torch.full((b,), s, dtype=torch.long)
    got_dec, caches, new_len = tfm.decode_step(
        params, caches, torch.from_numpy(toks[:, s:s + 1]).long(), lengths,
        tcfg)
    assert got_dec.shape == (b, tcfg.vocab) and torch.isfinite(
        got_dec.float()).all()
    assert new_len.tolist() == [s + 1] * b
    np.testing.assert_allclose(_f32(got_dec), _f32(want_dec), rtol=tol,
                               atol=tol)

    if s + 1 > tcfg.chunk_q:
        return         # the chunked route needs S + 1 a multiple of chunk_q
    # Decode after prefill reproduces the full forward at position s.
    full = tfm.forward(params, torch.from_numpy(toks).long(), tcfg)
    assert full.shape == (b, s + 1, tcfg.vocab)
    np.testing.assert_allclose(_f32(got_dec), _f32(full[:, s]), rtol=2e-2,
                               atol=2e-2)
    with op_by_op():
        jfull, _, _ = jtfm.forward(jparams, jnp.asarray(toks), jcfg)
    np.testing.assert_allclose(_f32(full), _f32(jfull), rtol=tol, atol=tol)


def test_moe_config_raises():
    _, tcfg = _configs("float32")
    with pytest.raises(NotImplementedError, match="moe"):
        tfm.init(dataclasses.replace(tcfg, moe=object()),
                 generator=torch.Generator(), device="cpu")


def test_serve_lm_runs_on_cpu(capsys):
    out = serve.main(["--mode", "lm", "--reduced", "--device", "cpu",
                      "--batch", "2", "--seq", "16", "--decode-steps", "3"])
    assert out["tokens"].shape == (2, 4)
    assert out["prefill_logits"].shape == (2, 512)
    assert torch.isfinite(out["prefill_logits"].float()).all()
    assert "[serve-lm] qwen3-0.6b-smoke on cpu" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="slice 7"):
        serve.main(["--mode", "sketch"])


def test_serve_lm_without_a_card_exits_nonzero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode", "lm",
         "--reduced"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
