"""The port's fingerprint hash and the B2 kernel's plain version against the
JAX reference, bit for bit, on the same numpy-seeded ids."""

import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis", reason="property fuzzing needs hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from repro.core import hashing as ref_hashing  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels.ref import hash_threshold_ref as jax_hash_threshold  # noqa: E402
from repro_torch.core import hashing  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.hash_threshold import hash_threshold  # noqa: E402

EDGE_IDS = np.asarray([0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1,
                       2**32, 2**32 + 5, 2**40 + 7, 2**62 + 3], np.int64)


def _ids(seed, n):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 2**34, size=n, dtype=np.int64)
    return np.concatenate([EDGE_IDS, ids])


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1])
def test_hash_u32_matches_reference(seed):
    ids = _ids(seed, 300)
    want = ref_hashing.hash_u32_np(ids, seed=seed)
    got = hashing.hash_u32(torch.from_numpy(ids), seed=seed)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(hashing.hash_u32_np(ids, seed=seed), want)


def test_u32_bit_pattern_round_trip():
    u = np.asarray([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32)
    t = hashing.to_tensor(u)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(hashing.to_numpy(t), u)
    np.testing.assert_array_equal(hashing.as_u64(t).numpy(), u.astype(np.int64))
    np.testing.assert_array_equal(
        hashing.to_numpy(hashing.as_bits(hashing.as_u64(t))), u)


@pytest.mark.parametrize("tau", [0, 2**31, 2**32 - 2, 2**32 - 1])
def test_hash_threshold_plain_matches_jax_oracle(tau):
    ids = _ids(3, 500)
    ids32 = (ids.astype(np.uint64) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    h_want, keep_want = jax_hash_threshold(jnp.asarray(ids32), 5, tau)
    h, keep = hash_threshold(hashing.to_tensor(ids32), 5, tau)
    assert h.dtype == keep.dtype == torch.int32
    np.testing.assert_array_equal(hashing.to_numpy(h), np.asarray(h_want))
    np.testing.assert_array_equal(keep.numpy().astype(bool),
                                  np.asarray(keep_want))
    h_ref, keep_ref = ref.hash_threshold_ref(torch.from_numpy(ids), 5, tau)
    np.testing.assert_array_equal(h_ref.numpy(), np.asarray(h_want, np.int64))
    np.testing.assert_array_equal(keep_ref.numpy(), np.asarray(keep_want))


def test_hash_threshold_hashes_only_matches_jax_oracle():
    """The device build's form: no τ, so no keep flags are written."""
    ids = _ids(4, 500)
    ids32 = (ids.astype(np.uint64) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    h_want, _ = jax_hash_threshold(jnp.asarray(ids32), 5, 0)
    h, keep = hash_threshold(hashing.to_tensor(ids32), 5)
    assert keep is None
    np.testing.assert_array_equal(hashing.to_numpy(h), np.asarray(h_want))


@pytest.mark.parametrize("tau", [None, 2**31])
@pytest.mark.parametrize("lead", [1, 2, 3])
def test_hash_threshold_plain_matches_jax_oracle_on_slices(lead, tau):
    """A stream sliced 1-3 words in (as the card's scalar body takes it),
    at lengths that are not all multiples of four, in both forms."""
    ids = _ids(6, 500)
    ids32 = (ids.astype(np.uint64) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    t = hashing.to_tensor(ids32)[lead:]
    assert t.is_contiguous() and t.storage_offset() == lead
    h_want, keep_want = jax_hash_threshold(jnp.asarray(ids32[lead:]), 5,
                                           0 if tau is None else tau)
    h, keep = hash_threshold(t, 5, tau)
    np.testing.assert_array_equal(hashing.to_numpy(h), np.asarray(h_want))
    if tau is None:
        assert keep is None
    else:
        np.testing.assert_array_equal(keep.numpy().astype(bool),
                                      np.asarray(keep_want))


def test_hash_threshold_rejects_bad_input():
    with pytest.raises(ValueError):
        hash_threshold(torch.zeros(4, dtype=torch.int64), 0, 5)
    with pytest.raises(ValueError):
        hash_threshold(torch.zeros(4, dtype=torch.int32), 0, 2**32)


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 2**16), frac=st.floats(0.0, 1.0),
       n=st.integers(0, 300))
def test_hash_and_filter_matches_pallas_interpret(seed, frac, n):
    rng = np.random.default_rng(seed)
    ids32 = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    tau = int(frac * (2**32 - 1))
    h_want, keep_want = ref_ops.hash_and_filter(
        jnp.asarray(ids32), seed, np.uint32(tau), interpret=True)
    h, keep = ops.hash_and_filter(hashing.to_tensor(ids32), seed, tau)
    np.testing.assert_array_equal(hashing.to_numpy(h), np.asarray(h_want))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(keep_want))
