"""TRLWE tests: round trips, trivial ciphertexts, sample-extract consistency
(mirrors reference ``hom_nand/src/trlwe.rs:170-231``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rustfhe import tlwe, trlwe
from rustfhe.engine import get_engine
from rustfhe.params import TEST_PARAMS
from rustfhe.utils.rng import binary_array

U32 = jnp.uint32


@pytest.mark.parametrize("engine_name", ["oracle", "matmul"])
def test_round_trip(rng, engine_name):
    # trlwe.rs:207-230: 20 random binary polynomials.
    p = TEST_PARAMS
    engine = get_engine(engine_name)
    k1, k2, k3 = jax.random.split(rng, 3)
    s = binary_array(k1, (p.N,))
    bits = binary_array(k2, (20, p.N))
    ct = trlwe.encrypt_binary_poly(k3, s, bits, p, engine)
    dec = trlwe.decrypt_binary_poly(ct, s, p, engine)
    assert np.array_equal(np.asarray(dec), np.asarray(bits))


def test_trivial_decrypts_to_itself(rng):
    # trlwe.rs:225-229
    p = TEST_PARAMS
    engine = get_engine("matmul")
    s = binary_array(rng, (p.N,))
    msg = jnp.full((p.N,), 0x80000000, U32)
    ct = trlwe.trivial(msg)
    out = trlwe.phase(ct, s, p, engine)
    assert np.array_equal(np.asarray(out), np.asarray(msg))


def test_sample_extract_consistency(rng):
    # trlwe.rs:178-205: every index of a TRLWE decrypts identically via TLWE.
    p = TEST_PARAMS
    engine = get_engine("matmul")
    k1, k2, k3 = jax.random.split(rng, 3)
    s = binary_array(k1, (p.N,))
    bits = binary_array(k2, (p.N,))
    ct = trlwe.encrypt_binary_poly(k3, s, bits, p, engine)
    dec_poly = trlwe.decrypt_binary_poly(ct, s, p, engine)
    assert np.array_equal(np.asarray(dec_poly), np.asarray(bits))
    for i in range(p.N):
        t = trlwe.sample_extract(ct, i)
        bit = tlwe.decrypt_binary(t, s)
        assert int(np.asarray(bit)) == int(np.asarray(bits[i])), f"index {i}"


def test_sample_extract_batched(rng):
    p = TEST_PARAMS
    engine = get_engine("matmul")
    k1, k2, k3 = jax.random.split(rng, 3)
    s = binary_array(k1, (p.N,))
    bits = binary_array(k2, (4, p.N))
    ct = trlwe.encrypt_binary_poly(k3, s, bits, p, engine)
    t0 = trlwe.sample_extract(ct, 0)
    assert t0.shape == (4, p.N + 1)
    dec = tlwe.decrypt_binary(t0, s)
    assert np.array_equal(np.asarray(dec), np.asarray(bits[:, 0]))
