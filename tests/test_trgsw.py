"""TRGSW tests: round trips, external product, CMux
(mirrors reference ``hom_nand/src/trgsw.rs:332-477``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rustfhe import torus, trgsw, trlwe
from rustfhe.engine import get_engine
from rustfhe.params import TEST_PARAMS
from rustfhe.utils.rng import binary_array

U32 = jnp.uint32
I32 = jnp.int32


def _keys(rng, p):
    k1, k2 = jax.random.split(rng)
    return binary_array(k1, (p.N,)), k2


def test_round_trip_poly(rng):
    # trgsw.rs:341-361
    p = TEST_PARAMS
    engine = get_engine("matmul")
    s, k = _keys(rng, p)

    pol_u = jnp.asarray(np.arange(p.N) % 20, I32)
    rep = trgsw.encrypt_int_poly(jax.random.fold_in(k, 0), s, pol_u, p, engine)
    res = trgsw.decrypt_int_poly(rep, s, p, engine)
    assert np.array_equal(np.asarray(res), np.asarray(pol_u))

    pol_i = jnp.asarray(1 - 2 * (np.arange(p.N) % 2), I32)
    rep = trgsw.encrypt_int_poly(jax.random.fold_in(k, 1), s, pol_i, p, engine)
    res = trgsw.decrypt_int_poly(rep, s, p, engine)
    assert np.array_equal(np.asarray(res), np.asarray(pol_i))


def test_round_trip_scalar(rng):
    p = TEST_PARAMS
    engine = get_engine("matmul")
    s, k = _keys(rng, p)
    rep = trgsw.encrypt_int(k, s, jnp.asarray(4, I32), p, engine)
    res = trgsw.decrypt_int(rep, s, p, engine)
    assert int(np.asarray(res)) == 4


@pytest.mark.parametrize("engine_name", ["oracle", "matmul", "matmul_bf16"])
def test_external_product_by_one_preserves(rng, engine_name):
    # trgsw.rs:363-390: TRGSW(1) x TRLWE(m) decrypts back to ~m.
    p = TEST_PARAMS
    engine = get_engine(engine_name)
    s, k = _keys(rng, p)
    k1, k2 = jax.random.split(k)

    msg = jnp.asarray(
        np.where(np.arange(p.N) % 2 == 0, 0x80000000, 0x40000000).astype(np.uint32)
    )
    ct = trlwe.encrypt_torus_poly(k1, s, msg, p, engine)
    rep1 = trgsw.encrypt_int(k2, s, jnp.asarray(1, I32), p, engine)
    prepared = engine.prepare_trgsw(rep1, p)
    out = trgsw.external_product(prepared, ct, p, engine)
    dec = trlwe.phase(out, s, p, engine)
    err = np.asarray((dec - msg).astype(U32))
    wrap = np.minimum(err, (1 << 32) - err.astype(np.int64)).astype(np.float64) / 2**32
    assert wrap.max() < 2e-3  # reference tolerance (trgsw.rs:379)


@pytest.mark.parametrize("item", [0, 1])
def test_cmux_selects(rng, item):
    # trgsw.rs:392-424
    p = TEST_PARAMS
    engine = get_engine("matmul")
    s, k = _keys(rng, p)
    k1, k2, k3 = jax.random.split(k, 3)

    pol0 = jnp.zeros((p.N,), U32)
    pol1 = jnp.ones((p.N,), U32)
    ct0 = trlwe.encrypt_binary_poly(k1, s, pol0, p, engine)
    ct1 = trlwe.encrypt_binary_poly(k2, s, pol1, p, engine)
    sel = trgsw.encrypt_int(k3, s, jnp.asarray(item, I32), p, engine)
    prepared = engine.prepare_trgsw(sel, p)
    out = trgsw.cmux(prepared, ct1, ct0, p, engine)
    dec = trlwe.decrypt_binary_poly(out, s, p, engine)
    expect = pol1 if item == 1 else pol0
    assert np.array_equal(np.asarray(dec), np.asarray(expect))


@pytest.mark.slow  # compile-heavy: in the full suite (pytest -m ""), not the fast run
def test_cmux_batched(rng):
    p = TEST_PARAMS
    engine = get_engine("matmul")
    s, k = _keys(rng, p)
    k1, k2, k3 = jax.random.split(k, 3)
    B = 8
    bits0 = binary_array(k1, (B, p.N))
    bits1 = binary_array(jax.random.fold_in(k1, 7), (B, p.N))
    ct0 = trlwe.encrypt_binary_poly(k2, s, bits0, p, engine)
    ct1 = trlwe.encrypt_binary_poly(jax.random.fold_in(k2, 3), s, bits1, p, engine)
    sel = trgsw.encrypt_int(k3, s, jnp.asarray(1, I32), p, engine)
    prepared = engine.prepare_trgsw(sel, p)
    out = trgsw.cmux(prepared, ct1, ct0, p, engine)
    dec = trlwe.decrypt_binary_poly(out, s, p, engine)
    assert np.array_equal(np.asarray(dec), np.asarray(bits1))


@pytest.mark.parametrize("N", [256, 512])
def test_cmux_selects_n512(rng, N):
    """The reference's CMux is KNOWN BROKEN at N=512/256 after the spqlios
    introduction (commented-out test + TODO, trgsw.rs:425-456); the exact
    integer engines here are N-generic, so the same case must pass."""
    p = TEST_PARAMS.replace(N=N)
    engine = get_engine("matmul")
    s, k = _keys(rng, p)
    k1, k2, k3 = jax.random.split(k, 3)
    bits = binary_array(k1, (p.N,))
    ct0 = trlwe.encrypt_binary_poly(k2, s, bits, p, engine)
    ct1 = trlwe.encrypt_binary_poly(jax.random.fold_in(k2, 1), s, 1 - bits, p, engine)
    for item in (0, 1):
        sel = trgsw.encrypt_int(jax.random.fold_in(k3, item), s, jnp.asarray(item, I32), p, engine)
        prepared = engine.prepare_trgsw(sel, p)
        out = trgsw.cmux(prepared, ct1, ct0, p, engine)
        dec = trlwe.decrypt_binary_poly(out, s, p, engine)
        expect = (1 - bits) if item == 1 else bits
        assert np.array_equal(np.asarray(dec), np.asarray(expect)), N


def test_round_trip_item_types(rng):
    # All reference-supported TRGSW item types (trgsw.rs:17-21).
    p = TEST_PARAMS
    engine = get_engine("matmul")
    s, k = _keys(rng, p)

    bits = binary_array(jax.random.fold_in(k, 2), (p.N,))
    rep = trgsw.encrypt_binary_poly(jax.random.fold_in(k, 3), s, bits, p, engine)
    res = trgsw.decrypt_binary_poly(rep, s, p, engine)
    assert np.array_equal(np.asarray(res), np.asarray(bits))

    pol_u = jnp.asarray((np.arange(p.N) % 7).astype(np.uint32))
    rep = trgsw.encrypt_uint_poly(jax.random.fold_in(k, 4), s, pol_u, p, engine)
    res = trgsw.decrypt_uint_poly(rep, s, p, engine)
    assert np.array_equal(np.asarray(res), np.asarray(pol_u))

    rep = trgsw.encrypt_binary(jax.random.fold_in(k, 5), s, 1, p, engine)
    assert int(np.asarray(trgsw.decrypt_binary(rep, s, p, engine))) == 1
    rep = trgsw.encrypt_binary(jax.random.fold_in(k, 6), s, 0, p, engine)
    assert int(np.asarray(trgsw.decrypt_binary(rep, s, p, engine))) == 0
