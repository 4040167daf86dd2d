"""fft64 engine: exact f64-FFT convolution (the CPU-validation engine).

Engine invariant (CLAUDE.md): exact equality vs OracleEngine on the
adversarial probe set before being selectable — the same gate every other
engine passes (tests/test_poly.py pattern).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rustfhe.engine import (
    engine_probe_result,
    get_engine,
    probe_vectors,
    select_fast_engine,
)
from rustfhe.params import DEFAULT_PARAMS, PBS_PARAMS, TEST_PARAMS


@pytest.fixture
def x64():
    """Enable float64/complex128 for the test (restored afterwards; the jit
    cache keys on the flag, so other tests' compilations are unaffected)."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


@pytest.mark.parametrize("params", [TEST_PARAMS, DEFAULT_PARAMS, PBS_PARAMS],
                         ids=["test", "default", "pbs"])
def test_exact_vs_oracle_on_probe(x64, params):
    rows, digits = probe_vectors(params)
    rows_j, dig_j = jnp.asarray(rows), jnp.asarray(digits)
    oracle = get_engine("oracle")
    want = np.asarray(
        oracle.external_product_digits(
            oracle.prepare_trgsw(rows_j, params), dig_j, params
        )
    )
    ok, why = engine_probe_result(get_engine("fft64"), params, rows_j, dig_j, want)
    assert ok, why


def test_poly_mul_torus_binary_exact(x64):
    p = DEFAULT_PARAMS
    rs = np.random.RandomState(3)
    a = jnp.asarray(
        rs.randint(0, 2**32, size=(5, p.N), dtype=np.uint64).astype(np.uint32)
    )
    s = jnp.asarray(rs.randint(0, 2, size=(p.N,)).astype(np.uint32))
    got = np.asarray(get_engine("fft64").poly_mul_torus_binary(a, s, p))
    want = np.asarray(get_engine("oracle").poly_mul_torus_binary(a, s, p))
    assert np.array_equal(got, want)


def test_selected_on_cpu_with_x64(x64):
    # On CPU with x64 enabled the probe-gated cascade must land on fft64
    # (it is ~10x cheaper per blind-rotate step than the circulant matmul).
    assert select_fast_engine(TEST_PARAMS) == "fft64"


def test_raises_without_x64():
    assert not jax.config.jax_enable_x64
    p = TEST_PARAMS
    rows, _ = probe_vectors(p)
    with pytest.raises(RuntimeError, match="x64"):
        get_engine("fft64").prepare_trgsw(jnp.asarray(rows), p)
    # ...and the auto-selection never offers it without x64.
    assert select_fast_engine(p) != "fft64"


def test_full_gate_on_fft64(x64):
    """End-to-end NAND at TEST_PARAMS through the fft64 engine."""
    from rustfhe import gates, keys, tlwe

    p = TEST_PARAMS
    kg, ke = jax.random.split(jax.random.PRNGKey(5))
    sk, ck = keys.gen_keys(kg, p, engine_name="fft64")
    bits = jnp.asarray(np.array([0, 0, 1, 1], np.uint32))
    other = jnp.asarray(np.array([0, 1, 0, 1], np.uint32))
    k1, k2 = jax.random.split(ke)
    cx = tlwe.encrypt_binary(k1, sk.lv0, bits, p)
    cy = tlwe.encrypt_binary(k2, sk.lv0, other, p)
    out = gates.hom_nand(ck, cx, cy, params=p, engine_name="fft64")
    dec = np.asarray(tlwe.decrypt_binary(out, sk.lv0))
    assert np.array_equal(dec, 1 - (np.asarray(bits) & np.asarray(other)))
