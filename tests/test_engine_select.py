"""Engine selection: per-platform candidate order, the override, the host
reference the probe compares against, and the blind rotation every engine
runs through."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rustfhe import bootstrap, engine as E
from rustfhe.params import DEFAULT_PARAMS, PBS_TEST_PARAMS, TEST_PARAMS

U32 = jnp.uint32


@pytest.fixture
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


@pytest.mark.parametrize("platform,want", [
    ("cpu", ("matmul", "matmul_bf16")),
    ("gpu", ("matmul", "matmul_bf16")),
])
def test_candidate_order_without_x64(platform, want):
    assert not jax.config.jax_enable_x64
    assert E.candidate_engines(platform) == want


@pytest.mark.parametrize("platform,want", [
    ("cpu", ("fft64", "matmul", "matmul_bf16")),
    ("gpu", ("matmul", "fft64", "matmul_bf16")),
])
def test_candidate_order_with_x64(x64, platform, want):
    assert E.candidate_engines(platform) == want


def test_unknown_platform_raises(monkeypatch):
    with pytest.raises(ValueError, match="no engine candidates"):
        E.candidate_engines("metal")
    monkeypatch.setattr(jax, "devices", lambda *a: [SimpleNamespace(platform="metal")])
    with pytest.raises(ValueError, match="no engine candidates"):
        E.select_fast_engine(TEST_PARAMS)


def test_select_on_cpu_without_x64():
    assert E.select_fast_engine(TEST_PARAMS) == "matmul"


def test_override_naming_removed_engine_fails_clearly(monkeypatch):
    monkeypatch.setenv("RUSTFHE_ENGINE", "pallas_k2")
    with pytest.raises(ValueError, match="'pallas_k2' names no registered engine"):
        E.select_fast_engine(TEST_PARAMS)


def test_override_exact_engine_is_returned(monkeypatch):
    monkeypatch.setenv("RUSTFHE_ENGINE", "matmul_bf16")
    assert E.select_fast_engine(TEST_PARAMS) == "matmul_bf16"


class _OffByOne:
    """Runs, but adds 1 to every output word: inexact."""

    name = "off_by_one"

    def prepare_trgsw(self, rows, params):
        return E.get_engine("matmul").prepare_trgsw(rows, params)

    def external_product_digits(self, prepared, digits, params):
        out = E.get_engine("matmul").external_product_digits(prepared, digits, params)
        return (out + U32(1)).astype(U32)


def test_override_inexact_engine_raises(monkeypatch):
    monkeypatch.setitem(E._ENGINES, "off_by_one", _OffByOne())
    monkeypatch.setenv("RUSTFHE_ENGINE", "off_by_one")
    with pytest.raises(RuntimeError, match="failed the oracle probe.*INEXACT"):
        E.select_fast_engine(TEST_PARAMS)


@pytest.mark.parametrize("params", [TEST_PARAMS, PBS_TEST_PARAMS, DEFAULT_PARAMS],
                         ids=["test", "pbs_test", "default"])
def test_host_reference_matches_oracle_engine(params):
    rows, digits = E.probe_vectors(params)
    oracle = E.get_engine("oracle")
    want = np.asarray(oracle.external_product_digits(
        oracle.prepare_trgsw(jnp.asarray(rows), params), jnp.asarray(digits), params))
    got = E.oracle_external_product_np(rows, digits)
    assert got.dtype == np.uint32 and got.shape == want.shape
    assert np.array_equal(got, want)


def _rotation_inputs(params, seed):
    rs = np.random.RandomState(seed)
    ct = rs.randint(0, 2**32, size=(5, params.n + 1), dtype=np.uint64).astype(np.uint32)
    bk = rs.randint(0, 2**32, size=(params.n, 2 * params.l, 2, params.N),
                    dtype=np.uint64).astype(np.uint32)
    tv = rs.randint(0, 2**32, size=(2, params.N), dtype=np.uint64).astype(np.uint32)
    return jnp.asarray(ct), jnp.asarray(bk), jnp.asarray(tv)


def _rotate(name, params, ct, bk, tv):
    eng = E.get_engine(name)
    return np.asarray(bootstrap.blind_rotate(ct, eng.prepare_trgsw(bk, params), tv,
                                             params, eng))


@pytest.mark.parametrize("name", ["matmul", "fft64"])
def test_blind_rotate_equals_oracle_engine(x64, name):
    """The scan over cmux_step is bit-exact against the oracle engine on
    random key material (every word mod 2^32, not just decoded bits)."""
    p = TEST_PARAMS
    ct, bk, tv = _rotation_inputs(p, 12)
    want = _rotate("oracle", p, ct, bk, tv)
    got = _rotate(name, p, ct, bk, tv)
    assert got.dtype == np.uint32
    assert np.array_equal(got, want)


def test_blind_rotate_is_a_chain_of_cmux_steps():
    """blind_rotate == the initial X^{-b~} rotation then cmux_step per key bit."""
    from rustfhe import poly, tlwe

    p = TEST_PARAMS
    ct, bk, tv = _rotation_inputs(p, 13)
    eng = E.get_engine("matmul")
    prep = eng.prepare_trgsw(bk, p)
    shift = 32 - p.nbit - 1
    b = (tlwe.body(ct) >> U32(shift)).astype(jnp.int32)
    a = ((tlwe.mask(ct) + U32(1 << (shift - 1))) >> U32(shift)).astype(jnp.int32)
    acc = poly.rotate_binary(tv, jnp.mod(-b, 2 * p.N)[..., None])
    for i in range(p.n):
        acc = bootstrap.cmux_step(acc, prep[i], a[..., i], p, eng)
    want = np.asarray(bootstrap.blind_rotate(ct, prep, tv, p, eng))
    assert np.array_equal(np.asarray(acc), want)
