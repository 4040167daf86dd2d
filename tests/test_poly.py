"""Negacyclic polynomial op tests: rotate golden vectors
(``utils/src/math.rs:75-84,894-903``), naive-product hand values
(math.rs:725-864 flavor), and engine-vs-oracle exact equivalence — the
analogue of the reference's fft_cross-vs-cross test (math.rs:904-952)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rustfhe import poly
from rustfhe.engine import get_engine
from rustfhe.params import TFHEParams

U32 = jnp.uint32
I32 = jnp.int32


def test_rotate_golden():
    p = jnp.array([1, 2, 3, 4, 5], I32)
    cases = {
        1: [-5, 1, 2, 3, 4],
        3: [-3, -4, -5, 1, 2],
        -1: [2, 3, 4, 5, -1],
        -3: [4, 5, -1, -2, -3],
        5: [-1, -2, -3, -4, -5],
        -4: [5, -1, -2, -3, -4],
        10: [1, 2, 3, 4, 5],
    }
    for n, expect in cases.items():
        got = list(np.asarray(poly.rotate(p, n)))
        assert got == expect, (n, got, expect)
    # rotate(-8) == rotate(2) (math.rs:82)
    assert np.array_equal(np.asarray(poly.rotate(p, -8)), np.asarray(poly.rotate(p, 2)))


def test_rotate_batched_per_item():
    rs = np.random.RandomState(0)
    p = jnp.asarray(rs.randint(0, 2**32, size=(8, 16), dtype=np.uint64).astype(np.uint32))
    ns = jnp.array([0, 1, 5, 16, 17, 31, 32, 3], I32)
    out = poly.rotate(p, ns)
    for b in range(8):
        single = poly.rotate(p[b], int(ns[b]))
        assert np.array_equal(np.asarray(out[b]), np.asarray(single))


def test_rotate_uint_wraps_sign():
    # negation of unsigned coefficients must be mod-2^32 two's complement.
    p = jnp.array([1, 0, 0, 0], U32)
    out = np.asarray(poly.rotate(p, 4))  # X^N * p == -p
    assert out[0] == 0xFFFFFFFF


def test_naive_negacyclic_hand_values():
    # (1 + 2X)(3 + 4X) over Z[X]/(X^2+1) = 3 + 10X + 8X^2 = -5 + 10X
    a = jnp.array([1, 2], I32)
    b = jnp.array([3, 4], I32)
    got = list(poly.negacyclic_mul_i64(np.asarray(a), np.asarray(b)))
    assert got == [-5, 10]
    # X * X == -1 at N=2
    a = jnp.array([0, 1], I32)
    got = list(poly.negacyclic_mul_i64(np.asarray(a), np.asarray(a)))
    assert got == [-1, 0]


def test_torus_oracle_matches_i64_mod32():
    rs = np.random.RandomState(1)
    N = 32
    a = rs.randint(0, 2**32, size=(N,), dtype=np.uint64).astype(np.uint32)
    b = rs.randint(-32, 32, size=(N,)).astype(np.int32)
    got = np.asarray(poly.negacyclic_mul_torus_oracle(jnp.asarray(a), jnp.asarray(b)))
    exact = poly.negacyclic_mul_i64(a.astype(np.int64), b)
    assert np.array_equal(got, (exact % (1 << 32)).astype(np.uint32))


def test_signed_limbs_round_trip():
    rs = np.random.RandomState(2)
    xs = jnp.asarray(rs.randint(0, 2**32, size=(1000,), dtype=np.uint64).astype(np.uint32))
    for bits in (8, 4):
        limbs = poly.to_signed_limbs(xs, bits, 32 // bits)
        assert int(jnp.max(jnp.abs(limbs.astype(I32)))) <= 1 << (bits - 1)
        back = poly.from_signed_limbs(limbs, bits)
        assert np.array_equal(np.asarray(back), np.asarray(xs))


@pytest.mark.parametrize("engine_name", ["matmul", "matmul_bf16"])
def test_poly_mul_engine_vs_oracle(engine_name):
    params = TFHEParams(n=16, N=64)
    eng = get_engine(engine_name)
    oracle = get_engine("oracle")
    rs = np.random.RandomState(3)
    a = jnp.asarray(rs.randint(0, 2**32, size=(5, 64), dtype=np.uint64).astype(np.uint32))
    s = jnp.asarray(rs.randint(0, 2, size=(64,)).astype(np.uint32))
    got = eng.poly_mul_torus_binary(a, s, params)
    want = oracle.poly_mul_torus_binary(a, s, params)
    assert np.array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("engine_name", ["matmul", "matmul_bf16"])
def test_external_product_engine_vs_oracle(engine_name):
    params = TFHEParams(n=16, N=64)
    eng = get_engine(engine_name)
    oracle = get_engine("oracle")
    rs = np.random.RandomState(4)
    rows = jnp.asarray(
        rs.randint(0, 2**32, size=(2 * params.l, 2, params.N), dtype=np.uint64).astype(np.uint32)
    )
    digits = jnp.asarray(
        rs.randint(-params.half_bg, params.half_bg, size=(3, 2 * params.l, params.N)).astype(
            np.int32
        )
    )
    got = eng.external_product_digits(eng.prepare_trgsw(rows, params), digits, params)
    want = oracle.external_product_digits(oracle.prepare_trgsw(rows, params), digits, params)
    assert np.array_equal(np.asarray(got), np.asarray(want))


def test_rotate_binary_matches_rotate():
    rs = np.random.RandomState(7)
    p = jnp.asarray(rs.randint(0, 2**32, size=(6, 2, 32), dtype=np.uint64).astype(np.uint32))
    ns = jnp.asarray(rs.randint(0, 64, size=(6, 1)).astype(np.int32))
    got = poly.rotate_binary(p, ns)
    want = poly.rotate(p, ns)
    assert np.array_equal(np.asarray(got), np.asarray(want))
    # signed dtype too
    q = jnp.asarray(rs.randint(-100, 100, size=(4, 16)).astype(np.int32))
    ms = jnp.asarray(rs.randint(0, 32, size=(4,)).astype(np.int32))
    assert np.array_equal(
        np.asarray(poly.rotate_binary(q, ms)),
        np.asarray(poly.rotate(q, ms)),
    )


class _EdgeBrokenEngine:
    """Deliberately broken engine: wrong ONLY where a most-negative digit
    (-half_bg) multiplies a row byte equal to 0x80 — the limb sign-overflow
    edge a single random probe sample catches only with ~50% probability at
    N=1024 (P(per-position) = 1/Bg * 1/256).  The adversarial probe set must
    catch it deterministically."""

    name = "edge_broken"

    def __init__(self):
        from rustfhe.engine import get_engine

        self._oracle = get_engine("oracle")

    def prepare_trgsw(self, rows, params):
        return self._oracle.prepare_trgsw(rows, params)

    def external_product_digits(self, prepared, digits, params):
        out = self._oracle.external_product_digits(prepared, digits, params)
        # Inject the edge fault: if any (digit == -half_bg, row byte == 0x80)
        # pair exists, corrupt the first output coefficient.
        rows_bytes = np.asarray(prepared).view(np.uint8)
        has_edge_row = bool((rows_bytes == 0x80).any())
        has_edge_digit = bool((np.asarray(digits) == -params.half_bg).any())
        if has_edge_row and has_edge_digit:
            out = out.at[..., 0, 0].add(jnp.uint32(1))
        return out


def test_probe_vectors_catch_edge_broken_engine():
    from rustfhe.engine import engine_exact_on_probe, get_engine, probe_vectors

    params = TFHEParams(n=16, N=64)
    rows, digits = probe_vectors(params)
    rows_j, digits_j = jnp.asarray(rows), jnp.asarray(digits)
    oracle = get_engine("oracle")
    want = oracle.external_product_digits(
        oracle.prepare_trgsw(rows_j, params), digits_j, params
    )
    assert engine_exact_on_probe(get_engine("matmul"), params, rows_j, digits_j, want)
    assert not engine_exact_on_probe(_EdgeBrokenEngine(), params, rows_j, digits_j, want)
    # The probe set must contain both edge triggers by construction.
    assert (np.asarray(rows).view(np.uint8) == 0x80).any()
    assert (digits == -params.half_bg).any()


def test_probe_result_distinguishes_failure_causes():
    """engine_probe_result reports WHY a probe failed: an engine that ran
    but was inexact reads 'INEXACT'; one that cannot run is not judged at
    all — its error propagates (selection never chooses by catching it)."""
    from rustfhe.engine import engine_probe_result, get_engine, probe_vectors

    params = TFHEParams(n=16, N=64)
    rows, digits = probe_vectors(params)
    rows_j, digits_j = jnp.asarray(rows), jnp.asarray(digits)
    oracle = get_engine("oracle")
    want = oracle.external_product_digits(
        oracle.prepare_trgsw(rows_j, params), digits_j, params
    )
    ok, why = engine_probe_result(get_engine("matmul"), params, rows_j, digits_j, want)
    assert ok and why == "exact"
    ok, why = engine_probe_result(_EdgeBrokenEngine(), params, rows_j, digits_j, want)
    assert not ok and "INEXACT" in why

    class _Crashing:
        name = "crashing"

        def prepare_trgsw(self, rows, params):
            raise RuntimeError("lowering failed: simulated")

        def external_product_digits(self, prepared, digits, params):
            raise AssertionError("unreachable")

    with pytest.raises(RuntimeError, match="simulated"):
        engine_probe_result(_Crashing(), params, rows_j, digits_j, want)
