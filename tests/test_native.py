"""Native library tests: exact C++ convolution vs the JAX/numpy oracles,
FFT path accuracy (reference-style 1e-6 torus tolerance, math.rs:904-952),
and the native levelizer vs the Python one."""

import numpy as np
import pytest

from rustfhe import native, poly
from rustfhe.apps.circuits import ripple_carry_adder


def test_native_available():
    # The image ships g++; the lib should build on demand.
    assert native.available(), "native library failed to build/load"


def test_exact_u32_conv_matches_oracle():
    rs = np.random.RandomState(0)
    N = 256
    a = rs.randint(0, 2**32, size=(N,), dtype=np.uint64).astype(np.uint32)
    b = rs.randint(-32, 32, size=(N,)).astype(np.int32)
    got = native.negacyclic_mul_u32_exact(a, b)
    want = (poly.negacyclic_mul_i64(a.astype(np.int64), b) % (1 << 32)).astype(np.uint32)
    assert np.array_equal(got, want)


def test_fft_f64_small_hand_case():
    # (1 + 2X)(3 + 4X) mod X^2+1 = -5 + 10X
    out = native.negacyclic_mul_f64_fft(np.array([1.0, 2.0]), np.array([3.0, 4.0]))
    assert np.allclose(out, [-5.0, 10.0], atol=1e-9)


def test_fft_torus_vs_exact_tolerance():
    # The f64 FFT path is approximate like the reference's spqlios engine;
    # reproduce the reference's fft_cross-vs-cross check at N=1024 with
    # torus tolerance 1e-6 (math.rs:904-952).
    rs = np.random.RandomState(1)
    N = 1024
    for _ in range(3):
        a = rs.randint(0, 2**32, size=(N,), dtype=np.uint64).astype(np.uint32)
        b = rs.randint(0, 2, size=(N,)).astype(np.int32)
        got = native.negacyclic_mul_torus_fft(a, b)
        want = native.negacyclic_mul_u32_exact(a, b)
        diff = (got - want).astype(np.uint32)
        wrap = np.minimum(diff.astype(np.int64), (1 << 32) - diff.astype(np.int64))
        assert (wrap.astype(np.float64) / 2**32).max() < 1e-6


def test_levelizer_matches_python():
    c = ripple_carry_adder(8)
    inputs3 = np.full((len(c.gates), 3), -1, np.int64)
    outputs = np.zeros(len(c.gates), np.int64)
    for g_idx, g in enumerate(c.gates):
        for t, w in enumerate(g.inputs):
            inputs3[g_idx, t] = w
        outputs[g_idx] = g.output
    levels, depth = native.levelize(len(c.gates), c.n_wires, c.n_inputs, inputs3, outputs)
    assert depth == c.depth
    # agreement with the Python levelizer
    py_layers = c.levelize()
    py_level = {}
    for lv, layer in enumerate(py_layers, start=1):
        for g in layer:
            py_level[g.output] = lv
    for g_idx, g in enumerate(c.gates):
        assert levels[g_idx] == py_level[g.output]
