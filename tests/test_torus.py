"""Torus32 codec tests: bit patterns per the reference's decimal suites
(``utils/src/math.rs:987-1046``) and encode/decode round trips."""

import jax.numpy as jnp
import numpy as np

from rustfhe import torus

U32 = jnp.uint32


def enc(f):
    return int(np.asarray(torus.from_double(jnp.float32(f))))


def test_from_float_bit_patterns():
    # math.rs:994-998
    assert enc(0.5) == 1 << 31
    assert enc(0.25) == 1 << 30
    assert enc(0.125) == 1 << 29
    assert enc(-0.5) == 1 << 31
    assert enc(-0.25) == (1 << 30) + (1 << 31)


def test_to_float_round_trip():
    # math.rs:1014-1029
    for f, g in [(0.5, 0.5), (0.25, 0.25), (-0.25, 0.75), (0.4, 0.4),
                 (0.123, 0.123), (3.1, 0.1)]:
        got = float(np.asarray(torus.to_double(torus.from_double(jnp.float32(f)))))
        assert abs(got - g) < 1e-6, (f, got, g)
    # tiny values collapse toward 0
    got = float(np.asarray(torus.to_double(torus.from_double(jnp.float32(1e-10)))))
    assert got < 1e-6


def test_binary_encoding():
    # tlwe.rs:181-186: One -> +1/8, Zero -> -1/8.
    assert int(np.asarray(torus.binary_to_torus(1))) == 0x20000000
    assert int(np.asarray(torus.binary_to_torus(0))) == 0xE0000000


def test_binary_decode_threshold():
    # tlwe.rs:187-195: fraction < 0.5 decodes to One.
    assert int(np.asarray(torus.torus_to_binary(U32(0x20000000)))) == 1
    assert int(np.asarray(torus.torus_to_binary(U32(0xE0000000)))) == 0
    assert int(np.asarray(torus.torus_to_binary(U32(0x7FFFFFFF)))) == 1
    assert int(np.asarray(torus.torus_to_binary(U32(0x80000000)))) == 0


def test_wrapping_arithmetic():
    # math.rs:1047-1074 flavor: ring ops wrap mod 1.
    a = torus.from_double(jnp.float32(0.75))
    b = torus.from_double(jnp.float32(0.5))
    s = (a + b).astype(U32)
    assert abs(float(np.asarray(torus.to_double(s))) - 0.25) < 1e-6
    # scalar mul wraps: 0.75 * 4 == 0.0
    m = (a * U32(4)).astype(U32)
    assert float(np.asarray(torus.to_double(m))) < 1e-6


def test_pow_two_minus():
    # math.rs:622-636
    assert torus.pow_two_minus(1) == 1 << 31
    assert torus.pow_two_minus(0) == 0
    assert torus.pow_two_minus(32) == 1
    assert torus.pow_two_minus(31) == 2


def test_is_in_wrapping_distance():
    # math.rs:617-621: approx-compare respects the torus wraparound.
    a = jnp.array([0x00000000, 0xFFFFFFF0, 0x80000000, 0x40000000], U32)
    b = jnp.array([0x00000010, 0x00000010, 0x80000100, 0xC0000000], U32)
    got = np.asarray(torus.is_in(a, b, radius_pow=10))
    # distances: 0x10 (tiny), 0x20 across the wrap (tiny), 0x100 (tiny), 0.5 (max)
    assert got.tolist() == [True, True, True, False]
    assert not bool(torus.is_in(jnp.uint32(0), jnp.uint32(1 << 22), 10))
    assert bool(torus.is_in(jnp.uint32(0), jnp.uint32((1 << 22) - 1), 10))
