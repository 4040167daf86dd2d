"""Golden-vector tests for gadget decomposition.

Vectors reproduce the reference's ``decimal_decomposition`` suite
(``utils/src/math.rs:1206-1273``) digit-for-digit, plus the polynomial-wide
form (``math.rs:866-893``) and mask-constant checks.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from rustfhe import decomp
from rustfhe.params import DEFAULT_PARAMS, TFHEParams

U32 = jnp.uint32


def sdec(x, bits, l):
    """decomposition_i32 semantics: inline mask (math.rs:581-593)."""
    mask = decomp.make_decomp_mask_inline(l, bits)
    return np.asarray(decomp.decompose_signed_custom(U32(x), bits, l, mask))


def udec(x, bits, l):
    return np.asarray(decomp.decompose_unsigned_custom(U32(x), bits, l))


def test_mask_constants():
    # Production mask for (l=3, bits=6): double-added 2^13 -> 2^14 | 2^19 | 2^25
    assert DEFAULT_PARAMS.decomp_mask == (1 << 14) | (1 << 19) | (1 << 25)
    # Inline mask: textbook half-ulp bits.
    assert decomp.make_decomp_mask_inline(3, 6) == (1 << 13) | (1 << 19) | (1 << 25)


def test_decomposition_u32_half():
    # math.rs:1208-1217
    res = udec(0x80000000, 1, 32)
    assert res[0] == 1 and np.all(res[1:] == 0)


def test_decomposition_i32_half():
    # math.rs:1218-1226
    res = sdec(0x80000000, 1, 32)
    assert res[0] == -1 and np.all(res[1:] == 0)
    # math.rs:1228-1233
    assert list(sdec(0x80000000, 4, 8)) == [-8, 0, 0, 0, 0, 0, 0, 0]
    # math.rs:1234-1239
    assert list(sdec(0x80000000, 4, 7)) == [-8, 0, 0, 0, 0, 0, 0]


def test_decomposition_rounding_carry():
    # math.rs:1241-1260: 0x8000_0001, 31 one-bit digits, rounding carries.
    res = udec(0x80000001, 1, 31)
    assert res[0] == 1 and np.all(res[1:30] == 0) and res[30] == 1
    res = sdec(0x80000001, 1, 31)
    assert res[0] == 0 and np.all(res[1:] == -1)


def test_decomposition_production_shape():
    # math.rs:1262-1272: the (bits=6, l=3) cases.
    x = 0b00000100001000001100000000000000
    assert list(sdec(x, 6, 3)) == [1, 2, 3]
    x = 0b00000100001000001110000000000000
    assert list(sdec(x, 6, 3)) == [1, 2, 4]
    x = 0b01111110000010000000000010000000
    assert list(sdec(x, 6, 3)) == [-32, -31, -32]


def test_polynomial_decomposition_matches_scalar():
    # math.rs:866-893: polynomial decomposition == per-coefficient scalar.
    xs = np.array([0x00000001, 0x00028000], dtype=np.uint32)
    mask = decomp.make_decomp_mask_inline(2, 16)
    d = np.asarray(decomp.decompose_signed_custom(jnp.asarray(xs), 16, 2, mask))
    assert list(d[0]) == [0, 1]
    assert list(d[1]) == [3, -32768]


def test_digit_range_and_recompose():
    p = DEFAULT_PARAMS
    rs = np.random.RandomState(0)
    xs = jnp.asarray(rs.randint(0, 2**32, size=(4096,), dtype=np.uint64).astype(np.uint32))
    d = decomp.decompose_signed(xs, p)
    assert int(d.min()) >= -p.half_bg
    assert int(d.max()) < p.half_bg
    r = decomp.recompose_signed(d, p)
    diff = (xs - r).astype(U32)
    wrap = np.minimum(np.asarray(diff), np.asarray((~diff + U32(1)).astype(U32)))
    # Residual below the last digit is < 2^14 and the production mask's
    # full-ulp rounding bias adds up to another 2^14: bound 2^15.
    assert wrap.max() <= (1 << 15)


def test_unsigned_digits_range():
    p = DEFAULT_PARAMS
    rs = np.random.RandomState(1)
    xs = jnp.asarray(rs.randint(0, 2**32, size=(1024,), dtype=np.uint64).astype(np.uint32))
    d = decomp.decompose_unsigned(xs, p)
    assert int(d.max()) < p.iks_t
    assert d.shape == (1024, p.iks_l)
