"""Typed encrypted-integer API (ints.FheUint / FheInt): plaintext-consistency
tests at TEST_PARAMS.  Every op is checked against its numpy/Python model on
a batch of values (wrapping mod 2^width)."""

import jax
import numpy as np
import pytest

from rustfhe.context import TFHE
from rustfhe.ints import FheInt, FheUint
from rustfhe.params import TEST_PARAMS

W = 4
MASK = (1 << W) - 1


@pytest.fixture(scope="module")
def ctx():
    return TFHE.new(jax.random.PRNGKey(7), TEST_PARAMS, "matmul")


A_VALS = np.array([0, 1, 7, 11, 15, 9], np.uint64)
B_VALS = np.array([0, 15, 3, 11, 1, 2], np.uint64)


@pytest.fixture(scope="module")
def ab(ctx):
    return ctx.encrypt_uint(A_VALS, W), ctx.encrypt_uint(B_VALS, W)


def test_round_trip_uint(ctx):
    x = ctx.encrypt_uint(A_VALS, W)
    assert x.width == W and x.batch_shape == (len(A_VALS),)
    np.testing.assert_array_equal(x.decrypt(), A_VALS)


def test_round_trip_sint(ctx):
    vals = np.array([-8, -1, 0, 3, 7, -5], np.int64)
    x = ctx.encrypt_sint(vals, W)
    np.testing.assert_array_equal(x.decrypt(), vals)


def test_linear_ops_no_bootstrap(ctx):
    """NOT and plaintext shifts are linear plane ops."""
    x = ctx.encrypt_uint(A_VALS, W)
    np.testing.assert_array_equal((~x).decrypt(), (~A_VALS) & MASK)
    np.testing.assert_array_equal((x << 2).decrypt(), (A_VALS << 2) & MASK)
    np.testing.assert_array_equal((x >> 1).decrypt(), A_VALS >> 1)
    np.testing.assert_array_equal((x >> W).decrypt(), A_VALS * 0)


def test_arithmetic_shift_sint(ctx):
    vals = np.array([-8, -3, 5, -1], np.int64)
    x = ctx.encrypt_sint(vals, W)
    np.testing.assert_array_equal((x >> 1).decrypt(), vals >> 1)
    np.testing.assert_array_equal((x >> W).decrypt(), vals >> 63)


def test_add_sub(ab):
    a, b = ab
    np.testing.assert_array_equal((a + b).decrypt(), (A_VALS + B_VALS) & MASK)
    d, borrow = a.sub_with_borrow(b)
    np.testing.assert_array_equal(d.decrypt(), (A_VALS - B_VALS) & MASK)
    np.testing.assert_array_equal(
        np.asarray(a.ctx.decrypt(borrow)), (A_VALS < B_VALS).astype(np.uint32))
    np.testing.assert_array_equal((-a).decrypt(), (-A_VALS) & MASK)


def test_plaintext_mixing(ab):
    a, _ = ab
    np.testing.assert_array_equal((a + 3).decrypt(), (A_VALS + 3) & MASK)
    np.testing.assert_array_equal((10 - a).decrypt(), (10 - A_VALS) & MASK)
    np.testing.assert_array_equal((a ^ 5).decrypt(), A_VALS ^ 5)


def test_mul(ab):
    a, b = ab
    np.testing.assert_array_equal((a * b).decrypt(), (A_VALS * B_VALS) & MASK)
    full = a.mul_full(b)
    assert full.width == 2 * W
    np.testing.assert_array_equal(full.decrypt(), A_VALS * B_VALS)


def test_bitwise(ab):
    a, b = ab
    np.testing.assert_array_equal((a & b).decrypt(), A_VALS & B_VALS)
    np.testing.assert_array_equal((a | b).decrypt(), A_VALS | B_VALS)
    np.testing.assert_array_equal((a ^ b).decrypt(), A_VALS ^ B_VALS)


def test_compare_and_select(ab):
    a, b = ab
    dec = lambda ct: np.asarray(a.ctx.decrypt(ct), np.uint64)
    np.testing.assert_array_equal(dec(a.lt(b)), A_VALS < B_VALS)
    np.testing.assert_array_equal(dec(a.eq(b)), A_VALS == B_VALS)
    np.testing.assert_array_equal(dec(a.ge(b)), A_VALS >= B_VALS)
    np.testing.assert_array_equal(a.min_(b).decrypt(),
                                  np.minimum(A_VALS, B_VALS))
    np.testing.assert_array_equal(a.max_(b).decrypt(),
                                  np.maximum(A_VALS, B_VALS))


def test_signed_compare_abs(ctx):
    av = np.array([-8, -1, 0, 3, -5, 7], np.int64)
    bv = np.array([7, -1, -8, -3, -5, -7], np.int64)
    a = ctx.encrypt_sint(av, W)
    b = ctx.encrypt_sint(bv, W)
    dec = lambda ct: np.asarray(ctx.decrypt(ct), np.uint64)
    np.testing.assert_array_equal(dec(a.lt(b)), av < bv)
    np.testing.assert_array_equal(dec(a.eq(b)), av == bv)
    np.testing.assert_array_equal(a.min_(b).decrypt(), np.minimum(av, bv))
    # abs(-8) wraps to -8 at width 4 (two's complement), like Rust's
    # wrapping_abs.
    expect = np.abs(av)
    expect[av == -(1 << (W - 1))] = -(1 << (W - 1))
    np.testing.assert_array_equal(a.abs_().decrypt(), expect)


def test_width_extension(ctx):
    a = ctx.encrypt_uint(np.array([9, 3], np.uint64), W)
    b = ctx.encrypt_uint(np.array([200, 11], np.uint64), 8)
    np.testing.assert_array_equal((a + b).decrypt(), np.array([209, 14]))
    s = ctx.encrypt_sint(np.array([-3, 5], np.int64), W)
    t = ctx.encrypt_sint(np.array([-100, 100], np.int64), 8)
    np.testing.assert_array_equal((s + t).decrypt(), np.array([-103, 105]))


def test_divmod(ctx):
    av = np.array([13, 7, 15, 0, 9], np.uint64)
    bv = np.array([3, 7, 4, 5, 0], np.uint64)
    a = ctx.encrypt_uint(av, W)
    b = ctx.encrypt_uint(bv, W)
    q, r = a.divmod(b)
    # division by zero: q = 2^w - 1, r = a (TFHE-library convention)
    expect_q = np.where(bv == 0, MASK, av // np.where(bv == 0, 1, bv))
    expect_r = np.where(bv == 0, av, av % np.where(bv == 0, 1, bv))
    np.testing.assert_array_equal(q.decrypt(), expect_q)
    np.testing.assert_array_equal(r.decrypt(), expect_r)


def test_multidim_batch(ctx):
    vals = np.arange(6, dtype=np.uint64).reshape(2, 3)
    x = ctx.encrypt_uint(vals, W)
    y = ctx.encrypt_uint(vals[::-1], W)
    np.testing.assert_array_equal((x + y).decrypt(),
                                  (vals + vals[::-1]) & MASK)


def test_fheuint_mesh_sharded():
    """FheUint composes with the sharded evaluation path unchanged: a
    GateSession is a drop-in ctx, so every integer op runs its circuit
    levels data-sharded over the 8-virtual-device mesh."""
    from rustfhe.ints import FheUint
    from rustfhe.parallel.multihost import GateSession

    sess = GateSession(jax.random.PRNGKey(5), TEST_PARAMS, "matmul", model=2)
    rs = np.random.RandomState(11)
    av = rs.randint(0, 8, size=16).astype(np.uint64)
    bv = rs.randint(0, 8, size=16).astype(np.uint64)
    a = FheUint.encrypt(sess, av, 3)
    b = FheUint.encrypt(sess, bv, 3)
    np.testing.assert_array_equal((a + b).decrypt(), (av + bv) & 7)
    np.testing.assert_array_equal((a ^ b).decrypt(), av ^ bv)
    np.testing.assert_array_equal(a.min_(b).decrypt(), np.minimum(av, bv))


def test_rotations(ctx):
    x = ctx.encrypt_uint(A_VALS, W)
    rotl = lambda v, k: ((v << np.uint64(k)) | (v >> np.uint64(W - k))) & MASK
    np.testing.assert_array_equal(x.rotl(1).decrypt(), rotl(A_VALS, 1))
    np.testing.assert_array_equal(x.rotr(3).decrypt(), rotl(A_VALS, 1))
    np.testing.assert_array_equal(x.rotl(0).decrypt(), A_VALS)
    np.testing.assert_array_equal(x.rotl(W + 2).decrypt(), rotl(A_VALS, 2))


def test_signed_mul_full(ctx):
    """FheInt.mul_full sign-extends: the full 2w-bit product of signed
    values is the signed product, not the unsigned-array one (which gave
    e.g. (-1) * 2 -> 30 at width 4)."""
    av = np.array([-1, -8, 3, -5, 7], np.int64)
    bv = np.array([2, -8, -3, 5, 7], np.int64)
    a = ctx.encrypt_sint(av, W)
    b = ctx.encrypt_sint(bv, W)
    full = a.mul_full(b)
    assert full.width == 2 * W
    np.testing.assert_array_equal(full.decrypt(), av * bv)


def test_operand_type_errors(ctx, ab):
    """Named methods raise TypeError on unsupported operand types; dunder
    operators defer via NotImplemented (surfacing as TypeError from
    Python); FheUint/FheInt never silently mix."""
    a, _ = ab
    s = ctx.encrypt_sint(np.zeros(len(A_VALS), np.int64), W)
    with pytest.raises(TypeError):
        a.lt(1.5)
    with pytest.raises(TypeError):
        a.min_("nope")
    with pytest.raises(TypeError):
        a + 1.5  # dunder -> NotImplemented -> Python TypeError
    with pytest.raises(TypeError):
        a + s  # unsigned/signed mix is an explicit error, not an assert


def test_wide_plaintext_coercion(ctx):
    """Plaintext operands with bits above 32 coerce exactly (the old
    uint32 constant path silently dropped them)."""
    wide = 40
    big = (1 << 39) | (1 << 35) | 5
    x = ctx.encrypt_uint(np.array([0, (1 << 40) - 1], np.uint64), wide)
    np.testing.assert_array_equal(
        (x ^ big).decrypt(),
        np.array([big, ((1 << 40) - 1) ^ big], np.uint64))


def test_width64_sint_round_trip(ctx):
    """decrypt at width 64 reinterprets uint64 as two's complement instead
    of computing an out-of-range 1 << 64 shift."""
    vals = np.array([-1, -(1 << 63), (1 << 63) - 1, 42], np.int64)
    x = ctx.encrypt_sint(vals, 64)
    np.testing.assert_array_equal(x.decrypt(), vals)


def test_signed_divmod(ctx):
    """Truncated signed division (C/Rust): q toward zero, r follows a;
    div-by-zero: q = -sign(a) interpretation (-1 / +1), r = a."""
    av = np.array([7, -7, 7, -7, -8, 5], np.int64)
    bv = np.array([2, 2, -2, -2, 3, 0], np.int64)
    a = ctx.encrypt_sint(av, W)
    b = ctx.encrypt_sint(bv, W)
    q, r = a.divmod(b)
    safe = np.where(bv == 0, 1, bv)
    eq = np.fix(av / safe).astype(np.int64)
    er = av - eq * safe
    eq = np.where(bv == 0, np.where(av < 0, 1, -1), eq)
    er = np.where(bv == 0, av, er)
    np.testing.assert_array_equal(q.decrypt(), eq)
    np.testing.assert_array_equal(r.decrypt(), er)
