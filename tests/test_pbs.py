"""Programmable bootstrapping tests: encode/decode exactness, end-to-end
LUT evaluation through the real blind-rotate scan, per-row multi-LUT
batching, chaining, and the noise-budget space check.

The reference has no PBS; these tests pin the NEW capability against the
same machinery its gate tests use (TEST_PARAMS, matmul engine, CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rustfhe import keys, pbs, tlwe
from rustfhe.context import TFHE
from rustfhe.params import DEFAULT_PARAMS, TEST_PARAMS

U32 = jnp.uint32

SPACE = 4  # at TEST_PARAMS (N=64, n=16) the bucket margin is ~6.6 sigma


@pytest.fixture(scope="module")
def setup():
    p = TEST_PARAMS
    key = jax.random.PRNGKey(11)
    kg, ke = jax.random.split(key)
    sk, ck = keys.gen_keys(kg, p, engine_name="matmul")
    return p, sk, ck, ke


# --------------------------- codec exactness --------------------------- #
def test_encode_decode_roundtrip_exact():
    for space in (2, 4, 8, 64):
        xs = jnp.arange(2 * space, dtype=U32)
        enc = pbs.encode_int(xs, space)
        assert enc.dtype == jnp.uint32
        # exact staircase: x * 2^32 / (2*space)
        assert np.array_equal(
            np.asarray(enc), (np.arange(2 * space, dtype=np.uint64) * ((1 << 32) // (2 * space))).astype(np.uint32)
        )
        assert np.array_equal(np.asarray(pbs.decode_int(enc, space)), np.asarray(xs))


def test_decode_tolerates_noise_within_half_bucket():
    space = 4
    enc = pbs.encode_int(jnp.arange(space, dtype=U32), space)
    half = (1 << 32) // (4 * space)
    up = pbs.decode_int(enc + U32(half - 1), space)
    down = pbs.decode_int(enc - U32(half), space)
    assert np.array_equal(np.asarray(up), np.arange(space))
    assert np.array_equal(np.asarray(down), np.arange(space))
    # wrap: 0 minus noise decodes back to 0, not to the top bucket
    z = pbs.decode_int(pbs.encode_int(jnp.array(0, U32), space) - U32(half), space)
    assert int(z) == 0


def test_encode_wraps_mod_2space():
    space = 4
    assert int(pbs.encode_int(jnp.array(-1, jnp.int32), space)) == int(
        pbs.encode_int(jnp.array(2 * space - 1, U32), space)
    )


def test_space_validation():
    with pytest.raises(ValueError):
        pbs.encrypt_int(jax.random.PRNGKey(0), jnp.zeros((16,), U32), 0, 3, TEST_PARAMS)
    with pytest.raises(ValueError):
        pbs.lut_testvec(jnp.zeros((4,)), 4, TEST_PARAMS.replace(N=2))
    with pytest.raises(ValueError):
        pbs.lut_testvec(jnp.zeros((8,)), 4, TEST_PARAMS)  # table/space mismatch


# ----------------------- encrypted round trips ------------------------- #
def test_encrypt_decrypt_int_roundtrip(setup):
    p, sk, ck, ke = setup
    xs = jnp.arange(SPACE, dtype=U32)
    ct = pbs.encrypt_int(jax.random.fold_in(ke, 0), sk.lv0, xs, SPACE, p)
    dec = np.asarray(pbs.decrypt_int(ct, sk.lv0, SPACE))
    assert np.array_equal(dec, np.asarray(xs))


def test_lut_testvec_staircase():
    p = TEST_PARAMS
    table = jnp.array([3, 0, 2, 1], U32)
    tv = pbs.lut_testvec(table, 4, p)
    assert tv.shape == (2, p.N)
    reps = p.N // 4
    want = np.repeat(np.asarray(pbs.encode_int(table, 4)), reps)
    assert np.array_equal(np.asarray(tv[0]), want)
    assert not np.asarray(tv[1]).any()


# --------------------------- end-to-end PBS ---------------------------- #
def test_pbs_arbitrary_table(setup):
    p, sk, ck, ke = setup
    table = jnp.array([2, 0, 3, 3], U32)  # arbitrary, non-monotone, repeats
    xs = jnp.tile(jnp.arange(SPACE, dtype=U32), 4)  # every input, batched
    ct = pbs.encrypt_int(jax.random.fold_in(ke, 1), sk.lv0, xs, SPACE, p)
    out = pbs.pbs(ck, ct, table, space=SPACE, params=p, engine_name="matmul")
    assert out.shape == ct.shape
    dec = np.asarray(pbs.decrypt_int(out, sk.lv0, SPACE))
    assert np.array_equal(dec, np.asarray(table)[np.asarray(xs)])


def test_pbs_multi_lut_per_row(setup):
    # a DIFFERENT function per batch row in one fused program
    p, sk, ck, ke = setup
    rng = np.random.default_rng(3)
    tables = jnp.asarray(rng.integers(0, SPACE, size=(8, SPACE)), U32)
    xs = jnp.asarray(rng.integers(0, SPACE, size=(8,)), U32)
    ct = pbs.encrypt_int(jax.random.fold_in(ke, 2), sk.lv0, xs, SPACE, p)
    out = pbs.pbs(ck, ct, tables, space=SPACE, params=p, engine_name="matmul")
    dec = np.asarray(pbs.decrypt_int(out, sk.lv0, SPACE))
    want = np.asarray(tables)[np.arange(8), np.asarray(xs)]
    assert np.array_equal(dec, want)


def test_pbs_chains_and_resets_noise(setup):
    # g(f(x)) via two chained PBS calls: outputs are valid fresh-ish inputs
    p, sk, ck, ke = setup
    f = jnp.array([1, 2, 3, 0], U32)  # +1 mod 4
    g = jnp.array([0, 3, 2, 1], U32)  # negate mod 4
    xs = jnp.arange(SPACE, dtype=U32)
    ct = pbs.encrypt_int(jax.random.fold_in(ke, 4), sk.lv0, xs, SPACE, p)
    mid = pbs.pbs(ck, ct, f, space=SPACE, params=p, engine_name="matmul")
    out = pbs.pbs(ck, mid, g, space=SPACE, params=p, engine_name="matmul")
    dec = np.asarray(pbs.decrypt_int(out, sk.lv0, SPACE))
    want = np.asarray(g)[np.asarray(f)[np.asarray(xs)]]
    assert np.array_equal(dec, want)


def test_pbs_identity_refreshes(setup):
    # identity LUT == a noise-refreshing bootstrap of the int encoding
    p, sk, ck, ke = setup
    xs = jnp.arange(SPACE, dtype=U32)
    ct = pbs.encrypt_int(jax.random.fold_in(ke, 5), sk.lv0, xs, SPACE, p)
    out = pbs.pbs(ck, ct, jnp.arange(SPACE, dtype=U32), space=SPACE,
                  params=p, engine_name="matmul")
    dec = np.asarray(pbs.decrypt_int(out, sk.lv0, SPACE))
    assert np.array_equal(dec, np.asarray(xs))


def test_context_apply_lut():
    p = TEST_PARAMS
    ctx = TFHE.new(jax.random.PRNGKey(21), p, engine_name="matmul")
    table = [3, 1, 0, 2]
    xs = jnp.array([2, 0, 3, 1, 2], U32)
    out = ctx.apply_lut(ctx.encrypt_int(xs, SPACE), table, SPACE)
    dec = np.asarray(ctx.decrypt_int(out, SPACE))
    assert np.array_equal(dec, np.asarray(table)[np.asarray(xs)])


# -------------------------- noise-space check -------------------------- #
def test_check_pbs_space_defaults():
    # production set, calibrated by the MEASURED anchor 3 (noise.py):
    # space=4 is as sound as the gates (passes); space=8 measured 18/4096
    # wrong on device (2.9 sigma) and must be flagged; space=16 likewise.
    ok4, msg4 = pbs.check_pbs_space(DEFAULT_PARAMS, 4)
    ok8, msg8 = pbs.check_pbs_space(DEFAULT_PARAMS, 8)
    ok16, msg16 = pbs.check_pbs_space(DEFAULT_PARAMS, 16)
    assert ok4, msg4
    assert not ok8, msg8
    assert not ok16, msg16
    # the calibrated space-8 margin must sit in the measured ~2.9-sigma band
    from rustfhe.utils.noise import DEFAULT_SIGMA_INFLATION, noise_budget

    m8 = (1.0 / 32.0) / (noise_budget(DEFAULT_PARAMS).sigma_total
                         * DEFAULT_SIGMA_INFLATION)
    assert 2.5 < m8 < 3.3, m8
    assert f"{m8:.1f}" in msg8


# ------------------------- multi-output PBS ---------------------------- #
def test_pbs_many_lut(setup):
    """t lookup tables, one blind rotation (pbs_many): every output row j
    decodes to tables[j][x]."""
    p, sk, ck, ke = setup
    space, t = 2, 4  # N=64 -> 8 coefficients per (bucket, sub-slot)
    rs = np.random.RandomState(17)
    xs = rs.randint(0, space, size=12)
    tables = rs.randint(0, space, size=(t, space))
    ct = pbs.encrypt_int(jax.random.fold_in(ke, 31), sk.lv0,
                         jnp.asarray(xs), space, p)
    # unsafe=True: t=4 at the tiny test set sits at a 2.1-sigma calibrated
    # bound (N=64's coarsened switch is genuinely coarse) — fine for this
    # fixed-seed functional test, but the margin gate rightly flags it.
    out = pbs.pbs_many(ck, ct, jnp.asarray(tables), space=space, params=p,
                       engine_name="matmul", unsafe=True)
    assert out.shape == (12, t, p.n + 1)
    dec = np.asarray(pbs.decrypt_int(out, sk.lv0, space))
    for j in range(t):
        np.testing.assert_array_equal(dec[:, j], tables[j][xs])


def test_pbs_many_t1_matches_pbs(setup):
    """t=1 is a plain PBS (no coarsening): bit-identical to pbs()."""
    p, sk, ck, ke = setup
    space = 4
    xs = jnp.arange(space, dtype=U32)
    table = jnp.asarray([3, 0, 2, 1])
    ct = pbs.encrypt_int(jax.random.fold_in(ke, 32), sk.lv0, xs, space, p)
    one = pbs.pbs(ck, ct, table, space=space, params=p, engine_name="matmul")
    many = pbs.pbs_many(ck, ct, table[None, :], space=space, params=p,
                        engine_name="matmul")
    assert np.array_equal(np.asarray(many[:, 0]), np.asarray(one))


def test_pbs_many_per_row_tables(setup):
    """Leading table axes broadcast against the batch: a different t-tuple
    of functions per batch row."""
    p, sk, ck, ke = setup
    space, t, B = 2, 2, 6
    rs = np.random.RandomState(23)
    xs = rs.randint(0, space, size=B)
    tables = rs.randint(0, space, size=(B, t, space))
    ct = pbs.encrypt_int(jax.random.fold_in(ke, 33), sk.lv0,
                         jnp.asarray(xs), space, p)
    out = pbs.pbs_many(ck, ct, jnp.asarray(tables), space=space, params=p,
                       engine_name="matmul")
    dec = np.asarray(pbs.decrypt_int(out, sk.lv0, space))
    for b in range(B):
        for j in range(t):
            assert dec[b, j] == tables[b, j, xs[b]]


def test_check_pbs_many():
    ok2, msg2 = pbs.check_pbs_many(DEFAULT_PARAMS, 2, 2)
    ok1, msg1 = pbs.check_pbs_many(DEFAULT_PARAMS, 2, 1)
    # margin shrinks monotonically in t (drift var scales by t^2)
    m = lambda s: float(s.split("margin ")[1].split(" sigma")[0])
    assert m(msg1) > m(msg2)
    assert ok2, msg2  # space=2, t=2 is sound at the default set
    # t=1 must agree with check_pbs_space's verdict machinery
    with pytest.raises(ValueError):
        pbs.check_pbs_many(DEFAULT_PARAMS, 2, 3)  # t not a power of two
    with pytest.raises(ValueError):
        pbs.check_pbs_many(TEST_PARAMS, 64, 2)  # space*t > N


def test_pbs_raw_matches_encoded(setup):
    """raw=True with pre-encoded torus values is bit-identical to the
    integer-table path."""
    p, sk, ck, ke = setup
    space = 4
    xs = jnp.arange(space, dtype=U32)
    table = jnp.asarray([2, 0, 3, 1])
    ct = pbs.encrypt_int(jax.random.fold_in(ke, 41), sk.lv0, xs, space, p)
    enc = pbs.pbs(ck, ct, table, space=space, params=p, engine_name="matmul")
    raw = pbs.pbs(ck, ct, pbs.encode_int(table, space), space=space, params=p,
                  engine_name="matmul", raw=True)
    assert np.array_equal(np.asarray(enc), np.asarray(raw))


def test_from_pbs_int_bridge(setup):
    """PBS-domain int -> FheUint bit planes in ONE bootstrap, composable
    with the integer API."""
    p, sk, ck, ke = setup
    from rustfhe.context import TFHE

    ctx = TFHE(sk, ck, p, "matmul")
    space = 4
    xs = np.array([0, 1, 2, 3, 3, 1], np.uint32)
    ct = pbs.encrypt_int(jax.random.fold_in(ke, 42), sk.lv0,
                         jnp.asarray(xs), space, p)
    # TEST_PARAMS' coarse nbit scores below the 5-sigma analytic bar, so
    # the bridge must REFUSE by default...
    with pytest.raises(ValueError, match="margin below threshold"):
        ctx.int_to_uint(ct, space)
    # ...and run under the explicit override (decode is fine in practice
    # at these test dimensions — the margins here are tiny-N artifacts).
    u = ctx.int_to_uint(ct, space, unsafe=True)
    assert u.width == 2
    np.testing.assert_array_equal(u.decrypt(), xs)
    # bits are valid gate-encoded ciphertexts: integer ops compose
    np.testing.assert_array_equal((u + 1).decrypt(), (xs + 1) & 3)
