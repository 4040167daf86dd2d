"""Seeded (compressed) ciphertexts: bit-exact interchangeability with
direct encryption, public expansion, gate evaluation, and the (n+1)x wire
format.

Capability beyond the reference (which has no serialization, SURVEY.md §5)
mirroring TFHE-rs seeded/compressed ciphertexts: the counter-based RNG
(utils/rng.py) makes every mask a deterministic function of a public seed,
so a ciphertext can travel as (seed, body).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np

from rustfhe import tlwe
from rustfhe.context import TFHE
from rustfhe.params import DEFAULT_PARAMS, TEST_PARAMS
from rustfhe.utils.serialization import (
    load_seeded_ciphertexts,
    save_ciphertexts,
    save_seeded_ciphertexts,
)


def test_seeded_matches_direct_bit_for_bit():
    """expand(encrypt_seeded(k)) == encrypt(k): the compressed form is the
    SAME ciphertext, not just an equivalent one."""
    from rustfhe.keys import gen_secret_key

    k = jax.random.PRNGKey(7)
    sk = gen_secret_key(jax.random.fold_in(k, 0), TEST_PARAMS)
    bits = jnp.asarray(np.random.RandomState(1).randint(0, 2, 33), jnp.uint32)
    ke = jax.random.fold_in(k, 1)
    full = tlwe.encrypt_binary(ke, sk.lv0, bits, TEST_PARAMS)
    seed, body = tlwe.encrypt_binary_seeded(ke, sk.lv0, bits, TEST_PARAMS)
    expanded = tlwe.expand_seeded(seed, body, TEST_PARAMS.n)
    assert np.array_equal(np.asarray(full), np.asarray(expanded))
    assert np.array_equal(
        np.asarray(tlwe.decrypt_binary(expanded, sk.lv0)), np.asarray(bits))


def test_context_roundtrip_and_gates():
    ctx = TFHE.new(jax.random.PRNGKey(3), TEST_PARAMS, "matmul")
    bits = jnp.asarray([0, 1, 0, 1], jnp.uint32)
    other = jnp.asarray([0, 0, 1, 1], jnp.uint32)
    seeded = ctx.encrypt_seeded(bits)
    # Expansion is public: the cloud-only view can do it (and then compute).
    cloud = ctx.cloud_only()
    x = cloud.expand_seeded(seeded)
    y = ctx.encrypt(other)
    out = np.asarray(ctx.decrypt(ctx.nand(x, y)))
    assert np.array_equal(out, 1 - (np.asarray(bits) & np.asarray(other)))


def test_cloud_only_cannot_encrypt_seeded():
    ctx = TFHE.new(jax.random.PRNGKey(3), TEST_PARAMS, "matmul").cloud_only()
    try:
        ctx.encrypt_seeded(jnp.asarray([1], jnp.uint32))
        assert False, "cloud-only encrypt_seeded must raise"
    except ValueError:
        pass


def test_serialization_roundtrip_and_size(tmp_path):
    ctx = TFHE.new(jax.random.PRNGKey(9), TEST_PARAMS, "matmul")
    bits = jnp.asarray(np.random.RandomState(2).randint(0, 2, 64), jnp.uint32)
    seeded = ctx.encrypt_seeded(bits)

    p_seed = str(tmp_path / "seeded.npz")
    p_full = str(tmp_path / "full.npz")
    save_seeded_ciphertexts(p_seed, seeded, TEST_PARAMS)
    save_ciphertexts(p_full, ctx.expand_seeded(seeded), TEST_PARAMS)

    cts, params = load_seeded_ciphertexts(p_seed)
    assert params == TEST_PARAMS
    assert np.array_equal(np.asarray(ctx.decrypt(cts)), np.asarray(bits))
    # Wire-format win: body-only vs (n+1) columns of uniform (incompressible)
    # mask.  Compression nibbles at both, so assert a conservative n/4.
    ratio = os.path.getsize(p_full) / os.path.getsize(p_seed)
    assert ratio > TEST_PARAMS.n / 4, ratio


def test_production_shape_seed_determinism():
    """The seed alone reproduces the mask at production dims (no secret
    material in the expansion path)."""
    k = jax.random.PRNGKey(11)
    b = jnp.zeros((5,), jnp.uint32)
    ct1 = tlwe.expand_seeded(np.asarray([1, 2], np.uint32), b, DEFAULT_PARAMS.n)
    ct2 = tlwe.expand_seeded(jnp.asarray([1, 2], jnp.uint32), b, DEFAULT_PARAMS.n)
    assert np.array_equal(np.asarray(ct1), np.asarray(ct2))
    assert ct1.shape == (5, DEFAULT_PARAMS.n + 1)
    del k


def test_seed_is_mask_subkey_not_full_key():
    """SECURITY regression: the published seed must be the mask subkey
    split(key)[0], never the full PRNG key (whose noise subkey would let
    anyone recompute every Gaussian sample and solve for the secret key
    over GF(2))."""
    from rustfhe.keys import gen_secret_key

    k = jax.random.PRNGKey(13)
    sk = gen_secret_key(jax.random.fold_in(k, 0), TEST_PARAMS)
    ke = jax.random.fold_in(k, 1)
    seed, _body = tlwe.encrypt_binary_seeded(
        ke, sk.lv0, jnp.asarray([1, 0], jnp.uint32), TEST_PARAMS)
    assert not np.array_equal(np.asarray(seed), np.asarray(ke))
    assert np.array_equal(np.asarray(seed),
                          np.asarray(jax.random.split(ke)[0]))


def test_public_key_rows_floor():
    """Too-few pk rows (enumerable subset-sum) must raise, like every
    other unsafe parameter choice in the framework."""
    from rustfhe.keys import gen_secret_key

    sk = gen_secret_key(jax.random.PRNGKey(1), TEST_PARAMS)
    try:
        tlwe.gen_public_key(jax.random.PRNGKey(2), sk.lv0, TEST_PARAMS,
                            rows=TEST_PARAMS.n)
        assert False, "rows < n+1 must raise"
    except ValueError as e:
        assert "rows" in str(e)


def test_fheuint_seeded_roundtrip():
    """Typed-integer seeded upload: encrypt_seeded -> public expand ->
    arithmetic -> decrypt."""
    from rustfhe.ints import FheUint

    ctx = TFHE.new(jax.random.PRNGKey(17), TEST_PARAMS, "matmul")
    ctx.circuit_fixed_width = None
    vals = np.array([3, 250, 77], np.uint64)
    seeded = FheUint.encrypt_seeded(ctx, vals, 8)
    a = FheUint.expand_seeded(ctx.cloud_only(), seeded)
    assert np.array_equal(
        np.asarray(FheUint(ctx, a.bits).decrypt()), vals)


def test_radix_seeded_roundtrip():
    """Radix-integer seeded upload: (seed, digit bodies) -> public expand
    -> decrypt."""
    from rustfhe.radix import RadixUint

    ctx = TFHE.new(jax.random.PRNGKey(23), TEST_PARAMS, "matmul")
    vals = np.array([7, 255, 129], np.uint64)
    seeded = RadixUint.encrypt_seeded(ctx, vals, 4)
    a = RadixUint.expand_seeded(ctx.cloud_only(), seeded)
    assert np.array_equal(
        np.asarray(RadixUint(ctx, a.digits).decrypt()), vals)
