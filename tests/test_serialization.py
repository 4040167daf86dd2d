"""Serialization round trips: secret key, raw cloud key, ciphertexts —
decryption still works after reload (new capability vs the reference)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rustfhe import gates, keys, tlwe
from rustfhe.engine import get_engine
from rustfhe.params import TEST_PARAMS
from rustfhe.utils import serialization as ser

U32 = jnp.uint32


def test_secret_key_round_trip(tmp_path, rng):
    p = TEST_PARAMS
    sk = keys.gen_secret_key(rng, p)
    path = str(tmp_path / "sk.npz")
    ser.save_secret_key(path, sk, p)
    sk2, p2 = ser.load_secret_key(path)
    assert p2 == p
    assert np.array_equal(np.asarray(sk.lv0), np.asarray(sk2.lv0))
    assert np.array_equal(np.asarray(sk.lv1), np.asarray(sk2.lv1))


def test_cloud_key_and_ciphertext_round_trip(tmp_path, rng):
    p = TEST_PARAMS
    engine = get_engine("matmul")
    k1, k2, k3, k4 = jax.random.split(rng, 4)
    sk = keys.gen_secret_key(k1, p)
    bk_raw = keys.gen_bootstrapping_key_raw(k2, sk, p, engine)
    ksk_raw = keys.gen_key_switching_key_raw(k3, sk, p)

    ck_path = str(tmp_path / "ck.npz")
    ser.save_cloud_key_raw(ck_path, bk_raw, ksk_raw, p)
    ck, p2 = ser.load_cloud_key(ck_path, "matmul")
    assert p2 == p

    bits = jnp.array([0, 1, 0, 1], U32)
    cx = tlwe.encrypt_binary(k4, sk.lv0, bits, p)
    ct_path = str(tmp_path / "cts.npz")
    ser.save_ciphertexts(ct_path, cx, p)
    cx2, _ = ser.load_ciphertexts(ct_path)
    assert np.array_equal(np.asarray(cx), np.asarray(cx2))

    # Evaluate a gate with the reloaded cloud key; decrypt with reloaded sk.
    out = gates.hom_nand(ck, cx2, cx2, params=p, engine_name="matmul")
    dec = list(np.asarray(tlwe.decrypt_binary(out, sk.lv0)))
    assert dec == [1, 0, 1, 0]  # NAND(x, x) == NOT x


def test_bad_magic_rejected(tmp_path):
    import numpy as np

    path = str(tmp_path / "junk.npz")
    np.savez(path, header=np.frombuffer(b'{"magic": "nope"}', dtype=np.uint8))
    try:
        ser.load_secret_key(path)
        assert False, "should have raised"
    except (ValueError, KeyError):
        pass


def _header(magic, params):
    meta = {"magic": magic, "version": ser.VERSION,
            "params": {f: getattr(params, f) for f in ser._PARAM_FIELDS}}
    return np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)


def test_suffixed_tag_of_earlier_releases_loads(tmp_path):
    """Files written under the package's former name carry the tag with a
    suffix; they load, while other tags are still rejected."""
    cts = np.arange(3 * (TEST_PARAMS.n + 1), dtype=np.uint32).reshape(3, -1)
    old = str(tmp_path / "old.npz")
    np.savez(old, header=_header(ser.MAGIC + "_legacy", TEST_PARAMS), cts=cts)
    got, p = ser.load_ciphertexts(old)
    assert p == TEST_PARAMS and np.array_equal(np.asarray(got), cts)
    other = str(tmp_path / "other.npz")
    np.savez(other, header=_header(ser.MAGIC + "x", TEST_PARAMS), cts=cts)
    with pytest.raises(ValueError, match="not a rustfhe file"):
        ser.load_ciphertexts(other)


def test_cached_keys_round_trip(tmp_path, rng):
    """cached_keys (VERDICT r4 #3): first call generates + writes, second
    call LOADS (no regeneration) and yields byte-identical key material;
    a different-params cache regenerates instead of being misused."""
    from rustfhe.params import PBS_TEST_PARAMS

    p = TEST_PARAMS
    prefix = str(tmp_path / "kc")
    sk1, ck1 = ser.cached_keys(prefix, rng, p, "matmul")
    assert (tmp_path / "kc.sk.npz").exists() and (tmp_path / "kc.ck.npz").exists()

    # Second call with a DIFFERENT rng key must load the cache, not regen.
    other = jax.random.PRNGKey(999)
    sk2, ck2 = ser.cached_keys(prefix, other, p, "matmul")
    assert np.array_equal(np.asarray(sk1.lv0), np.asarray(sk2.lv0))
    assert np.array_equal(np.asarray(ck1.bk), np.asarray(ck2.bk))
    assert np.array_equal(np.asarray(ck1.ksk), np.asarray(ck2.ksk))

    # A gate through the cached key still decodes.
    k4 = jax.random.fold_in(rng, 7)
    bits = jnp.array([0, 1], U32)
    cx = tlwe.encrypt_binary(k4, sk2.lv0, bits, p)
    out = gates.hom_nand(ck2, cx, cx, params=p, engine_name="matmul")
    assert list(np.asarray(tlwe.decrypt_binary(out, sk2.lv0))) == [1, 0]

    # Param mismatch: the cache is regenerated for the new params.
    sk3, ck3 = ser.cached_keys(prefix, other, PBS_TEST_PARAMS, "matmul")
    assert sk3.lv0.shape[0] == PBS_TEST_PARAMS.n
    _, p_after = ser.load_secret_key(f"{prefix}.sk.npz")
    assert p_after == PBS_TEST_PARAMS


def test_cached_keys_match_gen_keys(tmp_path, rng):
    """The cache path and gen_keys produce identical prepared keys for the
    same PRNG key (raw generation is engine-independent and deterministic)."""
    p = TEST_PARAMS
    sk_g, ck_g = keys.gen_keys(rng, p, engine_name="matmul")
    sk_c, ck_c = ser.cached_keys(str(tmp_path / "km"), rng, p, "matmul")
    assert np.array_equal(np.asarray(sk_g.lv0), np.asarray(sk_c.lv0))
    assert np.array_equal(np.asarray(ck_g.bk), np.asarray(ck_c.bk))
    assert np.array_equal(np.asarray(ck_g.ksk), np.asarray(ck_c.ksk))
