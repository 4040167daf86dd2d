"""TLWE tests: ring ops, encrypt/decrypt round trips, identity key switch
(mirrors reference ``hom_nand/src/tlwe.rs:295-397``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rustfhe import bootstrap, keys, tlwe, torus
from rustfhe.engine import get_engine
from rustfhe.params import TEST_PARAMS, TFHEParams

U32 = jnp.uint32


def test_ring_ops():
    # tlwe.rs:302-326 flavor, exact uint32 arithmetic.
    l = jnp.array([0x80000000, 0x80000000, 0x40000000], U32)  # b=0.5, a=[0.5,0.25]
    r = jnp.array([0x40000000, 0x20000000, 0x80000000], U32)
    add = (l + r).astype(U32)
    assert [hex(v) for v in np.asarray(add)] == ["0xc0000000", "0xa0000000", "0xc0000000"]
    sub = (l - r).astype(U32)
    assert np.asarray(sub)[0] == 0x40000000
    tri = (l * U32(3)).astype(U32)
    assert np.asarray(tri)[0] == 0x80000000  # 0.5*3 == 1.5 == 0.5
    zero = (l * U32(0)).astype(U32)
    assert np.all(np.asarray(zero) == 0)


def test_encrypt_decrypt_round_trip(rng):
    # tlwe.rs:328-344: 100 round trips.
    p = TEST_PARAMS
    k1, k2, k3 = jax.random.split(rng, 3)
    from rustfhe.utils.rng import binary_array

    s = binary_array(k1, (p.n,))
    bits = binary_array(k2, (100,))
    ct = tlwe.encrypt_binary(k3, s, bits, p)
    dec = tlwe.decrypt_binary(ct, s)
    assert np.array_equal(np.asarray(dec), np.asarray(bits))


def test_trivial_decrypts_to_message():
    p = TEST_PARAMS
    s = jnp.ones((p.n,), U32)
    ct = tlwe.trivial(U32(0x12345678), p.n)
    assert int(np.asarray(tlwe.phase(ct, s))) == 0x12345678


@pytest.mark.parametrize("engine_name", [
    pytest.param("oracle", marks=pytest.mark.slow),  # 11 s of eager O(N^2) KS
    "matmul",
])
def test_identity_key_switch(rng, engine_name):
    # tlwe.rs:346-396: encrypt at lv1 dimension, switch to lv0, decrypt.
    p = TEST_PARAMS
    engine = get_engine(engine_name)
    k1, k2 = jax.random.split(rng)
    sk = keys.gen_secret_key(k1, p)
    ksk_raw = keys.gen_key_switching_key_raw(k2, sk, p)
    ksk = engine.prepare_ksk(ksk_raw, p)

    for item in (0, 1):
        kk = jax.random.fold_in(rng, item)
        bits = jnp.full((20,), item, U32)
        # lv1 TLWE under the lv1 key (dimension N)
        ct1 = tlwe.encrypt_binary(kk, sk.lv1, bits, p.replace(n=p.N))
        assert np.all(np.asarray(tlwe.decrypt_binary(ct1, sk.lv1)) == item)
        ct0 = bootstrap.identity_key_switch(ct1, ksk, p, engine)
        dec = tlwe.decrypt_binary(ct0, sk.lv0)
        assert np.all(np.asarray(dec) == item)


def test_key_switch_engines_agree(rng):
    p = TEST_PARAMS
    k1, k2, k3 = jax.random.split(rng, 3)
    sk = keys.gen_secret_key(k1, p)
    ksk_raw = keys.gen_key_switching_key_raw(k2, sk, p)
    ct1 = tlwe.encrypt_binary(k3, sk.lv1, jnp.array([0, 1, 1, 0], U32), p.replace(n=p.N))
    outs = {}
    for name in ("oracle", "matmul", "matmul_bf16"):
        e = get_engine(name)
        outs[name] = np.asarray(bootstrap.identity_key_switch(ct1, e.prepare_ksk(ksk_raw, p), p, e))
    assert np.array_equal(outs["oracle"], outs["matmul"])
    assert np.array_equal(outs["oracle"], outs["matmul_bf16"])
