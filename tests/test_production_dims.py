"""Production-dimension CPU tests.

The reference tests identity key switching at its real dimensions
(1024 -> 635) and at a second pair (256 -> 60)
(``hom_nand/src/tlwe.rs:346-396``); the on-card bench exercises production
parameters only for NAND on device.  These tests keep the production
shapes honest in the CPU suite: key switching at both reference dimension
pairs, and one full production-parameter NAND truth table (slow, ~45 s —
the CPU analogue of the reference's gate bench ``tfhe.rs:147-279``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rustfhe import bootstrap, gates, keys, tlwe
from rustfhe.engine import get_engine
from rustfhe.params import DEFAULT_PARAMS, TFHEParams

U32 = jnp.uint32


@pytest.mark.parametrize(
    "p",
    [
        DEFAULT_PARAMS,  # 1024 -> 635, the production pair (tlwe.rs:347-371)
        TFHEParams(n=60, N=256, alpha_lv0=2.0**-15, alpha_lv1=2.0**-25),
        # second reference pair (tlwe.rs:373-396: M=256, N=60)
    ],
    ids=["prod_1024_to_635", "ref_256_to_60"],
)
def test_identity_key_switch_production_dims(p):
    engine = get_engine("matmul")
    key = jax.random.PRNGKey(41)
    k1, k2, k3 = jax.random.split(key, 3)
    sk = keys.gen_secret_key(k1, p)
    ksk_raw = keys.gen_key_switching_key_raw(k2, sk, p)
    ksk = engine.prepare_ksk(ksk_raw, p)

    bits = jnp.asarray(np.tile([0, 1], 8).astype(np.uint32))
    ct1 = tlwe.encrypt_binary(k3, sk.lv1, bits, p.replace(n=p.N))
    assert np.array_equal(
        np.asarray(tlwe.decrypt_binary(ct1, sk.lv1)), np.asarray(bits)
    )
    ct0 = bootstrap.identity_key_switch(ct1, ksk, p, engine)
    dec = np.asarray(tlwe.decrypt_binary(ct0, sk.lv0))
    assert np.array_equal(dec, np.asarray(bits))


def test_production_params_nand_cpu_slow():
    """Full bootstrapped NAND truth table at n=635/N=1024 on CPU (~45 s).

    Catches production-dimension bugs (padding, noise-margin, layout) that
    the TEST_PARAMS suite cannot see; the on-device analogue is bench.py's
    correctness gate.
    """
    p = DEFAULT_PARAMS
    kg, ke = jax.random.split(jax.random.PRNGKey(5))
    sk, ck = keys.gen_keys(kg, p, engine_name="matmul")

    pat = np.array([[0, 0], [1, 0], [0, 1], [1, 1]], np.uint32)
    k1, k2 = jax.random.split(ke)
    cx = tlwe.encrypt_binary(k1, sk.lv0, jnp.asarray(pat[:, 0]), p)
    cy = tlwe.encrypt_binary(k2, sk.lv0, jnp.asarray(pat[:, 1]), p)
    out = gates.hom_nand(ck, cx, cy, params=p, engine_name="matmul")
    dec = np.asarray(tlwe.decrypt_binary(out, sk.lv0))
    assert np.array_equal(dec, 1 - (pat[:, 0] & pat[:, 1]))
