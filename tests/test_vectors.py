"""Frozen regression vectors: deterministic keygen/encrypt/bootstrap outputs
pinned across releases (the cross-implementation anchor SURVEY.md §7 step 7
calls for — the reference itself is nondeterministic, so the *algebra* is
pinned by the golden-vector tests and the end-to-end pipeline is pinned here
against LITERAL digests frozen at round 4).

If one of these digests changes, the release contract changed: the RNG
stream (utils/rng.py key-split order), a ciphertext/key layout, or the gate
pipeline produced different bytes — every serialized key/ciphertext in the
wild is invalidated.  Update the constants ONLY for a deliberate,
documented format break.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np

from rustfhe import gates, keys, tlwe
from rustfhe.params import TEST_PARAMS

U32 = jnp.uint32

# Literal frozen digests (sha256[:16] of the raw bytes), computed on the CPU
# backend at TEST_PARAMS.  All quantities are exact mod-2^32 integer arrays
# derived from the counter-based threefry PRNG, so they are platform-stable.
SK_DIGEST = "963f5a0ea6a18eb6"  # gen_secret_key(PRNGKey(1234))
BK_DIGEST = "6ebbfab7a1e2f686"  # gen_bootstrapping_key_raw(PRNGKey(5))
KSK_DIGEST = "9d41aaf4972c9295"  # gen_key_switching_key_raw(PRNGKey(6))
NAND_DIGEST = "71cc0a2664e65f94"  # full keygen+encrypt+NAND pipeline below


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()[:16]


def test_frozen_secret_key_digest():
    p = TEST_PARAMS
    sk = keys.gen_secret_key(jax.random.PRNGKey(1234), p)
    assert _digest(sk.lv0, sk.lv1) == SK_DIGEST


def test_frozen_raw_key_digests():
    p = TEST_PARAMS
    sk = keys.gen_secret_key(jax.random.PRNGKey(1234), p)
    from rustfhe.engine import get_engine

    e = get_engine("matmul")
    bk = keys.gen_bootstrapping_key_raw(jax.random.PRNGKey(5), sk, p, e)
    assert _digest(bk) == BK_DIGEST
    ksk = keys.gen_key_switching_key_raw(jax.random.PRNGKey(6), sk, p)
    assert _digest(ksk) == KSK_DIGEST


def test_frozen_pipeline_digest():
    """Same PRNG keys end to end -> the frozen gate-output bytes: pins the
    whole keygen/encrypt/bootstrap/key-switch pipeline bit-for-bit."""
    p = TEST_PARAMS
    kg, ke = jax.random.split(jax.random.PRNGKey(99))
    sk, ck = keys.gen_keys(kg, p, engine_name="matmul")
    cx = tlwe.encrypt_binary(jax.random.fold_in(ke, 0), sk.lv0,
                             jnp.array([0, 1, 0, 1], U32), p)
    cy = tlwe.encrypt_binary(jax.random.fold_in(ke, 1), sk.lv0,
                             jnp.array([0, 0, 1, 1], U32), p)
    out = gates.hom_nand(ck, cx, cy, params=p, engine_name="matmul")
    assert _digest(out) == NAND_DIGEST
    # And the digest pins a CORRECT gate batch, not just stable bytes.
    np.testing.assert_array_equal(
        np.asarray(tlwe.decrypt_binary(out, sk.lv0)), [1, 1, 1, 0])
