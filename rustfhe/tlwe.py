"""TLWE (scalar LWE over the torus), batched.

Re-design of the reference's ``TLWE``/``TLWERep`` (``hom_nand/src/tlwe.rs``)
with a batch-first layout: a batch of TLWE ciphertexts is ONE uint32 array of
shape ``(..., n+1)`` with the body ``b`` at index 0 and the mask ``a`` at
indices 1..n (reference: ``TLWERep { cipher: b, p_key: a }``, tlwe.rs:20-23).
All ring operations are plain wrapping uint32 array arithmetic, so they
vectorize over any batch shape and fuse under jit.

Encoding: Binary One -> +1/8, Zero -> -1/8; decode fraction < 0.5 -> One
(tlwe.rs:181-195).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import torus
from .params import TFHEParams
from .utils.rng import gaussian_torus, uniform_torus

U32 = jnp.uint32


def trivial(b, n: int) -> jnp.ndarray:
    """Noiseless ciphertext (b, 0,...,0) (tlwe.rs:75-79)."""
    b = jnp.asarray(b, U32)
    out = jnp.zeros(b.shape + (n + 1,), U32)
    return out.at[..., 0].set(b)


def logic_true(n: int) -> jnp.ndarray:
    return trivial(torus.TORUS_ONE_EIGHTH, n)


def logic_false(n: int) -> jnp.ndarray:
    return trivial(torus.TORUS_MINUS_ONE_EIGHTH, n)


def body(ct) -> jnp.ndarray:
    return ct[..., 0]


def mask(ct) -> jnp.ndarray:
    return ct[..., 1:]


def neg(ct) -> jnp.ndarray:
    return (~jnp.asarray(ct, U32) + U32(1)).astype(U32)


def mul_int(ct, k: int) -> jnp.ndarray:
    """Scalar multiply; wrapping, handles negative k (math.rs:638-653)."""
    return (jnp.asarray(ct, U32) * U32(k & 0xFFFFFFFF)).astype(U32)


def encrypt_torus(key, s: jnp.ndarray, m, params: TFHEParams) -> jnp.ndarray:
    """Encrypt torus message(s) under binary key ``s (n,)``.

    ``m``: uint32 array, any shape B.  Returns ``B + (n+1,)``.
    b = sum_{s_i=1} a_i + e + m (tlwe.rs:213-228).
    """
    m = jnp.asarray(m, U32)
    n = s.shape[-1]
    ka, ke = jax.random.split(key)
    a = uniform_torus(ka, m.shape + (n,))
    e = gaussian_torus(ke, m.shape, params.alpha_lv0)
    b = jnp.sum(a * s.astype(U32), axis=-1, dtype=U32) + e + m
    return jnp.concatenate([b[..., None], a], axis=-1)


def gen_public_key(key, s: jnp.ndarray, params: TFHEParams,
                   rows: int | None = None) -> jnp.ndarray:
    """LWE public key: ``rows`` encryptions of zero, shape (M, n+1).

    Regev-style public-key encryption (the TFHE-rs CompactPublicKey
    capability; the reference is secret-key only): the key holder
    publishes M = 2(n+1) zero-encryptions; any party then encrypts by
    summing a random binary subset and adding the message plus one fresh
    smoothing noise (``encrypt_torus_public``).  Security is the standard
    LWE argument (the pk rows are LWE samples; the subset-sum is again
    LWE-pseudorandom with the smoothing noise), not the statistical
    leftover-hash bound (which would need M > (n+1) log2 q rows).

    Noise: a pk ciphertext carries ~M/2 zero-encryption noises + 1 fresh
    noise; at the DEFAULT set this moves the calibrated gate margin only
    9.1 -> 9.0 predicted sigma (5.7 -> 5.6 lower bound) because fresh
    input noise is negligible against the bootstrap terms
    (utils/noise.noise_budget: var_fresh ~ 1e-5 of sigma_total^2).
    """
    n = s.shape[-1]
    M = rows if rows is not None else 2 * (n + 1)
    if M < n + 1:
        # Too few rows makes the subset-sum enumerable (2^M masks): an
        # attacker matches mask(ct - S_j) == 0 over all subset sums S_j
        # and reads the body.  Gate it like every other unsafe parameter
        # choice in this framework (pbs margin gates, keys HBM guards).
        raise ValueError(
            f"public key needs rows >= n+1 = {n + 1} (got {M}): fewer "
            f"rows make the ciphertext mask enumerable")
    return encrypt_torus(key, s, jnp.zeros((M,), U32), params)


def encrypt_torus_public(key, pk: jnp.ndarray, m, params: TFHEParams) -> jnp.ndarray:
    """Encrypt under the PUBLIC key: no secret material needed.

    ct = sum of a fresh random binary subset of the pk rows, plus the
    message and one smoothing noise on the body.  Batched over ``m``'s
    shape (an independent subset per message)."""
    m = jnp.asarray(m, U32)
    kr, ke = jax.random.split(key)
    from .utils.rng import binary_array

    r = binary_array(kr, m.shape + (pk.shape[0],))  # (..., M)
    # Matrix product, not a materialized (..., M, n+1) outer product: at
    # production dims a 4096-batch outer form would stage ~13 GB; the dot
    # is the same wrapping mod-2^32 result with O(batch * (n+1)) memory.
    # No vendor library multiplies uint32 matrices, so XLA generates this
    # kernel itself; chip_smoke.py checks it against numpy on the card.
    ct = jnp.matmul(r.astype(U32), pk, preferred_element_type=U32)
    e = gaussian_torus(ke, m.shape, params.alpha_lv0)
    return ct.at[..., 0].add(e + m)


def encrypt_binary_public(key, pk: jnp.ndarray, bits, params: TFHEParams) -> jnp.ndarray:
    return encrypt_torus_public(key, pk, torus.binary_to_torus(bits), params)


def _canonical_key(key) -> jnp.ndarray:
    """PRNG key -> raw (2,) uint32 threefry key words.

    Typed key arrays with a NON-default implementation are rejected: their
    split/bits semantics differ, so ``expand_seeded`` (which derives the
    mask from raw words under the default impl) would reproduce a
    different mask and decryptions would be silent garbage."""
    key = jnp.asarray(key)
    if jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
        impl = str(jax.random.key_impl(key))
        default = str(jax.random.key_impl(jax.random.PRNGKey(0)))
        if impl != default:
            raise ValueError(
                f"seeded encryption requires the default ({default}) PRNG "
                f"implementation; got {impl}")
        key = jax.random.key_data(key)
    return jnp.asarray(key, U32)


def _seed_data(key) -> jnp.ndarray:
    """PRNG key -> raw (2,) uint32 seed words (handles typed key arrays)."""
    if jnp.issubdtype(jnp.asarray(key).dtype, jax.dtypes.prng_key):
        key = jax.random.key_data(key)
    return jnp.asarray(key, U32)


def encrypt_torus_seeded(key, s: jnp.ndarray, m, params: TFHEParams):
    """Seeded (compressed) encryption: ``(seed (2,) uint32, body B)``.

    The mask ``a`` of ``encrypt_torus`` is already a deterministic function
    of the public PRNG seed (counter-based ``utils/rng.uniform_torus``), so
    a ciphertext can travel as just ``(seed, b)`` — ``(n+1)x`` smaller on
    the wire — and any party re-derives ``a`` with ``expand_seeded``.  This
    is the TFHE-rs seeded/compressed-ciphertext capability (absent from
    the reference, which has no serialization at all — SURVEY.md §5).
    Only the MASK subkey is published — the mask is public in a normal
    ciphertext too, so naming it by its seed is security-neutral; the
    noise subkey must never leave the encryptor (see the inline note).

    ``expand_seeded(seed, b, n)`` reproduces ``encrypt_torus(key, ...)``
    BIT-FOR-BIT (pinned by tests/test_seeded.py), so seeded and direct
    encryptions are interchangeable.  One seed covers the whole batch.
    """
    ct = encrypt_torus(key, s, m, params)
    # Publish ONLY the mask subkey (split(key)[0]): the mask is public in
    # a normal ciphertext anyway.  Publishing the full key would be a
    # total break — the noise subkey split(key)[1] lets anyone recompute
    # every Gaussian sample e_i, and since m_i = ±2^29 is even,
    # (b_i - e_i) mod 2 = <a_i mod 2, s> yields the binary secret key by
    # GF(2) elimination from ~n seeded bits.
    ka, _ke = jax.random.split(_canonical_key(key))
    return _seed_data(ka), body(ct)


def encrypt_binary_seeded(key, s: jnp.ndarray, bits, params: TFHEParams):
    return encrypt_torus_seeded(key, s, torus.binary_to_torus(bits), params)


def expand_seeded(seed, b, n: int) -> jnp.ndarray:
    """(seed, body) -> full TLWE batch ``(..., n+1)``; public operation.

    ``seed`` is the MASK subkey published by ``encrypt_torus_seeded``;
    feeding it to ``uniform_torus`` at the body's batch shape reproduces
    the mask exactly as ``encrypt_torus`` drew it.  The noise subkey is
    never published (see the security note in ``encrypt_torus_seeded``)."""
    b = jnp.asarray(b, U32)
    a = uniform_torus(jnp.asarray(seed, U32), b.shape + (n,))
    return jnp.concatenate([b[..., None], a], axis=-1)


def phase(ct, s: jnp.ndarray) -> jnp.ndarray:
    """b - <a, s> (tlwe.rs:230-240)."""
    ct = jnp.asarray(ct, U32)
    a_dot_s = jnp.sum(mask(ct) * s.astype(U32), axis=-1, dtype=U32)
    return body(ct) - a_dot_s


def encrypt_binary(key, s: jnp.ndarray, bits, params: TFHEParams) -> jnp.ndarray:
    return encrypt_torus(key, s, torus.binary_to_torus(bits), params)


def decrypt_binary(ct, s: jnp.ndarray) -> jnp.ndarray:
    return torus.torus_to_binary(phase(ct, s))
