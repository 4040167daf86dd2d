"""Negacyclic polynomial operations over Z[X]/(X^N + 1), batched.

Polynomials are plain JAX arrays whose last axis is the coefficient axis
(length N).  This replaces the reference's ``Polynomial<T, N>`` newtype
(``utils/src/math.rs:42-348``) with array-native operations that vectorize
over any leading batch axes — the batch-first layout decision (SURVEY.md §7):
the parallel axis is the *batch of ciphertexts*, not the polynomial degree.

Contents:
  * ``rotate`` / ``rotate_batched``: multiplication by X^n with negacyclic
    sign wrap (semantics of ``Polynomial::rotate``, math.rs:74-133).
  * ``negacyclic_mul_i64``: naive O(N^2) exact oracle over int64
    (mirrors ``Cross::cross`` + ``convolution``, math.rs:237-257,713-723);
    used only in tests as the ground truth the fast engines are checked
    against — the analogue of the reference's fft_cross-vs-cross test
    (math.rs:904-952).
  * ``negacyclic_mul_torus_oracle``: same, reduced mod 2^32 on uint32.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32
I32 = jnp.int32
I64 = jnp.int64


def rotate(p: jnp.ndarray, n, two_n: int | None = None) -> jnp.ndarray:
    """Multiply polynomial(s) by X^n in Z[X]/(X^N+1).

    Args:
      p: array ``(..., N)``; any integer dtype (signed values negate
         natively; uint32 negates by wrapping two's complement).
      n: rotation amount — a Python int or an integer array broadcastable to
         ``p.shape[:-1]`` (per-batch-element rotations, as needed inside
         blind rotation where each sample has its own a~_i, tfhe.rs:103-110).
      two_n: optional override of 2*N (defaults to 2*p.shape[-1]).

    Semantics (math.rs:85-133): with m = n mod 2N, out[i] = p[k] where
    k = (i - m) mod 2N, negated when k >= N.
    """
    N = p.shape[-1]
    tn = two_n if two_n is not None else 2 * N
    n = jnp.asarray(n, I32)
    idx = jnp.arange(N, dtype=I32)
    # k in [0, 2N)
    k = jnp.mod(idx - n[..., None], tn)
    neg = k >= N
    k = jnp.where(neg, k - N, k)
    shape = jnp.broadcast_shapes(p.shape, k.shape)
    p_b = jnp.broadcast_to(p, shape)
    k_b = jnp.broadcast_to(k, shape).astype(jnp.int32)
    gathered = jnp.take_along_axis(p_b, k_b, axis=-1)
    if jnp.issubdtype(p.dtype, jnp.unsignedinteger):
        negated = (~gathered + jnp.asarray(1, p.dtype)).astype(p.dtype)
    else:
        negated = -gathered
    return jnp.where(neg, negated, gathered)


def _negacyclic_roll_static(p: jnp.ndarray, s: int) -> jnp.ndarray:
    """Multiply by X^s for a STATIC s in [0, 2N): slice+concat+negate."""
    N = p.shape[-1]
    s = s % (2 * N)
    neg = False
    if s >= N:
        s -= N
        neg = True
    if jnp.issubdtype(p.dtype, jnp.unsignedinteger):
        negate = lambda x: (~x + jnp.asarray(1, p.dtype)).astype(p.dtype)
    else:
        negate = lambda x: -x
    if s == 0:
        out = p
    else:
        out = jnp.concatenate([negate(p[..., N - s :]), p[..., : N - s]], axis=-1)
    return negate(out) if neg else out


def rotate_binary(p: jnp.ndarray, n, nbits: int | None = None) -> jnp.ndarray:
    """Per-item rotation by X^n via binary decomposition of n — gather-free.

    Same semantics as ``rotate`` but implemented as nbits+1 static negacyclic
    rolls combined with element-wise selects (which XLA fuses; no dynamic
    gather).  ``n`` must already be reduced to
    [0, 2N); shape broadcastable to ``p.shape[:-1]``.
    """
    N = p.shape[-1]
    if nbits is None:
        nbits = (2 * N - 1).bit_length()
    n = jnp.asarray(n, I32)
    out = p
    for k in range(nbits):
        bit = ((n >> k) & 1).astype(jnp.bool_)[..., None]
        rolled = _negacyclic_roll_static(out, 1 << k)
        out = jnp.where(bit, rolled, out)
    return out


def negacyclic_mul_i64(a, b) -> np.ndarray:
    """Exact negacyclic product over the integers (int64, host numpy).

    Oracle only: O(N^2); mirrors the reference's naive ``cross``
    (math.rs:237-257).  Pure numpy so it is exact regardless of the JAX
    x64 setting; used only in tests.
    """
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    N = a.shape[-1]
    # out[k] = sum_{i+j==k} a_i b_j - sum_{i+j==k+N} a_i b_j
    # via the doubled-coefficient trick: d = [b, -b] (length 2N),
    # out[k] = sum_i a_i * d[(k - i) mod 2N].
    d = np.concatenate([b, -b], axis=-1)
    i = np.arange(N)
    k = np.arange(N)
    idx = np.mod(k[:, None] - i[None, :], 2 * N)  # (N out, N in)
    mat = d[..., idx]  # (..., k, i)
    return np.einsum("...i,...ki->...k", a, mat)


def negacyclic_mul_torus_oracle(a_torus, b_int) -> jnp.ndarray:
    """Exact negacyclic product of a Torus32 poly by an integer poly, mod 2^32.

    ``a_torus``: uint32 ``(..., N)``; ``b_int``: integer ``(..., N)`` with
    small magnitude (binary keys or gadget digits).  Works entirely in
    uint32 wrapping arithmetic, so it is exact mod 2^32 for *any* operand
    magnitudes — the ground-truth for engine tests.
    """
    a = jnp.asarray(a_torus, U32)
    b = jnp.asarray(b_int).astype(I32).astype(U32)  # mod 2^32
    N = a.shape[-1]
    d = jnp.concatenate([b, (~b + U32(1)).astype(U32)], axis=-1)
    i = jnp.arange(N)
    k = jnp.arange(N)
    idx = jnp.mod(k[:, None] - i[None, :], 2 * N)
    mat = jnp.take(d, idx, axis=-1)  # (..., N out, N in) of b-values mod 2^32
    prod = a[..., None, :] * mat  # wrapping u32 products
    return jnp.sum(prod, axis=-1, dtype=U32)


def to_signed_limbs(x, limb_bits: int, num_limbs: int, dtype=None) -> jnp.ndarray:
    """Split uint32 values into balanced signed limbs.

    Returns ``dtype`` (default int8) array ``(..., num_limbs)`` with limb ``k`` in
    [-2^(limb_bits-1), 2^(limb_bits-1)) such that
    ``sum_k limb_k * 2^(limb_bits*k) == x (mod 2^32)``.
    The final carry out of the top limb is dropped: its weight is
    ``2^(limb_bits*num_limbs) >= 2^32``, hence 0 mod 2^32.

    The balanced form keeps matmul-side products small: |limb| <= 2^(limb_bits-1),
    which bounds int8-matmul accumulations well inside exact int32/f32 range.
    """
    assert limb_bits * num_limbs >= 32
    if dtype is None:
        dtype = jnp.int8
    x = jnp.asarray(x, U32)
    base = U32((1 << limb_bits) - 1)
    half = 1 << (limb_bits - 1)
    limbs = []
    carry = jnp.zeros(x.shape, U32)
    for k in range(num_limbs):
        shift = limb_bits * k
        raw = ((x >> U32(shift)) & base) if shift < 32 else jnp.zeros_like(x)
        raw = raw + carry
        # raw in [0, 2^limb_bits]; map to balanced and carry the excess.
        over = raw >= U32(half)
        # narrow immediately: raw - over*2^limb_bits fits [-half, half-1].
        limbs.append(
            (raw.astype(I32) - jnp.where(over, I32(1 << limb_bits), I32(0))).astype(dtype)
        )
        carry = over.astype(U32)
    return jnp.stack(limbs, axis=-1)


def from_signed_limbs(limbs, limb_bits: int) -> jnp.ndarray:
    """Recombine (test helper): sum_k limb_k << (limb_bits*k) mod 2^32."""
    l = jnp.asarray(limbs, I32).astype(U32)
    num = l.shape[-1]
    weights = jnp.array(
        [(1 << (limb_bits * k)) & 0xFFFFFFFF if limb_bits * k < 32 else 0 for k in range(num)],
        U32,
    )
    return jnp.sum(l * weights, axis=-1, dtype=U32)
