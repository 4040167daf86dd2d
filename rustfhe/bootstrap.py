"""Gate bootstrapping: blind rotation, sample extraction, key switch.

The hot path (SURVEY.md §3.2).  Design decisions:

* Blind rotation is a ``jax.lax.scan`` over the n sequential CMux steps
  (the fold at reference ``hom_nand/src/tfhe.rs:103-110``), with the whole
  batch of gates vectorized inside each step — the parallel axis is the
  batch, the n-step chain is inherently sequential (data dependence through
  the accumulator).
* The entire bootstrap is one jit region: the reference crosses the
  Rust->C++ FFI boundary 8x per CMux; here there are zero host round trips.
* Per-sample rotation amounts (each gate in the batch has its own a~_i) are
  applied gather-free (``poly.rotate_binary``: log2(2N) static negacyclic
  rolls + selects, which XLA fuses into elementwise kernels).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import poly, tlwe, trgsw, trlwe
from .decomp import decompose_unsigned
from .keys import CloudKey
from .params import TFHEParams

U32 = jnp.uint32
I32 = jnp.int32


def blind_rotate(ct, bk_prepared, testvec, params: TFHEParams, engine) -> jnp.ndarray:
    """Rotate ``testvec`` by the (encrypted) phase of ``ct``.

    ct: uint32 (..., n+1) lv0 TLWE; testvec: uint32 (..., 2, N) TRLWE
    (broadcastable); returns uint32 (..., 2, N).

    Scaling matches tfhe.rs:89-113 exactly:
      b~   = b >> (32 - nbit - 1)                 (floor, tfhe.rs:97)
      a~_i = (a_i + 2^(32-nbit-2)) >> (32-nbit-1)  (round, tfhe.rs:108)
      acc  = X^{-b~} * testvec; acc = CMux(bk_i, X^{a~_i} * acc, acc)
    """
    nbit = params.nbit
    shift = 32 - nbit - 1
    two_n = 2 * params.N
    b = tlwe.body(ct)  # (...,)
    a = tlwe.mask(ct)  # (..., n)
    b_tilde = (b >> U32(shift)).astype(I32)
    a_tilde = ((a + U32(1 << (shift - 1))) >> U32(shift)).astype(I32)

    # X^{-b~}: reduce to [0, 2N) for the gather-free binary rotation.
    neg_b = jnp.mod(-b_tilde, two_n)
    acc = poly.rotate_binary(testvec, neg_b[..., None])  # (..., 2, N)

    # scan over the n key bits; batch stays inside the step.
    a_steps = jnp.moveaxis(a_tilde, -1, 0)  # (n, ...)

    def step(acc, xs):
        bk_i, a_i = xs
        return cmux_step(acc, bk_i, a_i, params, engine), None

    acc, _ = jax.lax.scan(step, acc, (bk_prepared, a_steps))
    return acc


def cmux_step(acc, bk_i, a_i, params: TFHEParams, engine) -> jnp.ndarray:
    """One blind-rotate step: acc + bk_i (x) (X^{a_i} * acc - acc).

    acc: uint32 (..., 2, N); bk_i: one engine-prepared TRGSW; a_i: int32
    (...,) rotation amounts in [0, 2N)."""
    rotated = poly.rotate_binary(acc, a_i[..., None])
    diff = (rotated - acc).astype(U32)
    digits = trgsw.decompose_trlwe(diff, params)
    cross = engine.external_product_digits(bk_i, digits, params)
    return (acc + cross).astype(U32)


def gate_bootstrapping_tlwe2tlwe(ct, bk_prepared, params: TFHEParams, engine) -> jnp.ndarray:
    """lv0 TLWE -> lv1 TLWE encrypting mu * sign (tfhe.rs:81-88)."""
    mu = U32(params.mu)
    testvec = trlwe.trivial(jnp.full((params.N,), mu, U32))  # (2, N)
    rotated = blind_rotate(ct, bk_prepared, testvec, params, engine)
    return trlwe.sample_extract(rotated, 0)


def identity_key_switch(ct_lv1, ksk_prepared, params: TFHEParams, engine) -> jnp.ndarray:
    """lv1 TLWE (..., N+1) -> lv0 TLWE (..., n+1) (tlwe.rs:43-73)."""
    b = tlwe.body(ct_lv1)
    a = tlwe.mask(ct_lv1)  # (..., N)
    digits = decompose_unsigned(a, params)  # (..., N, iks_l)
    contrib = engine.key_switch_digits(ksk_prepared, digits, params)
    return (tlwe.trivial(b, params.n) - contrib).astype(U32)


def bootstrap(ct, ck: CloudKey, params: TFHEParams, engine) -> jnp.ndarray:
    """Full gate bootstrap: blind rotate + extract + key switch (tfhe.rs:73-80)."""
    lv1 = gate_bootstrapping_tlwe2tlwe(ct, ck.bk, params, engine)
    return identity_key_switch(lv1, ck.ksk, params, engine)
