"""Key generation: secret keys, key-switching key, bootstrapping key.

Mirrors ``TFHE::new`` (reference ``hom_nand/src/tfhe.rs:21-25``):
  * KSK lv1->lv0: N x iks_l x T TLWE encryptions of t*s_i/2^(basebit*(l+1))
    (tlwe.rs:246-277) — fully vectorized here instead of the reference's
    triple loop (which carries a "could be multithreaded" TODO, tlwe.rs:264).
  * BK: n TRGSW encryptions of the lv0 key bits under the lv1 key, stored in
    the engine's prepared (fast) representation — the analogue of the
    pre-FFT'd ``TRGSWRepF`` bootstrapping key (tfhe.rs:116-135).

All randomness flows from one ``jax.random`` key: keygen is deterministic
and reproducible, which the reference (thread_rng everywhere) cannot do.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import tlwe, trgsw
from .engine import resolve_engine
from .params import TFHEParams
from .utils.rng import binary_array

U32 = jnp.uint32


class SecretKey(NamedTuple):
    """lv0: (n,) uint32 bits; lv1: (N,) uint32 bits."""

    lv0: jnp.ndarray
    lv1: jnp.ndarray


class CloudKey(NamedTuple):
    """Evaluation key material in engine-prepared form.

    bk:  engine-prepared TRGSW rows with leading axis n (one per lv0 bit).
    ksk: engine-prepared key-switching table.
    """

    bk: object
    ksk: object


def gen_secret_key(key, params: TFHEParams) -> SecretKey:
    k0, k1 = jax.random.split(key)
    return SecretKey(
        lv0=binary_array(k0, (params.n,)),
        lv1=binary_array(k1, (params.N,)),
    )


def gen_key_switching_key_raw(key, sk: SecretKey, params: TFHEParams) -> jnp.ndarray:
    """Raw KSK: uint32 (N, iks_l, T, n+1); slot t encrypts
    (t+1) * s1_i * 2^(32 - basebit*(l+1)) (tlwe.rs:252-258, exact power-of-two
    messages so the integer form matches the reference's f32 arithmetic)."""
    N, L, T = params.N, params.iks_l, params.iks_t
    bb = params.iks_basebit
    s1 = sk.lv1.astype(U32)  # (N,)
    t_vals = jnp.arange(1, T + 1, dtype=U32)  # (T,)
    shifts = jnp.array([32 - bb * (l + 1) for l in range(L)], U32)  # (L,)
    # msg[i, l, t] = (t+1) * s1[i] << (32 - bb*(l+1)), wrapping
    msgs = (s1[:, None, None] * t_vals[None, None, :]) << shifts[None, :, None]
    return tlwe.encrypt_torus(key, sk.lv0, msgs.astype(U32), params)


def gen_bootstrapping_key_raw(key, sk: SecretKey, params: TFHEParams, engine) -> jnp.ndarray:
    """Raw BK: uint32 (n, 2L, 2, N) — TRGSW(s0_i) under s1 (tfhe.rs:119-126)."""
    return trgsw.encrypt_int(key, sk.lv1, sk.lv0.astype(jnp.int32), params, engine)


def gen_cloud_key(key, sk: SecretKey, params: TFHEParams, engine_name="matmul") -> CloudKey:
    """Generate the evaluation key, fully jitted.

    ``engine_name``: registered name or engine instance (the key is stored
    in that engine's prepared representation).

    jit matters here for memory, not just speed: the limb-splitting and key
    preparation create large intermediates that eager mode keeps alive;
    under jit XLA frees/fuses them, keeping peak HBM far lower.
    """
    engine = resolve_engine(engine_name)

    @partial(jax.jit, static_argnames=())
    def _gen(key, sk):
        kb, kk = jax.random.split(key)
        bk_raw = gen_bootstrapping_key_raw(kb, sk, params, engine)
        ksk_raw = gen_key_switching_key_raw(kk, sk, params)
        return CloudKey(
            bk=engine.prepare_trgsw(bk_raw, params),
            ksk=engine.prepare_ksk(ksk_raw, params),
        )

    return _gen(key, sk)


def gen_cloud_key_raw(key, sk: SecretKey, params: TFHEParams,
                      engine_name="matmul"):
    """(bk_raw, ksk_raw) uint32 — the engine-INDEPENDENT evaluation keys
    (every engine is exact mod 2^32, so the raw bytes do not depend on
    ``engine_name``; it only selects the encryption-path engine).  This is
    what ``utils.serialization.save_cloud_key_raw`` persists: prepare once
    per engine on load instead of re-running keygen per process."""
    engine = resolve_engine(engine_name)

    @jax.jit
    def _gen(key, sk):
        kb, kk = jax.random.split(key)
        return (
            gen_bootstrapping_key_raw(kb, sk, params, engine),
            gen_key_switching_key_raw(kk, sk, params),
        )

    return _gen(key, sk)


def gen_keys(key, params: TFHEParams = None, engine_name="matmul"):
    """One-call keygen: (SecretKey, CloudKey).

    ``engine_name=None`` auto-selects the fastest exact engine for the
    device (engine.select_fast_engine — runs an on-device probe; pass an
    explicit name to skip it)."""
    if params is None:
        from .params import DEFAULT_PARAMS

        params = DEFAULT_PARAMS
    if engine_name is None:
        from .engine import select_fast_engine

        engine_name = select_fast_engine(params)
    ks, kc = jax.random.split(key)
    sk = gen_secret_key(ks, params)
    ck = gen_cloud_key(kc, sk, params, engine_name)
    return sk, ck
