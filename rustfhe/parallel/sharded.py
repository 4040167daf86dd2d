"""Mesh-sharded batched gate evaluation.

Replaces the reference's nonexistent parallelism (SURVEY.md §2.6) with a
mesh scale-out path:

* gate batch partitioned over the ``data`` axis (each device bootstraps its
  shard of the batch independently — no communication in the blind-rotate
  scan; this is the >=1M gates/s axis),
* key-switch table rows partitioned over the ``model`` axis, with each
  device accumulating its partial sum of KS[i,l,d] contributions and a
  ``psum`` producing the full switch (the collective analogue of
  the accumulation loop at reference ``tlwe.rs:65-72``).

Bootstrapping keys are replicated (62 MB at default parameters in the matmul
engine's form, small beside device memory — SURVEY.md §7 "Hard parts" 5).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from .. import tlwe, trlwe
from ..bootstrap import blind_rotate
from ..decomp import decompose_unsigned
from ..engine import resolve_engine
from ..keys import CloudKey
from ..params import TFHEParams

U32 = jnp.uint32
I32 = jnp.int32
I8 = jnp.int8


def _key_switch_local(ct_lv1, ksk_local, params: TFHEParams, engine, axis_name: str):
    """Key switch with the KSK row-sharded over ``axis_name``.

    ksk_local: this device's contiguous row-shard of the prepared KSK
    (matmul engine layout: (Q_local, (n+1)*K) int8).  Builds the full
    one-hot, slices the local Q range, matmuls, and psums partial limbs.

    Requires the ``model`` axis size to divide N*iks_l (i.e. each contiguous
    row shard covers whole (i, l) digit groups: Q = N*iks_l*(iks_t-1) rows
    with the t axis innermost).  Power-of-two axis sizes always satisfy this
    at power-of-two N; the assert below fails loudly at trace time otherwise.
    """
    b = tlwe.body(ct_lv1)
    a = tlwe.mask(ct_lv1)
    digits = decompose_unsigned(a, params)  # (..., N, iks_l)
    nslots = params.iks_t - 1
    il = params.N * params.iks_l
    d = digits.astype(I32).reshape(digits.shape[:-2] + (il,))

    # Per-slot mask dots over this device's (i, l) row range (the t axis is
    # innermost in the prepared layout, so a contiguous row shard is a whole
    # number of (i, l) groups) — same formulation as the unsharded engine.
    q_local = ksk_local.shape[0]
    assert q_local % nslots == 0, (q_local, nslots)
    il_local = q_local // nslots
    start = jax.lax.axis_index(axis_name) * il_local
    d_local = jax.lax.dynamic_slice_in_dim(d, start, il_local, axis=-1)
    ks3 = ksk_local.reshape(il_local, nslots, ksk_local.shape[-1])
    out = None
    for t in range(1, params.iks_t):
        m = (d_local == t).astype(I8)
        part = jnp.dot(m, ks3[:, t - 1], preferred_element_type=I32)
        out = part if out is None else out + part
    out = jax.lax.psum(out, axis_name)  # exact: integer partial sums
    K = engine.num_limbs
    out = out.reshape(out.shape[:-1] + (out.shape[-1] // K, K))
    acc = jnp.zeros(out.shape[:-1], U32)
    u = out.astype(U32)
    for k in range(K):
        acc = acc + (u[..., k] << U32(engine.limb_bits * k))
    return (tlwe.trivial(b, params.n) - acc).astype(U32)


def _bootstrap_local(pre, bk, ksk_local, params: TFHEParams, engine,
                     ks_fn=None):
    """Full bootstrap of the local batch shard, key switch psum'd over
    ``model`` (blind rotate + extract: tfhe.rs:73-88; switch: tlwe.rs:43-73)."""
    testvec = trlwe.trivial(jnp.full((params.N,), jnp.asarray(params.mu, U32), U32))
    rotated = blind_rotate(pre, bk, testvec, params, engine)
    lv1 = trlwe.sample_extract(rotated, 0)
    if ks_fn is None:
        return _key_switch_local(lv1, ksk_local, params, engine, "model")
    return ks_fn(lv1, ksk_local, params, engine)


def _gate_local(kind: str, params: TFHEParams, engine, ks_fn=None):
    """The six reference gate formulas (tfhe.rs:27-71) over local shards."""
    mu = jnp.asarray(params.mu, U32)

    def mu_triv():
        return tlwe.trivial(mu, params.n)

    def nand(bk, ksk, x, y):
        pre = (mu_triv() - (x + y)).astype(U32)
        return _bootstrap_local(pre, bk, ksk, params, engine, ks_fn)

    def and_(bk, ksk, x, y):
        pre = ((x + y) - mu_triv()).astype(U32)
        return _bootstrap_local(pre, bk, ksk, params, engine, ks_fn)

    def or_(bk, ksk, x, y):
        pre = ((x + y) + mu_triv()).astype(U32)
        return _bootstrap_local(pre, bk, ksk, params, engine, ks_fn)

    def xor(bk, ksk, x, y):
        two_mu = tlwe.trivial(jnp.asarray((2 * params.mu) & 0xFFFFFFFF, U32), params.n)
        pre = ((x + y) * U32(2) + two_mu).astype(U32)
        return _bootstrap_local(pre, bk, ksk, params, engine, ks_fn)

    def not_(bk, ksk, x):
        return _bootstrap_local(tlwe.neg(x), bk, ksk, params, engine, ks_fn)

    def mux(bk, ksk, control, in0, in1):
        # Two independent ANDs fused into one double-width bootstrap batch
        # (same trick as gates.hom_mux), then the OR bootstrap.
        pre_a = ((control + in1) - mu_triv()).astype(U32)
        pre_b = ((tlwe.neg(control) + in0) - mu_triv()).astype(U32)
        both = _bootstrap_local(jnp.stack([pre_a, pre_b]), bk, ksk, params, engine, ks_fn)
        pre = (both[0] + both[1] + mu_triv()).astype(U32)
        return _bootstrap_local(pre, bk, ksk, params, engine, ks_fn)

    return {"nand": nand, "and": and_, "or": or_, "xor": xor,
            "not": not_, "mux": mux}[kind]


def sharded_gate_fn(mesh: Mesh, params: TFHEParams, engine_name="matmul",
                    kind: str = "nand", key_switch: str = "psum"):
    """Build a jitted, mesh-sharded homomorphic gate over (bk, ksk, *cts).

    ``engine_name``: a registered engine name or an engine INSTANCE (the
    bk must have been prepared by the same engine).
    ``kind``: one of nand/and/or/xor (2 ciphertext args), not (1 arg),
    mux (3 args).  ``key_switch``: "psum" (each device builds the full
    one-hot and slices its KSK row range; requires the ``model`` axis size
    to divide N*iks_l — see _key_switch_local) or "all_to_all" (one-hot
    built batch-sharded over ``data``, transpose-exchanged to row-sharded —
    the KSK must then be row-sharded over ``data``).  The returned function
    expects ciphertext batches sharded over ``data``; the bootstrapping key
    is replicated.  Returns outputs sharded over ``data``.
    """
    engine = resolve_engine(engine_name)
    if key_switch == "psum":
        gate = _gate_local(kind, params, engine)
        ksk_spec = P("model")
    elif key_switch == "all_to_all":
        def ks_fn(lv1, ksk_local, p_, eng):
            return key_switch_all_to_all(lv1, ksk_local, p_, eng, "data")

        gate = _gate_local(kind, params, engine, ks_fn)
        ksk_spec = P("data")
    else:
        raise ValueError(f"unknown key_switch {key_switch!r}")
    n_cts = {"not": 1, "mux": 3}.get(kind, 2)
    mapped = jax.shard_map(
        gate,
        mesh=mesh,
        in_specs=(P(), ksk_spec) + (P("data"),) * n_cts,
        out_specs=P("data"),
    )
    return jax.jit(mapped)


def sharded_bootstrap_fn(mesh: Mesh, params: TFHEParams, engine_name="matmul",
                         ndim: int = 2, shard_batch: bool = True):
    """Jitted, mesh-sharded bootstrap of an already-precombined batch.

    The returned function maps (bk, ksk, pre) -> bootstrapped outputs, with
    ``pre`` of rank ``ndim`` shaped (..., B, n+1): the axis before the
    ciphertext axis is data-sharded (any leading gate-lane axes stay
    replicated); the key switch uses the model-psum path.  This is the one
    construction behind both GateSession.bootstrap_raw and bench.py's
    BENCH_SHARDED measurement — keep them on it so the library path and
    the benched path cannot drift.  ``shard_batch=False`` computes
    replicated (for batches not divisible by the data axis).
    """
    engine = resolve_engine(engine_name)

    def boot(bk, ksk, pre_local):
        return _bootstrap_local(pre_local, bk, ksk, params, engine)

    spec = P(*((None,) * (ndim - 2) + ("data",))) if shard_batch else P()
    return jax.jit(
        jax.shard_map(
            boot, mesh=mesh,
            in_specs=(P(), P("model"), spec),
            out_specs=spec,
        )
    )


def sharded_pbs_fn(mesh: Mesh, params: TFHEParams, engine_name="matmul", *,
                   space: int, raw: bool = False, unsafe: bool = False):
    """Jitted, mesh-sharded (multi-output) programmable bootstrap.

    Returns ``(bk, ksk, ct, tables) -> (..., t, n+1)``: the ciphertext
    batch is sharded over ``data`` (axis 0), ``tables (t, space)`` is
    replicated (one t-tuple of functions for the whole batch), the key
    switch is the model-psum path — the PBS analogue of
    ``sharded_bootstrap_fn``, built on the same rotation core as the
    unsharded ``pbs.pbs_many`` so the two cannot drift.  The (space, t,
    params) margin gate applies exactly as on the unsharded path
    (``pbs._gate_margin``: raise < 3 calibrated sigma, warn < 5;
    ``unsafe=True`` skips it) — sharding does not change the noise."""
    from ..pbs import _gate_margin, rotate_extract_many

    engine = resolve_engine(engine_name)

    def run(bk, ksk_local, ct_local, tables):
        _gate_margin(params, space, tables.shape[-2], unsafe, "sharded_pbs")
        lv1 = rotate_extract_many(bk, ct_local, tables, space, params,
                                  engine, raw=raw)
        return _key_switch_local(lv1, ksk_local, params, engine, "model")

    return jax.jit(
        jax.shard_map(
            run, mesh=mesh,
            in_specs=(P(), P("model"), P("data"), P()),
            out_specs=P("data"),
        )
    )


# --------------------------------------------------------------------- #
# Tensor-parallel blind rotate: BK row-sharded, psum INSIDE the hot loop
# --------------------------------------------------------------------- #
class _TPMatmulEngine:
    """MatmulEngine wrapper whose external product contracts only this
    device's shard of the 2L gadget rows and psums the int32 partial limb
    sums over ``model`` BEFORE recombination (exact: |partial| <= 2^24.6,
    integer psum is associative).

    This is the tp-style sharding of the hot-loop contraction itself: each
    device stores 2L/model of every TRGSW (BK memory and matmul MACs divide by
    the axis size) and one psum of the (B_local, 2*K*N) int32 partials runs
    per blind-rotate step — the collective lives INSIDE lax.scan.
    """

    def __init__(self, base, axis_name: str):
        self._base = base
        self.axis = axis_name
        self.limb_bits = base.limb_bits
        self.num_limbs = base.num_limbs

    def external_product_digits(self, prepared_local, digits, params):
        # prepared_local: int8 (2L_local, 2, K, 2N) — this device's row shard.
        two_l_local = prepared_local.shape[0]
        start = jax.lax.axis_index(self.axis) * two_l_local
        d_local = jax.lax.dynamic_slice_in_dim(digits, start, two_l_local, axis=-2)
        circ = self._base._circulant(prepared_local, params)
        dflat = d_local.reshape(d_local.shape[:-2] + (two_l_local * params.N,))
        out = self._base._matmul(dflat, circ)  # int32 partial limb sums
        out = jax.lax.psum(out, self.axis)
        out = out.reshape(out.shape[:-1] + (2, self.num_limbs, params.N))
        return self._base._recombine(out, params)

    def poly_mul_torus_binary(self, a, s, params):
        return self._base.poly_mul_torus_binary(a, s, params)


class _TPFFT64Engine:
    """FFT64Engine wrapper for the same tp sharding: each device convolves
    only its shard of the 2L gadget rows (the per-limb f64 partial sums are
    exact integers, so a float psum over ``model`` BEFORE rounding is exact
    too — same associativity argument as the int32 limb psum above)."""

    def __init__(self, base, axis_name: str):
        self._base = base
        self.axis = axis_name
        self.limb_bits = base.limb_bits
        self.num_limbs = base.num_limbs

    def external_product_digits(self, prepared_local, digits, params):
        # prepared_local: c128 (2L_local, 2, K, N+1) — this device's rows.
        two_l_local = prepared_local.shape[0]
        start = jax.lax.axis_index(self.axis) * two_l_local
        d_local = jax.lax.dynamic_slice_in_dim(digits, start, two_l_local, axis=-2)
        part = self._base._conv_partial(prepared_local, d_local, params)
        part = jax.lax.psum(part, self.axis)
        return self._base._round_recombine(part, params)

    def poly_mul_torus_binary(self, a, s, params):
        return self._base.poly_mul_torus_binary(a, s, params)


def _tp_engine(engine, axis_name: str):
    """Tensor-parallel wrapper for the engines that support row sharding."""
    from ..engine.fft64 import FFT64Engine
    from ..engine.matmul import MatmulEngine

    if isinstance(engine, FFT64Engine):
        return _TPFFT64Engine(engine, axis_name)
    if isinstance(engine, MatmulEngine):
        return _TPMatmulEngine(engine, axis_name)
    raise TypeError(
        f"engine {getattr(engine, 'name', engine)!r} has no tensor-parallel "
        "row-sharded external product (use 'matmul' or 'fft64')"
    )


def tp_gate_fn(mesh: Mesh, params: TFHEParams, kind: str = "nand",
               engine_name="matmul"):
    """Mesh-sharded gate with the BK gadget rows tensor-parallel over
    ``model``: per-step psum of external-product partials inside the scan,
    plus the psum key switch.  Inputs: bk sharded on its 2L axis, ksk row
    sharded, ciphertexts over ``data``."""
    engine = resolve_engine(engine_name)
    n_cts = {"not": 1, "mux": 3}.get(kind, 2)

    def gate_n(bk_local, ksk_local, *cts):
        tp = _tp_engine(engine, "model")
        return _gate_local(kind, params, tp)(bk_local, ksk_local, *cts)

    mapped = jax.shard_map(
        gate_n,
        mesh=mesh,
        in_specs=(P(None, "model"), P("model")) + (P("data"),) * n_cts,
        out_specs=P("data"),
    )
    return jax.jit(mapped)


def shard_cloud_key_tp(ck: CloudKey, mesh: Mesh):
    """BK sharded over its gadget-row (2L) axis, KSK row-sharded."""
    from jax.sharding import NamedSharding

    bk = jax.device_put(ck.bk, NamedSharding(mesh, P(None, "model")))
    ksk = jax.device_put(ck.ksk, NamedSharding(mesh, P("model")))
    return CloudKey(bk=bk, ksk=ksk)


# --------------------------------------------------------------------- #
# all_to_all key switch: batch-sharded one-hot exchanged to row-sharded
# --------------------------------------------------------------------- #
def key_switch_all_to_all(ct_lv1, ksk_local, params: TFHEParams, engine,
                          axis_name: str):
    """Key switch where each device builds the one-hot only for its BATCH
    shard, then ``all_to_all`` re-shards it from batch-major to KSK-row-major
    before the local matmul (the transpose-exchange pattern of a sharded
    contraction; SURVEY.md §5 names all_to_all for transposed stages), and a
    final psum accumulates the partial limb sums.

    ct_lv1: (..., B_local, N+1) — batch sharded over ``axis_name`` (leading
    dims allowed; they are folded into the exchanged batch).
    ksk_local: (Q_local, (n+1)*K) — rows sharded over the SAME axis.
    Returns the switched lv0 ciphertexts, batch-sharded as on entry.
    """
    lead = ct_lv1.shape[:-1]
    b = tlwe.body(ct_lv1)
    a = tlwe.mask(ct_lv1)
    digits = decompose_unsigned(a, params)  # (..., N, iks_l)
    nslots = params.iks_t - 1
    t = jnp.arange(1, params.iks_t, dtype=I32)
    onehot = (digits.astype(I32)[..., None] == t).astype(I8)
    q_total = params.N * params.iks_l * nslots
    onehot = onehot.reshape(-1, q_total)  # (B_local_flat, Q)

    b_local = onehot.shape[0]
    # Transpose-exchange: batch-sharded (B_local, Q) -> row-sharded
    # (B_total, Q_local).  Chunk d of every peer's Q axis lands on device d,
    # concatenated in peer (= batch) order.
    full_onehot_local = jax.lax.all_to_all(
        onehot, axis_name, split_axis=1, concat_axis=0, tiled=True
    )
    part = jnp.dot(full_onehot_local, ksk_local, preferred_element_type=I32)
    part = jax.lax.psum(part, axis_name)  # (B_total, (n+1)*K) int32, exact
    K = engine.num_limbs
    out = part.reshape(part.shape[:-1] + (part.shape[-1] // K, K))
    acc = jnp.zeros(out.shape[:-1], U32)
    u = out.astype(U32)
    for k in range(K):
        acc = acc + (u[..., k] << U32(engine.limb_bits * k))
    # Back to batch-sharded: take this device's slice of the full batch
    # (its own flattened rows, by construction of the concat order).
    my = jax.lax.axis_index(axis_name) * b_local
    acc_local = jax.lax.dynamic_slice_in_dim(acc, my, b_local, axis=0)
    acc_local = acc_local.reshape(lead + (params.n + 1,))
    return (tlwe.trivial(b, params.n) - acc_local).astype(U32)


def shard_cloud_key(ck: CloudKey, mesh: Mesh):
    """Place BK replicated and KSK row-sharded over ``model``."""
    from jax.sharding import NamedSharding

    bk = jax.device_put(ck.bk, NamedSharding(mesh, P()))
    ksk = jax.device_put(ck.ksk, NamedSharding(mesh, P("model")))
    return CloudKey(bk=bk, ksk=ksk)
