"""Batched encrypted fixed-width integers: ``FheUint`` / ``FheInt``.

The reference exposes single encrypted *bits* plus a gate REPL
(``nander/src/lib.rs:19-38``); real users of a TFHE framework want typed
integers (the ``FheUint8``-style API of modern TFHE libraries).  This
module provides them as a thin, fully batched layer over the level-fused
circuit evaluator (``apps/circuits.py``): an encrypted integer is a stack
of TLWE bit ciphertexts ``(..., width, n+1)`` (LSB first), and every
arithmetic op lowers to one standard-cell circuit evaluated with ONE
batched bootstrap per level across both the integer's bits and all user
batch axes — the batch-first shape of the computation.

Cost notes (bootstraps are the only expensive op):
  * ``~x`` and comparisons' final negations are LINEAR (``tlwe.neg`` — the
    binary encoding is ±1/8, so NOT is negation, ``tfhe.rs:27``): free.
  * plaintext shifts are ciphertext-plane moves: free.
  * ``& | ^`` are one single-level batched bootstrap over all bits.
  * ``+ - * // %`` and comparisons run their cell circuit level-fused.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from . import tlwe
from .apps import circuits

U32 = jnp.uint32


def _select_bits(ctx, cond, bits_true, bits_false):
    """mux over bit-plane stacks; cond (..., n+1) broadcasts over the
    width axis.  Returns bits of the true branch where cond=1."""
    return ctx.mux(cond[..., None, :], bits_false, bits_true)


class FheUint:
    """Encrypted unsigned integer, fixed ``width`` bits, wrapping mod
    2^width; arbitrary leading batch axes.

    ``bits``: uint32 array ``(..., width, n+1)`` of TLWE ciphertexts,
    LSB first.
    """

    SIGNED = False

    def __init__(self, ctx, bits):
        self.ctx = ctx
        self.bits = jnp.asarray(bits, U32)
        assert self.bits.ndim >= 2, "bits must be (..., width, n+1)"

    # ------------------------- construction --------------------------- #
    @classmethod
    def encrypt(cls, ctx, values, width: int) -> "FheUint":
        return cls(ctx, ctx.encrypt(cls._to_bits(values, width)))

    @classmethod
    def trivial(cls, ctx, values, width: int) -> "FheUint":
        """Noiseless ciphertexts of plaintext constants (AsLogic,
        tlwe.rs:80-87) — the evaluator-side way to mix plaintexts in."""
        return cls(ctx, ctx.trivial(cls._to_bits(values, width)))

    @classmethod
    def encrypt_seeded(cls, ctx, values, width: int):
        """Compressed client->server upload of integers: (seed, bodies)
        over the (..., width) bit planes, ~(n+1)x smaller than
        ``encrypt``; rebuild with ``expand_seeded`` (public — the server
        or any cloud-only context can do it)."""
        return ctx.encrypt_seeded(cls._to_bits(values, width))

    @classmethod
    def expand_seeded(cls, ctx, seeded) -> "FheUint":
        return cls(ctx, ctx.expand_seeded(seeded))

    @classmethod
    def encrypt_public(cls, ctx, pk, values, width: int, key=None) -> "FheUint":
        """Keyless typed-integer encryption under a PUBLIC key
        (tlwe.gen_public_key): works on a cloud-only context with an
        explicit PRNG ``key``."""
        return cls(ctx, ctx.encrypt_public(pk, cls._to_bits(values, width),
                                           key=key))

    @staticmethod
    def _to_bits(values, width: int):
        assert 0 < width <= 64
        v = np.asarray(values, np.uint64)
        idx = np.arange(width, dtype=np.uint64)
        return jnp.asarray((v[..., None] >> idx) & np.uint64(1), U32)

    def decrypt(self):
        """Decrypt to integers (np.uint64 / np.int64 for FheInt)."""
        assert self.width <= 64
        bits = np.asarray(self.ctx.decrypt(self.bits), np.uint64)
        val = np.zeros(bits.shape[:-1], np.uint64)
        for i in range(self.width):
            val |= bits[..., i] << np.uint64(i)
        if self.SIGNED:
            if self.width == 64:
                # uint64 -> int64 reinterpret IS two's complement at w=64
                # (the shift-based form below would shift by 64: UB).
                return val.view(np.int64)
            sign = (val >> np.uint64(self.width - 1)) & np.uint64(1)
            return (val.astype(np.int64)
                    - (sign.astype(np.int64) << np.int64(self.width)))
        return val

    # --------------------------- plumbing ----------------------------- #
    @property
    def width(self) -> int:
        return self.bits.shape[-2]

    @property
    def batch_shape(self):
        return self.bits.shape[:-2]

    def _like(self, bits) -> "FheUint":
        return type(self)(self.ctx, bits)

    def _zero_plane(self):
        """A trivial-zero ciphertext plane shaped like one bit plane."""
        zeros = jnp.zeros(self.batch_shape + (1,), U32)
        return self.ctx.trivial(zeros)

    def _ext_planes(self, k: int):
        """k extension planes: zeros (unsigned) / copies of the sign plane
        (signed).  Copying a ciphertext is a valid sign extension — the
        planes decrypt equal by construction."""
        if self.SIGNED:
            msb = self.bits[..., -1:, :]
            return jnp.broadcast_to(msb, self.batch_shape + (k,) + msb.shape[-1:])
        z = self._zero_plane()
        return jnp.broadcast_to(z, self.batch_shape + (k,) + z.shape[-1:])

    def extend(self, width: int) -> "FheUint":
        """Zero-extend (FheUint) / sign-extend (FheInt) to ``width``."""
        if width == self.width:
            return self
        assert width > self.width
        ext = self._ext_planes(width - self.width)
        return self._like(jnp.concatenate([self.bits, ext], axis=-2))

    def _coerce(self, other, *, dunder: bool = False):
        """Coerce ``other`` to a same-width operand.

        Dunder operators (``dunder=True``) return ``(NotImplemented,
        NotImplemented)`` on unsupported types so Python's protocol can try
        the reflected op; named methods raise ``TypeError`` directly."""
        if isinstance(other, (int, np.integer)):
            # Mask in Python-int space, carry as uint64: widths up to 64
            # coerce exactly (a pre-masked uint32 constant would silently
            # drop bits 32..63).
            val = int(other) & ((1 << self.width) - 1)
            other = type(self).trivial(
                self.ctx,
                np.full(self.batch_shape, val, np.uint64),
                self.width,
            )
        if not isinstance(other, FheUint):
            if dunder:
                return NotImplemented, NotImplemented
            raise TypeError(
                f"operand must be FheUint/FheInt or int, "
                f"got {type(other).__name__}"
            )
        if other.SIGNED != self.SIGNED:
            raise TypeError("cannot mix FheUint and FheInt operands")
        w = max(self.width, other.width)
        return self.extend(w), other.extend(w)

    def _run(self, cell: circuits.Circuit, *operands: "FheUint"):
        """Evaluate a standard cell on the concatenated bit planes; returns
        the output planes ``(..., n_out, n+1)``.

        If the ctx carries a ``circuit_fixed_width`` attribute, every level
        is padded to that width so ONE compiled bootstrap program serves
        all levels of all cells — set it where compiles are expensive (each
        new width compiles the n-step scan); it must be >= the widest level used
        (64 covers every 8-bit cell)."""
        ct_in = jnp.concatenate([o.bits for o in operands], axis=-2)
        fw = getattr(self.ctx, "circuit_fixed_width", None)
        return circuits.evaluate_encrypted(cell, self.ctx, ct_in,
                                           fixed_width=fw)

    # ------------------------- arithmetic ----------------------------- #
    def _adder_kind(self) -> str:
        """Adder cell family: "kogge_stone" (default — log-depth, the
        latency-right choice on the level-fused evaluator) or "ripple"
        (fewest gates; set ``ctx.circuit_adder = "ripple"`` for
        throughput-bound huge batches)."""
        return getattr(self.ctx, "circuit_adder", "kogge_stone")

    def add_with_carry(self, other):
        a, b = self._coerce(other)
        cell = (circuits.ripple_carry_adder if self._adder_kind() == "ripple"
                else circuits.kogge_stone_adder)(a.width)
        out = a._run(cell, a, b)
        return a._like(out[..., : a.width, :]), out[..., a.width, :]

    def __add__(self, other):
        a, b = self._coerce(other, dunder=True)
        if a is NotImplemented:
            return NotImplemented
        s, _carry = a.add_with_carry(b)
        return s

    __radd__ = __add__

    def sub_with_borrow(self, other):
        """(self - other mod 2^w, borrow bit ct); borrow=1 iff
        self < other (unsigned).

        Default path: two's-complement through the log-depth adder —
        ``a + ~b + 1`` with ~b and the three output fixups (bit 0's
        complement, borrow = NOT carry) all FREE plane negations
        (tlwe.neg), so subtraction costs exactly an addition."""
        a, b = self._coerce(other)
        if self._adder_kind() == "ripple":
            out = a._run(circuits.ripple_borrow_subtractor(a.width), a, b)
            return a._like(out[..., : a.width, :]), out[..., a.width, :]
        nb = a._like(tlwe.neg(b.bits))
        out = a._run(
            circuits.kogge_stone_adder(a.width, incoming_one=True), a, nb)
        diff = out[..., : a.width, :]
        diff = diff.at[..., 0, :].set(tlwe.neg(diff[..., 0, :]))
        borrow = tlwe.neg(out[..., a.width, :])
        return a._like(diff), borrow

    def __sub__(self, other):
        a, b = self._coerce(other, dunder=True)
        if a is NotImplemented:
            return NotImplemented
        d, _borrow = a.sub_with_borrow(b)
        return d

    def __rsub__(self, other):
        a, b = self._coerce(other, dunder=True)
        if a is NotImplemented:
            return NotImplemented
        return b - a

    def __neg__(self):
        return type(self).trivial(
            self.ctx, jnp.zeros(self.batch_shape, U32), self.width) - self

    def _mul_cell(self, w: int):
        return (circuits.array_multiplier if self._adder_kind() == "ripple"
                else circuits.wallace_multiplier)(w)

    def mul_full(self, other):
        """Full-width UNSIGNED product (2w bits).  FheInt overrides this
        with the sign-extending variant (the unsigned multiplier's high
        half is wrong for negative operands)."""
        a, b = self._coerce(other)
        out = a._run(a._mul_cell(a.width), a, b)
        return a._like(out)

    def __mul__(self, other):
        # Truncated product mod 2^w: identical bits for signed/unsigned
        # (so the unsigned array multiplier serves both — FheInt.mul_full
        # overrides the FULL-width product, which is not sign-agnostic).
        a, b = self._coerce(other, dunder=True)
        if a is NotImplemented:
            return NotImplemented
        out = a._run(a._mul_cell(a.width), a, b)
        return a._like(out[..., : a.width, :])

    __rmul__ = __mul__

    def divmod(self, other):
        """Unsigned restoring long division: (quotient, remainder).

        Division by zero follows the usual TFHE-library convention:
        quotient = 2^w - 1, remainder = self.  w subtract+select rounds,
        each level-fused; the quotient bits are linear NOTs of fresh
        borrow bits (no extra bootstraps).
        """
        assert not self.SIGNED, "divmod is defined on FheUint"
        a, b = self._coerce(other)
        w = a.width
        r = type(a).trivial(a.ctx, jnp.zeros(a.batch_shape, U32), w)
        q_planes = [None] * w
        for i in reversed(range(w)):
            # r = (r << 1) | a[i]: pure plane shuffle.
            r = a._like(jnp.concatenate(
                [a.bits[..., i : i + 1, :], r.bits[..., : w - 1, :]], axis=-2))
            diff, borrow = r.sub_with_borrow(b)
            r = a._like(_select_bits(a.ctx, borrow, r.bits, diff.bits))
            q_planes[i] = tlwe.neg(borrow)  # q[i] = NOT borrow, linear
        q = a._like(jnp.stack(q_planes, axis=-2))
        return q, r

    def __floordiv__(self, other):
        return self.divmod(other)[0]

    def __mod__(self, other):
        return self.divmod(other)[1]

    # -------------------------- bitwise ------------------------------- #
    def _bitop(self, op: str, other):
        a, b = self._coerce(other, dunder=True)
        if a is NotImplemented:
            return NotImplemented
        return a._like(getattr(a.ctx, op)(a.bits, b.bits))

    def __and__(self, other):
        return self._bitop("and_", other)

    def __or__(self, other):
        return self._bitop("or_", other)

    def __xor__(self, other):
        return self._bitop("xor", other)

    __rand__, __ror__, __rxor__ = __and__, __or__, __xor__

    def __invert__(self):
        # Binary encoding is ±1/8: NOT is linear negation (tfhe.rs:27).
        return self._like(tlwe.neg(self.bits))

    def __lshift__(self, k: int):
        k = int(k)
        assert 0 <= k
        if k == 0:
            return self
        if k >= self.width:
            return type(self).trivial(
                self.ctx, jnp.zeros(self.batch_shape, U32), self.width)
        z = jnp.broadcast_to(self._zero_plane(),
                             self.batch_shape + (k, self.bits.shape[-1]))
        return self._like(
            jnp.concatenate([z, self.bits[..., : self.width - k, :]], axis=-2))

    def __rshift__(self, k: int):
        """Logical shift (FheUint) / arithmetic shift (FheInt)."""
        k = int(k)
        assert 0 <= k
        if k == 0:
            return self
        k = min(k, self.width)
        if k == self.width:  # unsigned -> zeros; signed -> all sign planes
            return self._like(self._ext_planes(k))
        return self._like(jnp.concatenate(
            [self.bits[..., k:, :], self._ext_planes(k)], axis=-2))

    def rotl(self, k: int) -> "FheUint":
        """Rotate bits left by a plaintext amount: pure plane cycle, free."""
        k = int(k) % self.width
        if k == 0:
            return self
        return self._like(jnp.concatenate(
            [self.bits[..., -k:, :], self.bits[..., :-k, :]], axis=-2))

    def rotr(self, k: int) -> "FheUint":
        return self.rotl(-int(k) % self.width)

    # ------------------------- comparisons ---------------------------- #
    def _cmp_bits(self):
        """Bit planes used for magnitude comparison: unsigned uses the raw
        planes; signed flips the sign plane (linear NOT) so two's-complement
        order becomes unsigned order."""
        if not self.SIGNED:
            return self.bits
        flipped = tlwe.neg(self.bits[..., -1:, :])
        return jnp.concatenate([self.bits[..., :-1, :], flipped], axis=-2)

    def _compare(self, other):
        """(lt, eq, gt) encrypted bit ciphertexts.

        Default path: the log-depth prefix comparator (b's planes
        pre-complemented for free); lt = NOT ge is free, gt = ge AND NOT
        eq is one extra single-gate level."""
        a, b = self._coerce(other)
        if self._adder_kind() == "ripple":
            ct_in = jnp.concatenate([a._cmp_bits(), b._cmp_bits()], axis=-2)
            out = circuits.evaluate_encrypted(
                circuits.comparator(a.width), a.ctx, ct_in,
                fixed_width=getattr(a.ctx, "circuit_fixed_width", None))
            return out[..., 0, :], out[..., 1, :], out[..., 2, :]
        ct_in = jnp.concatenate(
            [a._cmp_bits(), tlwe.neg(b._cmp_bits())], axis=-2)
        out = circuits.evaluate_encrypted(
            circuits.prefix_comparator(a.width), a.ctx, ct_in,
            fixed_width=getattr(a.ctx, "circuit_fixed_width", None))
        ge, eq = out[..., 0, :], out[..., 1, :]
        lt = tlwe.neg(ge)
        gt = a.ctx.and_(ge, tlwe.neg(eq))
        return lt, eq, gt

    def lt(self, other):
        return self._compare(other)[0]

    def eq(self, other):
        return self._compare(other)[1]

    def gt(self, other):
        return self._compare(other)[2]

    def ne(self, other):
        return tlwe.neg(self.eq(other))

    def le(self, other):
        return tlwe.neg(self.gt(other))

    def ge(self, other):
        return tlwe.neg(self.lt(other))

    # -------------------------- selection ----------------------------- #
    def select(self, cond, other) -> "FheUint":
        """cond ? self : other, cond an encrypted bit ``(..., n+1)``."""
        a, b = self._coerce(other)
        return a._like(_select_bits(a.ctx, cond, a.bits, b.bits))

    def min_(self, other):
        a, b = self._coerce(other)
        return a.select(a.lt(b), b)

    def max_(self, other):
        a, b = self._coerce(other)
        return a.select(a.gt(b), b)

    def abs_(self):
        if not self.SIGNED:
            return self
        # sign plane IS an encrypted is-negative bit.
        return (-self).select(self.bits[..., -1, :], self)


def from_pbs_int(ctx, ct, space: int, *, unsafe: bool = False) -> FheUint:
    """Bridge a PBS-domain encrypted integer into the bit world: decompose
    ``ct`` (padding-bit encoding of x in [0, space), see pbs.py) into a
    ``FheUint`` of width log2(space) via multi-output PBS with raw
    gate-encoded ±mu tables.

    The multi-output degree ``t`` is chosen ADAPTIVELY: the largest power
    of two whose t²-scaled modulus-switch drift passes the calibrated
    noise check at ``ctx.params`` (``pbs.check_pbs_many``; t=1 falls back
    to ``check_pbs_space``), and the bit planes split into
    ``ceil(width / t)`` rotations — e.g. at ``params.PBS_PARAMS`` a
    space-8 integer decomposes in 2 rotations of t=2 at a >= 5-sigma
    margin, where a single t=4 rotation would sit at ~2.6 calibrated
    sigma.  If even t=1 fails the space check, raises unless
    ``unsafe=True`` (which also restores the single-rotation maximal-t
    form for borderline-margin measurements).

    The result's bits are fresh gate-encoded ciphertexts, so the full
    integer/circuit API composes on them.
    """
    from . import pbs as _pbs

    w = space.bit_length() - 1
    assert space == 1 << w, f"space must be a power of two, got {space}"
    t_full = 1 << max(0, (w - 1)).bit_length() if w > 1 else 1  # pad to pow2
    if unsafe:
        t = t_full
    else:
        t = 0
        cand = t_full
        while cand >= 1:
            ok, msg = (_pbs.check_pbs_many(ctx.params, space, cand)
                       if cand > 1 else _pbs.check_pbs_space(ctx.params, space))
            if ok:
                t = cand
                break
            cand >>= 1
        if t == 0:
            raise ValueError(
                f"from_pbs_int margin below threshold at this parameter set "
                f"even at t=1 ({msg}); use a PBS-tuned preset "
                f"(params.PBS_PARAMS) or pass unsafe=True to override"
            )
    mu = ctx.params.mu
    neg_mu = (-mu) & 0xFFFFFFFF
    bit_tab = [[(mu if (x >> j) & 1 else neg_mu) for x in range(space)]
               for j in range(w)]
    planes = []
    for j0 in range(0, w, t):
        chunk = bit_tab[j0 : j0 + t]
        pad = t - len(chunk)
        tabs = np.array(chunk + [[0] * space] * pad, np.uint32)
        if t == 1:
            out = _pbs.pbs(ctx.ck, ct, jnp.asarray(tabs[0]), space=space,
                           raw=True, params=ctx.params, unsafe=unsafe,
                           engine_name=ctx.engine_name)[..., None, :]
        else:
            out = _pbs.pbs_many(ctx.ck, ct, jnp.asarray(tabs), space=space,
                                raw=True, params=ctx.params, unsafe=unsafe,
                                engine_name=ctx.engine_name)
        planes.append(out[..., : len(chunk), :])
    return FheUint(ctx, jnp.concatenate(planes, axis=-2))


class FheInt(FheUint):
    """Encrypted signed integer (two's complement, ``width`` bits).

    Wrapping add/sub/mul and the bitwise/shift/select ops are inherited
    bit-identically; comparisons order by flipped sign plane and ``>>`` is
    arithmetic.  ``divmod`` stays unsigned-only (use ``abs_`` + ``select``
    to build signed division if needed).
    """

    SIGNED = True

    def mul_full(self, other):
        """Full-width SIGNED product (2w bits, two's complement).

        Sign-extends both operands to 2w and takes the low 2w bits of the
        unsigned product — the truncation identity makes those bits the
        exact signed product, which always fits 2w bits."""
        a, b = self._coerce(other)
        w = a.width
        ae, be = a.extend(2 * w), b.extend(2 * w)
        out = ae._run(a._mul_cell(2 * w), ae, be)
        return a._like(out[..., : 2 * w, :])

    def divmod(self, other):
        """Signed TRUNCATED division (C/Rust semantics): quotient rounds
        toward zero, remainder takes the dividend's sign.

        Built on the unsigned restoring divider over |a|, |b|: the signs
        are re-applied with encrypted-condition selects (q negated iff the
        signs differ, r negated iff a < 0).  |INT_MIN| wraps (two's
        complement), matching ``wrapping_div``."""
        a, b = self._coerce(other)
        sa = a.bits[..., -1, :]  # sign planes ARE encrypted is-negative bits
        sb = b.bits[..., -1, :]
        ua = FheUint(a.ctx, (-a).select(sa, a).bits)  # |a| (unsigned view)
        ub = FheUint(b.ctx, (-b).select(sb, b).bits)
        q_u, r_u = ua.divmod(ub)
        q_u, r_u = a._like(q_u.bits), a._like(r_u.bits)  # back to signed
        sdiff = a.ctx.xor(sa, sb)  # one single-bit bootstrap
        q = (-q_u).select(sdiff, q_u)
        r = (-r_u).select(sa, r_u)
        return q, r

    @staticmethod
    def _to_bits(values, width: int):
        v = np.asarray(values)
        if np.issubdtype(v.dtype, np.signedinteger):
            # int64 -> uint64 reinterpret, then mask: exact up to width 64
            # (an int64 mask constant would overflow at width 64).
            v = v.astype(np.int64).view(np.uint64) & np.uint64((1 << width) - 1)
        return FheUint._to_bits(v, width)
