"""Radix-PBS encrypted integers: block arithmetic on programmable bootstraps.

The bit-circuit integer API (``ints.py``) costs one bootstrap LEVEL per
gate level — an 8-bit ripple add is 15 sequential levels (~38 gate
bootstraps).  This module is the modern-TFHE alternative (the radix
representation of TFHE-rs, built here on the framework's own PBS): an
integer is a little-endian vector of 2-bit DIGITS, each digit a PBS-domain
ciphertext (``pbs.py`` padding-bit encoding, space=8 = message 2 bits +
carry headroom), and arithmetic works digit-wise:

  * add/sub: per digit, the sum ``a_i + b_i + carry`` is a LINEAR torus
    add (values <= 3+3+1 = 7 fit the space-8 domain exactly), and ONE
    batched PBS level extracts ``(sum & 3, sum >> 2)`` — message and
    carry — as fresh ciphertexts.  An 8-bit add is 4 bootstrap levels
    (8 PBS lookups), vs 15 levels / ~38 bootstraps for the bit circuit:
    a >= 2x cut in bootstraps and >= 4x in latency-critical depth.
  * comparisons: per-digit difference lookups emit GATE-encoded bits
    (raw +-mu tables), combined by the existing boolean machinery.
  * plaintext-amount SHIFTS are native digit re-indexing (``shift_left``
    / ``shift_right`` / ``<<`` / ``>>``): even amounts are FREE (pure
    re-index), odd amounts cost ONE PBS level whose two outputs per digit
    recombine linearly.
  * overflow flags: unsigned carry-out re-encoded as a gate bit
    (``add_overflows``, +1 raw lookup); signed two's-complement overflow
    from the three sign bits (``RadixInt.add_with_overflow``, +1 raw
    3-lane level and two gate levels).
  * plaintext-operand multiply folds the scalar's bits into shifts
    (``_mul_scalar``: 1 shared odd-shift level + a popcount-deep add
    tree — e.g. x10 on 8 bits: 9 levels vs the general path's 18).
  * signed FULL-width multiply via the sign-extension identity
    ``a*b = a_u*b_u - 2^w(sa*b_u + sb*a_u) mod 2^{2w}``
    (``RadixInt.mul(full=True)``: unsigned full product + 2 levels of
    sign-bit/sign-gated lookups + 2 subtraction chains; nd=4: 52 levels).
  * radix <-> bit bridges both ways (one PBS level each direction), so
    the two integer APIs compose; division, bitwise ops and
    encrypted-condition select route through the bridges (no native
    digit-wise form exists for them), paying 2 extra levels over the
    bit-circuit cost while the hot ops stay native-radix.
  * ``RadixInt``: the signed (two's complement) variant.

Soundness is checked with the measured-calibrated noise model
(``check_radix`` below; utils/noise.py per-preset corrections): at
``params.PBS_PARAMS`` the worst PBS input of the add path (three bootstrap
outputs summed, then the modulus switch) has a 13.8-sigma calibrated
lower-bound margin — above the framework's 5-sigma bar — and the DEFAULT
reference set is correctly rejected (its space-8 bucket measured 18/4096
wrong on device; pbs.py).  ``use_many=True`` switches the (msg, carry)
extraction to a single PBSmanyLUT rotation (t=2): half the rotation work per
digit at a 7.9-sigma lower bound at PBS_PARAMS (anchor 4 measured the
preset's drift term 2.7x conservative, so the round-4 "4.9 borderline"
restated upward) — gated by the same check.

Reference anchor: the generalization of the gate bootstrap at
``hom_nand/src/tfhe.rs:81-88``; the reference has no integers at all
(SURVEY.md §2.4 tops out at single-bit logic), so this module is
capability beyond it, costed against the repo's own bit-circuit path.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from . import pbs as _pbs
from . import tlwe

U32 = jnp.uint32

MSG_BITS = 2
MSG_MOD = 1 << MSG_BITS          # digit values live in [0, 4)
SPACE = 1 << (MSG_BITS + 1)      # PBS space: one carry bit of headroom


def check_radix(params, use_many: bool = False,
                min_sigmas: float = 5.0) -> tuple[bool, str]:
    """Noise verdict for the radix add path at ``params``.

    The worst PBS input of one add level is ``a_i + b_i + carry`` — three
    FRESH BOOTSTRAP OUTPUTS summed (each carrying blind-rotate + key-switch
    variance), then the modulus switch (t^2-scaled when ``use_many``).
    Margin = the space-8 half-bucket over the calibrated sigma (stated as
    the preset-calibrated lower bound, utils/noise.calibrate)."""
    from .utils.noise import calibrate, noise_budget

    nb = noise_budget(params)
    var_out = nb.var_bootstrap + nb.var_keyswitch  # one bootstrap output
    t2 = 4.0 if use_many else 1.0
    var = 3.0 * var_out + t2 * nb.var_rounding
    cm = calibrate(params, math.sqrt(var), 1.0 / (4.0 * SPACE))
    msg = (f"radix add (space={SPACE}, use_many={use_many}): "
           f"{cm.describe()}")
    return cm.lower_bound_sigmas >= min_sigmas, msg


def check_radix_mul(params, min_sigmas: float = 5.0) -> tuple[bool, str]:
    """Noise verdict for the radix MULTIPLY path at ``params``.

    The multiply's worst PBS input is the bivariate product index
    ``a_i + 4 * b_bit`` — one bootstrap output plus a 4-scaled bootstrap
    output (variance x16) plus the modulus switch.  (The adds it feeds are
    covered by ``check_radix``; their inputs stay plain digits.)"""
    from .utils.noise import calibrate, noise_budget

    nb = noise_budget(params)
    var_out = nb.var_bootstrap + nb.var_keyswitch
    var = 17.0 * var_out + nb.var_rounding
    cm = calibrate(params, math.sqrt(var), 1.0 / (4.0 * SPACE))
    msg = f"radix mul (space={SPACE}, idx = a + 4*bit): {cm.describe()}"
    return cm.lower_bound_sigmas >= min_sigmas, msg


def _digit_tables(kind: str) -> np.ndarray:
    """(space,) int tables for the digit-normalization lookups."""
    x = np.arange(SPACE, dtype=np.uint32)
    if kind == "msg":
        return x & (MSG_MOD - 1)
    if kind == "carry":
        return x >> MSG_BITS
    raise ValueError(kind)


class RadixUint:
    """Encrypted unsigned integer, ``2 * ndigits`` bits, wrapping.

    ``digits``: uint32 ``(..., ndigits, n+1)`` PBS-domain ciphertexts,
    least-significant digit first; each encrypts a value in [0, 4) at
    space=8.  Arbitrary leading batch axes, like every batched type here.
    """

    def __init__(self, ctx, digits):
        self.ctx = ctx
        self.digits = jnp.asarray(digits, U32)
        assert self.digits.ndim >= 2, "digits must be (..., ndigits, n+1)"

    # ------------------------- construction --------------------------- #
    @staticmethod
    def _to_digits(values, ndigits: int) -> jnp.ndarray:
        v = np.asarray(values, np.uint64)
        idx = np.arange(ndigits, dtype=np.uint64) * np.uint64(MSG_BITS)
        return jnp.asarray((v[..., None] >> idx) & np.uint64(MSG_MOD - 1), U32)

    @classmethod
    def encrypt(cls, ctx, values, ndigits: int) -> "RadixUint":
        digs = cls._to_digits(values, ndigits)
        ct = _pbs.encrypt_int(ctx._next_key(), ctx.sk.lv0, digs, SPACE,
                              ctx.params)
        return cls(ctx, ct)

    @classmethod
    def trivial(cls, ctx, values, ndigits: int) -> "RadixUint":
        digs = cls._to_digits(values, ndigits)
        return cls(ctx, tlwe.trivial(_pbs.encode_int(digs, SPACE),
                                     ctx.params.n))

    @classmethod
    def encrypt_seeded(cls, ctx, values, ndigits: int):
        """Compressed upload of radix integers: (seed, bodies) over the
        (..., ndigits) digit ciphertexts, ~(n+1)x smaller than
        ``encrypt``; rebuild with ``expand_seeded`` (public)."""
        digs = cls._to_digits(values, ndigits)
        return tlwe.encrypt_torus_seeded(
            ctx._next_key(), ctx.sk.lv0, _pbs.encode_int(digs, SPACE),
            ctx.params)

    @classmethod
    def expand_seeded(cls, ctx, seeded) -> "RadixUint":
        seed, b = seeded
        return cls(ctx, tlwe.expand_seeded(seed, b, ctx.params.n))

    def decrypt(self):
        digs = np.asarray(
            _pbs.decrypt_int(self.digits, self.ctx.sk.lv0, SPACE), np.uint64)
        val = np.zeros(digs.shape[:-1], np.uint64)
        for i in range(self.ndigits):
            val |= (digs[..., i] % MSG_MOD) << np.uint64(MSG_BITS * i)
        return val

    # --------------------------- plumbing ----------------------------- #
    @property
    def ndigits(self) -> int:
        return self.digits.shape[-2]

    @property
    def width(self) -> int:
        return MSG_BITS * self.ndigits

    @property
    def batch_shape(self):
        return self.digits.shape[:-2]

    def _like(self, digits) -> "RadixUint":
        return RadixUint(self.ctx, digits)

    def _coerce(self, other) -> tuple["RadixUint", "RadixUint"]:
        if isinstance(other, (int, np.integer)):
            val = int(other) & ((1 << self.width) - 1)
            other = type(self).trivial(
                self.ctx, np.full(self.batch_shape, val, np.uint64),
                self.ndigits)
        if not isinstance(other, RadixUint):
            raise TypeError(
                f"operand must be RadixUint or int, got {type(other).__name__}")
        if isinstance(self, RadixInt) != isinstance(other, RadixInt):
            raise TypeError("cannot mix RadixUint and RadixInt operands")
        if other.ndigits != self.ndigits:
            raise ValueError(
                f"digit-count mismatch: {self.ndigits} vs {other.ndigits}")
        return self, other

    # ----------------------- the PBS level core ----------------------- #
    def _pbs_level(self, cts, tables, raw: bool = False,
                   unsafe: bool = False) -> jnp.ndarray:
        """One batched PBS level: ``cts`` (k, ..., n+1) with per-lane
        ``tables`` (k, space) -> (k, ..., n+1).  All k lookups run in ONE
        bootstrap program (the lane axis is just batch)."""
        ctx = self.ctx
        lead = cts.shape[1:-1]
        tabs = jnp.asarray(tables, U32).reshape(
            (cts.shape[0],) + (1,) * len(lead) + (SPACE,))
        tabs = jnp.broadcast_to(tabs, (cts.shape[0],) + lead + (SPACE,))
        return _pbs.pbs(ctx.ck, cts, tabs, space=SPACE, params=ctx.params,
                        engine_name=ctx.engine_name, raw=raw, unsafe=unsafe)

    def _extract_msg_carry(self, s, use_many: bool, unsafe: bool = False):
        """(msg, carry) of a space-8 sum ciphertext ``s`` (..., n+1), one
        bootstrap level."""
        tm, tc = _digit_tables("msg"), _digit_tables("carry")
        if use_many:
            tabs = jnp.asarray(np.stack([tm, tc]), U32)  # (2, space)
            lead = s.shape[:-1]
            tabs = jnp.broadcast_to(
                tabs.reshape((1,) * len(lead) + (2, SPACE)),
                lead + (2, SPACE))
            out = _pbs.pbs_many(self.ctx.ck, s, tabs, space=SPACE,
                                params=self.ctx.params, unsafe=unsafe,
                                engine_name=self.ctx.engine_name)
            return out[..., 0, :], out[..., 1, :]
        both = self._pbs_level(jnp.stack([s, s]), np.stack([tm, tc]),
                               unsafe=unsafe)
        return both[0], both[1]

    # ------------------------- arithmetic ----------------------------- #
    def add_with_carry(self, other, *, use_many: bool = False,
                       unsafe: bool = False):
        """(self + other mod 2^width, carry-out ciphertext).

        ``ndigits`` sequential bootstrap levels (the carry chain is the
        only data dependence); each level is one batched PBS extracting
        (msg, carry) of the linear digit sum.  The carry-out is a
        PBS-domain bit (value in {0,1} at space=8)."""
        a, b = self._coerce(other)
        ok, msg = check_radix(a.ctx.params, use_many=use_many)
        if not ok and not unsafe:
            raise ValueError(
                f"radix arithmetic margin below threshold ({msg}); use "
                f"params.PBS_PARAMS or pass unsafe=True")
        carry = None
        out = []
        for i in range(a.ndigits):
            s = (a.digits[..., i, :] + b.digits[..., i, :]).astype(U32)
            if carry is not None:
                s = (s + carry).astype(U32)
            m, carry = a._extract_msg_carry(s, use_many, unsafe)
            out.append(m)
        return a._like(jnp.stack(out, axis=-2)), carry

    def __add__(self, other):
        s, _c = self.add_with_carry(other)
        return s

    __radd__ = __add__

    def sub_with_not_borrow(self, other, *, use_many: bool = False,
                            unsafe: bool = False):
        """(self - other mod 2^width, NOT-borrow ciphertext): radix-4
        complement add — ``a + (3 - b_i per digit) + 1`` — so the carry
        chain machinery is shared; not-borrow = 1 iff self >= other."""
        a, b = self._coerce(other)
        ok, msg = check_radix(a.ctx.params, use_many=use_many)
        if not ok and not unsafe:
            raise ValueError(
                f"radix arithmetic margin below threshold ({msg}); use "
                f"params.PBS_PARAMS or pass unsafe=True")
        three = _pbs.encode_int(MSG_MOD - 1, SPACE)
        one_body = _pbs.encode_int(1, SPACE)
        carry = None
        out = []
        for i in range(a.ndigits):
            # 3 - b_i: trivial(3) minus ciphertext — linear negation.
            comp = (-b.digits[..., i, :]).astype(U32)
            comp = comp.at[..., 0].add(three)
            s = (a.digits[..., i, :] + comp).astype(U32)
            if carry is None:
                s = s.at[..., 0].add(one_body)  # +1 of the complement
            else:
                s = (s + carry).astype(U32)
            m, carry = a._extract_msg_carry(s, use_many, unsafe)
            out.append(m)
        return a._like(jnp.stack(out, axis=-2)), carry

    def __sub__(self, other):
        d, _nb = self.sub_with_not_borrow(other)
        return d

    def __rsub__(self, other):
        a, b = self._coerce(other)
        return b - a

    def __neg__(self):
        return RadixUint.trivial(
            self.ctx, np.zeros(self.batch_shape, np.uint64),
            self.ndigits) - self

    # --------------------------- shifts ------------------------------- #
    def _zero_digits(self, count: int) -> jnp.ndarray:
        z = jnp.zeros(self.batch_shape + (count,), U32)
        return tlwe.trivial(z, self.ctx.params.n)

    def _extended(self, out_nd: int) -> "RadixUint":
        """Zero-extend (unsigned) to ``out_nd`` digits — free (trivial
        zero digits are noiseless)."""
        assert out_nd >= self.ndigits
        if out_nd == self.ndigits:
            return self
        return self._like(jnp.concatenate(
            [self.digits, self._zero_digits(out_nd - self.ndigits)], axis=-2))

    def _shift1_parts(self, unsafe: bool = False):
        """ONE PBS level: per digit, (low-bit-at-weight-2, high-bit) fresh
        digits — the two pieces every odd-amount shift recombines linearly."""
        x = np.arange(SPACE, dtype=np.uint32)
        t_lo2 = ((x & 1) << 1).astype(np.uint32)   # low bit -> weight 2
        t_hi = ((x >> 1) & 1).astype(np.uint32)    # high bit -> weight 1
        nd = self.ndigits
        dstack = jnp.moveaxis(self.digits, -2, 0)
        cts = jnp.concatenate([dstack, dstack])
        tabs = np.concatenate([np.tile(t_lo2, (nd, 1)),
                               np.tile(t_hi, (nd, 1))])
        out = self._pbs_level(cts, tabs, unsafe=unsafe)
        return out[:nd], out[nd:]  # (nd, ..., n+1) each

    def shift_left(self, k: int, *, unsafe: bool = False) -> "RadixUint":
        """``self << k`` (wrapping) for a PLAINTEXT amount k — native digit
        re-indexing, no bit bridge (VERDICT r4 #5).

        Even k: pure digit re-index (trivial zeros shifted in) — ZERO PBS.
        Odd k: +1 PBS level (``_shift1_parts``) whose two outputs recombine
        linearly per digit (sum <= 3, a valid digit).  NOISE NOTE: an
        odd-shifted digit carries TWO bootstrap outputs' variance; feeding
        it straight into an add makes that level's worst input 4 outputs
        instead of check_radix's modeled 3 — a sqrt(4/3) margin haircut
        (13.8 -> 11.9 calibrated sigma at PBS_PARAMS, still >= 5)."""
        if k < 0:
            raise ValueError(f"shift amount must be >= 0, got {k}")
        nd = self.ndigits
        if k == 0:
            return self
        if k >= self.width:
            return self._like(self._zero_digits(nd))
        q, r = divmod(k, MSG_BITS)
        digs = self.digits
        if r:
            lo2, hi = self._shift1_parts(unsafe=unsafe)
            planes = [lo2[0]]
            for i in range(1, nd):
                planes.append((lo2[i] + hi[i - 1]).astype(U32))
            digs = jnp.stack(planes, axis=-2)
        if q:
            digs = jnp.concatenate(
                [self._zero_digits(q), digs[..., : nd - q, :]], axis=-2)
        return self._like(digs)

    def shift_right(self, k: int, *, unsafe: bool = False) -> "RadixUint":
        """``self >> k`` (LOGICAL, zero-filled) for a plaintext amount —
        the mirror of ``shift_left``: even k free, odd k one PBS level.
        On RadixInt this shifts the raw two's-complement pattern (Rust
        ``u64 >>`` semantics); no arithmetic (sign-filled) variant exists
        natively — sign extension is data-dependent, bridge via to_bits."""
        if k < 0:
            raise ValueError(f"shift amount must be >= 0, got {k}")
        nd = self.ndigits
        if k == 0:
            return self
        if k >= self.width:
            return self._like(self._zero_digits(nd))
        q, r = divmod(k, MSG_BITS)
        digs = self.digits
        if q:
            digs = jnp.concatenate(
                [digs[..., q:, :], self._zero_digits(q)], axis=-2)
        if r:
            src = RadixUint(self.ctx, digs)
            lo2, hi = src._shift1_parts(unsafe=unsafe)
            # right-by-1: digit i = (d_i >> 1) + 2 * (d_{i+1} & 1).
            planes = []
            for i in range(nd):
                d = hi[i]
                if i + 1 < nd:
                    d = (d + lo2[i + 1]).astype(U32)
                planes.append(d)
            digs = jnp.stack(planes, axis=-2)
        return self._like(digs)

    def __lshift__(self, k: int):
        return self.shift_left(k)

    def __rshift__(self, k: int):
        return self.shift_right(k)

    # ----------------------- overflow flags --------------------------- #
    def _pbs_bit_to_gate(self, ct, table_on_space,
                         unsafe: bool = False) -> jnp.ndarray:
        """One raw 1-lane PBS re-encoding a space-8 value as a GATE bit."""
        p = self.ctx.params
        mu, neg_mu = p.mu, (-p.mu) & 0xFFFFFFFF
        tab = np.where(table_on_space, mu, neg_mu).astype(np.uint32)
        return self._pbs_level(ct[None], tab[None], raw=True,
                               unsafe=unsafe)[0]

    def add_overflows(self, other, *, use_many: bool = False,
                      unsafe: bool = False):
        """(sum, overflow GATE bit) — unsigned overflow IS the carry-out;
        one extra raw lookup re-encodes it for the boolean world (compose
        with gates/ints/circuits)."""
        s, carry = self.add_with_carry(other, use_many=use_many,
                                       unsafe=unsafe)
        x = np.arange(SPACE)
        ovf = self._pbs_bit_to_gate(carry, x >= 1, unsafe=unsafe)
        return s, ovf

    # ------------------------ multiplication -------------------------- #
    def _zero_digit(self):
        return self._zero_digits(1)[..., 0, :]

    def _mul_scalar(self, c: int, *, full: bool = False,
                    unsafe: bool = False):
        """PLAINTEXT-operand multiply fast path (VERDICT r4 #5): the
        scalar's bits fold into shifts — no bit-extraction level, no
        product level.  Each set bit k of c contributes ``self << k``;
        every odd-k row shares ONE ``shift_left(1)`` PBS level (all other
        shifting is free digit re-indexing) and the rows reduce with the
        same batched add tree as the general multiply.

        8-bit truncated scalar multiply: 1 level (the shared odd shift,
        only if c has odd set bits) + ceil(log2(popcount)) x nd add
        levels — e.g. x10 = 1 + 2x4 = 9 levels vs the general path's 18.
        NOISE: odd-shifted digits carry 2 outputs' variance, so the first
        add round's worst input is 5 outputs vs check_radix's modeled 3 —
        a sqrt(5/3) haircut (13.8 -> 10.7 calibrated sigma at PBS_PARAMS,
        still >= 5)."""
        ok, msg = check_radix(self.ctx.params)
        if not ok and not unsafe:
            raise ValueError(
                f"radix scalar-mul margin below threshold ({msg}); use "
                f"params.PBS_PARAMS or pass unsafe=True")
        nd = self.ndigits
        out_nd = 2 * nd if full else nd
        c &= (1 << (MSG_BITS * out_nd)) - 1
        if c == 0:
            return self._like(self._zero_digits(out_nd)
                              if full else self._zero_digits(nd))
        base = self._extended(out_nd) if full else self
        odd = None
        rows = []
        for k in range(MSG_BITS * out_nd):
            if not (c >> k) & 1:
                continue
            if k % 2 and odd is None:
                odd = base.shift_left(1, unsafe=unsafe)  # shared level
            src = odd if k % 2 else base
            rows.append(src.shift_left(k - (k % 2), unsafe=unsafe).digits)
        arr = jnp.stack(rows)
        out = self._reduce_rows(arr, out_nd, unsafe)
        return self._like(out)

    def _reduce_rows(self, arr, out_nd: int, unsafe: bool) -> jnp.ndarray:
        """Batched binary add tree over stacked radix rows
        ``arr (R, ..., out_nd, n+1)`` -> digits (..., out_nd, n+1)."""
        zero = self._zero_digit()
        while arr.shape[0] > 1:
            if arr.shape[0] % 2:
                zrow = jnp.broadcast_to(
                    jnp.stack([zero] * out_nd, axis=-2)[None],
                    (1,) + arr.shape[1:])
                arr = jnp.concatenate([arr, zrow])
            s, _ = RadixUint(self.ctx, arr[0::2]).add_with_carry(
                RadixUint(self.ctx, arr[1::2]), unsafe=unsafe)
            arr = s.digits
        return arr[0]

    def mul(self, other, *, full: bool = False, unsafe: bool = False):
        """Schoolbook radix multiply, every PBS at a >= 5-sigma margin
        (``check_radix_mul``) — no wide-space lookups anywhere:

        1. ONE level extracts both bits of every digit of ``b``;
        2. ONE level evaluates all digit-by-bit products via the bivariate
           index ``a_i + 4*b_bit`` (space-8 lookup ``(x & 3) * (x >> 2)``;
           products by a BIT are <= 3, so they are plain digits — the
           naive digit-by-digit product (<= 9) would need a space-16
           normalization whose margin is only ~4.5 sigma);
        3. the partial-product rows (the x2-weighted bit-1 rows entered
           TWICE — doubling by re-addition keeps every addend a plain
           digit) reduce in a BATCHED binary tree: each round is one
           radix add over all row pairs stacked on a lane axis, so the
           whole reduction costs ceil(log2(3*nd)) x nd bootstrap levels.

        8-bit (nd=4) truncated multiply: 2 + 4*4 = 18 bootstrap levels.
        ``full=True`` returns all 2*nd digits.  A PLAINTEXT ``other``
        dispatches to the shift-and-add fast path (``_mul_scalar``)."""
        if isinstance(other, (int, np.integer)):
            return self._mul_scalar(int(other), full=full, unsafe=unsafe)
        a, b = self._coerce(other)
        p = a.ctx.params
        ok1, m1 = check_radix(p)
        ok2, m2 = check_radix_mul(p)
        if not (ok1 and ok2) and not unsafe:
            raise ValueError(
                f"radix mul margin below threshold ({m1 if not ok1 else m2});"
                f" use params.PBS_PARAMS or pass unsafe=True")
        nd = a.ndigits
        out_nd = 2 * nd if full else nd
        # 1. both bits of every digit of b, one PBS level.
        dstack = jnp.moveaxis(b.digits, -2, 0)  # (nd, ..., n+1)
        cts = jnp.concatenate([dstack, dstack])  # (2nd, ...)
        x = np.arange(SPACE, dtype=np.uint32)
        tabs = np.concatenate([np.tile(x & 1, (nd, 1)),
                               np.tile((x >> 1) & 1, (nd, 1))])
        bits = self._pbs_level(cts, tabs, unsafe=unsafe)
        # 2. all digit-by-bit products in one PBS level.
        tab_mul = ((x & 3) * ((x >> 2) & 1)).astype(np.uint32)
        lanes = []
        for i in range(nd):
            for j in range(nd):
                if i + j >= out_nd:
                    continue
                ai = a.digits[..., i, :]
                for w in (0, 1):
                    bj = bits[j + w * nd]
                    lanes.append((ai + U32(4) * bj).astype(U32))
        prods = self._pbs_level(jnp.stack(lanes),
                                np.tile(tab_mul, (len(lanes), 1)),
                                unsafe=unsafe)
        # 3. rows (plane shuffles, free), x2 rows twice; batched add tree.
        zero = self._zero_digit()
        rows = []
        # Group product lanes into per-(bit-weight, i) rows: row (w, i)
        # holds P_ij at digit position i+j — a valid radix number (every
        # digit <= 3).
        rows_map: dict[tuple[int, int], dict[int, jnp.ndarray]] = {}
        lane = 0
        for i in range(nd):
            for j in range(nd):
                if i + j >= out_nd:
                    continue
                for w in (0, 1):
                    rows_map.setdefault((w, i), {})[i + j] = prods[lane]
                    lane += 1
        assert lane == len(lanes)
        for (w, i), dig in sorted(rows_map.items()):
            planes = [dig.get(k, zero) for k in range(out_nd)]
            row = jnp.stack(planes, axis=-2)
            rows.append(row)
            if w == 1:  # x2 = enter the bit-1 row twice
                rows.append(row)
        arr = jnp.stack(rows)  # (R, ..., out_nd, n+1)
        # _like preserves the signed/unsigned class (truncated product
        # bits are sign-agnostic; only the decrypt interpretation differs).
        return a._like(a._reduce_rows(arr, out_nd, unsafe))

    def __mul__(self, other):
        return self.mul(other)

    __rmul__ = __mul__

    # ------------------------- comparisons ---------------------------- #
    def _digit_rel_bits(self, other, unsafe: bool = False):
        """Per-digit (lt, eq) GATE-encoded bit ciphertexts, ONE bootstrap
        level: lookup on d_i = a_i - b_i + 4 in [1, 7] with raw +-mu
        tables (pbs.py raw mode emits arbitrary output encodings)."""
        a, b = self._coerce(other)
        p = a.ctx.params
        four = _pbs.encode_int(MSG_MOD, SPACE)
        d = (a.digits - b.digits).astype(U32)
        d = d.at[..., 0].add(four)  # (..., ndigits, n+1), values in [1,7]
        mu, neg_mu = p.mu, (-p.mu) & 0xFFFFFFFF
        x = np.arange(SPACE)
        t_lt = np.where(x < MSG_MOD, mu, neg_mu).astype(np.uint32)
        t_eq = np.where(x == MSG_MOD, mu, neg_mu).astype(np.uint32)
        # Lane axis = 2 * ndigits lookups, one batched raw PBS level.
        cts = jnp.concatenate([d, d], axis=-2)
        cts = jnp.moveaxis(cts, -2, 0)  # (2*nd, ..., n+1)
        tabs = np.concatenate([np.tile(t_lt, (a.ndigits, 1)),
                               np.tile(t_eq, (a.ndigits, 1))])
        out = self._pbs_level(cts, tabs, raw=True, unsafe=unsafe)
        lt = jnp.moveaxis(out[: a.ndigits], 0, -2)
        eq = jnp.moveaxis(out[a.ndigits :], 0, -2)
        return lt, eq  # (..., ndigits, n+1) gate bits

    def _compare(self, other, unsafe: bool = False):
        """(lt, eq) encrypted GATE bits (composable with gates/ints)."""
        lt_d, eq_d = self._digit_rel_bits(other, unsafe=unsafe)
        ctx = self.ctx
        # MSB-first combine: lt = lt_hi | (eq_hi & lt_lo); eq = AND-tree.
        lt = lt_d[..., -1, :]
        eq = eq_d[..., -1, :]
        for i in range(self.ndigits - 2, -1, -1):
            lt = ctx.or_(lt, ctx.and_(eq, lt_d[..., i, :]))
            eq = ctx.and_(eq, eq_d[..., i, :])
        return lt, eq

    def lt(self, other, *, unsafe: bool = False):
        return self._compare(other, unsafe=unsafe)[0]

    def eq(self, other, *, unsafe: bool = False):
        return self._compare(other, unsafe=unsafe)[1]

    def le(self, other, *, unsafe: bool = False):
        lt, eq = self._compare(other, unsafe=unsafe)
        return self.ctx.or_(lt, eq)

    def gt(self, other, *, unsafe: bool = False):
        return tlwe.neg(self.le(other, unsafe=unsafe))

    def ge(self, other, *, unsafe: bool = False):
        return tlwe.neg(self.lt(other, unsafe=unsafe))

    def ne(self, other, *, unsafe: bool = False):
        return tlwe.neg(self.eq(other, unsafe=unsafe))

    # -------------------------- selection ----------------------------- #
    def select(self, cond, other, *, unsafe: bool = False) -> "RadixUint":
        """cond ? self : other with an encrypted GATE bit condition.

        PBS digits cannot be multiplied by a ciphertext directly, so the
        select routes through the bit world: both operands' digits bridge
        to gate-encoded bits (one PBS level, batched), the mux runs on
        bits (two gate levels), and the result bridges back (one PBS
        level) — 4 bootstrap levels total, every lookup at the add path's
        margin."""
        a, b = self._coerce(other)
        xa, xb = a.to_bits(unsafe=unsafe), b.to_bits(unsafe=unsafe)
        sel = xa.select(cond, xb)
        return type(a).from_bits(sel, ndigits=a.ndigits, unsafe=unsafe)

    def min_(self, other, *, unsafe: bool = False):
        a, b = self._coerce(other)
        return a.select(a.lt(b, unsafe=unsafe), b, unsafe=unsafe)

    def max_(self, other, *, unsafe: bool = False):
        a, b = self._coerce(other)
        return a.select(a.gt(b, unsafe=unsafe), b, unsafe=unsafe)

    # ------------------ bridge-backed derived ops --------------------- #
    # Division and bitwise ops have no native digit-wise form (bitwise
    # mixes bits WITHIN a digit; restoring division needs per-round
    # encrypted selects) — they route through the bit bridges, paying 2
    # extra bootstrap levels total on top of the bit-circuit cost.  The
    # hot ops (+ - * compare select) stay native-radix.
    def _via_bits(self, other, op, unsafe: bool = False):
        a, b = self._coerce(other)
        out = op(a.to_bits(unsafe=unsafe), b.to_bits(unsafe=unsafe))
        return type(a).from_bits(out, ndigits=a.ndigits, unsafe=unsafe)

    def divmod(self, other, *, unsafe: bool = False):
        """(quotient, remainder): unsigned restoring division through the
        bit bridge (div-by-zero: q = all-ones, r = self)."""
        a, b = self._coerce(other)
        q_bits, r_bits = a.to_bits(unsafe=unsafe).divmod(
            b.to_bits(unsafe=unsafe))
        return (type(a).from_bits(q_bits, ndigits=a.ndigits, unsafe=unsafe),
                type(a).from_bits(r_bits, ndigits=a.ndigits, unsafe=unsafe))

    def __floordiv__(self, other):
        return self.divmod(other)[0]

    def __mod__(self, other):
        return self.divmod(other)[1]

    def __and__(self, other):
        return self._via_bits(other, lambda x, y: x & y)

    def __or__(self, other):
        return self._via_bits(other, lambda x, y: x | y)

    def __xor__(self, other):
        return self._via_bits(other, lambda x, y: x ^ y)

    # ----------------------- bit-world bridges ------------------------ #
    def to_bits(self, *, unsafe: bool = False):
        """RadixUint -> ints.FheUint (gate-encoded bit planes), ONE
        bootstrap level: every digit's (bit0, bit1) looked up with raw
        +-mu tables in one batched PBS."""
        from .ints import FheUint

        p = self.ctx.params
        mu, neg_mu = p.mu, (-p.mu) & 0xFFFFFFFF
        x = np.arange(SPACE)
        t_b0 = np.where(x & 1, mu, neg_mu).astype(np.uint32)
        t_b1 = np.where((x >> 1) & 1, mu, neg_mu).astype(np.uint32)
        cts = jnp.concatenate([self.digits, self.digits], axis=-2)
        cts = jnp.moveaxis(cts, -2, 0)
        tabs = np.concatenate([np.tile(t_b0, (self.ndigits, 1)),
                               np.tile(t_b1, (self.ndigits, 1))])
        out = self._pbs_level(cts, tabs, raw=True, unsafe=unsafe)
        b0 = jnp.moveaxis(out[: self.ndigits], 0, -2)
        b1 = jnp.moveaxis(out[self.ndigits :], 0, -2)
        bits = jnp.stack([b0, b1], axis=-2)  # (..., nd, 2, n+1)
        return FheUint(self.ctx, bits.reshape(
            self.batch_shape + (self.width, self.digits.shape[-1])))

    @classmethod
    def from_bits(cls, x, *, ndigits: int | None = None,
                  unsafe: bool = False) -> "RadixUint":
        """ints.FheUint -> RadixUint, ONE bootstrap level: each gate bit
        is bootstrapped to PBS-domain {0, 1} (space=8), then digits form
        as the LINEAR combination b0 + 2*b1."""
        ctx = x.ctx
        w = x.width
        nd = ndigits if ndigits is not None else (w + MSG_BITS - 1) // MSG_BITS
        assert nd * MSG_BITS >= w, (nd, w)
        p = ctx.params
        # Gate bit (phase +-1/8) -> PBS-domain value: a sign lookup.  The
        # gate encoding is the space=2 padding-bit encoding shifted by
        # -1/8... use the gate-bootstrap trick directly: rotate on the bit
        # ciphertext with a two-bucket table {1, 0} at space=2 emitting
        # space-8 raw encodings.
        one_enc = int(_pbs.encode_int(1, SPACE))
        # space=2 decode: pbs.encode_int maps 0 -> phase 0, 1 -> 1/4; the
        # gate encoding is -1/8 / +1/8.  Adding 1/8 moves it onto the
        # space-2 grid exactly (0 -> 0, 1 -> 1/4), so a two-bucket table
        # {0: 0, 1: one_enc} re-encodes each bit into the space-8 domain.
        # The table is SHARED by every bit: one (2,) operand for the whole
        # (w, ...) batch.
        shift = U32(1 << 29)  # +1/8
        cts = jnp.moveaxis(x.bits, -2, 0)
        cts = cts.at[..., 0].add(shift)
        tab = jnp.asarray(np.array([0, one_enc], np.uint32))
        vals = _pbs.pbs(ctx.ck, cts, tab, space=2, params=p,
                        engine_name=ctx.engine_name, raw=True, unsafe=unsafe)
        vals = jnp.moveaxis(vals, 0, -2)  # (..., w, n+1) PBS-domain bits
        digs = []
        for i in range(nd):
            b0 = vals[..., MSG_BITS * i, :]
            d = b0
            if MSG_BITS * i + 1 < w:
                b1 = vals[..., MSG_BITS * i + 1, :]
                d = (b0 + U32(2) * b1).astype(U32)
            digs.append(d)
        return cls(ctx, jnp.stack(digs, axis=-2))


class RadixInt(RadixUint):
    """Encrypted SIGNED integer (two's complement over ``2 * ndigits``
    bits) in radix form.

    Wrapping add/sub/neg and the TRUNCATED multiply are digit-identical
    to the unsigned case (inherited); comparisons map signed order onto
    unsigned order by flipping the top digit's high bit — one extra
    2-lane PBS level (the flip ``x ^ 2`` is not linear on PBS digits);
    ``abs_`` routes through the bit bridge.  The full-width product
    (``mul(full=True)``) uses the sign-extension identity
    ``a*b = a_u*b_u - 2^w(sa*b_u + sb*a_u)`` — see its docstring for the
    level costs."""

    @staticmethod
    def _to_digits(values, ndigits: int) -> jnp.ndarray:
        v = np.asarray(values)
        if np.issubdtype(v.dtype, np.signedinteger):
            v = v.astype(np.int64).view(np.uint64) & np.uint64(
                (1 << (MSG_BITS * ndigits)) - 1)
        return RadixUint._to_digits(v, ndigits)

    def decrypt(self):
        val = super().decrypt()
        w = self.width
        sign = (val >> np.uint64(w - 1)) & np.uint64(1)
        return (val.astype(np.int64)
                - (sign.astype(np.int64) << np.int64(w)))

    def _like(self, digits) -> "RadixInt":
        return RadixInt(self.ctx, digits)

    def _bias_top(self, unsafe: bool = False):
        """Flip the top digit's high bit (x ^ 2) with one 1-lane PBS:
        maps two's-complement order onto unsigned order."""
        x = np.arange(SPACE, dtype=np.uint32)
        tab = np.where(x < MSG_MOD, x ^ 2, x)  # identity on carry range
        top = self._pbs_level(self.digits[None, ..., -1, :],
                              tab[None], unsafe=unsafe)[0]
        return self._like(jnp.concatenate(
            [self.digits[..., :-1, :], top[..., None, :]], axis=-2))

    def _compare(self, other, unsafe: bool = False):
        a, b = self._coerce(other)
        return RadixUint._compare(a._bias_top(unsafe), b._bias_top(unsafe),
                                  unsafe=unsafe)

    def add_with_overflow(self, other, *, use_many: bool = False,
                          unsafe: bool = False):
        """(sum, signed-overflow GATE bit): two's-complement overflow iff
        the operands share a sign the result doesn't — one raw 3-lane PBS
        level re-encodes the three sign bits for the boolean world, then
        ovf = !(sa ^ sb) & (sa ^ ss) (two gate levels; the NOT is linear)."""
        a, b = self._coerce(other)
        s, _c = a.add_with_carry(b, use_many=use_many, unsafe=unsafe)
        p = a.ctx.params
        mu, neg_mu = p.mu, (-p.mu) & 0xFFFFFFFF
        x = np.arange(SPACE)
        t_sign = np.where((x >> 1) & 1, mu, neg_mu).astype(np.uint32)
        tops = jnp.stack([a.digits[..., -1, :], b.digits[..., -1, :],
                          s.digits[..., -1, :]])
        bits = self._pbs_level(tops, np.tile(t_sign, (3, 1)), raw=True,
                               unsafe=unsafe)
        sa, sb, ss = bits[0], bits[1], bits[2]
        ctx = a.ctx
        ovf = ctx.and_(tlwe.neg(ctx.xor(sa, sb)), ctx.xor(sa, ss))
        return s, ovf

    def mul(self, other, *, full: bool = False, unsafe: bool = False):
        """Signed multiply.  Truncated (default): digit-identical to the
        unsigned case.  ``full=True``: the sign-extension trick (VERDICT r4
        #5) — for w-bit two's complement, a = a_u - 2^w*sa, so

          a * b = a_u*b_u - 2^w*(sa*b_u + sb*a_u)   (mod 2^{2w})

        i.e. the UNSIGNED full product of the raw digit patterns, corrected
        by the operands' magnitudes gated on the other's sign bit.  Cost on
        top of the unsigned full product: 1 PBS level extracting both sign
        bits, 1 level for all sign-gated digit products (the same bivariate
        ``digit + 4*bit`` lookup as the multiply core, at check_radix_mul's
        margin), and 2 subtraction chains over 2*nd digits — e.g. nd=4:
        34 + 2 + 16 = 52 levels."""
        if not full:
            return super().mul(other, full=False, unsafe=unsafe)
        if isinstance(other, (int, np.integer)):
            # scalar full path: encrypt-free trivial operand keeps the
            # correction arithmetic uniform (sb is then a trivial bit).
            other = type(self).trivial(
                self.ctx,
                np.full(self.batch_shape,
                        int(other) & ((1 << self.width) - 1), np.uint64),
                self.ndigits)
        a, b = self._coerce(other)
        nd = a.ndigits
        out_nd = 2 * nd
        # 1. unsigned full product of the raw digit patterns.
        prod_u = RadixUint(a.ctx, a.digits).mul(
            RadixUint(b.ctx, b.digits), full=True, unsafe=unsafe)
        # 2. both sign bits as PBS-domain {0,1}, one 2-lane level.
        x = np.arange(SPACE, dtype=np.uint32)
        t_sign = ((x >> 1) & 1).astype(np.uint32)
        tops = jnp.stack([a.digits[..., -1, :], b.digits[..., -1, :]])
        sbits = self._pbs_level(tops, np.tile(t_sign, (2, 1)), unsafe=unsafe)
        sa, sb = sbits[0], sbits[1]
        # 3. sign-gated magnitudes sa*b_i, sb*a_i: one 2*nd-lane level.
        tab_mul = ((x & 3) * ((x >> 2) & 1)).astype(np.uint32)
        lanes = ([(b.digits[..., i, :] + U32(4) * sa).astype(U32)
                  for i in range(nd)]
                 + [(a.digits[..., i, :] + U32(4) * sb).astype(U32)
                    for i in range(nd)])
        prods = self._pbs_level(jnp.stack(lanes),
                                np.tile(tab_mul, (2 * nd, 1)), unsafe=unsafe)
        # 4. corrections placed at digit offset nd (= << w, free), two subs.
        def _corr(digs_list):
            placed = jnp.concatenate(
                [self._zero_digits(nd), jnp.stack(digs_list, axis=-2)],
                axis=-2)
            return RadixUint(a.ctx, placed)
        res = RadixUint(a.ctx, prod_u.digits)
        res, _ = res.sub_with_not_borrow(
            _corr([prods[i] for i in range(nd)]), unsafe=unsafe)
        res, _ = res.sub_with_not_borrow(
            _corr([prods[nd + i] for i in range(nd)]), unsafe=unsafe)
        return RadixInt(a.ctx, res.digits)

    def divmod(self, other, *, unsafe: bool = False):
        """Signed TRUNCATED division (C/Rust semantics) through the bit
        bridge (FheInt.divmod)."""
        from .ints import FheInt

        a, b = self._coerce(other)
        fa = FheInt(a.ctx, a.to_bits(unsafe=unsafe).bits)
        fb = FheInt(b.ctx, b.to_bits(unsafe=unsafe).bits)
        q_bits, r_bits = fa.divmod(fb)
        return (type(a).from_bits(q_bits, ndigits=a.ndigits, unsafe=unsafe),
                type(a).from_bits(r_bits, ndigits=a.ndigits, unsafe=unsafe))

    def abs_(self, *, unsafe: bool = False):
        bits = self.to_bits(unsafe=unsafe)
        from .ints import FheInt

        sbits = FheInt(self.ctx, bits.bits)
        return type(self).from_bits(FheInt(self.ctx, sbits.abs_().bits),
                                    ndigits=self.ndigits, unsafe=unsafe)
