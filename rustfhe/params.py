"""TFHE parameter sets.

Re-design of the compile-time const-generic parameter plumbing in
the reference (rusTfhe): there, dimensions are Rust const-generics and the
numeric constants live in helper structs (``TLWEHelper`` reference
``hom_nand/src/tlwe.rs:174-180``, ``TRLWEHelper`` ``trlwe.rs:75-77``,
``TRGSWHelper`` ``trgsw.rs:110-116``, ``TFHEHelper`` ``tfhe.rs:14-18``).

Here a frozen (hashable) dataclass carries the whole parameter set so it can
be passed as a ``jax.jit`` static argument; every shape in the framework is a
pure function of it, keeping XLA shapes static.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


def _make_decomp_mask(l: int, bits: int) -> int:
    """Rounding mask for the signed gadget decomposition.

    Bit-exact port of the semantics of ``Torus32::make_decomp_mask`` in the
    reference (``utils/src/math.rs:542-560``), including its quirk: when
    ``32 - l*bits != 0`` the bit at ``32 - l*bits - 1`` is added *twice*
    (once by the initializer, once by the ``i = l`` loop iteration), so it
    carries up one position.  The external product uses exactly this constant
    (``hom_nand/src/trgsw.rs:269``), so we must reproduce it, not the
    similar-but-different inlined variant at ``math.rs:581-593``.
    """
    total = 32
    u = 0
    if total - l * bits != 0:
        u = (u + (1 << (total - l * bits - 1))) & 0xFFFFFFFF
        for i in range(l, 0, -1):
            u += 1 << (total - i * bits - 1)
    else:
        for i in range(l - 1, 0, -1):
            u += 1 << (total - i * bits - 1)
    return u & 0xFFFFFFFF


@dataclass(frozen=True)
class TFHEParams:
    """Full TFHE gate-bootstrapping parameter set.

    Defaults reproduce the reference's ~128-bit set (SURVEY.md §2.5):
    n=635, N=1024, alpha_lv0=2^-15, alpha_lv1=2^-25, Bg=2^6, L=3,
    key-switch basebit=2 with 8 levels, gate constant mu=1/8.
    """

    # TLWE lv0 dimension (reference tlwe.rs:175)
    n: int = 635
    # TRLWE / lv1 polynomial degree, must be a power of two (trlwe.rs:76)
    N: int = 1024
    # lv0 noise stddev (tlwe.rs:176)
    alpha_lv0: float = 2.0 ** -15
    # lv1 noise stddev (trlwe.rs:77)
    alpha_lv1: float = 2.0 ** -25
    # gadget decomposition base bits: Bg = 2^bgbit (trgsw.rs:112)
    bgbit: int = 6
    # gadget decomposition levels (trgsw.rs:115)
    l: int = 3
    # identity key switch base bits (tlwe.rs:179)
    iks_basebit: int = 2
    # identity key switch levels (tlwe.rs:178)
    iks_l: int = 8

    # ------------------------------------------------------------------ #
    # Derived quantities (computed, not stored, so the dataclass stays
    # trivially hashable and constructors stay simple).
    # ------------------------------------------------------------------ #
    @property
    def nbit(self) -> int:
        """log2(N) (tfhe.rs:16)."""
        return self.N.bit_length() - 1

    @property
    def bg(self) -> int:
        return 1 << self.bgbit

    @property
    def half_bg(self) -> int:
        return 1 << (self.bgbit - 1)

    @property
    def decomp_mask(self) -> int:
        """Rounding mask used by the external product (trgsw.rs:269)."""
        return _make_decomp_mask(self.l, self.bgbit)

    @property
    def iks_t(self) -> int:
        """Key-switch digit base 2^basebit (tlwe.rs:180)."""
        return 1 << self.iks_basebit

    @property
    def iks_round(self) -> int:
        """Rounding constant for key-switch decomposition (tlwe.rs:50-54)."""
        from .decomp import iks_round_constant

        return iks_round_constant(self.iks_basebit, self.iks_l)

    @property
    def mu(self) -> int:
        """Torus32 encoding of the gate constant 1/8 (tfhe.rs:17)."""
        return 1 << 29

    @property
    def two_n(self) -> int:
        return 2 * self.N

    def __post_init__(self):
        if self.N & (self.N - 1) != 0:
            raise ValueError(f"N must be a power of two, got {self.N}")
        if self.l * self.bgbit > 32:
            raise ValueError("l * bgbit must be <= 32")
        if self.iks_l * self.iks_basebit > 32:
            raise ValueError("iks_l * iks_basebit must be <= 32")

    def replace(self, **kw) -> "TFHEParams":
        return dataclasses.replace(self, **kw)


# The reference's production parameter set (SURVEY.md §2.5).
DEFAULT_PARAMS = TFHEParams()

# A small set for fast CPU tests: same algebraic structure, tiny dimensions.
# Noise chosen so that gates still decode correctly with wide margin.
TEST_PARAMS = TFHEParams(
    n=16,
    N=64,
    alpha_lv0=2.0 ** -20,
    alpha_lv1=2.0 ** -28,
)

# Larger-degree variant for the parameter sweep bench config
# (BASELINE.json configs[4]).
N2048_PARAMS = TFHEParams(
    N=2048,
    alpha_lv1=2.0 ** -26,
)

# PBS-tuned preset (round-4, VERDICT r3 item 2): sound multi-bit
# programmable bootstrapping, where the DEFAULT set supports only 2-bit
# PBS (space=4 at 5.7 calibrated sigma; space=8 measured 18/4096 wrong on
# device).  Margins under the MEASURED-calibrated noise model
# (utils/noise.py anchors 1-3, DEFAULT_SIGMA_INFLATION applied):
#
#   space=4: 19.3 sigma   space=8: 9.7 sigma   space=16: 4.8 sigma
#   pbs_many (space=8, t=2): 5.1 sigma  — the radix-integer workhorse
#
# so 3-bit PBS (and the 2-bit-message + carry radix arithmetic in
# radix.py) passes the 5-sigma bar with real headroom; space=16 is
# borderline-by-design (the dominant term is the modulus-switch drift
# (n+1) * 2^-2(nbit+2) / 3, irreducible at N=2048 without a larger ring).
#
# Design: N=2048 (nbit=11 quarters the per-coefficient drift variance vs
# N=1024), l=4 x bgbit=6 (24-bit gadget: eps = 2^-24 makes decomposition
# rounding negligible; half_bg=32 keeps the Karatsuba-2 int8 digit-sum
# bound 32*4 <= 128, so the production fused kernel still applies),
# alpha_lv1=2^-32 (exact-integer engines don't care; RLWE N=2048 at
# 2^-32 is far beyond 128-bit), key switch rebased to 4-bit x 4 levels
# (same 16-bit depth as the default's 2x8 with half the KSK noise terms),
# and lv0 moved along the security-equivalence curve n/log2(1/alpha) ~
# const: n=714 at alpha=2^-15*2^-2 = 2^-17 (714/17 = 42.0 vs the
# reference set's 635/15 = 42.3 — same lattice hardness ballpark as the
# reference's own ~110-bit set, not a security downgrade).
# Gate margin at this preset: 30.9 sigma.  Device-validated in BENCH.md
# (round 4).
PBS_PARAMS = TFHEParams(
    n=714,
    N=2048,
    alpha_lv0=2.0 ** -17,
    alpha_lv1=2.0 ** -32,
    bgbit=6,
    l=4,
    iks_basebit=4,
    iks_l=4,
)

# CPU-test analogue of PBS_PARAMS: same algebraic structure (l=4, 4x4 key
# switch), tiny dimensions, noise low enough that space=8 PBS decodes
# exactly in tests; N=256 keeps nbit high enough that even the analytic
# radix-add margin (radix.check_radix) passes without an override.
PBS_TEST_PARAMS = TFHEParams(
    n=16,
    N=256,
    alpha_lv0=2.0 ** -20,
    alpha_lv1=2.0 ** -30,
    bgbit=6,
    l=4,
    iks_basebit=4,
    iks_l=4,
)

# EXPERIMENTAL speed preset: 2 gadget levels of base 2^8 instead of 3 of
# 2^6 — 2L goes 6 -> 4, cutting the external product's matmul work by 1.5x
# while digits still fit int8.  UNSOUND at the default n=635/N=1024
# dimensions: the 16-bit gadget (vs the default 18) leaves a decomposition
# rounding error eps = 2^-17 that dominates per-step noise
# (~(1+N)*eps^2 + 2lN(Bg/2)^2*alpha_lv1^2 ~= 2^-23.9/step, x635 steps
# -> sigma ~0.02 vs the 1/16 margin ~= 3 sigma), measured on device as
# 12/8192 wrong NAND outputs (exact integer arithmetic: the same on any
# device).  Lowering alpha cannot fix a
# decomposition-dominated budget, and l=2 with bgbit=9 (18 bits) needs
# +-256 digits, which break the int8 matmul path.  Kept for small-n circuits
# (passes at n<=64; tests/test_params_sweep.py) — not a production preset.
FAST_PARAMS = TFHEParams(
    bgbit=8,
    l=2,
)
