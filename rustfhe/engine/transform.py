"""Transform-domain (Nussbaumer / incomplete-NTT) external product.

The exact-integer analogue of keeping the bootstrapping key pre-transformed
(``TRGSWRepF``, reference ``hom_nand/src/trgsw.rs:64-108``), built exactly:

* N = m*r (r <= m, both powers of two); block i of a polynomial is the
  stride slice x[i::r], an element of S = Z[Y]/(Y^m+1).
* omega = Y^(m/r) is a 2r-th root of unity in S, and multiplication by a
  power of omega is a SIGNED PERMUTATION of a block — so the length-2r
  block-FFT is a +-1 integer matrix: forward M_f (N, 2N) over the 2L digit
  polys, inverse M_i (2N, N) (with the X^r = Y wraparound folded in) over
  the 2 outputs.  The BK blocks are transformed once at preparation.
* The inverse FFT's 1/2r scale does not exist mod 2^32; the pipeline runs
  mod 2^(32+log2(2r)+slack) = mod 2^40 (5 signed 8-bit BK limbs) and the
  division is recovered exactly at the end:
      S = A + B*2^16 + C*2^32 = 2r * c   (mod 2^40),   2r | A  always,
      c mod 2^32 = (A >> sh) + (B << (16-sh)) + (C << (32-sh)),  sh=log2(2r).
* Digit-side transform values grow to r*(Bg/2); they are split into two
  signed base-2^6 limbs, with the 2^6 scale folded into duplicated
  (pre-scaled) BK panel rows so the pointwise contraction stays a single
  exact integer matmul per frequency.

Everything here is bit-exact mod 2^32 (tests/test_transform.py asserts
against the oracle).  Performance: it needs 41.4 MMAC/gate/step at N=1024
(the +-1 transforms are dense as matrices but carry little information),
more than a Karatsuba-split circulant product would; it is never selected,
and its speed on the GPU is not measured.  The module is kept as (a) the
reference implementation of the transform-domain design with real numbers
behind the refutation, and (b) the basis of the DEGREE-SHARDED pipeline
(parallel/degree_sharded.py) where the N axis spans devices and
reduce-scatter collectives sit between transform stages (SURVEY.md §5).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

I8 = jnp.int8
I32 = jnp.int32
U32 = jnp.uint32

MOD_BITS = 40
MOD = 1 << MOD_BITS
DLIMB_BITS = 6  # digit-transform limb base (values fit int8 after split)
BLIMBS = 5      # BK limbs of 8 bits covering mod 2^40


def split_mr(N: int) -> tuple[int, int]:
    """N -> (m, r): r = largest power of two with r <= m and m*r = N."""
    nbit = N.bit_length() - 1
    r = 1 << (nbit // 2)
    return N // r, r


def _rot_np(v, e, m):
    """Y^e * v in S = Z[Y]/(Y^m+1) (numpy, values mod MOD)."""
    e = e % (2 * m)
    u = np.arange(m)
    src = (u - e) % m
    sign = np.where(((u - e) % (2 * m)) >= m, MOD - 1, 1).astype(np.uint64)
    return (v[..., src] * sign) % MOD


@functools.lru_cache(maxsize=8)
def forward_matrix(N: int) -> np.ndarray:
    """M_f (N, 2N) int8 in {-1,0,1}: natural-layout poly -> block-major
    frequency planes F_k = sum_i omega^{ik} A_i (A_i = x[i::r], zero-padded
    to 2r blocks)."""
    m, r = split_mr(N)
    w = m // r  # omega = Y^w
    Mf = np.zeros((N, 2 * N), np.int8)
    uu = np.arange(m)
    for i in range(r):
        for k in range(2 * r):
            e = (w * i * k) % (2 * m)
            src = (uu - e) % m
            sg = np.where(((uu - e) % (2 * m)) >= m, -1, 1)
            Mf[i + src * r, k * m + uu] += sg.astype(np.int8)
    return Mf


@functools.lru_cache(maxsize=8)
def inverse_matrix(N: int) -> np.ndarray:
    """M_i (2N, N) int8: block-major frequency planes -> natural-layout
    coefficients, inverse FFT WITHOUT the 1/2r scale, with the X^r = Y
    wraparound (out block t += Y * C_{t+r}) folded in."""
    m, r = split_mr(N)
    w = m // r
    Mi = np.zeros((2 * N, N), np.int64)
    uu = np.arange(m)
    for k in range(2 * r):
        for t in range(2 * r):
            e = (-w * t * k) % (2 * m)
            if t >= r:
                tt, e = t - r, (e + 1) % (2 * m)  # wraparound: Y * C_t
            else:
                tt = t
            src = (uu - e) % m
            sg = np.where(((uu - e) % (2 * m)) >= m, -1, 1)
            Mi[k * m + src, tt + uu * r] += sg
    assert np.abs(Mi).max() <= 2
    return Mi.astype(np.int8)


def _bal_split_np(x, width, n_limbs):
    out = []
    v = x.astype(np.int64).copy()
    for _ in range(n_limbs):
        l = v - (((v + (1 << (width - 1))) >> width) << width)
        out.append(l)
        v = (v - l) >> width
    return out


def prepare_panels(rows_u32: np.ndarray, N: int) -> np.ndarray:
    """rows (2L, 2, N) uint32 -> per-frequency pointwise panels, int8
    (2r, 2L*2*m, 2*BLIMBS*m): row (j, d, u) holds limb columns of
    Y^u * (2^(6d) * G[j,c,k]) mod 2^40 — the 2^(6d) pre-scale makes the
    digit-limb contraction a single matmul."""
    m, r = split_mr(N)
    w = m // r
    two_l = rows_u32.shape[0]
    q = np.asarray(rows_u32, np.uint64)
    # Block FFT of every BK row polynomial (mod 2^40).
    G = np.zeros((two_l, 2, 2 * r, m), np.uint64)
    blocks = q.reshape(two_l, 2, m, r)  # [..., u, i]: A_i[u] = x[i + u*r]
    for k in range(2 * r):
        acc = np.zeros((two_l, 2, m), np.uint64)
        for i in range(r):
            acc = (acc + _rot_np(blocks[..., i], w * i * k, m)) % MOD
        G[:, :, k, :] = acc
    panels = np.zeros((2 * r, two_l * 2 * m, 2 * BLIMBS * m), np.int8)
    for k in range(2 * r):
        for j in range(two_l):
            for d in range(2):
                scaled = (G[j, :, k] << np.uint64(DLIMB_BITS * d)) % MOD
                for c in range(2):
                    for u in range(m):
                        gy = _rot_np(scaled[c], u, m).astype(np.int64) % MOD
                        gl = _bal_split_np(gy, 8, BLIMBS)
                        row = (j * 2 + d) * m + u
                        for e in range(BLIMBS):
                            panels[k, row, (c * BLIMBS + e) * m:
                                   (c * BLIMBS + e + 1) * m] = gl[e]
    return panels


# --------------------------------------------------------------------- #
# Exact jnp pipeline (int32 dots — correctness path, not the perf path)
# --------------------------------------------------------------------- #
def dlimb_split(F):
    """Balanced base-2^DLIMB_BITS split of transform values F into
    (f0, f1) int32 planes with F == f0 + f1 * 2^DLIMB_BITS."""
    f1 = (F + (1 << (DLIMB_BITS - 1))) >> DLIMB_BITS
    f0 = F - (f1 << DLIMB_BITS)
    return f0, f1


def forward_digits(digits, Mf):
    """digits (..., 2L, N) int32 -> dlimb planes (f0, f1), each (..., 2L, 2N)
    int32 (balanced base-2^6 split of the transform values)."""
    F = jnp.einsum("...n,nk->...k", digits.astype(I32), Mf.astype(I32))
    return dlimb_split(F)


def pointwise(f0, f1, panels, m: int):
    """Per-frequency contraction over however many frequency planes the
    inputs carry (all 2r unsharded, or a device's shard): f0/f1
    (..., 2L, n_freq*m), panels (n_freq, 2L*2*m, 2*BLIMBS*m) -> int32
    partial planes (..., 2, BLIMBS, n_freq*m) ordered (c, blimb,
    freq-major coeffs)."""
    n_freq = panels.shape[-3]
    two_l = f0.shape[-2]
    lead = f0.shape[:-2]
    # rows (j, d, u) per frequency: interleave f0/f1 at block k.
    fk = jnp.stack([f0, f1], axis=-2)  # (..., 2L, 2, n_freq*m)
    fk = fk.reshape(lead + (two_l * 2, n_freq, m))
    fk = jnp.swapaxes(fk, -3, -2)  # (..., n_freq, 2L*2, m)
    fk = fk.reshape(lead + (n_freq, two_l * 2 * m))
    out = jnp.einsum(
        "...kr,krc->...kc", fk.astype(I32), panels.astype(I32)
    )  # (..., n_freq, 2*BLIMBS*m)
    out = out.reshape(lead + (n_freq, 2, BLIMBS, m))
    out = jnp.moveaxis(out, -4, -2)  # (..., 2, BLIMBS, n_freq, m)
    return out.reshape(lead + (2, BLIMBS, n_freq * m))


def relimb(parts):
    """Canonical re-limb of sum_e parts_e 2^(8e) mod 2^40 into BLIMBS int8
    planes (values in [-128, 128))."""
    limbs = []
    carry = jnp.zeros_like(parts[..., 0, :])
    for e in range(BLIMBS):
        t = parts[..., e, :] + carry
        l = t - (((t + 128) >> 8) << 8)
        limbs.append(l)
        carry = (t - l) >> 8
    return jnp.stack(limbs, axis=-2)  # (..., BLIMBS, 2N)


def abc_combine(W, sh: int):
    """Exact /2^sh recovery mod 2^32 from BLIMBS=5 inverse-transform limb
    planes W (..., BLIMBS, n): S = A + B*2^16 + C*2^32 with 2^sh | A, so
    c = (A >> sh) + (B << (16-sh)) + (C << (32-sh))."""
    A = W[..., 0, :] + (W[..., 1, :] << 8)
    B = W[..., 2, :] + (W[..., 3, :] << 8)
    C = W[..., 4, :]
    # A >> sh must be an ARITHMETIC shift (A is signed; 2^sh | A exactly).
    return (
        (A >> sh).astype(U32)
        + (B.astype(U32) << U32(16 - sh))
        + (C.astype(U32) << U32(32 - sh))
    ).astype(U32)


def inverse_combine(limbs, Mi, N: int):
    """limbs (..., BLIMBS, 2N) int32 -> uint32 (..., N): inverse transform
    per limb plane, then the exact division by 2r via the A/B/C shifts."""
    _, r = split_mr(N)
    sh = (2 * r).bit_length() - 1
    W = jnp.einsum("...k,kn->...n", limbs.astype(I32), Mi.astype(I32))
    return abc_combine(W, sh)


class NussTransformEngine:
    """PolyEngine whose external product runs in the transform domain.

    Exact mod 2^32 (validated vs the oracle); registered for completeness
    and as the unsharded reference for the degree-sharded pipeline — NOT
    selected by select_fast_engine."""

    name = "nuss"

    def prepare_trgsw(self, rows, params):
        rows_np = np.asarray(rows, np.uint32)
        lead = rows_np.shape[:-3]
        flat = rows_np.reshape((-1,) + rows_np.shape[-3:])
        panels = np.stack([prepare_panels(f, params.N) for f in flat])
        return jnp.asarray(panels.reshape(lead + panels.shape[1:]))

    def external_product_digits(self, prepared, digits, params):
        N = params.N
        m, _ = split_mr(N)
        Mf = jnp.asarray(forward_matrix(N))
        Mi = jnp.asarray(inverse_matrix(N))
        f0, f1 = forward_digits(jnp.asarray(digits, I32), Mf)
        parts = pointwise(f0, f1, prepared, m)
        limbs = relimb(parts)
        return inverse_combine(limbs, Mi, N)

    def poly_mul_torus_binary(self, a, s, params):
        from .matmul import MatmulEngine

        return MatmulEngine().poly_mul_torus_binary(a, s, params)
