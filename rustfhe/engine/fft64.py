"""Exact negacyclic convolution via f64 FFT.

The reference's own native layer computes torus polynomial products with a
double-precision FFT and recovers exact integers by rounding (the vendored
spqlios path, ``utils/src/spqlios/fft_processor_spqlios.cpp`` — f64 in, f64
out, with the caller's i32<->f64 conversions at
``utils/src/spqlios.rs:60-108``).  This engine does the same in JAX with
complex128 FFTs.  On the CPU (and the virtual-mesh sharding validation,
tests/conftest.py, ``__graft_entry__.dryrun_multichip``) it is 10-30x
cheaper per blind-rotate step than materializing the matmul engine's
per-step circulant, and it is just as exact:

* uint32 operands are pre-split into two balanced signed 16-bit limbs
  (|limb| <= 2^15), so every per-limb convolution coefficient is bounded by
  ``2L * N * half_bg * 2^15`` — 2^32.6 at the production set (N=1024, l=3,
  half_bg=32), 2^35 at PBS_PARAMS — comfortably below 2^53, hence exactly
  representable in f64.
* The length-2N real FFT's rounding error is ~eps * log2(2N) * |coef|
  ~= 2^-52 * 16 * 2^35 < 2^-10, far below the 0.5 rounding threshold, so
  ``round()`` recovers the exact integer convolution; limbs recombine with
  wrapping shifts, exact mod 2^32.  Exactness is not assumed: the engine is
  gated by the same adversarial oracle probe as every other engine
  (tests/test_fft64.py; ``engine.select_fast_engine``).

Negacyclic structure: the negacyclic product ``a (*) b`` of length N equals
the first N coefficients of the length-2N CIRCULAR convolution of
``[a, -a]`` with ``[b, 0_N]``.  The doubling lives on the PREPARED operand
(built once per key); the per-step operand is only zero-padded.

Requires ``jax_enable_x64`` (complex128): constructing the engine's ops
without it raises immediately with the fix, instead of silently returning
garbage from a complex64 FFT (whose 2^14 rounding error would destroy
exactness).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..poly import to_signed_limbs
from .matmul import MatmulEngine

U32 = jnp.uint32
I64 = jnp.int64
F64 = jnp.float64


def _require_x64():
    if not jax.config.jax_enable_x64:
        raise RuntimeError(
            "the fft64 engine needs float64/complex128: call "
            'jax.config.update("jax_enable_x64", True) before using it '
            "(complex64 FFTs round by ~2^14 and cannot be exact)"
        )


class FFT64Engine:
    """Exact f64-FFT negacyclic convolution engine.

    Key switching delegates to the matmul engine's int8-limb mask-dot path
    unchanged (``prepare_ksk`` / ``key_switch_digits``), so the sharded
    key-switch code — which consumes that layout via ``engine.num_limbs`` /
    ``engine.limb_bits`` (parallel/sharded.py) — works with this engine
    as-is.  Only the external product / polynomial product is FFT-based.
    """

    #: bits per balanced signed limb of the FFT operands (f64-exactness bound).
    conv_limb_bits = 16
    conv_num_limbs = 2
    #: engine selection skips this engine unless jax_enable_x64 is on.
    needs_x64 = True

    def __init__(self):
        self.name = "fft64"
        self._ks = MatmulEngine()  # int8-limb key-switch path
        # Sharded key-switch recombination reads these (parallel/sharded.py).
        self.limb_bits = self._ks.limb_bits
        self.num_limbs = self._ks.num_limbs

    # ------------------------------------------------------------------ #
    # Preparation
    # ------------------------------------------------------------------ #
    def _limbs_f64(self, x):
        """uint32 (..., N) -> f64 (..., K, N) balanced signed 16-bit limbs."""
        limbs = to_signed_limbs(
            x, self.conv_limb_bits, self.conv_num_limbs, dtype=jnp.int32
        )
        return jnp.moveaxis(limbs, -1, -2).astype(F64)

    def _prepare_poly(self, x):
        """uint32 (..., N) -> rfft of the negacyclic doubling [limbs, -limbs]:
        complex128 (..., K, N+1)."""
        _require_x64()
        limbs = self._limbs_f64(jnp.asarray(x, U32))
        doubled = jnp.concatenate([limbs, -limbs], axis=-1)  # (..., K, 2N)
        return jnp.fft.rfft(doubled, axis=-1)

    def prepare_trgsw(self, rows, params):
        """rows: uint32 (..., 2L, 2, N) -> complex128 (..., 2L, 2, K, N+1)."""
        return self._prepare_poly(rows)

    # ------------------------------------------------------------------ #
    # External product
    # ------------------------------------------------------------------ #
    def _conv_partial(self, prepared, digits, params):
        """Per-limb f64 convolution partial sums (exact integers).

        prepared: complex128 (R, 2, K, N+1); digits: int (..., R, N) with R
        the contracted gadget-row count (2L, or a tensor-parallel shard of
        it).  Returns f64 (..., 2, K, N): sum_j digits_j (*) row_j, per limb.
        Exact-integer-valued, so partials may be summed across devices
        (psum) BEFORE rounding — the tp-sharded contraction uses that.
        """
        N = params.N
        d = digits.astype(F64)
        df = jnp.fft.rfft(d, n=2 * N, axis=-1)  # zero-padded: (..., R, N+1)
        prod = jnp.einsum("...jf,jckf->...ckf", df, prepared)
        full = jnp.fft.irfft(prod, n=2 * N, axis=-1)
        return full[..., :N]

    def _round_recombine(self, part, params):
        """f64 (..., 2, K, N) integer-valued limb sums -> uint32 (..., 2, N)."""
        r = jnp.round(part).astype(I64)
        acc = jnp.zeros(r.shape[:-2] + r.shape[-1:], U32)
        for k in range(self.conv_num_limbs):
            acc = acc + (r[..., k, :].astype(U32) << U32(self.conv_limb_bits * k))
        return acc

    def external_product_digits(self, prepared, digits, params):
        """prepared: c128 (2L, 2, K, N+1); digits: int (..., 2L, N) -> u32 (..., 2, N)."""
        part = self._conv_partial(prepared, digits, params)
        return self._round_recombine(part, params)

    # ------------------------------------------------------------------ #
    # Key switch (matmul engine's int8-limb layout, unchanged)
    # ------------------------------------------------------------------ #
    def prepare_ksk(self, ksk_raw, params):
        return self._ks.prepare_ksk(ksk_raw, params)

    def key_switch_digits(self, prepared, digits, params):
        return self._ks.key_switch_digits(prepared, digits, params)

    # ------------------------------------------------------------------ #
    # Torus x binary polynomial product (encrypt/decrypt path)
    # ------------------------------------------------------------------ #
    def poly_mul_torus_binary(self, a, s, params):
        """a: uint32 (..., N) torus; s: {0,1} (N,) -> uint32 (..., N).

        Limbed a against zero-padded s; |sum| <= N * 2^15 = 2^25 — exact.
        """
        _require_x64()
        N = a.shape[-1]
        af = self._prepare_poly(a)  # (..., K, N+1)
        sf = jnp.fft.rfft(jnp.asarray(s).astype(F64), n=2 * N, axis=-1)
        full = jnp.fft.irfft(af * sf, n=2 * N, axis=-1)[..., :N]  # (..., K, N)
        r = jnp.round(full).astype(I64)
        acc = jnp.zeros(r.shape[:-2] + (N,), U32)
        for k in range(self.conv_num_limbs):
            acc = acc + (r[..., k, :].astype(U32) << U32(self.conv_limb_bits * k))
        return acc
