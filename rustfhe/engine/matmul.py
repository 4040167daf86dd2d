"""Production engine: negacyclic convolution as one dense integer matmul.

An exact replacement for the reference's spqlios f64 FFT path
(``utils/src/spqlios/*``, ``fft_processor_spqlios.cpp``): instead of
transforming to a frequency domain we evaluate the external product
directly as an exact integer matrix product, which XLA hands to the
vendor GEMM (cuBLAS on the GPU, s8 x s8 -> s32):

  out[c] = sum_j digits_j (*) row[j][c]        (trgsw.rs:289-299)

with ``(*)`` the negacyclic convolution mod 2^32.  Each bootstrapping-key
polynomial (uint32) is pre-split into ``num_limbs`` balanced signed limbs
(|limb| <= 2^(limb_bits-1)); the convolution of the small gadget digits
(|d| <= Bg/2, trgsw.rs:270-271) with each limb is exact in int32 (or f32)
accumulation:

  |sum| <= 2L*N * (Bg/2) * 2^(limb_bits-1)
        =  6144 * 32 * 128 ~= 2^24.6   (int8 path, int32 accum: exact)
        =  6144 * 32 * 8   ~= 2^20.6   (bf16 path, f32 accum: exact)

Limbs recombine afterwards with wrapping shifts — exact mod 2^32.  The
negacyclic structure is materialized per step as a "circulant" operand
C[(j,m),(c,l,n)] = Q[j,c,l,(n-m) mod 2N] gathered from the precomputed
doubled table Q = [limbs, -limbs]; one (2L*N, 2*num_limbs*N) int8 matmul per
blind-rotate step then does the multiply-accumulate work.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..poly import to_signed_limbs

U32 = jnp.uint32
I32 = jnp.int32
I8 = jnp.int8


class MatmulEngine:
    """Dense-matmul negacyclic convolution engine.

    Args:
      limb_bits: bits per balanced signed limb of the torus operand.
        8 -> 4 limbs, int8 x int8 -> int32 matmul (default).
        4 -> 8 limbs, bf16 x bf16 -> f32 matmul (guaranteed-exact
        fallback for backends without integer matmul).
      use_bf16: compute the matmul in bfloat16 with f32 accumulation.
    """

    def __init__(self, limb_bits: int = 8, use_bf16: bool = False):
        assert 32 % limb_bits == 0
        self.limb_bits = limb_bits
        self.num_limbs = 32 // limb_bits
        self.use_bf16 = use_bf16
        self.name = "matmul_bf16" if use_bf16 else "matmul"

    # ------------------------------------------------------------------ #
    # Preparation
    # ------------------------------------------------------------------ #
    def prepare_trgsw(self, rows, params):
        """rows: uint32 (..., 2L, 2, N) -> doubled limb table.

        Returns int8 ``(..., 2L, 2, num_limbs, 2N)``: limbs of each row
        polynomial followed by their negation — the negacyclic doubling that
        turns "index mod 2N" into plain gathers (the same doubling underlies
        ``Polynomial::rotate``, math.rs:85-133).
        """
        rows = jnp.asarray(rows, U32)
        # Decompose the row and its mod-2^32 negation independently: limb-wise
        # negation would overflow int8 for limbs equal to -2^(limb_bits-1),
        # and any valid balanced decomposition of -row recombines identically.
        neg_rows = (~rows + U32(1)).astype(U32)
        limbs = to_signed_limbs(rows, self.limb_bits, self.num_limbs)
        neg_limbs = to_signed_limbs(neg_rows, self.limb_bits, self.num_limbs)
        limbs = jnp.moveaxis(limbs, -1, -2)  # (...,2L,2,K,N)
        neg_limbs = jnp.moveaxis(neg_limbs, -1, -2)
        return jnp.concatenate([limbs, neg_limbs], axis=-1)  # (...,2L,2,K,2N)

    # ------------------------------------------------------------------ #
    # External product
    # ------------------------------------------------------------------ #
    def _circulant(self, q, params):
        """q: int8 (R, 2, K, 2N) -> C: int8 (R*N, 2*K*N), R row polys
        (R = 2L for a full TRGSW; any leading row count works, e.g. a
        tensor-parallel row shard).

        C[(j,m),(c,l,n)] = q[j,c,l,(n-m) mod 2N].

        Built gather-free with the tile/reshape identity: for t of length L,
        ``tile(t, N)[: N*(L-1)].reshape(N, L-1)[m, i] == t[(i - m) mod L]``
        (each reshaped row starts one element earlier mod L).  Pure data
        movement, with no 2D gather.
        """
        N = params.N
        two_n = 2 * N
        lead = q.shape[:-1]  # (R, 2, K)
        tiled = jnp.tile(q, (1,) * len(lead) + (N,))  # (..., N*2N)
        tiled = tiled[..., : N * (two_n - 1)].reshape(lead + (N, two_n - 1))
        c = tiled[..., :N]  # (R, 2, K, m, n)
        c = jnp.moveaxis(c, -2, 1)  # (R, m, 2, K, n)
        rows = q.shape[0]
        return c.reshape(rows * N, 2 * self.num_limbs * N)

    def _matmul(self, digits_flat, circ):
        """digits_flat: (..., 2L*N) small ints; circ: (2L*N, 2*K*N) int8.

        Returns int32 (..., 2*K*N), exact.
        """
        if self.use_bf16:
            out = jnp.dot(
                digits_flat.astype(jnp.bfloat16),
                circ.astype(jnp.bfloat16),
                preferred_element_type=jnp.float32,
            )
            return out.astype(I32)
        return jnp.dot(
            digits_flat.astype(I8),
            circ,
            preferred_element_type=I32,
        )

    def _recombine(self, out_i32, params):
        """out_i32: (..., 2, K, N) int32 limbs -> uint32 (..., 2, N) mod 2^32."""
        acc = jnp.zeros(out_i32.shape[:-2] + out_i32.shape[-1:], U32)
        u = out_i32.astype(U32)
        for k in range(self.num_limbs):
            shift = self.limb_bits * k
            acc = acc + (u[..., k, :] << U32(shift))
        return acc

    def external_product_digits(self, prepared, digits, params):
        """prepared: int8 (2L, 2, K, 2N); digits: int32 (..., 2L, N) -> u32 (..., 2, N)."""
        N = params.N
        two_l = 2 * params.l
        circ = self._circulant(prepared, params)
        dflat = digits.reshape(digits.shape[:-2] + (two_l * N,))
        out = self._matmul(dflat, circ)  # (..., 2*K*N) i32
        out = out.reshape(out.shape[:-1] + (2, self.num_limbs, N))
        return self._recombine(out, params)

    # ------------------------------------------------------------------ #
    # Identity key switch as a one-hot limb matmul
    # ------------------------------------------------------------------ #
    def prepare_ksk(self, ksk_raw, params):
        """ksk_raw: uint32 (N, iks_l, T, n+1) -> int8 (N*iks_l*(T-1), (n+1)*K).

        Only digit values 1..T-1 can occur (basebit-wide digits), so slot
        T is dropped; limb-split each TLWE row for the exact matmul.
        """
        used = jnp.asarray(ksk_raw, U32)[:, :, : params.iks_t - 1, :]
        q = params.N * params.iks_l * (params.iks_t - 1)
        flat = used.reshape(q, -1)  # (Q, n+1)
        limbs = to_signed_limbs(flat, self.limb_bits, self.num_limbs)  # (Q, n+1, K)
        return limbs.reshape(q, -1)  # (Q, (n+1)*K)

    def key_switch_digits(self, prepared, digits, params):
        """digits: (..., N, iks_l) in [0, T) -> sum_{i,l} KS[i,l,d] as uint32 (..., n+1).

        Implemented as ONE (digit == t) mask dot per nonzero slot t against
        that slot's KSK row slice (nslots = T-1 small dots instead of one
        dot over a (…, N*L*nslots) one-hot): same MACs, but the operand is
        built without the 3-wide innermost broadcast axis of the fused
        one-hot variant (benches/keyswitch_probe.py times both).
        Accumulation stays exact (|sum| <= N*iks_l * 2^(limb_bits-1) << 2^24).
        """
        nslots = params.iks_t - 1
        il = params.N * params.iks_l
        d = digits.astype(jnp.int32).reshape(digits.shape[:-2] + (il,))
        ks3 = prepared.reshape(il, nslots, prepared.shape[-1])
        out = None
        for t in range(1, params.iks_t):
            m = (d == t).astype(I8)
            if self.use_bf16:
                part = jnp.dot(
                    m.astype(jnp.bfloat16),
                    ks3[:, t - 1].astype(jnp.bfloat16),
                    preferred_element_type=jnp.float32,
                ).astype(I32)
            else:
                part = jnp.dot(m, ks3[:, t - 1], preferred_element_type=I32)
            out = part if out is None else out + part
        out = out.reshape(out.shape[:-1] + (out.shape[-1] // self.num_limbs, self.num_limbs))
        # (..., n+1, K) -> recombine limbs
        acc = jnp.zeros(out.shape[:-1], U32)
        u = out.astype(U32)
        for k in range(self.num_limbs):
            acc = acc + (u[..., k] << U32(self.limb_bits * k))
        return acc

    # ------------------------------------------------------------------ #
    # Torus x binary polynomial product (encrypt/decrypt path)
    # ------------------------------------------------------------------ #
    def poly_mul_torus_binary(self, a, s, params):
        """a: uint32 (..., N) torus; s: {0,1} (N,) -> uint32 (..., N).

        Computed as limbs-of-a times the circulant of s; |sum| <= N * 128,
        well inside the exact range of both matmul paths.
        """
        N = a.shape[-1]
        s = jnp.asarray(s).astype(I8)
        sd = jnp.concatenate([s, -s], axis=-1)  # (2N,)
        # same tile/reshape circulant construction as _circulant
        cs = jnp.tile(sd, N)[: N * (2 * N - 1)].reshape(N, 2 * N - 1)[:, :N]
        limbs = to_signed_limbs(jnp.asarray(a, U32), self.limb_bits, self.num_limbs)
        # (..., N, K) -> (..., K, N)
        limbs = jnp.moveaxis(limbs, -1, -2)
        if self.use_bf16:
            prod = jnp.dot(
                limbs.astype(jnp.bfloat16),
                cs.astype(jnp.bfloat16),
                preferred_element_type=jnp.float32,
            ).astype(I32)
        else:
            prod = jnp.dot(limbs, cs, preferred_element_type=I32)  # (..., K, n)
        acc = jnp.zeros(prod.shape[:-2] + (N,), U32)
        u = prod.astype(U32)
        for k in range(self.num_limbs):
            acc = acc + (u[..., k, :] << U32(self.limb_bits * k))
        return acc
