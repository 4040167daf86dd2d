"""Probe: multi-bit (grouped, k=2) blind rotation — VERDICT r2 item 2.

The one standard TFHE-family lever that was absent from the refuted list:
group k key bits per blind-rotate step so the scan runs n/k steps.  This
file builds the k=2 construction EXACTLY (validated by on-device decode
correctness of full gates through it) and measures it, so the verdict is a
measurement, not an estimate.

Construction (generalizes the per-bit fold at reference
``hom_nand/src/tfhe.rs:103-110``):

  X^{a0 s0 + a1 s1} = (1 + s0 (X^{a0}-1)) (1 + s1 (X^{a1}-1))
                    = 1 + s0 m0 + s1 m1 + s0 s1 m0 m1,   m_j = X^{a_j} - 1

so with BK entries B0 = TRGSW(s0), B1 = TRGSW(s1), B01 = TRGSW(s0*s1)
(~1.5x BK memory) and ⊡ the external product, one group step is

  acc <- acc + m0 (B0 ⊡ acc) + m1 (B1 ⊡ acc) + m0 m1 (B01 ⊡ acc)

where all three ⊡ SHARE one gadget decomposition of acc (the public
monomial factors m_T commute out of the product: sum_j d_j (*) (m (*) r_j)
= m (*) sum_j d_j (*) r_j), and each m_T application is a per-gate binary
rotation + subtract on the output TRLWE.

Why it cannot win with the exact integer-matmul external product (the
matmul engine's cost model; with an FFT engine the question is open again,
ROADMAP.md S7):

* Matmul: the three ⊡ against the shared digits are one contraction with 3x
  the output width — 3x the MACs of ONE standard step to cover 2 key bits
  = x1.5 MACs/bit (k bits: (2^k - 1)/k >= 1.5 for every k >= 2, monotone
  increasing).  The FFT/NTT setting wins here because its per-step cost is
  dominated by the 2L forward transforms of the digits, which the grouped
  form amortizes across the 2^k-1 BK entries; in the exact matmul model there
  is no transform — the contraction IS the cost, and it scales with the
  number of BK entries, not the number of steps.
* VPU: per 2 bits, standard does 2 in-scan rotations; grouped does 4
  rotate+subtract plane passes (m0, m1, and m0 m1 applied as two chained
  rotations), elementwise work the step already spends much of its time on.
* Noise: the BK/gadget error of each term is convolved by m_T
  (2^|T| signed monomials -> variance x2^|T|), so one group step carries
  (2+2+4) = 8 units of per-product variance vs 2x1 = 2 for two standard
  steps: x4 blind-rotate variance per bit pair.  utils/noise.py puts the
  default set at 10.8 sigma; grouped-2 lands at ~7.3 sigma (the rotate
  term is only one of four variance components) — still above the 5-sigma
  bar, so noise alone would not kill it; the extra matmul and elementwise
  work does.

Usage:
  python benches/multibit_probe.py check   # decode-correctness of grouped
                                           # gates at TEST params (CPU ok)
  python benches/multibit_probe.py [B]     # timing at DEFAULT params (card):
                                           # standard vs grouped scan over
                                           # the same number of key bits
"""

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from rustfhe import keys, poly, tlwe, trgsw, trlwe  # noqa: E402
from rustfhe.bootstrap import identity_key_switch  # noqa: E402
from rustfhe.engine import get_engine  # noqa: E402
from rustfhe.params import DEFAULT_PARAMS, TEST_PARAMS, TFHEParams  # noqa: E402

I32, U32 = jnp.int32, jnp.uint32


# --------------------------------------------------------------------- #
# Grouped (k=2) bootstrapping key + blind rotation
# --------------------------------------------------------------------- #
def gen_grouped_bk(key, sk, params: TFHEParams, engine):
    """(bkg, bk_last): engine-prepared grouped BK.

    bkg: (n//2, 3, ...) — per pair (s_even, s_odd, s_even*s_odd);
    bk_last: (1, ...) standard TRGSW(s_{n-1}) when n is odd, else None.
    """
    s0 = sk.lv0.astype(I32)
    g = params.n // 2
    se, so = s0[: 2 * g : 2], s0[1 : 2 * g : 2]
    items = jnp.stack([se, so, se * so], axis=1)  # (g, 3)
    raw = trgsw.encrypt_int(key, sk.lv1, items, params, engine)  # (g,3,2L,2,N)
    bkg = engine.prepare_trgsw(raw, params)
    bk_last = None
    if params.n % 2 == 1:
        raw_l = trgsw.encrypt_int(
            jax.random.fold_in(key, 1), sk.lv1, s0[-1:], params, engine
        )
        bk_last = engine.prepare_trgsw(raw_l, params)
    return bkg, bk_last


def _apply_m(x, a, params):
    """(X^a - 1) * x for per-gate a in [0, 2N): rotate + subtract."""
    return (poly.rotate_binary(x, a[..., None]) - x).astype(U32)


def grouped_step(bk_g, acc, a0, a1, params: TFHEParams, engine):
    """One k=2 group step: bk_g (3, ...) prepared, acc (..., 2, N) u32,
    a0/a1 (...,) int32 in [0, 2N)."""
    digits = trgsw.decompose_trlwe(acc, params)  # shared decomposition
    c0 = engine.external_product_digits(bk_g[0], digits, params)
    c1 = engine.external_product_digits(bk_g[1], digits, params)
    c01 = engine.external_product_digits(bk_g[2], digits, params)
    d0 = _apply_m(c0, a0, params)
    d1 = _apply_m(c1, a1, params)
    d01 = _apply_m(_apply_m(c01, a0, params), a1, params)
    return (acc + d0 + d1 + d01).astype(U32)


def blind_rotate_grouped2(ct, bkg, bk_last, testvec, params: TFHEParams, engine):
    """Grouped-2 blind rotation (same scaling contract as bootstrap.blind_rotate)."""
    shift = 32 - params.nbit - 1
    two_n = 2 * params.N
    b = tlwe.body(ct)
    a = tlwe.mask(ct)
    b_tilde = (b >> U32(shift)).astype(I32)
    a_tilde = ((a + U32(1 << (shift - 1))) >> U32(shift)).astype(I32)

    acc = poly.rotate_binary(testvec, jnp.mod(-b_tilde, two_n)[..., None])

    g = params.n // 2
    a0s = jnp.moveaxis(a_tilde[..., : 2 * g : 2], -1, 0)  # (g, ...)
    a1s = jnp.moveaxis(a_tilde[..., 1 : 2 * g : 2], -1, 0)

    def step(acc, xs):
        bk_g, a0, a1 = xs
        return grouped_step(bk_g, acc, a0, a1, params, engine), None

    acc, _ = jax.lax.scan(step, acc, (bkg, a0s, a1s))

    if bk_last is not None:  # odd n: one standard CMux step for the last bit
        a_l = a_tilde[..., -1]
        rotated = poly.rotate_binary(acc, a_l[..., None])
        diff = (rotated - acc).astype(U32)
        digits = trgsw.decompose_trlwe(diff, params)
        acc = (acc + engine.external_product_digits(bk_last[0], digits, params)).astype(U32)
    return acc


def bootstrap_grouped2(ct, bkg, bk_last, ksk, params: TFHEParams, engine):
    testvec = trlwe.trivial(jnp.full((params.N,), jnp.asarray(params.mu, U32), U32))
    rotated = blind_rotate_grouped2(ct, bkg, bk_last, testvec, params, engine)
    lv1 = trlwe.sample_extract(rotated, 0)
    return identity_key_switch(lv1, ksk, params, engine)


# --------------------------------------------------------------------- #
# Correctness: full NAND truth table through the grouped rotation
# --------------------------------------------------------------------- #
def check_correctness(params: TFHEParams = TEST_PARAMS, batch: int = 64, seed: int = 5):
    engine = get_engine("matmul")
    key = jax.random.PRNGKey(seed)
    kg, ke = jax.random.split(key)
    sk, ck = keys.gen_keys(kg, params, engine_name="matmul")
    kb, _ = jax.random.split(jax.random.fold_in(kg, 77))
    bkg, bk_last = gen_grouped_bk(kb, sk, params, engine)

    pat = np.tile(np.array([[0, 0], [1, 0], [0, 1], [1, 1]], np.uint32),
                  (batch // 4 + 1, 1))[:batch]
    cx = tlwe.encrypt_binary(jax.random.fold_in(ke, 0), sk.lv0,
                             jnp.asarray(pat[:, 0]), params)
    cy = tlwe.encrypt_binary(jax.random.fold_in(ke, 1), sk.lv0,
                             jnp.asarray(pat[:, 1]), params)
    mu_triv = tlwe.trivial(jnp.asarray(params.mu, U32), params.n)
    pre = (mu_triv - (cx + cy)).astype(U32)
    out = jax.jit(
        lambda p: bootstrap_grouped2(p, bkg, bk_last, ck.ksk, params, engine)
    )(pre)
    dec = np.asarray(tlwe.decrypt_binary(out, sk.lv0))
    want = 1 - (pat[:, 0] & pat[:, 1])
    bad = int((dec != want).sum())
    return bad, batch


# --------------------------------------------------------------------- #
# Timing: standard vs grouped scan over the same number of key bits
# --------------------------------------------------------------------- #
def main_timing(B: int):
    params = DEFAULT_PARAMS
    engine = get_engine("matmul")
    bits = 16  # key bits per timed scan (8 grouped steps vs 16 standard)
    rs = np.random.RandomState(7)
    print(f"# device: {jax.devices()[0]}  B={B}  bits/scan={bits}", flush=True)

    rows = jnp.asarray(
        rs.randint(0, 2**32, size=(bits, 2 * params.l, 2, params.N),
                   dtype=np.uint64).astype(np.uint32)
    )
    bk_std = engine.prepare_trgsw(rows, params)          # (bits, ...)
    # grouped needs 3 TRGSWs per pair; reuse the two prepared entries plus
    # the first again as the pair-product slot (timing only — values don't
    # matter, shapes/dtypes/layout do)
    pairs = bk_std.reshape((bits // 2, 2) + bk_std.shape[1:])
    bkg3 = jnp.concatenate([pairs, pairs[:, :1]], axis=1)  # (bits//2, 3, ...)

    acc0 = jnp.asarray(
        rs.randint(0, 2**32, size=(B, 2, params.N), dtype=np.uint64).astype(np.uint32)
    )
    a_all = jnp.asarray(rs.randint(0, 2 * params.N, size=(bits, B)).astype(np.int32))

    @jax.jit
    def run_std(acc):
        def step(acc, xs):
            bk_i, a_i = xs
            rotated = poly.rotate_binary(acc, a_i[..., None])
            diff = (rotated - acc).astype(U32)
            digits = trgsw.decompose_trlwe(diff, params)
            return (acc + engine.external_product_digits(bk_i, digits, params)).astype(U32), None

        out, _ = jax.lax.scan(step, acc, (bk_std, a_all))
        return out

    @jax.jit
    def run_grp(acc):
        def step(acc, xs):
            bk_g, a0, a1 = xs
            return grouped_step(bk_g, acc, a0, a1, params, engine), None

        out, _ = jax.lax.scan(
            step, acc,
            (bkg3, a_all[0::2], a_all[1::2]),
        )
        return out

    for name, fn in (("standard", run_std), ("grouped2", run_grp)):
        y = jax.block_until_ready(fn(acc0))  # compile
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            y = fn((y + U32(1)).astype(U32))  # chained: no call is skipped
        jax.block_until_ready(y)
        dt = (time.perf_counter() - t0) / reps
        per_bit = dt / bits
        print(
            f"{name:9s} {dt*1e3:8.2f} ms/{bits}-bit scan   "
            f"{per_bit*1e3:7.3f} ms/bit   -> full n=635 rotate ~{per_bit*635*1e3:6.0f} ms",
            flush=True,
        )

    # Noise verdict at the default set
    from rustfhe.utils.noise import noise_budget

    nb = noise_budget(params)
    grp_sigma = (
        nb.var_fresh + nb.var_rounding + 4.0 * nb.var_bootstrap + nb.var_keyswitch
    ) ** 0.5
    print(
        f"# noise: standard margin {nb.margin_sigmas:.1f} sigma; grouped-2 "
        f"(x4 blind-rotate variance) ~{(1/16)/grp_sigma:.1f} sigma",
        flush=True,
    )


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "check":
        bad, batch = check_correctness()
        print(f"# grouped-2 NAND truth table: {batch - bad}/{batch} correct")
        assert bad == 0, f"{bad}/{batch} wrong"
    else:
        main_timing(int(sys.argv[1]) if len(sys.argv) > 1 else 8192)
