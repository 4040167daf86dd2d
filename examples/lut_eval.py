"""Programmable bootstrapping demo: homomorphic lookup-table evaluation.

Evaluates arbitrary functions f: Z_space -> Z_space on encrypted integers
with ONE bootstrap each (rustfhe.pbs) — a capability the reference does
not have, running on the same fused blind-rotate kernels as the gates:

  * a fixed demo function (squaring mod space),
  * a batch of RANDOM per-row functions (multi-LUT: a different table per
    ciphertext in one fused program),
  * a chained pair g(f(x)) showing outputs are valid fresh inputs.

Every decode is asserted against the cleartext table before timing is
reported.  Usage:

  python examples/lut_eval.py [--space 8] [--batch 4096] [--params default]
"""

import argparse
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from rustfhe import pbs  # noqa: E402
from rustfhe.context import TFHE  # noqa: E402
from rustfhe.params import DEFAULT_PARAMS, TEST_PARAMS  # noqa: E402

U32 = jnp.uint32


def main():
    from rustfhe.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--space", type=int, default=4,
                    help="message space (power of two; noise-checked — at the "
                         "reference parameter set space=4 is as sound as the "
                         "gates; space=8 measured 18/4096 wrong on device)")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--params", choices=["default", "test"], default="default")
    args = ap.parse_args()
    p = {"default": DEFAULT_PARAMS, "test": TEST_PARAMS}[args.params]
    space, B = args.space, args.batch

    ok, msg = pbs.check_pbs_space(p, space, min_sigmas=4.0)
    print(f"# noise budget: {msg}" + ("" if ok else "  [UNSOUND — refusing]"))
    if not ok:
        sys.exit(1)

    dev = jax.devices()[0]
    print(f"# device: {dev.platform} {dev.device_kind}")
    t0 = time.perf_counter()
    # KEYFILE: on-disk raw-key cache (utils.serialization.cached_keys) —
    # keygen runs once per machine; later runs load in seconds.
    # KEYFILE="" disables.
    # Default key cache under the user's home (NOT a predictable
    # world-writable /tmp name: the cache holds the SECRET key, and a
    # pre-planted file at a shared path would silently supply an
    # attacker-known key).  KEYFILE="" disables caching.
    keyfile = os.environ.get(
        "KEYFILE",
        os.path.expanduser(f"~/.cache/rustfhe/keys_{p.N}_{p.n}"))
    ctx = TFHE.new(jax.random.PRNGKey(0), p, engine_name=None,
                   keyfile=keyfile or None)
    print(f"# keygen ({ctx.engine_name}): {time.perf_counter() - t0:.1f}s")

    rng = np.random.default_rng(0)
    xs = jnp.asarray(rng.integers(0, space, size=(B,)), U32)
    ct = ctx.encrypt_int(xs, space)

    # 1. one function for the whole batch: squaring mod space
    sq = jnp.asarray([(v * v) % space for v in range(space)], U32)
    t0 = time.perf_counter()
    out = jax.block_until_ready(ctx.apply_lut(ct, sq, space))
    print(f"# compile+first PBS batch: {time.perf_counter() - t0:.1f}s")
    dec = np.asarray(ctx.decrypt_int(out, space))
    assert np.array_equal(dec, np.asarray(sq)[np.asarray(xs)]), "square LUT wrong"
    t0 = time.perf_counter()
    jax.block_until_ready(ctx.apply_lut(ct, sq, space))
    dt = time.perf_counter() - t0
    print(f"# x^2 mod {space}: {B} lookups correct, {dt * 1e3:.0f} ms "
          f"-> {B / dt:,.0f} PBS/s")

    # 2. multi-LUT: a different random function per row, same program
    tables = jnp.asarray(rng.integers(0, space, size=(B, space)), U32)
    out = jax.block_until_ready(ctx.apply_lut(ct, tables, space))
    dec = np.asarray(ctx.decrypt_int(out, space))
    want = np.asarray(tables)[np.arange(B), np.asarray(xs)]
    assert np.array_equal(dec, want), "multi-LUT wrong"
    print(f"# multi-LUT: {B} distinct random functions correct in one program")

    # 3. chaining: g(f(x)) — PBS outputs are valid fresh inputs
    f = jnp.asarray(rng.permutation(space), U32)
    g = jnp.asarray(rng.permutation(space), U32)
    out = ctx.apply_lut(ctx.apply_lut(ct, f, space), g, space)
    dec = np.asarray(ctx.decrypt_int(out, space))
    assert np.array_equal(dec, np.asarray(g)[np.asarray(f)[np.asarray(xs)]])
    print(f"# chained g(f(x)): {B} correct through two bootstraps")

    # 4. multi-output PBS (PBSmanyLUT): t tables, ONE blind rotation.
    # space*t fixes the sub-slot resolution; at the default set t=2 at
    # space=2 is noise-sound (check_pbs_many).
    t_many = 2
    space_m = 2
    ok, msg = pbs.check_pbs_many(p, space_m, t_many, min_sigmas=4.0)
    print(f"# noise budget: {msg}" + ("" if ok else "  [UNSOUND — skipping]"))
    if ok:
        xs_m = jnp.asarray(rng.integers(0, space_m, size=(B,)), U32)
        ct_m = ctx.encrypt_int(xs_m, space_m)
        tabs = jnp.asarray(rng.integers(0, space_m, size=(t_many, space_m)),
                           U32)
        out = jax.block_until_ready(ctx.apply_luts(ct_m, tabs, space_m))
        t0 = time.perf_counter()
        out = jax.block_until_ready(ctx.apply_luts(ct_m, tabs, space_m))
        dt = time.perf_counter() - t0
        dec = np.asarray(ctx.decrypt_int(out, space_m))
        for j in range(t_many):
            want = np.asarray(tabs[j])[np.asarray(xs_m)]
            n_ok = int(np.sum(dec[:, j] == want))
            print(f"# manyLUT table {j}: {n_ok}/{B} correct")
            assert n_ok == B, f"manyLUT table {j}: {B - n_ok} wrong"
        print(f"# manyLUT: {t_many}x{B} lookups from {B} rotations, "
              f"{dt * 1e3:.0f} ms -> {t_many * B / dt:,.0f} lookups/s")

    # 5. PBS -> bit bridge: decompose a PBS-domain int into gate-encoded
    # FheUint bit planes (one bootstrap), then run integer-API ops on it.
    space_b = 4
    ok, msg = pbs.check_pbs_many(p, space_b, 2, min_sigmas=4.0)
    print(f"# noise budget: {msg}" + ("" if ok else "  [UNSOUND — skipping]"))
    if ok:
        xs_b = jnp.asarray(rng.integers(0, space_b, size=(B,)), U32)
        ct_b = ctx.encrypt_int(xs_b, space_b)
        # unsafe=True: this section IS the borderline-margin device
        # measurement of the single-rotation t=2 form (4.2 predicted sigma
        # < the 5-sigma API gate).  Without the override the bridge now
        # splits adaptively into per-bit rotations that each pass the
        # check (ints.from_pbs_int round 4).
        u = ctx.int_to_uint(ct_b, space_b, unsafe=True)
        got = np.asarray(u.decrypt())
        n_ok = int(np.sum(got == np.asarray(xs_b)))
        print(f"# int_to_uint: {n_ok}/{B} bit decompositions correct "
              f"(margin is borderline at space=4 x t=2 — also a noise "
              f"measurement)")
        assert n_ok >= int(0.99 * B), f"bridge: {B - n_ok} wrong (> 1%)"
    print("OK")


if __name__ == "__main__":
    main()
