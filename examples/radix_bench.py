"""Device validation + cost measurement of the PBS preset and radix integers.

Three sections (VERDICT r3 items 2 + 3):
  1. PBS_PARAMS soundness on hardware: space=8 programmable bootstrapping
     at a large batch — expect ZERO decode errors (the preset's calibrated
     margin is 9.7 sigma; the gate-preset validation methodology).
  2. Radix 8-bit add on device: correctness at production parameters and
     the headline cost metric — bootstrap LEVELS and total PBS lookups per
     8-bit add (radix: 4 levels / 8 lookups; bit-circuit: 15 levels / ~38
     gate bootstraps) — with measured wall times for both paths.
  3. pbs_many(space=8, t=2) at batch: the borderline-variant measurement
     (calibrated 4.9 sigma — prediction: ~1e-6/lookup, usually clean).

Usage:
  BATCH=256 PBS_BATCH=65536 python examples/radix_bench.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from rustfhe import pbs, radix
from rustfhe.context import TFHE
from rustfhe.params import PBS_PARAMS
from rustfhe.radix import RadixUint

U32 = jnp.uint32



def _force(arr):
    """Real data readback: every timed section ends in an actual host
    transfer of one element."""
    import numpy as _np

    return _np.asarray(arr).reshape(-1)[0]


def main():
    from rustfhe.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    p = PBS_PARAMS
    B = int(os.environ.get("BATCH", "256"))
    BP = int(os.environ.get("PBS_BATCH", "65536"))
    print(f"# device: {jax.devices()[0].platform} "
          f"{getattr(jax.devices()[0], 'device_kind', '?')}", flush=True)
    ok, msg = pbs.check_pbs_space(p, 8)
    print(f"# preset check: {msg} -> ok={ok}", flush=True)
    assert ok, "PBS_PARAMS must pass space=8 at the 5-sigma bar"
    ok_r, msg_r = radix.check_radix(p)
    print(f"# {msg_r} -> ok={ok_r}", flush=True)
    assert ok_r

    t0 = time.perf_counter()
    # engine_name=None -> select_fast_engine: honors RUSTFHE_ENGINE but
    # still runs the on-device exactness probe AT THIS PRESET (l=4,
    # N=2048).
    # Default key cache under the user's home (NOT a predictable
    # world-writable /tmp name: the cache holds the SECRET key, and a
    # pre-planted file at a shared path would silently supply an
    # attacker-known key).  KEYFILE="" disables caching.
    keyfile = os.environ.get(
        "KEYFILE",
        os.path.expanduser(f"~/.cache/rustfhe/keys_{p.N}_{p.n}"))
    ctx = TFHE.new(jax.random.PRNGKey(11), p, None, keyfile=keyfile or None)
    print(f"# keygen {time.perf_counter() - t0:.1f}s "
          f"(engine {ctx.engine_name})", flush=True)
    rng = np.random.default_rng(5)

    # ---- 1. space=8 PBS at large batch: zero-error device validation.
    space = 8
    xs = rng.integers(0, space, size=BP)
    table = jnp.asarray(rng.integers(0, space, size=(space,)), U32)
    ct = ctx.encrypt_int(jnp.asarray(xs, U32), space)
    t0 = time.perf_counter()
    out = jax.block_until_ready(ctx.apply_lut(ct, table, space))
    dt_c = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(ctx.apply_lut(out, table, space))
    dt = time.perf_counter() - t0  # chained second run: no compile, no cache
    dec = np.asarray(ctx.decrypt_int(out, space))
    want = np.asarray(table)[np.asarray(table)[xs]]  # chained g(g(x))
    n_ok = int((dec == want).sum())
    print(f"pbs space=8 B={BP}: {n_ok}/{BP} correct "
          f"({BP / dt:,.0f} PBS/s, first-call {dt_c:.1f}s incl compile)",
          flush=True)
    assert n_ok == BP, f"{BP - n_ok} decode errors at the PBS preset"

    # ---- 2. radix 8-bit add: correctness + cost vs the bit circuit.
    nd = 4  # 4 x 2-bit digits = 8 bits
    av = rng.integers(0, 256, size=B).astype(np.uint64)
    bv = rng.integers(0, 256, size=B).astype(np.uint64)
    a = RadixUint.encrypt(ctx, av, nd)
    b = RadixUint.encrypt(ctx, bv, nd)
    s, _ = a.add_with_carry(b)  # compile
    _force(s.digits[..., :1, :1])
    t0 = time.perf_counter()
    s2, _ = (s + b).add_with_carry(b)  # chained
    _force(s2.digits[..., :1, :1])
    dt_radix = (time.perf_counter() - t0) / 2
    got = s.decrypt()
    n_ok = int((got == ((av + bv) & 0xFF)).sum())
    print(f"radix add8 B={B}: {n_ok}/{B} correct, {dt_radix * 1e3:.0f} ms "
          f"per add ({nd} bootstrap levels, {2 * nd} PBS lookups)", flush=True)
    assert n_ok == B

    # bit-circuit add at the same preset for the wall-time comparison
    # (17 levels; one compiled bootstrap per level width through the
    # fixed-width program).
    ctx.circuit_fixed_width = 16  # widest adder8 level; one program for all
    ua = ctx.encrypt_uint(av, 8)
    ub = ctx.encrypt_uint(bv, 8)
    t0 = time.perf_counter()
    us = ua + ub  # includes compile of the fixed-width program
    _force(us.bits[..., :1, :1])
    dt_bits_c = time.perf_counter() - t0
    t0 = time.perf_counter()
    us2 = us + ub  # chained
    _force(us2.bits[..., :1, :1])
    dt_bits = time.perf_counter() - t0
    n_ok = int((us.decrypt() == ((av + bv) & 0xFF)).sum())
    print(f"bit-circuit add8 B={B}: {n_ok}/{B} correct, "
          f"{dt_bits * 1e3:.0f} ms per add (15 levels; first call "
          f"{dt_bits_c:.1f}s incl compile)", flush=True)
    assert n_ok == B
    print(f"=> radix vs bit-circuit: {dt_bits / dt_radix:.2f}x wall-time, "
          f"bootstrap levels 15 -> {nd}, lookups ~38 -> {2 * nd}", flush=True)

    # ---- 2b. radix 8-bit multiply (18 bootstrap levels; check_radix_mul
    # passes at 5.5 calibrated sigma at this preset).
    ok_mul, msg_mul = radix.check_radix_mul(p)
    print(f"# {msg_mul} -> ok={ok_mul}", flush=True)
    prod = a * b  # compile
    _force(prod.digits[..., :1, :1])
    t0 = time.perf_counter()
    prod2 = prod * b  # chained
    _force(prod2.digits[..., :1, :1])
    dt_mul = time.perf_counter() - t0
    n_ok = int((prod.decrypt() == ((av * bv) & 0xFF)).sum())
    print(f"radix mul8 B={B}: {n_ok}/{B} correct, {dt_mul * 1e3:.0f} ms "
          f"per multiply (18 bootstrap levels)", flush=True)
    assert n_ok == B

    # ---- 3. the borderline pbs_many(8, 2) variant, measured honestly.
    ok_m, msg_m = pbs.check_pbs_many(p, 8, 2)
    print(f"# {msg_m} -> ok={ok_m}", flush=True)
    tabs = jnp.asarray(rng.integers(0, space, size=(2, space)), U32)
    ctm = ctx.encrypt_int(jnp.asarray(xs[:B], U32), space)
    outm = jax.block_until_ready(ctx.apply_luts(ctm, tabs, space))
    decm = np.asarray(ctx.decrypt_int(outm, space))
    bad = 0
    for j in range(2):
        bad += int((decm[:, j] != np.asarray(tabs)[j][xs[:B]]).sum())
    print(f"pbs_many(8,2) B={B}: {2 * B - bad}/{2 * B} correct "
          f"(margin {msg_m.split('margin ')[1]})", flush=True)

    # ---- 4. round-5 radix API additions on device (VERDICT r4 #5).
    # Shifts: even amounts free (digit re-index), odd amounts 1 PBS level.
    for k in (2, 3):
        t0 = time.perf_counter()
        sh = a.shift_left(k)
        _force(sh.digits[..., :1, :1])
        dt_sh = time.perf_counter() - t0
        n_ok = int((sh.decrypt() == ((av << np.uint64(k)) & 0xFF)).sum())
        print(f"radix shl{k} B={B}: {n_ok}/{B} correct, "
              f"{dt_sh * 1e3:.0f} ms ({'1 PBS level' if k % 2 else 'free'}"
              f", first call incl compile)", flush=True)
        assert n_ok == B
    t0 = time.perf_counter()
    sr = a.shift_right(3)
    _force(sr.digits[..., :1, :1])
    n_ok = int((sr.decrypt() == (av >> np.uint64(3))).sum())
    print(f"radix shr3 B={B}: {n_ok}/{B} correct, "
          f"{(time.perf_counter() - t0) * 1e3:.0f} ms", flush=True)
    assert n_ok == B

    # Scalar multiply fast path: x10 = shared odd shift + 2 add rounds.
    t0 = time.perf_counter()
    sm = a * 10
    _force(sm.digits[..., :1, :1])
    dt_sm = time.perf_counter() - t0
    n_ok = int((sm.decrypt() == ((av * 10) & 0xFF)).sum())
    print(f"radix scalar x10 B={B}: {n_ok}/{B} correct, "
          f"{dt_sm * 1e3:.0f} ms (9 levels vs the general multiply's 18; "
          f"general measured {dt_mul * 1e3:.0f} ms above)", flush=True)
    assert n_ok == B

    # Overflow flags + signed full-width product.
    s_o, ovf = a.add_overflows(b)
    _force(ovf[..., :1])
    n_ok = int((np.asarray(ctx.decrypt(ovf), np.uint64)
                == ((av + bv) >> np.uint64(8))).sum())
    print(f"radix add_overflows B={B}: {n_ok}/{B} carry flags correct",
          flush=True)
    assert n_ok == B

    from rustfhe.radix import RadixInt

    sv_a = rng.integers(-128, 128, size=B).astype(np.int64)
    sv_b = rng.integers(-128, 128, size=B).astype(np.int64)
    sa8 = RadixInt.encrypt(ctx, sv_a, nd)
    sb8 = RadixInt.encrypt(ctx, sv_b, nd)
    t0 = time.perf_counter()
    sf = sa8.mul(sb8, full=True)
    _force(sf.digits[..., :1, :1])
    dt_sf = time.perf_counter() - t0
    n_ok = int((sf.decrypt() == sv_a * sv_b).sum())
    print(f"radix SIGNED full-width mul8 B={B}: {n_ok}/{B} correct, "
          f"{dt_sf * 1e3:.0f} ms (52 levels incl compile of the "
          f"correction programs)", flush=True)
    assert n_ok == B

    print("OK", flush=True)



if __name__ == "__main__":
    main()
