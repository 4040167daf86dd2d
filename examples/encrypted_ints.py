"""Typed encrypted integers end-to-end: a batch of FheUint8 values is
added, multiplied, divided, compared, and min/max-selected entirely under
encryption through the `ints` API (every op = standard cell circuit,
level-fused, one batched bootstrap per level), then decode-asserted
against the numpy model.

Usage: python examples/encrypted_ints.py [batch=256] [bits=8] [params]
  params: default | test  (test = small parameters, runs quickly on CPU)
"""

import sys
import time

import jax
import numpy as np

sys.path.insert(0, ".")

from rustfhe.context import TFHE  # noqa: E402
from rustfhe.ints import FheInt  # noqa: E402
from rustfhe.params import DEFAULT_PARAMS, TEST_PARAMS  # noqa: E402


def main():
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    bits = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    params = (TEST_PARAMS if (len(sys.argv) > 3 and sys.argv[3] == "test")
              else DEFAULT_PARAMS)
    mask = (1 << bits) - 1

    t0 = time.perf_counter()
    ctx = TFHE.new(jax.random.PRNGKey(11), params, None)
    print(f"# keygen: {time.perf_counter() - t0:.1f}s  "
          f"(n={params.n}, N={params.N}, engine {ctx.engine_name})")
    if params is DEFAULT_PARAMS:
        # One compiled bootstrap program for every circuit level (each
        # new shape is a fresh compile of the n-step scan); 64
        # covers the widest level of every 8-bit cell (the multiplier's).
        ctx.circuit_fixed_width = max(64, 8 * bits)

    rs = np.random.RandomState(5)
    av = rs.randint(0, 1 << bits, size=batch).astype(np.uint64)
    bv = rs.randint(0, 1 << bits, size=batch).astype(np.uint64)
    a = ctx.encrypt_uint(av, bits)
    b = ctx.encrypt_uint(bv, bits)

    def check(tag, fhe, expect, t0):
        got = fhe.decrypt() if hasattr(fhe, "decrypt") else np.asarray(
            ctx.decrypt(fhe), np.uint64)
        ok = int(np.sum(got == expect))
        dt = time.perf_counter() - t0
        print(f"# {tag:>10}: {ok}/{batch} correct  ({dt:.2f}s)")
        assert ok == batch, f"{tag}: {batch - ok} wrong"

    t = time.perf_counter(); check("a + b", a + b, (av + bv) & mask, t)
    t = time.perf_counter(); check("a * b", a * b, (av * bv) & mask, t)
    t = time.perf_counter(); check("a < b", a.lt(b), (av < bv).astype(np.uint64), t)
    t = time.perf_counter(); check("min", a.min_(b), np.minimum(av, bv), t)
    t = time.perf_counter()
    q, r = a.divmod(b)
    safe = np.where(bv == 0, 1, bv)
    check("a // b", q, np.where(bv == 0, mask, av // safe), t)
    t = time.perf_counter()
    check("a % b", r, np.where(bv == 0, av, av % safe), t)

    # signed: compare across the sign boundary + wrapping abs
    sv = (av.astype(np.int64) - (1 << (bits - 1)))
    s = FheInt.encrypt(ctx, sv, bits)
    t = time.perf_counter()
    exp_abs = np.abs(sv)
    exp_abs[sv == -(1 << (bits - 1))] = -(1 << (bits - 1))
    check("abs(s)", s.abs_(), exp_abs, t)
    print("# all integer ops decode correctly")


if __name__ == "__main__":
    main()
