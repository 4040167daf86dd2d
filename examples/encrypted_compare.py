"""Encrypted integer comparison: a batch of (a, b) pairs is compared
entirely under encryption with the n-bit comparator standard cell
(lt / eq / gt outputs), plus an encrypted a - b via the ripple-borrow
subtractor — all through the level-fused circuit evaluator.

Usage: python examples/encrypted_compare.py [batch=256] [bits=8] [params]
  params: default | test  (test = small parameters, runs quickly on CPU)
"""

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from rustfhe.apps.circuits import (  # noqa: E402
    comparator,
    evaluate_encrypted,
    evaluate_plain,
    ripple_borrow_subtractor,
)
from rustfhe.context import TFHE  # noqa: E402
from rustfhe.params import DEFAULT_PARAMS, TEST_PARAMS  # noqa: E402

U32 = jnp.uint32


def main():
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    bits = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    params = TEST_PARAMS if (len(sys.argv) > 3 and sys.argv[3] == "test") else DEFAULT_PARAMS

    cmp_c = comparator(bits)
    sub_c = ripple_borrow_subtractor(bits)
    print(f"# comparator: {len(cmp_c.gates)} gates, depth {cmp_c.depth}; "
          f"subtractor: {len(sub_c.gates)} gates, depth {sub_c.depth}")

    t0 = time.perf_counter()
    # engine_name=None: fastest exact engine for the device
    ctx = TFHE.new(jax.random.PRNGKey(7), params, None)
    print(f"# keygen: {time.perf_counter() - t0:.1f}s  "
          f"(n={params.n}, N={params.N}, engine {ctx.engine_name})")

    rs = np.random.RandomState(3)
    a = rs.randint(0, 1 << bits, size=batch)
    b = rs.randint(0, 1 << bits, size=batch)
    bits_in = np.zeros((batch, 2 * bits), np.uint32)
    for i in range(bits):
        bits_in[:, i] = (a >> i) & 1
        bits_in[:, bits + i] = (b >> i) & 1

    cts = ctx.encrypt(jnp.asarray(bits_in))

    t0 = time.perf_counter()
    out_cmp = evaluate_encrypted(cmp_c, ctx, cts)
    lt, eq, gt = (np.asarray(ctx.decrypt(out_cmp))[:, k] for k in range(3))
    dt = time.perf_counter() - t0
    assert np.array_equal(lt, (a < b).astype(np.uint32))
    assert np.array_equal(eq, (a == b).astype(np.uint32))
    assert np.array_equal(gt, (a > b).astype(np.uint32))
    total = len(cmp_c.gates) * batch
    print(f"# comparator: {batch} encrypted comparisons correct in {dt:.1f}s "
          f"({total / dt:,.0f} gate-evals/s)")

    t0 = time.perf_counter()
    out_sub = evaluate_encrypted(sub_c, ctx, cts)
    dec = np.asarray(ctx.decrypt(out_sub))
    dt = time.perf_counter() - t0
    diff = sum(dec[:, i].astype(np.int64) << i for i in range(bits))
    assert np.array_equal(diff, (a - b) % (1 << bits))
    assert np.array_equal(dec[:, bits], (a < b).astype(np.uint32))
    print(f"# subtractor: {batch} encrypted subtractions correct in {dt:.1f}s")
    # cross-check the plain evaluator too
    assert np.array_equal(np.asarray(evaluate_plain(cmp_c, bits_in))[:, 0], lt)
    print("ok")


if __name__ == "__main__":
    main()
