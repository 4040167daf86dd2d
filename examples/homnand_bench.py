"""Gate check harness: keygen + truth-table check of all gates with
per-gate timing — the analogue of the reference's ``homnand-bench`` example
(``hom_nand/examples/homnand-bench.rs``), batched: each gate's
whole truth table is one batched call.

Usage: python examples/homnand_bench.py [batch]
"""

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from rustfhe import gates, keys, tlwe  # noqa: E402
from rustfhe.engine import select_fast_engine  # noqa: E402
from rustfhe.params import DEFAULT_PARAMS as P  # noqa: E402

U32 = jnp.uint32

TRUTH = {
    "nand": lambda x, y: 1 - (x & y),
    "and": lambda x, y: x & y,
    "or": lambda x, y: x | y,
    "xor": lambda x, y: x ^ y,
}


def main():
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 1

    # fastest exact engine for the device (engine.select_fast_engine)
    engine_name = select_fast_engine(P)
    print(f"engine: {engine_name}", flush=True)
    print("generating keys...", flush=True)
    t0 = time.perf_counter()
    key = jax.random.PRNGKey(0)
    kg, ke = jax.random.split(key)
    sk, ck = keys.gen_keys(kg, P, engine_name=engine_name)
    jax.block_until_ready(ck)
    print(f"keygen: {time.perf_counter() - t0:.2f}s", flush=True)

    pat = np.tile(np.array([[0, 0], [1, 0], [0, 1], [1, 1]], np.uint32), (reps, 1))
    k1, k2 = jax.random.split(ke)
    cx = tlwe.encrypt_binary(k1, sk.lv0, jnp.asarray(pat[:, 0]), P)
    cy = tlwe.encrypt_binary(k2, sk.lv0, jnp.asarray(pat[:, 1]), P)

    for name, fn in gates.GATES_2IN.items():
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(ck, cx, cy, params=P, engine_name=engine_name))
        dt = time.perf_counter() - t0
        dec = np.asarray(tlwe.decrypt_binary(out, sk.lv0))
        expect = TRUTH[name](pat[:, 0], pat[:, 1])
        ok = np.array_equal(dec, expect)
        print(f"{name:5s} {'OK ' if ok else 'FAIL'} {dt * 1e6:12,.0f} us "
              f"({len(pat)} gates, {len(pat) / dt:,.0f} gates/s)", flush=True)
        assert ok, f"{name} truth table mismatch"

    # NOT
    bits = jnp.asarray(pat[:, 0])
    cn = tlwe.encrypt_binary(jax.random.fold_in(ke, 3), sk.lv0, bits, P)
    t0 = time.perf_counter()
    out = jax.block_until_ready(gates.hom_not(ck, cn, params=P, engine_name=engine_name))
    dt = time.perf_counter() - t0
    dec = np.asarray(tlwe.decrypt_binary(out, sk.lv0))
    ok = np.array_equal(dec, 1 - pat[:, 0])
    print(f"not   {'OK ' if ok else 'FAIL'} {dt * 1e6:12,.0f} us", flush=True)
    assert ok


if __name__ == "__main__":
    main()
