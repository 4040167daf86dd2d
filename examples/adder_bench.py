"""Encrypted 8-bit ripple-carry adder at production parameters — the
depth/circuit benchmark from BASELINE.json (configs 3 and 4): a levelized
multi-gate circuit over encrypted bits, with a batch of additions riding
through every bootstrapped gate.

Usage: python examples/adder_bench.py [batch=256] [bits=8]
"""

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from rustfhe.apps.circuits import evaluate_plain, ripple_carry_adder  # noqa: E402
from rustfhe.apps.circuits import evaluate_encrypted  # noqa: E402
from rustfhe.context import TFHE  # noqa: E402
from rustfhe.params import DEFAULT_PARAMS  # noqa: E402

U32 = jnp.uint32


def main():
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    bits = int(sys.argv[2]) if len(sys.argv) > 2 else 8

    circuit = ripple_carry_adder(bits)
    n_gates = len(circuit.gates)
    print(f"{bits}-bit adder: {n_gates} gates, depth {circuit.depth}", flush=True)

    t0 = time.perf_counter()
    # engine_name=None auto-selects the fastest exact engine.
    ctx = TFHE.new(jax.random.PRNGKey(0), DEFAULT_PARAMS, None)
    print(f"keygen: {time.perf_counter() - t0:.1f}s "
          f"(engine {ctx.engine_name})", flush=True)

    rs = np.random.RandomState(0)
    a = rs.randint(0, 1 << bits, size=batch)
    b = rs.randint(0, 1 << bits, size=batch)
    in_bits = np.zeros((batch, 2 * bits), np.uint32)
    for i in range(bits):
        in_bits[:, i] = (a >> i) & 1
        in_bits[:, bits + i] = (b >> i) & 1

    cts = ctx.encrypt(jnp.asarray(in_bits))  # (batch, 2*bits, n+1)

    t0 = time.perf_counter()
    out = jax.block_until_ready(evaluate_encrypted(circuit, ctx, cts))
    dt = time.perf_counter() - t0
    dec = np.asarray(ctx.decrypt(out))  # (batch, bits+1)

    total = np.zeros(batch, np.int64)
    for i in range(bits + 1):
        total |= dec[:, i].astype(np.int64) << i
    ok = np.array_equal(total, a + b)
    gate_evals = n_gates * batch
    print(
        f"{'OK' if ok else 'FAIL'}: {batch} additions in {dt:.2f}s "
        f"({gate_evals} bootstrapped gate-evals, {gate_evals / dt:,.0f} gates/s, "
        f"incl. compile)",
        flush=True,
    )
    assert ok, "encrypted addition mismatch"


if __name__ == "__main__":
    main()
