"""Measured A/B of the circuit optimizer (CSE + DCE + NOT folding) on the
level-fused evaluator: FheUint compares and the legacy comparator cell.

Runs on CPU (the bucketed evaluator path, where lane counts translate
directly to bootstrap work; the interactive path pads levels to
``ctx.circuit_fixed_width``, so its win there is the removed NOT LEVELS,
not lanes).  The "off" arm monkeypatches ``circuits.optimize`` to the
identity and routes ``lower_folded`` through plain ``lower`` so the
evaluator runs the pre-round-5 lowering.

Usage: python benches/optimizer_probe.py  (CPU, ~2-4 min)
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from rustfhe.apps import circuits as C  # noqa: E402
from rustfhe.context import TFHE  # noqa: E402
from rustfhe.params import TEST_PARAMS  # noqa: E402


def lower_unfolded(circuit):
    """Pre-round-5 lowering shim: plain ``lower`` dressed in the
    ``lower_folded`` return contract (NOT gates stay bootstrap lanes)."""
    from rustfhe.gates import PRE_COEFFS

    ops, in_a, in_b, out_w, n_wires = C.lower(circuit)
    coeff = (np.array([PRE_COEFFS[o] for o in ops], np.int64).reshape(-1, 3)
             if len(ops) else np.zeros((0, 3), np.int64))
    return (coeff, in_a, in_b, out_w, n_wires,
            np.array(circuit.outputs, np.int64),
            np.zeros(len(circuit.outputs), bool))


def timed(fn, reps=3):
    fn()  # warm (compiles)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    ctx = TFHE.new(jax.random.PRNGKey(5), TEST_PARAMS, "matmul")
    rs = np.random.RandomState(0)

    cases = [
        ("prefix_comparator(16)", C.prefix_comparator(16)),
        ("comparator(8) [NOT-heavy legacy cell]", C.comparator(8)),
    ]

    B = 64  # leading batch: bootstrap lanes dominate per-level dispatch
    for name, circ in cases:
        bits = rs.randint(0, 2, size=(B, circ.n_inputs)).astype(np.uint32)
        cts = ctx.encrypt(jnp.asarray(bits))
        want = C.evaluate_plain(circ, bits)

        def run():
            out = C.evaluate_encrypted(circ, ctx, cts)
            got = np.asarray(ctx.decrypt(out))
            assert np.array_equal(got, want), (name, got, want)

        t_on = timed(run)

        # A/B: disable the pass (identity optimize + unfolded lowering).
        orig_opt, orig_lf = C.optimize, C.lower_folded
        C.optimize, C.lower_folded = (lambda c: c), lower_unfolded
        try:
            t_off = timed(run)
        finally:
            C.optimize, C.lower_folded = orig_opt, orig_lf

        o = orig_opt(circ)
        print(f"{name}: gates {len(circ.gates)} -> {len(o.gates)} "
              f"(+NOT folding at lowering); "
              f"wall {t_off*1e3:.0f} -> {t_on*1e3:.0f} ms "
              f"({t_off/t_on:.2f}x), outputs correct both arms")


if __name__ == "__main__":
    main()
