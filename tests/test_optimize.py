"""Circuit optimizer (CSE + dead-gate elimination): exactness on every
shipped circuit builder, measured gate reductions, and the fused-REPL
cross-expression sharing it enables.

The reference has no circuit layer at all (one gate at a time,
``nander/src/lib.rs:72-89``); the optimizer is part of this framework's
circuit compiler, where every gate costs one bootstrap lane per batch
element, so duplicate/dead gates are pure wasted bootstrap work.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rustfhe.apps.circuits import (
    Circuit,
    array_multiplier,
    comparator,
    evaluate_encrypted,
    evaluate_plain,
    kogge_stone_adder,
    optimize,
    prefix_comparator,
    ripple_borrow_subtractor,
    ripple_carry_adder,
    wallace_multiplier,
)
from rustfhe.context import TFHE
from rustfhe.params import TEST_PARAMS

BUILDERS = [
    ("kogge_stone_adder", lambda: kogge_stone_adder(8)),
    ("kogge_stone_adder+1", lambda: kogge_stone_adder(8, incoming_one=True)),
    ("ripple_carry_adder", lambda: ripple_carry_adder(8)),
    ("ripple_borrow_subtractor", lambda: ripple_borrow_subtractor(8)),
    ("comparator", lambda: comparator(8)),
    ("prefix_comparator", lambda: prefix_comparator(8)),
    ("wallace_multiplier", lambda: wallace_multiplier(6)),
    ("array_multiplier", lambda: array_multiplier(6)),
]


@pytest.mark.parametrize("name,build", BUILDERS, ids=[n for n, _ in BUILDERS])
def test_optimize_exact_and_no_deeper(name, build):
    c = build()
    o = optimize(c)
    rs = np.random.RandomState(7)
    x = rs.randint(0, 2, size=(256, c.n_inputs))
    assert np.array_equal(evaluate_plain(c, x), evaluate_plain(o, x))
    assert o.n_inputs == c.n_inputs
    assert len(o.outputs) == len(c.outputs)
    assert len(o.gates) <= len(c.gates)
    assert o.depth <= c.depth
    # Idempotent: a second pass finds nothing.
    oo = optimize(o)
    assert len(oo.gates) == len(o.gates)


def test_optimize_measured_reductions():
    """Pin the headline reductions (a regression here means the pass — or a
    builder — silently lost its effect)."""
    assert len(optimize(prefix_comparator(8)).gates) <= 37  # was 67: -45%
    assert len(optimize(comparator(8)).gates) <= 55  # was 62
    assert len(optimize(wallace_multiplier(8)).gates) <= 425  # was 436
    # Already-minimal circuits are untouched.
    assert len(optimize(ripple_carry_adder(8)).gates) == 37
    assert len(optimize(kogge_stone_adder(8)).gates) == 67


def test_optimize_merges_mux_and_commutative():
    c = Circuit(n_inputs=3)
    m1 = c.mux(0, 1, 2)
    m2 = c.mux(0, 1, 2)  # duplicate mux
    a1 = c.and_(0, 1)
    a2 = c.and_(1, 0)  # commutative duplicate
    dead = c.xor(m1, a1)  # feeds nothing
    c.outputs = [c.or_(m2, a2)]
    o = optimize(c)
    assert len(o.gates) == 3  # mux + and + or
    rs = np.random.RandomState(3)
    x = rs.randint(0, 2, size=(64, 3))
    assert np.array_equal(evaluate_plain(c, x), evaluate_plain(o, x))
    del dead


def test_optimize_output_can_be_input_wire():
    c = Circuit(n_inputs=2)
    g = c.and_(0, 1)
    c.outputs = [1, g, 1]  # raw input wire appears in outputs
    o = optimize(c)
    x = np.array([[0, 1], [1, 1], [1, 0]])
    assert np.array_equal(evaluate_plain(c, x), evaluate_plain(o, x))


@pytest.fixture(scope="module")
def ctx():
    return TFHE.new(jax.random.PRNGKey(41), TEST_PARAMS, "matmul")


def test_encrypted_equivalence_through_evaluator(ctx):
    """evaluate_encrypted runs the optimizer internally; pin agreement with
    the UNoptimized circuit evaluated gate-by-gate in plaintext."""
    c = prefix_comparator(4)
    rs = np.random.RandomState(11)
    for _ in range(3):
        a, b = rs.randint(0, 16), rs.randint(0, 16)
        bits = np.array(
            [(a >> i) & 1 for i in range(4)]
            + [((~b) >> i) & 1 for i in range(4)],
            dtype=np.uint32,
        )
        cts = ctx.encrypt(jnp.asarray(bits))
        dec = np.asarray(ctx.decrypt(evaluate_encrypted(c, ctx, cts)))
        want = evaluate_plain(c, bits)
        assert np.array_equal(dec, want), (a, b, dec, want)


def test_repl_cross_expression_sharing(ctx):
    """K pipelined expressions sharing a subexpression merge lanes: the
    shared (1&0) computes once across the session (leaf dedup by value +
    CSE), and the decrypted bits are right."""
    from rustfhe.apps.nander import parse_logic_expr as parse
    from rustfhe.apps.replprog import FusedEvaluator, exprs_to_circuit
    from rustfhe.apps.circuits import optimize as opt

    exprs = [parse(s) for s in ["1&0", "(1&0)|1", "!(1&0)", "1&1"]]
    circ, _leaves = exprs_to_circuit(exprs)
    o = opt(circ)
    # 4 expressions contain (1&0) three times -> one lane after CSE:
    # gates = and(1,0), or(., 1), nand(., .) [lowered not], and(1,1).
    assert len(o.gates) <= 4 < len(circ.gates) + 2
    ev = FusedEvaluator(ctx, width=8, max_wires=32)
    bits = ev.eval_bits(exprs)
    assert bits == [0, 1, 1, 1]


def test_repl_single_expr_still_exact(ctx):
    from rustfhe.apps.nander import parse_logic_expr as parse
    from rustfhe.apps.replprog import FusedEvaluator

    ev = FusedEvaluator(ctx, width=8, max_wires=32)
    for s, want in [
        ("1", 1), ("0", 0), ("!1", 0),
        ("1&(0|1)", 1), ("(1&1)^(1|0)", 0),
        ("((1&1)&(1&1))|(0^0)", 1),  # duplicated subtrees collapse
    ]:
        assert ev.eval_bit(parse(s)) == want, s


# ---------------- NOT folding (lower_folded) ---------------- #

def _folded_levels(c):
    from rustfhe.apps.circuits import lower_folded, optimize as opt

    coeff, ia, ib, ow, nw, osrc, oneg = lower_folded(opt(c))
    lv = {w: 0 for w in range(c.n_inputs)}
    depth = 0
    for g in range(len(ow)):
        l = 1 + max(lv.get(ia[g], 0), lv.get(ib[g], 0))
        lv[ow[g]] = l
        depth = max(depth, l)
    return depth, len(ow)


def test_not_folding_removes_levels_and_lanes():
    """NOT is a free ciphertext negation: folded programs drop every not
    gate AND the levels it occupied."""
    d, g = _folded_levels(comparator(8))
    assert g == 38 and d == 16  # 55 gates/18 levels unfolded
    d, g = _folded_levels(ripple_borrow_subtractor(8))
    assert g == 37 and d == 15  # 52 gates/16 levels unfolded
    # NOT-free circuits are untouched.
    d, g = _folded_levels(kogge_stone_adder(8))
    assert g == 67 and d == 7


def test_not_chain_emits_zero_gates():
    from rustfhe.apps.circuits import lower_folded

    c = Circuit(n_inputs=1)
    w = 0
    for _ in range(5):
        w = c.not_(w)
    c.outputs = [w, c.not_(w)]
    coeff, ia, ib, ow, nw, osrc, oneg = lower_folded(c)
    assert len(ow) == 0
    assert list(osrc) == [0, 0] and list(oneg) == [True, False]


def test_encrypted_not_heavy_circuits(ctx):
    """Folded evaluation stays exact on NOT-heavy circuits, including
    negated outputs."""
    for build in (lambda: comparator(6), lambda: ripple_borrow_subtractor(6)):
        c = build()
        # Also expose a negated output directly.
        c.outputs = c.outputs + [c.not_(c.outputs[0])]
        rs = np.random.RandomState(5)
        for _ in range(2):
            bits = rs.randint(0, 2, size=c.n_inputs).astype(np.uint32)
            cts = ctx.encrypt(jnp.asarray(bits))
            dec = np.asarray(ctx.decrypt(evaluate_encrypted(c, ctx, cts)))
            assert np.array_equal(dec, evaluate_plain(c, bits))


def test_repl_not_expressions(ctx):
    """Console NOTs are free: pure-NOT expressions never touch the device,
    and negated roots flip host-side."""
    from rustfhe.apps.nander import parse_logic_expr as parse
    from rustfhe.apps.replprog import FusedEvaluator

    ev = FusedEvaluator(ctx, width=8, max_wires=32)
    for s, want in [("!1", 0), ("!!1", 1), ("!!!0", 1),
                    ("!(1&1)", 0), ("!(1&0)&!(0|0)", 1)]:
        ast = parse(s)
        assert ev.fits(ast), s
        assert ev.eval_bit(ast) == want, s
    # Pure-NOT chains are consts: the plan carries no device levels.
    assert ev._plan(parse("!!!1"))[0] == "const"
    # Pipelined mix with negated + leaf-only + gate roots.
    exprs = [parse(s) for s in ["!1", "!(1&1)", "1|0", "0"]]
    assert ev.eval_bits(exprs) == [0, 0, 1, 0]
