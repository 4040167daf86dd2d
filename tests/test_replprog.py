"""Fused REPL evaluator (apps/replprog.py): plan lowering + one-dispatch-
per-level evaluation must agree with the plain evaluator on every
expression shape (leaf-only, single gate, NOT chains, nested levels)."""

import jax
import numpy as np
import pytest

from rustfhe.apps import nander
from rustfhe.apps.replprog import FusedEvaluator, expr_to_circuit
from rustfhe.apps.circuits import evaluate_plain
from rustfhe.context import TFHE
from rustfhe.params import TEST_PARAMS

EXPRS = [
    "1", "0", "!1", "!!0",
    "1 $ 0", "0 $ 0", "1 & 1", "1 | 0", "1 ^ 1",
    "(1 & 0) ^ !0",
    "1 & 1 & 0 | 1",
    "((1|0)&(1^1))$(0|1)",
    "!(1 & (0 | !1)) ^ (1 $ (0 ^ 1))",
]


@pytest.fixture(scope="module")
def ctx():
    return TFHE.new(jax.random.PRNGKey(3), TEST_PARAMS, "matmul")


def test_expr_to_circuit_matches_plain():
    plain = nander.PlainLogic()
    for e in EXPRS:
        ast = nander.parse_logic_expr(e)
        circ, leaves = expr_to_circuit(ast)
        want = nander.eval_logic_expr(plain, ast)
        if circ.gates:
            got = int(evaluate_plain(circ, np.array(leaves))[..., 0])
        else:
            got = leaves[0] if leaves else 0
        assert got == want, e


def test_fused_eval_matches_plain(ctx):
    ev = FusedEvaluator(ctx)
    plain = nander.PlainLogic()
    for e in EXPRS:
        ast = nander.parse_logic_expr(e)
        assert ev.fits(ast), e
        assert ev.eval_bit(ast) == nander.eval_logic_expr(plain, ast), e


def test_capacity_fallback(ctx):
    # A level wider than the lane cap must be reported as not fitting.
    # The level-1 gates must be DISTINCT: identical subexpressions now
    # collapse to one lane (circuits.optimize CSE + leaf dedup).
    ev = FusedEvaluator(ctx, width=2, max_wires=16)
    wide = "(1 & 0) ^ (0 | 1) ^ (1 & 1) ^ (0 | 0)"  # 4 distinct level-1 gates
    ast = nander.parse_logic_expr(wide)
    assert not ev.fits(ast)
    with pytest.raises(ValueError, match="static capacities"):
        ev.eval_bit(ast)


def test_console_uses_fused_path(ctx):
    import io

    out = io.StringIO()
    nander.nander_console(params=TEST_PARAMS, engine_name="matmul", width=8,
                          max_wires=64, stdin=io.StringIO("(1 & 0) ^ !0\n1 $ 1\n"),
                          stdout=out)
    text = out.getvalue()
    assert "res: 1" in text and "res: 0" in text


def test_eval_bits_pipelined_matches_plain(ctx):
    """K expressions in one fused session (eval_bits): results must match
    the plain evaluator expression-by-expression."""
    fused = FusedEvaluator(ctx)
    plain = nander.PlainLogic()
    batches = [
        ["1 $ 0", "1 & 1", "0 | 0", "1 ^ 0"],          # K single gates
        ["1", "!0", "(1 & 0) ^ !0"],                   # mixed depths + leaf
        ["1 & 1 & 0 | 1", "((1|0)&(1^1))$(0|1)"],      # deeper pair
        ["0", "1"],                                     # all leaf-only
    ]
    for batch in batches:
        asts = [nander.parse_logic_expr(e) for e in batch]
        want = [nander.eval_logic_expr(plain, a) for a in asts]
        assert fused.fits_many(asts), batch
        got = fused.eval_bits(asts)
        assert got == want, batch


def test_eval_bits_capacity(ctx):
    fused = FusedEvaluator(ctx, width=4)
    asts = [nander.parse_logic_expr("1 $ 0")] * 5  # K > width
    assert not fused.fits_many(asts)
    with pytest.raises(ValueError, match="capacities"):
        fused.eval_bits(asts)


def test_console_pipelined_line(ctx):
    """A ';'-separated console line answers K results with one time line."""
    import io

    from rustfhe.apps.nander import nander_console

    out = io.StringIO()
    nander_console(params=TEST_PARAMS, engine_name="matmul", width=8,
                   max_wires=64, stdin=io.StringIO("1 $ 0; 1 & 1; (1 & 0) ^ !0\n"),
                   stdout=out)
    text = out.getvalue()
    assert "res: 1 1 1" in text, text
    assert "us/expr" in text, text


def test_console_pipelined_chunking(ctx):
    """A ';'-line with MORE expressions than the wire file's lane width
    evaluates in greedy fused chunks (round-5 console chunking)."""
    import io

    from rustfhe.apps.nander import nander_console

    # 10 single-gate expressions > the lane width of 8 passed here.
    exprs = ["1 $ 0", "1 & 1", "0 | 0", "1 ^ 0", "0 $ 0",
             "1 & 0", "1 | 0", "1 ^ 1", "!0", "!1"]
    want = "1 1 0 1 1 0 1 0 1 0"
    out = io.StringIO()
    nander_console(params=TEST_PARAMS, engine_name="matmul", width=8, max_wires=64,
                   stdin=io.StringIO("; ".join(exprs) + "\n"), stdout=out)
    text = out.getvalue()
    assert f"res: {want}" in text, text
