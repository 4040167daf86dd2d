"""nander parser/evaluator tests: grammar golden cases and FHE-vs-plain
agreement on random expressions (reference ``nander/src/lib.rs:64-172``)."""

import random

import jax
import numpy as np
import pytest

from rustfhe.apps import nander
from rustfhe.apps.nander import (
    FheLogic,
    ParseError,
    PlainLogic,
    eval_logic_expr,
    parse_logic_expr,
)


def peval(s: str) -> int:
    return eval_logic_expr(PlainLogic(), parse_logic_expr(s))


def test_literals_and_ops():
    assert peval("0") == 0
    assert peval("1") == 1
    assert peval("!0") == 1
    assert peval("!1") == 0
    assert peval("1&1") == 1
    assert peval("1&0") == 0
    assert peval("0|1") == 1
    assert peval("0|0") == 0
    assert peval("1^1") == 0
    assert peval("1^0") == 1
    assert peval("1$1") == 0
    assert peval("1$0") == 1


def test_left_associative_chain():
    # ((1 ^ 1) ^ 1) = 1, not 1 ^ (1 ^ 1)
    assert peval("1^1^1") == 1
    assert peval("1&1&0") == 0
    assert peval("0|0|1") == 1


def test_parens_and_not_binding():
    assert peval("!(1&1)") == 0
    assert peval("!1&1") == 0  # NOT binds tighter than &
    assert peval("(1&0)^!0") == 1
    assert peval("!!1") == 1


def test_whitespace_ignored():
    assert peval(" ( 1 & 0 ) ^ !0 ") == 1


def test_parse_errors():
    for bad in ["", "(1", "2", "1&", "&1", "1)", "()"]:
        with pytest.raises(ParseError):
            parse_logic_expr(bad)


def _random_expr(rng, depth):
    if depth == 0 or rng.random() < 0.25:
        return str(rng.randint(0, 1))
    op = rng.choice(["&", "|", "^", "$"])
    if rng.random() < 0.25:
        return f"!({_random_expr(rng, depth - 1)})"
    return f"({_random_expr(rng, depth - 1)}){op}({_random_expr(rng, depth - 1)})"


def test_nand_only_defaults():
    # A NAND-only Logip must get AND/OR/XOR/NOT via the default compositions
    # (lib.rs:25-37).
    class NandOnly(nander.Logip):
        def nand(self, l, r):
            return 1 - (l & r)

        def logic_true(self):
            return 1

        def logic_false(self):
            return 0

    p = NandOnly()
    assert p.and_(1, 1) == 1 and p.and_(1, 0) == 0
    assert p.or_(0, 0) == 0 and p.or_(0, 1) == 1
    assert p.xor(1, 1) == 0 and p.xor(0, 1) == 1
    assert p.not_(0) == 1


def test_fhe_matches_plain():
    from rustfhe.context import TFHE
    from rustfhe.params import TEST_PARAMS

    ctx = TFHE.new(jax.random.PRNGKey(21), TEST_PARAMS, "matmul")
    fhe = FheLogic(ctx)
    plain = PlainLogic()
    rng = random.Random(5)
    exprs = [_random_expr(rng, 3) for _ in range(5)] + ["(1&0)^!0", "1$0$1"]
    for s in exprs:
        expr = parse_logic_expr(s)
        want = eval_logic_expr(plain, expr)
        ct = eval_logic_expr(fhe, expr)
        got = int(np.asarray(ctx.decrypt(ct)))
        assert got == want, f"{s}: fhe={got} plain={want}"


def test_python_dash_m_console_fused_path():
    """Regression (round 5): ``python -m rustfhe.apps.nander`` runs the
    module as __main__ — a SECOND copy of the AST classes — and the fused
    evaluator's pattern matching against the canonical import then raised
    "not an expression" on every gate expression.  The __main__ stub must
    delegate to the canonical module.  Leaf-only and pipelined-leaf lines
    keep this subprocess test bootstrap-free (const fast path)."""
    import subprocess
    import sys

    r = subprocess.run(
        [sys.executable, "-m", "rustfhe.apps.nander"],
        input="0\n1; 0; 1\n",
        capture_output=True, text=True, timeout=300,
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"},
    )
    assert "res: 0" in r.stdout, (r.stdout, r.stderr[-2000:])
    assert "res: 1 0 1" in r.stdout, (r.stdout, r.stderr[-2000:])
    assert "not an expression" not in r.stderr
