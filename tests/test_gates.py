"""End-to-end bootstrapped gate tests: full truth tables through real
bootstrapping (mirrors reference ``hom_nand/src/tfhe.rs:147-279``), batched."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rustfhe import gates, keys, tlwe
from rustfhe.params import TEST_PARAMS

U32 = jnp.uint32

TRUTH = {
    "nand": [1, 1, 1, 0],
    "and": [0, 0, 0, 1],
    "or": [0, 1, 1, 1],
    "xor": [0, 1, 1, 0],
}


@pytest.fixture(scope="module")
def setup():
    p = TEST_PARAMS
    key = jax.random.PRNGKey(7)
    kg, ke = jax.random.split(key)
    sk, ck = keys.gen_keys(kg, p, engine_name="matmul")
    return p, sk, ck, ke


def _encrypt_pairs(p, sk, ke):
    # all four input combinations (x, y) = (0,0), (1,0), (0,1), (1,1)
    xs = jnp.array([0, 1, 0, 1], U32)
    ys = jnp.array([0, 0, 1, 1], U32)
    k1, k2 = jax.random.split(ke)
    cx = tlwe.encrypt_binary(k1, sk.lv0, xs, p)
    cy = tlwe.encrypt_binary(k2, sk.lv0, ys, p)
    return cx, cy


@pytest.mark.parametrize("gate", ["nand", "and", "or", "xor"])
def test_truth_table(setup, gate):
    p, sk, ck, ke = setup
    cx, cy = _encrypt_pairs(p, sk, jax.random.fold_in(ke, hash(gate) % 1000))
    out = gates.GATES_2IN[gate](ck, cx, cy, params=p, engine_name="matmul")
    dec = list(np.asarray(tlwe.decrypt_binary(out, sk.lv0)))
    assert dec == TRUTH[gate], f"{gate}: got {dec}"


def test_not(setup):
    p, sk, ck, ke = setup
    bits = jnp.array([0, 1], U32)
    ct = tlwe.encrypt_binary(jax.random.fold_in(ke, 5), sk.lv0, bits, p)
    out = gates.hom_not(ck, ct, params=p, engine_name="matmul")
    dec = list(np.asarray(tlwe.decrypt_binary(out, sk.lv0)))
    assert dec == [1, 0]


def test_mux(setup):
    p, sk, ck, ke = setup
    # (control, in0, in1) -> in1 if control else in0; all 8 combos.
    combos = [(c, a, b) for c in (0, 1) for a in (0, 1) for b in (0, 1)]
    cs = jnp.array([c for c, _, _ in combos], U32)
    a0 = jnp.array([a for _, a, _ in combos], U32)
    a1 = jnp.array([b for _, _, b in combos], U32)
    k1, k2, k3 = jax.random.split(jax.random.fold_in(ke, 9), 3)
    cc = tlwe.encrypt_binary(k1, sk.lv0, cs, p)
    c0 = tlwe.encrypt_binary(k2, sk.lv0, a0, p)
    c1 = tlwe.encrypt_binary(k3, sk.lv0, a1, p)
    out = gates.hom_mux(ck, cc, c0, c1, params=p, engine_name="matmul")
    dec = list(np.asarray(tlwe.decrypt_binary(out, sk.lv0)))
    expect = [b if c else a for c, a, b in combos]
    assert dec == expect


def test_gate_on_trivial_inputs(setup):
    # The nander REPL encrypts constants as trivial ciphertexts
    # (tlwe.rs:80-87); gates must bootstrap them correctly too.
    p, sk, ck, _ = setup
    from rustfhe import torus

    cx = tlwe.trivial(torus.binary_to_torus(jnp.array([0, 1, 0, 1], U32)), p.n)
    cy = tlwe.trivial(torus.binary_to_torus(jnp.array([0, 0, 1, 1], U32)), p.n)
    out = gates.hom_nand(ck, cx, cy, params=p, engine_name="matmul")
    dec = list(np.asarray(tlwe.decrypt_binary(out, sk.lv0)))
    assert dec == TRUTH["nand"]


def test_oracle_engine_gate():
    # Small single-gate check with the oracle engine end to end.
    p = TEST_PARAMS
    key = jax.random.PRNGKey(11)
    kg, ke = jax.random.split(key)
    sk, ck = keys.gen_keys(kg, p, engine_name="oracle")
    cx, cy = _encrypt_pairs(p, sk, ke)
    out = gates.hom_nand(ck, cx, cy, params=p, engine_name="oracle")
    dec = list(np.asarray(tlwe.decrypt_binary(out, sk.lv0)))
    assert dec == TRUTH["nand"]
