"""Multi-device tests on the 8-virtual-CPU-device mesh: sharded evaluation
must agree exactly with the single-device path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rustfhe import gates, keys, tlwe
from rustfhe.parallel import make_mesh, shard_cloud_key, sharded_gate_fn
from rustfhe.params import TEST_PARAMS

U32 = jnp.uint32


@pytest.fixture(scope="module")
def setup():
    p = TEST_PARAMS
    key = jax.random.PRNGKey(3)
    kg, ke = jax.random.split(key)
    sk, ck = keys.gen_keys(kg, p, engine_name="matmul")
    B = 16
    bits_x = jax.random.bernoulli(jax.random.fold_in(ke, 0), 0.5, (B,)).astype(U32)
    bits_y = jax.random.bernoulli(jax.random.fold_in(ke, 1), 0.5, (B,)).astype(U32)
    cx = tlwe.encrypt_binary(jax.random.fold_in(ke, 2), sk.lv0, bits_x, p)
    cy = tlwe.encrypt_binary(jax.random.fold_in(ke, 3), sk.lv0, bits_y, p)
    ref = gates.hom_nand(ck, cx, cy, params=p, engine_name="matmul")
    return p, sk, ck, cx, cy, ref, bits_x, bits_y


def test_device_count():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("data,model", [(8, 1), (4, 2), (2, 4)])
def test_sharded_matches_single_device(setup, data, model):
    p, sk, ck, cx, cy, ref, bx, by = setup
    mesh = make_mesh(data=data, model=model)
    fn = sharded_gate_fn(mesh, p, "matmul")
    ck_sh = shard_cloud_key(ck, mesh)
    out = fn(ck_sh.bk, ck_sh.ksk, cx, cy)
    # Bit-exact agreement with the unsharded result: the whole pipeline is
    # integer arithmetic, so sharding must not change a single bit.
    assert np.array_equal(np.asarray(out), np.asarray(ref))
    dec = np.asarray(tlwe.decrypt_binary(out, sk.lv0))
    expect = 1 - (np.asarray(bx) & np.asarray(by))
    assert np.array_equal(dec, expect)


@pytest.mark.parametrize("kind", ["and", "or", "xor"])
def test_sharded_two_input_gates_bit_exact(setup, kind):
    p, sk, ck, cx, cy, ref, bx, by = setup
    mesh = make_mesh(data=4, model=2)
    ck_sh = shard_cloud_key(ck, mesh)
    fn = sharded_gate_fn(mesh, p, "matmul", kind=kind)
    out = fn(ck_sh.bk, ck_sh.ksk, cx, cy)
    single = gates.GATES_2IN[kind](ck, cx, cy, params=p, engine_name="matmul")
    assert np.array_equal(np.asarray(out), np.asarray(single))
    dec = np.asarray(tlwe.decrypt_binary(out, sk.lv0))
    x, y = np.asarray(bx), np.asarray(by)
    expect = {"and": x & y, "or": x | y, "xor": x ^ y}[kind]
    assert np.array_equal(dec, expect)


def test_sharded_not_and_mux_bit_exact(setup):
    p, sk, ck, cx, cy, ref, bx, by = setup
    mesh = make_mesh(data=4, model=2)
    ck_sh = shard_cloud_key(ck, mesh)

    fn_not = sharded_gate_fn(mesh, p, "matmul", kind="not")
    out = fn_not(ck_sh.bk, ck_sh.ksk, cx)
    single = gates.hom_not(ck, cx, params=p, engine_name="matmul")
    assert np.array_equal(np.asarray(out), np.asarray(single))
    assert np.array_equal(
        np.asarray(tlwe.decrypt_binary(out, sk.lv0)), 1 - np.asarray(bx)
    )

    fn_mux = sharded_gate_fn(mesh, p, "matmul", kind="mux")
    ctrl = cx
    out = fn_mux(ck_sh.bk, ck_sh.ksk, ctrl, cy, cx)  # control ? cx : cy
    single = gates.hom_mux(ck, ctrl, cy, cx, params=p, engine_name="matmul")
    assert np.array_equal(np.asarray(out), np.asarray(single))
    x, y = np.asarray(bx), np.asarray(by)
    expect = np.where(x == 1, x, y)
    assert np.array_equal(np.asarray(tlwe.decrypt_binary(out, sk.lv0)), expect)


def test_tp_blind_rotate_bit_exact(setup):
    # BK gadget rows tensor-parallel over model: per-step psum inside the
    # scan must agree bit-for-bit with the replicated-BK path.
    from rustfhe.parallel import shard_cloud_key_tp, tp_gate_fn

    p, sk, ck, cx, cy, ref, bx, by = setup
    mesh = make_mesh(data=4, model=2)
    ck_tp = shard_cloud_key_tp(ck, mesh)
    fn = tp_gate_fn(mesh, p, kind="nand")
    out = fn(ck_tp.bk, ck_tp.ksk, cx, cy)
    assert np.array_equal(np.asarray(out), np.asarray(ref))


def test_multihost_gate_session(setup):
    # GateSession exercises the production multi-host code paths
    # (global mesh over all devices, make_array_from_process_local_data,
    # addressable-shard fetch) in its single-process degenerate form.
    from rustfhe.parallel.multihost import GateSession, global_gate_batch_size

    p, sk, ck, cx, cy, ref, bx, by = setup
    kg, _ = jax.random.split(jax.random.PRNGKey(3))  # the fixture's keygen seed
    sess = GateSession(kg, p, "matmul", model=2)
    assert global_gate_batch_size(2) == 16
    gx = sess.feed(np.asarray(cx))
    gy = sess.feed(np.asarray(cy))
    out = sess.nand(gx, gy)
    # Same seed as the fixture -> identical deterministic keys -> the
    # sharded result must match the fixture's single-device reference.
    assert np.array_equal(sess.fetch(out), np.asarray(ref))
    dec = sess.decrypt_local(out)
    assert np.array_equal(dec, 1 - (np.asarray(bx) & np.asarray(by)))
    # xor through the session too (covers the fn table).
    dec2 = sess.decrypt_local(sess.xor(gx, gy))
    assert np.array_equal(dec2, np.asarray(bx) ^ np.asarray(by))


def test_sharded_circuit_evaluator(setup):
    # The level-fused circuit evaluator runs mesh-sharded through
    # GateSession.bootstrap_raw: an adder batch sharded over `data`,
    # bit-exact vs plaintext evaluation.
    from rustfhe.apps.circuits import (
        evaluate_encrypted,
        evaluate_plain,
        ripple_carry_adder,
    )
    from rustfhe.parallel.multihost import GateSession

    p = setup[0]
    kg, _ = jax.random.split(jax.random.PRNGKey(3))
    sess = GateSession(kg, p, "matmul", model=2)
    circuit = ripple_carry_adder(2)
    rs = np.random.RandomState(4)
    pairs = rs.randint(0, 4, size=(16, 2))
    bits = np.array(
        [[(a >> i) & 1 for i in range(2)] + [(b >> i) & 1 for i in range(2)]
         for a, b in pairs],
        dtype=np.uint32,
    )  # (16, 4)
    cts = tlwe.encrypt_binary(
        jax.random.PRNGKey(77), sess.sk.lv0, jnp.asarray(bits), p
    )  # (16, 4, n+1)
    from jax.sharding import NamedSharding, PartitionSpec as P

    cts = jax.device_put(cts, NamedSharding(sess.mesh, P("data")))
    out = evaluate_encrypted(circuit, sess, cts)  # (16, 3, n+1)
    dec = np.asarray(tlwe.decrypt_binary(out, sess.sk.lv0))
    assert np.array_equal(dec, evaluate_plain(circuit, bits))


def test_all_to_all_key_switch_bit_exact(setup):
    # One-hot built batch-sharded, transpose-exchanged (all_to_all) to KSK
    # row shards: must agree bit-for-bit with the psum-only variant.
    p, sk, ck, cx, cy, ref, bx, by = setup
    mesh = make_mesh(data=4, model=2)
    from jax.sharding import NamedSharding, PartitionSpec as P
    from rustfhe.keys import CloudKey

    bk = jax.device_put(ck.bk, NamedSharding(mesh, P()))
    ksk = jax.device_put(ck.ksk, NamedSharding(mesh, P("data")))
    fn = sharded_gate_fn(mesh, p, "matmul", kind="nand", key_switch="all_to_all")
    out = fn(bk, ksk, cx, cy)
    assert np.array_equal(np.asarray(out), np.asarray(ref))


def test_fetch_nonlead_batch_axis_and_unbatched_bootstrap(setup):
    # GateSession.fetch on a bootstrap_raw output with a LEADING gate-lane
    # axis (lanes, B, n+1): the data-sharded axis is -2, not 0 — fetch must
    # concatenate along the detected sharded axis instead of collapsing to
    # one shard's rows.  Also: a single unbatched (n+1,) pre must take the
    # replicated fallback (regression for the ndim<2 IndexError).
    from rustfhe import gates
    from rustfhe.parallel.multihost import GateSession

    p = setup[0]
    sk = setup[1]
    cx, cy = setup[3], setup[4]
    kg, _ = jax.random.split(jax.random.PRNGKey(3))
    sess = GateSession(kg, p, "matmul", model=2)
    pre_a = gates.precombine("nand", cx, cy, params=p)
    pre_b = gates.precombine("and", cx, cy, params=p)
    pre = jnp.stack([pre_a, pre_b])  # (2, 16, n+1): lanes lead, batch at -2
    out = sess.bootstrap_raw(pre)
    fetched = sess.fetch(out)
    # Single process: the host's local rows are the whole batch.
    assert fetched.shape == out.shape
    assert np.array_equal(fetched, np.asarray(out))
    bx, by = np.asarray(setup[6]), np.asarray(setup[7])
    dec = np.asarray(tlwe.decrypt_binary(jnp.asarray(fetched), sk.lv0))
    assert np.array_equal(dec[0], 1 - (bx & by))
    assert np.array_equal(dec[1], bx & by)

    # ndim=1: single ciphertext, replicated fallback.
    one = sess.bootstrap_raw(pre_a[0])
    assert one.shape == (p.n + 1,)
    dec1 = int(tlwe.decrypt_binary(one[None], sk.lv0)[0])
    assert dec1 == int(1 - (bx[0] & by[0]))


def test_sharded_circuit_unbatched_small_levels(setup):
    # Regression: unbatched evaluation (cts (n_inputs, n+1)) produces 2D
    # pre batches whose gate-lane axis (bucket sizes 1-2) is smaller than
    # the data axis; bootstrap_raw must fall back to replicated compute
    # instead of tripping shard_map's divisibility check.
    from rustfhe.apps.circuits import (
        Circuit,
        evaluate_encrypted,
        evaluate_plain,
    )
    from rustfhe.parallel.multihost import GateSession

    p = setup[0]
    kg, _ = jax.random.split(jax.random.PRNGKey(3))
    sess = GateSession(kg, p, "matmul", model=2)
    c = Circuit(n_inputs=2)
    w = c.xor(0, 1)          # level 1: one gate
    c.outputs = [c.nand(w, 0)]  # level 2: one gate
    bits = np.array([1, 0], np.uint32)
    cts = tlwe.encrypt_binary(jax.random.PRNGKey(5), sess.sk.lv0, jnp.asarray(bits), p)
    out = evaluate_encrypted(c, sess, cts)  # (1, n+1)
    dec = np.asarray(tlwe.decrypt_binary(out, sess.sk.lv0))
    assert np.array_equal(dec, evaluate_plain(c, bits))


def test_sharded_pbs_bit_exact(setup):
    """sharded_pbs_fn (data-sharded multi-output PBS, model-psum key
    switch) agrees BIT-FOR-BIT with the unsharded pbs_many."""
    from rustfhe import pbs
    from rustfhe.parallel import make_mesh, shard_cloud_key, sharded_pbs_fn

    p, sk, ck, *_ = setup
    space, t, B = 2, 2, 16
    rs = np.random.RandomState(9)
    xs = rs.randint(0, space, size=B)
    tables = jnp.asarray(rs.randint(0, space, size=(t, space)), U32)
    ct = pbs.encrypt_int(jax.random.PRNGKey(21), sk.lv0,
                         jnp.asarray(xs), space, p)
    ref = pbs.pbs_many(ck, ct, tables, space=space, params=p,
                       engine_name="matmul")
    mesh = make_mesh(data=4, model=2)
    ck_sh = shard_cloud_key(ck, mesh)
    fn = sharded_pbs_fn(mesh, p, "matmul", space=space)
    out = fn(ck_sh.bk, ck_sh.ksk, ct, tables)
    assert np.array_equal(np.asarray(out), np.asarray(ref))
    dec = np.asarray(pbs.decrypt_int(out, sk.lv0, space))
    for j in range(t):
        np.testing.assert_array_equal(dec[:, j], np.asarray(tables)[j][xs])
