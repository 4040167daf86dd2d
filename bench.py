"""Throughput benchmark: batched bootstrapped HomNAND gates/s on one chip.

Baseline: the reference's single-core HomNAND bootstrap at the same
parameter set — 30,558,481 ns/gate ~= 32.72 gates/s
(``/root/reference/hom_nand/src/tfhe.rs:297``, BASELINE.md).

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "gates/s", "vs_baseline": N/32.72}

Correctness is asserted ON DEVICE at the benched parameter set before any
timing (the analogue of the reference's full truth-table bench,
``hom_nand/src/tfhe.rs:147-279``):
  * all six gates — NAND/AND/OR/XOR truth tables, NOT, and MUX over all 8
    input combinations — via one mixed-precombination bootstrap batch
    (``rustfhe.selfcheck.check_gate_batch``), and
  * an encrypted 8-bit ripple-carry adder (level-fused evaluator).
All checks share ONE compiled bootstrap program per batch shape (the gate
formulas differ only in their linear pre-combination), keeping compiles to
two (the big batch + the adder width).

Env knobs: BENCH_PARAMS=default|n2048|fast, BENCH_BATCH, BENCH_ITERS,
BENCH_GATES=all|nand (extended checks on/off), BENCH_SHARDED=1 (additionally
run + time the SAME batch through the mesh-sharded gate path over all local
devices, asserting bit-exact agreement with the unsharded output; reported
on stderr, the JSON metric stays the unsharded number).
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32

BASELINE_GATES_PER_SEC = 1e9 / 30_558_481.0  # 32.72


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    # Persistent compile cache (utils/cache.py): identical programs skip
    # their compiles on repeat runs; timed sections exclude compiles either
    # way.
    from rustfhe.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    from rustfhe import gates, keys, tlwe
    from rustfhe.apps.circuits import (
        evaluate_encrypted,
        evaluate_plain,
        ripple_carry_adder,
    )
    from rustfhe.context import TFHE
    from rustfhe.engine import select_fast_engine
    from rustfhe.params import (
        DEFAULT_PARAMS,
        FAST_PARAMS,
        N2048_PARAMS,
        PBS_PARAMS,
        TEST_PARAMS,
    )
    from rustfhe.selfcheck import check_gate_batch

    p = {
        "default": DEFAULT_PARAMS,
        "n2048": N2048_PARAMS,
        "pbs": PBS_PARAMS,  # the PBS/radix-tuned preset (space-8 sound)
        "fast": FAST_PARAMS,
        "test": TEST_PARAMS,  # CPU smoke runs of the bench logic itself
    }[os.environ.get("BENCH_PARAMS", "default")]
    # Bigger batches amortize the per-step fixed costs (circulant build,
    # launches); the accumulator at 131072 is 1.07 GB.
    batch = int(os.environ.get("BENCH_BATCH", "131072"))
    iters = int(os.environ.get("BENCH_ITERS", "3"))
    check_all = os.environ.get("BENCH_GATES", "all") == "all"

    dev = jax.devices()[0]
    log(f"# device: {dev.platform} {dev.device_kind}")

    engine_name = select_fast_engine(p)
    log(f"# engine: {engine_name}")

    key = jax.random.PRNGKey(0)
    kg, ke = jax.random.split(key)
    t0 = time.perf_counter()
    sk, ck = keys.gen_keys(kg, p, engine_name=engine_name)
    jax.block_until_ready(ck)
    log(f"# keygen: {time.perf_counter() - t0:.2f}s")

    def encrypt(bits, salt):
        return tlwe.encrypt_binary(
            jax.random.fold_in(ke, salt), sk.lv0, jnp.asarray(bits, U32), p
        )

    def pre_of(op, cx, cy):
        return gates.precombine(op, cx, cy, params=p)

    if check_all:
        check_gate_batch(ck, sk.lv0, p, engine_name, batch, ke, log=log)

        # 8-bit ripple-carry adder through the level-fused circuit evaluator.
        ctx = TFHE(sk, ck, p, engine_name)
        ctx._enc_key = jax.random.fold_in(ke, 999)
        adder = ripple_carry_adder(8)
        cases = np.array([[200, 100], [255, 255], [170, 85], [3, 4]], np.uint32)
        bits = np.zeros((len(cases), 16), np.uint32)
        for r, (a, b) in enumerate(cases):
            for i in range(8):
                bits[r, i] = (a >> i) & 1
                bits[r, 8 + i] = (b >> i) & 1
        cts = ctx.encrypt(jnp.asarray(bits))
        t0 = time.perf_counter()
        out_add = evaluate_encrypted(adder, ctx, cts, fixed_width=16)
        dec_add = np.asarray(ctx.decrypt(out_add))
        plain = evaluate_plain(adder, bits)
        assert np.array_equal(dec_add, plain), "adder: encrypted != plain evaluation"
        sums = [sum(int(dec_add[r, i]) << i for i in range(9)) for r in range(len(cases))]
        assert sums == [int(a) + int(b) for a, b in cases], sums
        log(
            f"# correctness[adder8]: {len(cases)} sums correct "
            f"({time.perf_counter() - t0:.1f}s, level-fused, width 16)"
        )

    # ----------------------------------------------------------------- #
    # Timed NAND batch (same bootstrap program as the mixed batch; the
    # linear pre-combination is precomputed — it is 3 vector ops, <0.1% of
    # a bootstrap).
    # ----------------------------------------------------------------- #
    pat = np.tile(np.array([[0, 0], [1, 0], [0, 1], [1, 1]], np.uint32), (batch // 4 + 1, 1))[
        :batch
    ]
    cx = encrypt(pat[:, 0], 900)
    cy = encrypt(pat[:, 1], 901)
    pre_nand = jax.block_until_ready(pre_of("nand", cx, cy))

    def run():
        return gates.hom_bootstrap(ck, pre_nand, params=p, engine_name=engine_name)

    t0 = time.perf_counter()
    out = jax.block_until_ready(run())
    log(f"# compile+first timed run: {time.perf_counter() - t0:.2f}s")
    dec = np.asarray(tlwe.decrypt_binary(out, sk.lv0))
    expect_nand = 1 - (pat[:, 0] & pat[:, 1])
    n_bad = int((dec != expect_nand).sum())
    assert n_bad == 0, f"correctness failure: {n_bad}/{batch} wrong NAND outputs"
    log(f"# correctness[nand-timed]: {batch}/{batch} NAND outputs decode correctly")

    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        times.append(time.perf_counter() - t0)
    best = min(times)
    gps = batch / best
    log(f"# per-batch: {best * 1e3:.1f} ms ({batch} gates) -> {gps:,.0f} gates/s")

    if os.environ.get("BENCH_SHARDED", "0") == "1":
        # The engine COMPOSED with the sharding stack: the same
        # pre-combined batch through sharded_bootstrap_fn's shard_map (psum
        # key switch) over a mesh of all local devices.  Must be bit-exact
        # vs the unsharded timed output.
        from rustfhe.parallel import make_mesh, shard_cloud_key
        from rustfhe.parallel.sharded import sharded_bootstrap_fn
        from jax.sharding import NamedSharding, PartitionSpec as SP

        mesh = make_mesh()  # all local devices on `data`, model=1
        ck_sh = shard_cloud_key(ck, mesh)
        sharded = sharded_bootstrap_fn(mesh, p, engine_name)
        pre_sh = jax.device_put(pre_nand, NamedSharding(mesh, SP("data")))
        t0 = time.perf_counter()
        out_sh = jax.block_until_ready(sharded(ck_sh.bk, ck_sh.ksk, pre_sh))
        log(f"# compile+first sharded run: {time.perf_counter() - t0:.2f}s "
            f"(mesh data={mesh.shape['data']}, engine {engine_name})")
        assert np.array_equal(np.asarray(out_sh), np.asarray(out)), (
            "sharded output differs from unsharded"
        )
        log(f"# correctness[sharded]: bit-exact vs unsharded ({batch} gates)")
        st = []
        for _ in range(iters):
            t0 = time.perf_counter()
            jax.block_until_ready(sharded(ck_sh.bk, ck_sh.ksk, pre_sh))
            st.append(time.perf_counter() - t0)
        sgps = batch / min(st)
        log(
            f"# sharded per-batch: {min(st) * 1e3:.1f} ms -> {sgps:,.0f} gates/s "
            f"({sgps / gps * 100:.1f}% of unsharded)"
        )

    print(
        json.dumps(
            {
                "metric": "homnand_bootstraps_per_sec_single_chip",
                "value": round(gps, 1),
                "unit": "gates/s",
                "vs_baseline": round(gps / BASELINE_GATES_PER_SEC, 1),
            }
        )
    )


if __name__ == "__main__":
    main()
