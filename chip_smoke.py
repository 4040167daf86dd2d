"""Bring-up smoke run of the TFHE gate path on one NVIDIA GPU.

Drives the main path once, through the entry points a user calls, at the
full parameter sets, and decode-asserts every result:

  1. card     — name and power limit (``nvidia-smi``, read by a child);
  2. engines  — oracle-probe verdict of every candidate engine at
                DEFAULT_PARAMS (n=635, N=1024, l=3) and PBS_PARAMS (n=714,
                N=2048, l=4): each external product equals the mod-2^32
                reference (host numpy) exactly, then the selected engine;
  3. gates    — ``TFHE.new`` at DEFAULT_PARAMS, one 4096-row mixed batch
                through ``gates.hom_bootstrap`` (NAND/AND/OR/XOR/NOT and MUX
                over all 8 input combinations); public-key encryption's
                uint32 matrix product against numpy;
  4. integers — ``FheUint`` 8-bit Kogge-Stone ``+`` and ``lt``; then the
                nander console on ``(1 & 0) ^ !0`` and on one ';'-line of 8
                expressions, each against plain evaluation;
  5. PBS      — at PBS_PARAMS: ``apply_lut`` on 1024 rows with a per-row
                table, and an 8-bit ``RadixUint`` add;
  6. numbers  — peak device memory, the bootstrap program's memory
                analysis, compile seconds, and the selected engine's
                blind-rotate step and whole-bootstrap times.

``--four`` runs only the data-parallel path across four cards in this one
process: ``sharded_gate_fn`` on a (data=4, model=1) mesh, then the psum key
switch and ``tp_gate_fn`` on (data=2, model=2), each bit-exact against the
unsharded single-card output at DEFAULT_PARAMS.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a GPU the script exits non-zero and prints no result.

  python chip_smoke.py            # one card
  python chip_smoke.py --four     # four cards of one host
"""

from __future__ import annotations

import argparse
import io
import json
import subprocess
import sys
import time

import numpy as np

SMOKE_BATCH = 4096
TIMED_BATCHES = (1, 1024, 16384)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """``name, power.limit`` as nvidia-smi reports them (a child process)."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------- #
# 2. engines
# ---------------------------------------------------------------------- #
def phase_engines(params_list) -> dict:
    """Probe every candidate engine of this device's platform against the
    mod-2^32 reference at each parameter set (tolerance 0: any inexact
    candidate fails the phase), then select.  Returns
    ``{params_name: selected_engine}``."""
    import jax
    import jax.numpy as jnp

    from rustfhe.engine import (
        CANDIDATES,
        engine_probe_result,
        get_engine,
        oracle_external_product_np,
        probe_vectors,
        select_fast_engine,
    )

    selected = {}
    for name_p, p in params_list:
        rows, digits = probe_vectors(p)
        want = oracle_external_product_np(rows, digits)
        rows_j, digits_j = jnp.asarray(rows), jnp.asarray(digits)
        for name in CANDIDATES[jax.devices()[0].platform]:
            eng = get_engine(name)
            x64 = jax.config.jax_enable_x64
            if getattr(eng, "needs_x64", False):
                jax.config.update("jax_enable_x64", True)
                bound = 2 * p.l * p.N * p.half_bg * 2 ** (eng.conv_limb_bits - 1)
                note = f" (f64 bound: per-limb sums < 2^{np.log2(bound):.1f} < 2^53)"
            else:
                note = ""
            try:
                ok, why = engine_probe_result(eng, p, rows_j, digits_j, want)
            finally:
                jax.config.update("jax_enable_x64", x64)
            log(f"# probe[{name_p}] {name}: {why}, {want.size} words{note}")
            assert ok, f"{name} at {name_p}: {why}"
        selected[name_p] = select_fast_engine(p)
        log(f"# engine[{name_p}]: {selected[name_p]}")
    return selected


# ---------------------------------------------------------------------- #
# 3. gates
# ---------------------------------------------------------------------- #
def phase_gates(params, engine_name: str, batch: int = SMOKE_BATCH):
    """``TFHE.new`` + one decode-asserted mixed gate batch.  Returns
    ``(ctx, compile_s)``: the context and the first bootstrap's seconds."""
    import jax

    from rustfhe.context import TFHE
    from rustfhe.selfcheck import check_gate_batch

    t0 = time.perf_counter()
    ctx = TFHE.new(jax.random.PRNGKey(0), params, engine_name)
    jax.block_until_ready(ctx.ck)
    log(f"# keygen: {time.perf_counter() - t0:.2f} s ({engine_name})")
    t0 = time.perf_counter()
    check_gate_batch(ctx.ck, ctx.sk.lv0, params, engine_name, batch,
                     jax.random.PRNGKey(1), log=log)
    compile_s = time.perf_counter() - t0
    log(f"# gates: {batch}-row batch (+ MUX second pass) incl. compile {compile_s:.2f} s")
    return ctx, compile_s


def phase_public_key(ctx, rows: int = 1024):
    """The uint32 matrix product of public-key encryption (an integer GEMM
    that no vendor library runs) against numpy, then a public-key
    encrypt/decrypt round trip."""
    import jax.numpy as jnp

    pk = ctx.make_public_key()
    rs = np.random.RandomState(4)
    r = rs.randint(0, 2, size=(rows, pk.shape[0])).astype(np.uint32)
    got = np.asarray(jnp.matmul(jnp.asarray(r), pk, preferred_element_type=jnp.uint32))
    want = ((r.astype(np.uint64) @ np.asarray(pk).astype(np.uint64)) % (1 << 32))
    assert np.array_equal(got, want.astype(np.uint32)), "uint32 matmul differs from numpy"
    bits = rs.randint(0, 2, size=rows).astype(np.uint32)
    dec = np.asarray(ctx.decrypt(ctx.encrypt_public(pk, bits)))
    assert np.array_equal(dec, bits), f"public-key round trip: {int((dec != bits).sum())} wrong"
    log(f"# public key: uint32 ({rows}, {pk.shape[0]}) @ {tuple(pk.shape)} exact; "
        f"{rows}/{rows} public-key encryptions decrypt correctly")


# ---------------------------------------------------------------------- #
# 4. integers and console
# ---------------------------------------------------------------------- #
CONSOLE_LINE = ["1 $ 0", "1 & 1", "0 | 0", "1 ^ 0", "!(1 & 0)",
                "(1 | 0) & (1 ^ 1)", "((1|0)&(1^1))$(0|1)", "1 & 1 & 0 | 1"]


def phase_ints_console(ctx, width: int | None = None, max_wires: int | None = None):
    """FheUint8 add and lt, then the nander console on one expression and
    on one ';'-line of ``CONSOLE_LINE``."""
    from rustfhe.apps import nander

    rs = np.random.RandomState(7)
    av = np.array([200, 255, 3, 0, 128, 77, 1, 254], np.uint64)
    bv = rs.randint(0, 256, size=av.shape).astype(np.uint64)
    a = ctx.encrypt_uint(av, 8)
    b = ctx.encrypt_uint(bv, 8)
    t0 = time.perf_counter()
    got = np.asarray((a + b).decrypt())
    assert np.array_equal(got, (av + bv) & 0xFF), (got, av, bv)
    log(f"# ints: FheUint8 add {len(av)}/{len(av)} correct ({time.perf_counter() - t0:.2f} s)")
    t0 = time.perf_counter()
    lt = np.asarray(ctx.decrypt(a.lt(b)))
    assert np.array_equal(lt, (av < bv).astype(lt.dtype)), (lt, av, bv)
    log(f"# ints: FheUint8 lt {len(av)}/{len(av)} correct ({time.perf_counter() - t0:.2f} s)")

    plain = nander.PlainLogic()
    want1 = nander.eval_logic_expr(plain, nander.parse_logic_expr("(1 & 0) ^ !0"))
    want8 = [nander.eval_logic_expr(plain, nander.parse_logic_expr(e)) for e in CONSOLE_LINE]
    out = io.StringIO()
    nander.nander_console(
        params=ctx.params, engine_name=ctx.engine_name,
        stdin=io.StringIO("(1 & 0) ^ !0\n" + "; ".join(CONSOLE_LINE) + "\n"),
        stdout=out, width=width or nander.CONSOLE_WIDTH,
        max_wires=max_wires or nander.CONSOLE_WIRES)
    res = [ln for ln in out.getvalue().splitlines() if ln.startswith("res: ")]
    times = [ln for ln in out.getvalue().splitlines() if ln.startswith("time: ")]
    assert res == [f"res: {want1}", "res: " + " ".join(map(str, want8))], out.getvalue()
    log(f"# console: '(1 & 0) ^ !0' -> {want1} ({times[0][6:]}); "
        f"';'-line of {len(CONSOLE_LINE)} correct ({times[1][6:]})")


# ---------------------------------------------------------------------- #
# 5. programmable bootstrapping
# ---------------------------------------------------------------------- #
def phase_pbs(params, engine_name: str, rows: int = 1024, space: int = 8):
    """``apply_lut`` with a per-row table, and an 8-bit RadixUint add."""
    import jax
    import jax.numpy as jnp

    from rustfhe.context import TFHE
    from rustfhe.radix import RadixUint

    t0 = time.perf_counter()
    ctx = TFHE.new(jax.random.PRNGKey(11), params, engine_name)
    jax.block_until_ready(ctx.ck)
    log(f"# keygen[pbs]: {time.perf_counter() - t0:.2f} s ({engine_name})")
    rs = np.random.RandomState(5)
    xs = rs.randint(0, space, size=rows)
    tables = rs.randint(0, space, size=(rows, space))
    ct = ctx.encrypt_int(jnp.asarray(xs, jnp.uint32), space)
    t0 = time.perf_counter()
    out = jax.block_until_ready(ctx.apply_lut(ct, jnp.asarray(tables, jnp.uint32), space))
    dec = np.asarray(ctx.decrypt_int(out, space))
    want = tables[np.arange(rows), xs]
    assert np.array_equal(dec, want), f"LUT: {int((dec != want).sum())}/{rows} wrong"
    log(f"# pbs: per-row LUT space={space} {rows}/{rows} correct "
        f"(incl. compile {time.perf_counter() - t0:.2f} s)")

    av = rs.randint(0, 256, size=16).astype(np.uint64)
    bv = rs.randint(0, 256, size=16).astype(np.uint64)
    t0 = time.perf_counter()
    s = RadixUint.encrypt(ctx, av, 4) + RadixUint.encrypt(ctx, bv, 4)
    got = np.asarray(s.decrypt())
    assert np.array_equal(got, (av + bv) & 0xFF), (got, av, bv)
    log(f"# radix: 8-bit add {len(av)}/{len(av)} correct "
        f"(incl. compile {time.perf_counter() - t0:.2f} s)")


# ---------------------------------------------------------------------- #
# 6. numbers
# ---------------------------------------------------------------------- #
def phase_numbers(ctx, card: str, batches=TIMED_BATCHES, iters: int = 2):
    """Step and bootstrap times of the selected engine, the bootstrap
    program's memory analysis, and peak device memory."""
    import jax
    import jax.numpy as jnp

    from rustfhe.utils.timing import bootstrap_times, cmux_step_ms

    p, name = ctx.params, ctx.engine_name
    rs = np.random.RandomState(3)
    for B in batches:
        step_ms = cmux_step_ms(ctx.ck, p, name, B)
        pre = jnp.asarray(rs.randint(0, 2**32, size=(B, p.n + 1), dtype=np.uint64)
                          .astype(np.uint32))
        st, _ = bootstrap_times(ctx.ck, pre, p, name, iters=iters)
        log(f"# time[{name}, B={B}]: step {step_ms:.3f} ms, bootstrap {st['boot_ms']:.2f} ms "
            f"({st['boot_ms'] / B * 1e3:.2f} us/gate), compile {st['compile_s']:.2f} s; "
            f"program temp {st['temp_bytes']} B, args {st['arg_bytes']} B; card {card}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"# memory: peak_bytes_in_use {stats.get('peak_bytes_in_use')} "
        f"of bytes_limit {stats.get('bytes_limit')}; card {card}")


# ---------------------------------------------------------------------- #
# --four: the data-parallel path across cards
# ---------------------------------------------------------------------- #
def phase_four(params, engine_name: str, devices, batch: int = SMOKE_BATCH):
    """sharded_gate_fn on (4, 1), psum key switch and tp_gate_fn on (2, 2),
    each bit-exact against the unsharded output on ``devices[0]``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from rustfhe import gates, keys, tlwe
    from rustfhe.parallel import (
        make_mesh,
        shard_cloud_key,
        shard_cloud_key_tp,
        sharded_gate_fn,
        tp_gate_fn,
    )

    assert len(devices) == 4, devices
    kg, ke = jax.random.split(jax.random.PRNGKey(2))
    with jax.default_device(devices[0]):
        sk, ck = keys.gen_keys(kg, params, engine_name=engine_name)
        rs = np.random.RandomState(9)
        bx = rs.randint(0, 2, size=batch).astype(np.uint32)
        by = rs.randint(0, 2, size=batch).astype(np.uint32)
        cx = tlwe.encrypt_binary(jax.random.fold_in(ke, 0), sk.lv0, jnp.asarray(bx), params)
        cy = tlwe.encrypt_binary(jax.random.fold_in(ke, 1), sk.lv0, jnp.asarray(by), params)
        t0 = time.perf_counter()
        ref = np.asarray(jax.block_until_ready(
            gates.hom_nand(ck, cx, cy, params=params, engine_name=engine_name)))
        single_s = time.perf_counter() - t0
    dec = np.asarray(tlwe.decrypt_binary(jnp.asarray(ref), sk.lv0))
    assert np.array_equal(dec, 1 - (bx & by)), "unsharded NAND decodes wrong"
    log(f"# four: unsharded NAND B={batch} on one card incl. compile {single_s:.2f} s")

    for (data, model), kind in (((4, 1), "dp"), ((2, 2), "dp"), ((2, 2), "tp")):
        mesh = make_mesh(data=data, model=model, devices=list(devices))
        if kind == "dp":
            fn = sharded_gate_fn(mesh, params, engine_name)
            ck_sh = shard_cloud_key(ck, mesh)
        else:
            fn = tp_gate_fn(mesh, params, kind="nand", engine_name=engine_name)
            ck_sh = shard_cloud_key_tp(ck, mesh)
        xs = jax.device_put(cx, NamedSharding(mesh, P("data")))
        ys = jax.device_put(cy, NamedSharding(mesh, P("data")))
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(ck_sh.bk, ck_sh.ksk, xs, ys))
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(fn(ck_sh.bk, ck_sh.ksk, xs, ys))
        run_s = time.perf_counter() - t0
        same = np.array_equal(np.asarray(out), ref)
        log(f"# four: {kind} mesh (data={data}, model={model}) NAND B={batch}: "
            f"{'bit-exact' if same else 'DIFFERS'} vs unsharded; "
            f"first call {first_s:.2f} s, second {run_s * 1e3:.1f} ms")
        assert same, f"{kind} ({data}, {model}) differs from the unsharded output"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the TFHE gate path on the GPU.")
    ap.add_argument("--four", action="store_true",
                    help="run only the data-parallel path across four cards")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {dev.platform}", file=sys.stderr)
        return 2
    if args.four and len(devices) < 4:
        print(f"chip_smoke --four: needs 4 GPUs; JAX found {len(devices)}", file=sys.stderr)
        return 2

    from rustfhe.params import DEFAULT_PARAMS, PBS_PARAMS
    from rustfhe.utils.cache import enable_compilation_cache

    card = card_line()
    log(f"# card: {card}")
    log(f"# jax {jax.__version__}: {dev.platform} {dev.device_kind} x{len(devices)}; "
        f"compile cache {enable_compilation_cache()}")
    t_all = time.perf_counter()
    if args.four:
        from rustfhe.engine import select_fast_engine

        engine = select_fast_engine(DEFAULT_PARAMS)
        log(f"# engine[default]: {engine}")
        phase_four(DEFAULT_PARAMS, engine, devices[:4])
    else:
        engines = phase_engines([("default", DEFAULT_PARAMS), ("pbs", PBS_PARAMS)])
        ctx, _ = phase_gates(DEFAULT_PARAMS, engines["default"])
        phase_public_key(ctx)
        phase_ints_console(ctx)
        phase_pbs(PBS_PARAMS, engines["pbs"])
        phase_numbers(ctx, card)
    log(f"# wall: {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
