"""Per-engine blind-rotate step and whole-bootstrap times on one device.

For each engine this prints one JSON line per batch size:
  * ``step_ms``: one jitted CMux step (rotate, decompose, external product,
    accumulate), chained ``x = step(x)`` so no call can be skipped; the
    mean over 20 calls, best of three such runs (all three in
    ``step_ms_all``).  At small batches this is the host's dispatch time of
    one call, not the device's time for the step;
  * ``boot_ms``: one whole gate bootstrap (``gates.hom_bootstrap``: the
    n-step scan, sample extract, key switch), best of ``--iters``;
  * ``compile_s``: lowering and compiling the bootstrap program;
  * ``temp_bytes`` / ``arg_bytes``: its memory analysis;
  * ``peak_bytes``: ``memory_stats()["peak_bytes_in_use"]`` afterwards.
The utils.timing helpers that measure them are the ones chip_smoke.py uses.
Every bootstrap batch is NAND-decoded against plain evaluation before it is
timed, and the device's name and power limit head the output.

Each engine runs in its own child process (``fft64`` with x64 on), one at
a time, so exactly one JAX process holds the device at any moment; the
parent never imports JAX.

  python benches/engine_times.py --params default --batches 1,1024,16384 \
      --engines matmul,matmul_bf16,fft64 [--hlo-dir out/hlo]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_line() -> str:
    """``name, power.limit`` of the card, read by a child process."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def _time_engine(engine_name: str, params_name: str, batches, iters: int,
                 hlo_dir: str | None) -> None:
    import jax

    if engine_name == "fft64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, ROOT)
    from rustfhe import gates, keys, params as P, tlwe
    from rustfhe.utils.timing import bootstrap_times, cmux_step_ms

    p = {"default": P.DEFAULT_PARAMS, "pbs": P.PBS_PARAMS, "test": P.TEST_PARAMS}[params_name]
    dev = jax.devices()[0]
    kg, ke = jax.random.split(jax.random.PRNGKey(0))
    t0 = time.perf_counter()
    sk, ck = keys.gen_keys(kg, p, engine_name=engine_name)
    jax.block_until_ready(ck)
    keygen_s = time.perf_counter() - t0

    for B in batches:
        rs = np.random.RandomState(B)
        bx = rs.randint(0, 2, size=B).astype(np.uint32)
        by = rs.randint(0, 2, size=B).astype(np.uint32)
        cx = tlwe.encrypt_binary(jax.random.fold_in(ke, 2 * B), sk.lv0, jnp.asarray(bx), p)
        cy = tlwe.encrypt_binary(jax.random.fold_in(ke, 2 * B + 1), sk.lv0, jnp.asarray(by), p)
        pre = jax.block_until_ready(gates.precombine("nand", cx, cy, params=p))
        step_all = [cmux_step_ms(ck, p, engine_name, B, reps=20, seed=B) for _ in range(3)]
        st, out = bootstrap_times(ck, pre, p, engine_name, iters=iters)
        dec = np.asarray(tlwe.decrypt_binary(out, sk.lv0))
        bad = int((dec != 1 - (bx & by)).sum())
        if hlo_dir and B == batches[-1]:
            os.makedirs(hlo_dir, exist_ok=True)
            txt = gates.hom_bootstrap.lower(ck, pre, params=p, engine_name=engine_name) \
                .compile().as_text()
            with open(os.path.join(hlo_dir, f"bootstrap_{engine_name}_{params_name}_B{B}.hlo"),
                      "w") as f:
                f.write(txt)
        stats = dev.memory_stats() or {}
        print(json.dumps({
            "engine": engine_name, "params": params_name, "B": B,
            "step_ms": min(step_all), "step_ms_all": step_all, **st, "us_per_gate": st["boot_ms"] / B * 1e3,
            "keygen_s": keygen_s,
            "wrong_nand": bad, "peak_bytes": stats.get("peak_bytes_in_use"),
            "platform": dev.platform, "kind": dev.device_kind,
        }), flush=True)
        assert bad == 0, f"{engine_name} B={B}: {bad} wrong NAND outputs"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--params", default="default")
    ap.add_argument("--batches", default="1,1024,16384")
    ap.add_argument("--engines", default="matmul,matmul_bf16,fft64")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--hlo-dir", default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    batches = [int(b) for b in a.batches.split(",")]
    if a.child:
        _time_engine(a.child, a.params, batches, a.iters, a.hlo_dir)
        return 0
    print(f"# card: {card_line()}", flush=True)
    rc = 0
    for name in a.engines.split(","):
        cmd = [sys.executable, os.path.abspath(__file__), "--child", name,
               "--params", a.params, "--batches", a.batches, "--iters", str(a.iters)]
        if a.hlo_dir:
            cmd += ["--hlo-dir", a.hlo_dir]
        r = subprocess.run(cmd)
        if r.returncode != 0:
            print(f"# {name}: exit {r.returncode}", flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
