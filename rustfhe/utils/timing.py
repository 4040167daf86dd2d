"""Timing / profiling helpers.

The analogue of the reference's ``timeit!`` macro (``utils/src/macros.rs:3-13``)
plus JAX-native profiling: device-synchronized wall timing and an optional
``jax.profiler`` trace context for per-kernel inspection.
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def timeit(label: str, result_holder: dict | None = None, sync=None):
    """Print ``label: <micros> us`` around a block (macros.rs:3-13 flavor).

    ``sync``: optional array/pytree to ``block_until_ready`` before stopping
    the clock (device work is async; without it you time dispatch only).
    """
    t0 = time.perf_counter()
    yield
    if sync is not None:
        jax.block_until_ready(sync)
    dt = time.perf_counter() - t0
    if result_holder is not None:
        result_holder[label] = dt
    print(f"{label}: {dt * 1e6:.0f} us")


def time_fn(fn, *args, iters: int = 3, warmup: int = 1):
    """Best-of-N device-synchronized timing of ``fn(*args)``; returns
    (best_seconds, last_result)."""
    out = None
    for _ in range(warmup):
        out = jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, out


@contextlib.contextmanager
def profile_trace(logdir: str):
    """jax.profiler trace context: view with TensorBoard / xprof."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def cmux_step_ms(ck, params, engine_name, batch: int, reps: int = 10,
                 seed: int = 0) -> float:
    """Mean milliseconds of one jitted blind-rotate step (``cmux_step``
    against the first bootstrapping-key row) at ``batch``, chained
    ``x = step(x)`` so no call can be skipped."""
    import jax.numpy as jnp
    import numpy as np

    from ..bootstrap import cmux_step
    from ..engine import resolve_engine

    eng = resolve_engine(engine_name)
    step = jax.jit(lambda acc, bk_i, a_i: cmux_step(acc, bk_i, a_i, params, eng))
    bk0 = jax.tree.map(lambda x: x[0], ck.bk)
    rs = np.random.RandomState(seed)
    acc = jnp.asarray(rs.randint(0, 2**32, size=(batch, 2, params.N), dtype=np.uint64)
                      .astype(np.uint32))
    a_i = jnp.asarray(rs.randint(0, 2 * params.N, size=(batch,)).astype(np.int32))
    x = jax.block_until_ready(step(acc, bk0, a_i))
    t0 = time.perf_counter()
    for _ in range(reps):
        x = step(x, bk0, a_i)
    jax.block_until_ready(x)
    return (time.perf_counter() - t0) / reps * 1e3


def bootstrap_times(ck, pre, params, engine_name, iters: int = 2):
    """Compile ``gates.hom_bootstrap`` for ``pre`` and time it.

    Returns ``(stats, out)``: ``stats`` holds ``compile_s`` (lowering and
    compiling), ``boot_ms`` (best of ``iters`` after one warm-up call) and
    the compiled program's ``temp_bytes`` / ``arg_bytes``; ``out`` is the
    bootstrapped batch, for the caller to decode."""
    from .. import gates

    t0 = time.perf_counter()
    compiled = gates.hom_bootstrap.lower(ck, pre, params=params,
                                         engine_name=engine_name).compile()
    compile_s = time.perf_counter() - t0
    best, out = time_fn(compiled, ck, pre, iters=iters)
    ma = compiled.memory_analysis()
    return {
        "compile_s": compile_s,
        "boot_ms": best * 1e3,
        "temp_bytes": getattr(ma, "temp_size_in_bytes", None),
        "arg_bytes": getattr(ma, "argument_size_in_bytes", None),
    }, out
