"""Polynomial-arithmetic engines.

This package plays the role of the reference's native layer (the vendored
spqlios f64 FFT: ``utils/src/spqlios/*`` + the ``Spqlios`` FFI wrapper,
``utils/src/spqlios.rs``).  Every engine here is *exact* mod 2^32
(SURVEY.md §7 design decision 1):

* ``OracleEngine`` — naive O(N^2) uint32 wrapping convolution.  Slow,
  trivially correct; the ground truth (the analogue of the reference's
  naive ``cross``, math.rs:237-257).
* ``MatmulEngine`` — negacyclic convolution as one dense integer matrix
  product per blind-rotate step: bootstrapping-key polynomials are
  pre-split into balanced signed limbs, a negacyclic "circulant" operand is
  materialized per step, and the int8 (or bf16) product accumulates exactly;
  limbs recombine with wrapping shifts, giving bit-exact results mod 2^32.
* ``FFT64Engine`` — the reference's own f64-FFT product, made exact by
  16-bit limbs and rounding (needs ``jax_enable_x64``).

Every engine implements the same three operations:
  ``prepare_trgsw``     — precompute the fast representation of TRGSW rows
                          (the analogue of ``TRGSWRepF``, trgsw.rs:64-108).
  ``external_product_digits`` — (digits, prepared rows) -> TRLWE pair.
  ``poly_mul_torus_binary``   — torus poly x binary poly (encrypt/decrypt).
"""

from __future__ import annotations

from typing import Protocol

import jax.numpy as jnp


class PolyEngine(Protocol):
    """Interface all polynomial engines implement."""

    name: str

    def prepare_trgsw(self, rows: jnp.ndarray, params) -> object:
        """Precompute the engine representation of TRGSW rows.

        ``rows``: uint32 ``(..., 2L, 2, N)`` — per row j, index 0 holds the
        cipher (b) polynomial and index 1 the mask (a) polynomial.
        """

    def external_product_digits(self, prepared, digits: jnp.ndarray, params) -> jnp.ndarray:
        """Accumulate sum_j digits[..., j, :] (*) rows[j] for both output polys.

        ``digits``: int32 ``(..., 2L, N)`` gadget digits (b digits then a
        digits, trgsw.rs:289-299).  Returns uint32 ``(..., 2, N)``.
        """

    def poly_mul_torus_binary(self, a: jnp.ndarray, s: jnp.ndarray, params) -> jnp.ndarray:
        """Negacyclic product of uint32 torus poly ``a (..., N)`` by binary
        poly ``s (N,)``, exact mod 2^32."""


from .oracle import OracleEngine  # noqa: E402
from .matmul import MatmulEngine  # noqa: E402

_ENGINES = {}


def register_engine(name: str, engine) -> None:
    _ENGINES[name] = engine


def get_engine(name: str = "matmul"):
    if name not in _ENGINES:
        raise KeyError(f"unknown engine {name!r}; have {sorted(_ENGINES)}")
    return _ENGINES[name]


def resolve_engine(engine):
    """Registry name or engine instance -> engine instance.

    Lets callers (keygen, the sharded gate builders) accept either a
    registered name ("matmul") or a custom-configured instance.
    """
    return get_engine(engine) if isinstance(engine, str) else engine


register_engine("oracle", OracleEngine())
register_engine("matmul", MatmulEngine())
register_engine("matmul_bf16", MatmulEngine(limb_bits=4, use_bf16=True))

from .transform import NussTransformEngine  # noqa: E402

# Transform-domain reference engine (exact; never auto-selected).  Its
# prepare_trgsw builds tables host-side (numpy): use it with direct calls,
# not inside jitted keygen.
register_engine("nuss", NussTransformEngine())

# Exact f64-FFT convolution (the reference's own spqlios trick).  Needs
# jax_enable_x64 (its ops raise with the fix otherwise), so it is only a
# candidate when x64 is on — and, like every engine, only after passing the
# oracle probe.
from .fft64 import FFT64Engine  # noqa: E402

register_engine("fft64", FFT64Engine())


def probe_vectors(params):
    """Adversarial (rows, digits) exactness-probe vectors.

    Beyond one random sample, the set stresses the failure modes integer
    engines actually have: limb-split sign/carry edges (row bytes 0x80,
    0x7F, 0xFF, 0x00), accumulator-magnitude extremes (all digits at the
    most-negative -half_bg against all-ones rows — the largest |partial
    sum| any input can produce), and digit-boundary values the balanced
    decomposition emits (exactly -half_bg, exactly half_bg - 1).

    Returns (rows u32 (2L, 2, N), digits i32 (P, 2L, N)) with P patterns
    batched so one oracle call covers them all.
    """
    import numpy as np

    shape_r = (2 * params.l, 2, params.N)
    size_r = int(np.prod(shape_r))
    rs = np.random.RandomState(1234)

    byte_edges = np.array([0x00, 0x01, 0x7F, 0x80, 0xFE, 0xFF], np.uint32)
    word_edges = np.array(
        [0x00000000, 0x00000001, 0x7FFFFFFF, 0x80000000, 0x80808080, 0xFFFFFFFF],
        np.uint32,
    )
    b = byte_edges[np.arange(size_r * 4) % len(byte_edges)].reshape(size_r, 4)
    rows = np.empty(size_r, np.uint32)
    third = size_r // 3
    # third 1: random; third 2: cycling word edges; third 3: cycling edge bytes.
    rows[:third] = rs.randint(0, 2**32, size=third, dtype=np.uint64).astype(np.uint32)
    rows[third : 2 * third] = word_edges[np.arange(third) % len(word_edges)]
    rest = size_r - 2 * third
    rows[2 * third :] = (
        b[:rest, 0] | (b[:rest, 1] << 8) | (b[:rest, 2] << 16) | (b[:rest, 3] << 24)
    )
    rows = rows.reshape(shape_r)

    hb = params.half_bg
    shape_d = (2 * params.l, params.N)
    digits = np.stack(
        [
            rs.randint(-hb, hb, size=shape_d),
            np.full(shape_d, -hb),  # most-negative digit everywhere
            np.full(shape_d, hb - 1),  # most-positive digit everywhere
            np.where(np.arange(params.N) % 2 == 0, -hb, hb - 1) * np.ones(shape_d, int),
        ]
    ).astype(np.int32)
    return rows, digits


def oracle_external_product_np(rows, digits) -> "np.ndarray":
    """Host-numpy mod-2^32 external product: the probe's reference.

    ``rows`` uint32 ``(2L, 2, N)``, ``digits`` int ``(P, 2L, N)`` ->
    uint32 ``(P, 2, N)``.  Plain int64 numpy, so it never touches an
    accelerator (and needs no CPU client in JAX): every partial sum is
    below 2L * N * 2^32 * half_bg < 2^63 for every preset here.
    """
    import numpy as np

    rows = np.asarray(rows, np.uint32).astype(np.int64)
    digits = np.asarray(digits, np.int64)
    n = rows.shape[-1]
    # circ[p, k, i] = d[p, (k - i) mod 2N] with d = [digits, -digits]: the
    # negacyclic convolution as a matrix (same identity as poly.negacyclic_mul_i64).
    idx = np.mod(np.arange(n)[:, None] - np.arange(n)[None, :], 2 * n)
    out = np.zeros((digits.shape[0], 2, n), np.int64)
    for j in range(rows.shape[0]):
        d = np.concatenate([digits[:, j], -digits[:, j]], axis=-1)
        out += np.swapaxes(np.matmul(d[:, idx], rows[j].T), -1, -2)
    return np.mod(out, 1 << 32).astype(np.uint32)


#: Candidate engines per JAX platform, in probe order (fastest first, as
#: measured by benches/engine_times.py; see CHANGES.md for the numbers).
CANDIDATES = {
    "cpu": ("fft64", "matmul", "matmul_bf16"),
    "gpu": ("matmul", "fft64", "matmul_bf16"),
}


def candidate_engines(platform: str) -> tuple[str, ...]:
    """Probe order for ``platform``, without engines the current process
    cannot run (``fft64`` needs ``jax_enable_x64``).  An unknown platform
    raises: there is no measured order to fall back on."""
    import jax

    if platform not in CANDIDATES:
        raise ValueError(
            f"no engine candidates for platform {platform!r}; "
            f"known platforms: {sorted(CANDIDATES)}"
        )
    x64 = jax.config.jax_enable_x64
    return tuple(
        name for name in CANDIDATES[platform]
        if x64 or not getattr(get_engine(name), "needs_x64", False)
    )


def select_fast_engine(params=None) -> str:
    """Pick the fastest engine whose external product is exact on this device.

    Candidates come from ``CANDIDATES`` for the platform of
    ``jax.devices()[0]`` and are probed in order against the mod-2^32
    reference over the adversarial ``probe_vectors`` set; the first exact
    one wins.  The reference is computed in host numpy
    (``oracle_external_product_np``); the candidates run on the device.

    ``RUSTFHE_ENGINE`` (env) narrows the probe to ONE registered engine.  It
    is still probed (engines must match the oracle before they are used);
    an inexact override raises instead of returning, and a name that is not
    registered raises at once.
    """
    import os

    import jax

    from ..params import DEFAULT_PARAMS

    params = params or DEFAULT_PARAMS
    platform = jax.devices()[0].platform
    names = candidate_engines(platform)
    override = os.environ.get("RUSTFHE_ENGINE")
    if override:
        if override not in _ENGINES:
            raise ValueError(
                f"RUSTFHE_ENGINE={override!r} names no registered engine; "
                f"have {sorted(_ENGINES)}"
            )
        names = (override,)
    rows, digits = probe_vectors(params)
    want = oracle_external_product_np(rows, digits)
    rows, digits = jnp.asarray(rows), jnp.asarray(digits)
    for name in names:
        ok, why = engine_probe_result(get_engine(name), params, rows, digits, want)
        if ok:
            return name
        if override:
            raise RuntimeError(
                f"RUSTFHE_ENGINE={override!r} failed the oracle probe on "
                f"{platform}: {why}"
            )
    raise RuntimeError(f"no engine computes the external product exactly on {platform}")


def engine_probe_result(engine, params, rows, digits, want) -> tuple[bool, str]:
    """(ok, why): the probe verdict, with what differed when it fails.

    An engine that cannot run raises; only a result that ran is judged."""
    import numpy as np

    got = np.asarray(
        engine.external_product_digits(engine.prepare_trgsw(rows, params), digits, params)
    )
    want = np.asarray(want)
    if got.shape != want.shape:
        return False, f"wrong output shape {got.shape} (want {want.shape})"
    if not np.array_equal(got, want):
        bad = got != want
        return False, (
            f"INEXACT results: {int(bad.sum())}/{bad.size} output words "
            f"differ from the mod-2^32 oracle"
        )
    return True, "exact"


def engine_exact_on_probe(engine, params, rows, digits, want) -> bool:
    """True iff ``engine`` reproduces the oracle on every probe pattern."""
    return engine_probe_result(engine, params, rows, digits, want)[0]


__all__ = [
    "PolyEngine",
    "OracleEngine",
    "MatmulEngine",
    "get_engine",
    "resolve_engine",
    "register_engine",
    "probe_vectors",
    "select_fast_engine",
    "candidate_engines",
    "oracle_external_product_np",
    "engine_probe_result",
]
