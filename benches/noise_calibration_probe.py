"""Probe: measured calibration of the analytic noise model (utils/noise.py).

The model had ONE measured anchor (the FAST preset's on-device failure:
12/8192 wrong gates ~ 3 sigma, a decomposition-rounding-dominated budget).
This probe adds BK-noise-dominated anchors: deliberately marginal presets
built by raising alpha_lv1 until the predicted decode margin sits in the
3-4 sigma band, then a large NAND batch ON DEVICE counts actual wrong
decodes against the model's one-sided tail prediction
P_fail = Phi(-margin_sigmas), expected failures = P_fail * B.

A match within small factors (Poisson noise + the Gaussian approximation
of a sum of bounded terms) validates the model's blind-rotate variance
term 2*l*N*(Bg/2)^2*alpha_lv1^2, the component the FAST anchor never
exercised.  Results are recorded in utils/noise.py's docstring and pinned
by tests/test_noise.py.

Usage: python benches/noise_calibration_probe.py [B]   (on the card)
"""

import math
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from rustfhe import gates, keys, tlwe  # noqa: E402
from rustfhe.engine import select_fast_engine  # noqa: E402
from rustfhe.params import DEFAULT_PARAMS  # noqa: E402
from rustfhe.utils.noise import noise_budget  # noqa: E402

U32 = jnp.uint32
B = int(sys.argv[1]) if len(sys.argv) > 1 else 131072


def run_preset(tag, params, engine_name, B):
    nb = noise_budget(params)
    p_fail = 0.5 * math.erfc(nb.margin_sigmas / math.sqrt(2))
    expect = p_fail * B
    print(
        f"[{tag}] predicted margin {nb.margin_sigmas:.2f} sigma, "
        f"P_fail {p_fail:.2e}, expected {expect:.1f}/{B}",
        flush=True,
    )

    key = jax.random.PRNGKey(42)
    kg, ke = jax.random.split(key)
    t0 = time.perf_counter()
    sk, ck = keys.gen_keys(kg, params, engine_name=engine_name)
    jax.block_until_ready(ck)
    rs = np.random.RandomState(3)
    bx = rs.randint(0, 2, size=B).astype(np.uint32)
    by = rs.randint(0, 2, size=B).astype(np.uint32)
    cx = tlwe.encrypt_binary(jax.random.fold_in(ke, 0), sk.lv0, jnp.asarray(bx), params)
    cy = tlwe.encrypt_binary(jax.random.fold_in(ke, 1), sk.lv0, jnp.asarray(by), params)
    pre = gates.precombine("nand", cx, cy, params=params)
    out = jax.block_until_ready(
        gates.hom_bootstrap(ck, pre, params=params, engine_name=engine_name)
    )
    dec = np.asarray(tlwe.decrypt_binary(out, sk.lv0))
    want = 1 - (bx & by)
    bad = int((dec != want).sum())
    ratio = bad / expect if expect > 0 else float("inf")
    print(
        f"[{tag}] MEASURED {bad}/{B} wrong decodes  "
        f"(predicted {expect:.1f}; measured/predicted = {ratio:.2f}; "
        f"keygen+run {time.perf_counter() - t0:.0f}s)",
        flush=True,
    )
    return bad, expect


def main():
    print(f"# device: {jax.devices()[0]}  B={B}", flush=True)
    presets = [
        ("alpha_lv1=2^-21.5", DEFAULT_PARAMS.replace(alpha_lv1=2.0 ** -21.5)),
        ("alpha_lv1=2^-21.8", DEFAULT_PARAMS.replace(alpha_lv1=2.0 ** -21.8)),
        ("default (control)", DEFAULT_PARAMS),
    ]
    engine_name = select_fast_engine(DEFAULT_PARAMS)
    print(f"# engine: {engine_name}", flush=True)
    for tag, p in presets:
        run_preset(tag, p, engine_name, B)


if __name__ == "__main__":
    main()
