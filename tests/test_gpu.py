"""On-card exactness checks (marker ``gpu``).  Without a GPU they skip;
``chip_smoke.py`` runs the same phases.  On the card:

  JAX_PLATFORMS=cuda python -m pytest -o addopts="" -m gpu tests/test_gpu.py
"""

import importlib.util
import pathlib

import jax
import pytest

from rustfhe.params import DEFAULT_PARAMS, PBS_PARAMS

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def card():
    # Decided here, never at import or collection time.
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX found {dev.platform}); run on the card")
    return dev


@pytest.fixture(scope="module")
def ctx(card, smoke):
    return smoke.phase_gates(DEFAULT_PARAMS, "matmul")[0]


@pytest.mark.gpu
def test_engine_probes_exact_on_card(card, smoke):
    """Every candidate's external product equals the mod-2^32 reference at
    DEFAULT_PARAMS and PBS_PARAMS (the phase asserts each verdict), and the
    selection lands on matmul."""
    sel = smoke.phase_engines([("default", DEFAULT_PARAMS), ("pbs", PBS_PARAMS)])
    assert sel == {"default": "matmul", "pbs": "matmul"}


@pytest.mark.gpu
def test_gate_batch_on_card(ctx):
    assert ctx.engine_name == "matmul"


@pytest.mark.gpu
def test_public_key_uint32_matmul_on_card(smoke, ctx):
    smoke.phase_public_key(ctx, rows=4096)
