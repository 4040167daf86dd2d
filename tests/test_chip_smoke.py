"""chip_smoke.py: its phases at test parameter sets on the CPU, and its
refusal to run (or to print a result) without a GPU."""

import importlib.util
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from rustfhe import engine as E
from rustfhe.params import PBS_TEST_PARAMS, TEST_PARAMS

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ctx(smoke):
    ctx, compile_s = smoke.phase_gates(TEST_PARAMS, "matmul", batch=64)
    assert compile_s > 0
    return ctx


def _run_alone(cwd):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )


def test_exits_nonzero_on_cpu():
    r = _run_alone(ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_engine_phase(smoke):
    assert smoke.phase_engines([("test", TEST_PARAMS)]) == {"test": "matmul"}
    assert not jax.config.jax_enable_x64  # the fft64 probe restores the flag


class _OffByOne:
    """Runs, but adds 1 to every output word: inexact."""

    def prepare_trgsw(self, rows, params):
        return E.get_engine("matmul").prepare_trgsw(rows, params)

    def external_product_digits(self, prepared, digits, params):
        out = E.get_engine("matmul").external_product_digits(prepared, digits, params)
        return (out + jnp.uint32(1)).astype(jnp.uint32)


def test_engine_phase_fails_on_inexact_candidate(smoke, monkeypatch):
    """Every candidate must be exact, not only the one selected."""
    monkeypatch.setitem(E._ENGINES, "off_by_one", _OffByOne())
    monkeypatch.setitem(E.CANDIDATES, "cpu", ("matmul", "off_by_one"))
    with pytest.raises(AssertionError, match="off_by_one at test: INEXACT"):
        smoke.phase_engines([("test", TEST_PARAMS)])


def test_gate_phase(ctx):
    assert ctx.engine_name == "matmul" and ctx.params == TEST_PARAMS


def test_public_key_phase(smoke, ctx):
    smoke.phase_public_key(ctx, rows=64)


def test_ints_console_phase(smoke, ctx):
    smoke.phase_ints_console(ctx, width=8, max_wires=64)


def test_pbs_phase(smoke):
    smoke.phase_pbs(PBS_TEST_PARAMS, "matmul", rows=64)


def test_numbers_phase(smoke, ctx, capsys):
    smoke.phase_numbers(ctx, "cpu", batches=(1, 4), iters=1)
    out = capsys.readouterr().out
    assert "time[matmul, B=4]" in out and "peak_bytes_in_use" in out


def test_four_phase_on_virtual_devices(smoke):
    """The --four path on 4 of the suite's virtual CPU devices."""
    assert len(jax.devices()) >= 4
    smoke.phase_four(TEST_PARAMS, "matmul", jax.devices()[:4], batch=16)
