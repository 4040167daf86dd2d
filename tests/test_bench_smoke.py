"""Smoke test of the driver-facing bench harness (bench.py).

``python bench.py`` runs on the card; a harness regression (segment layout, MUX second pass, adder
wiring, JSON schema) would otherwise only surface there.  This runs the
complete harness in-process at TEST_PARAMS on CPU — every correctness
segment plus the timed path — and checks the one-line JSON contract
(the analogue of the reference's example-as-integration-test,
``hom_nand/examples/homnand-bench.rs:39-136``).
"""

import importlib.util
import json
import pathlib

import pytest


def test_bench_harness_end_to_end(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_PARAMS", "test")
    monkeypatch.setenv("BENCH_BATCH", "64")
    monkeypatch.setenv("BENCH_ITERS", "1")
    monkeypatch.setenv("BENCH_GATES", "all")
    # Sharded path too (8-virtual-device mesh on CPU; matmul engine).
    monkeypatch.setenv("BENCH_SHARDED", "1")

    path = pathlib.Path(__file__).resolve().parents[1] / "bench.py"
    spec = importlib.util.spec_from_file_location("bench_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main()

    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, f"bench must print exactly one stdout line, got {out}"
    rec = json.loads(out[0])
    assert rec["metric"] == "homnand_bootstraps_per_sec_single_chip"
    assert rec["unit"] == "gates/s"
    assert rec["value"] > 0
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / (1e9 / 30_558_481.0), rel=1e-3)
