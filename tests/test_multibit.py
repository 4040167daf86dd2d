"""Grouped (multi-bit, k=2) blind rotation: construction correctness.

The k=2 grouped rotation (benches/multibit_probe.py) is a REFUTED perf
lever on this hardware (x1.5 MACs/bit — ROADMAP.md), but the refutation's
claim to have "built it exactly" is only honest while the construction
keeps decoding correctly; this test pins that.  It generalizes the
reference's per-bit fold (hom_nand/src/tfhe.rs:103-110) to key-bit pairs.
"""

import importlib.util
import pathlib


def _load_probe():
    path = pathlib.Path(__file__).resolve().parents[1] / "benches" / "multibit_probe.py"
    spec = importlib.util.spec_from_file_location("multibit_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_grouped2_nand_truth_table():
    mod = _load_probe()
    bad, batch = mod.check_correctness()
    assert bad == 0, f"{bad}/{batch} grouped-2 NAND outputs wrong"


def test_grouped2_odd_n_leftover_step():
    # Odd n exercises the trailing standard CMux step after the groups.
    from rustfhe.params import TFHEParams

    mod = _load_probe()
    p = TFHEParams(n=15, N=64, alpha_lv0=2.0**-20, alpha_lv1=2.0**-28)
    bad, batch = mod.check_correctness(params=p, batch=32, seed=9)
    assert bad == 0, f"{bad}/{batch} grouped-2 NAND outputs wrong at odd n"
