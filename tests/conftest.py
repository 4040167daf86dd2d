"""Test configuration: force CPU with 8 virtual devices.

Multi-device sharding tests run on a virtual CPU mesh
(``--xla_force_host_platform_device_count=8``), per SURVEY.md §4's note on
what the reference lacks: device-count-portable distributed tests.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

import pytest  # noqa: E402


@pytest.fixture
def rng():
    return jax.random.PRNGKey(42)


# --------------------------------------------------------------------- #
# slow-test split: the default run must stay under
# ~5 min so the inner loop is fast; the heavy tests (production dims,
# two-OS-process multihost, wide integer circuits
# — each 9-60 s on CPU, measured 2026-08-20) carry the ``slow`` marker
# and run with ``pytest -m ""`` (the full-suite form used by the round
# workflow) or ``-m slow``.  Central list, not per-file decorators, so
# the measured-duration policy lives in one place.
# --------------------------------------------------------------------- #
_SLOW_TESTS = {
    # test_file.py::test_name (parametrized tests match by base name)
    "test_production_dims.py::test_production_params_nand_cpu_slow",
    "test_production_dims.py::test_identity_key_switch_production_dims",
    "test_sharding.py::test_sharded_circuit_evaluator",
    "test_sharding.py::test_sharded_not_and_mux_bit_exact",
    "test_sharding.py::test_sharded_circuit_unbatched_small_levels",
    "test_sharding.py::test_fetch_nonlead_batch_axis_and_unbatched_bootstrap",
    "test_multihost_procs.py::test_two_process_gate_session",
    "test_ints.py::test_fheuint_mesh_sharded",
    "test_ints.py::test_divmod",
    "test_ints.py::test_signed_divmod",
    "test_ints.py::test_signed_mul_full",
    "test_ints.py::test_width_extension",
    "test_ints.py::test_multidim_batch",
    "test_multibit.py::test_grouped2_odd_n_leftover_step",
    "test_multibit.py::test_grouped2_nand_truth_table",
    "test_params_sweep.py::test_nand_truth_table_across_params",
    "test_bench_smoke.py::test_bench_harness_end_to_end",
    "test_serialization.py::test_cloud_key_and_ciphertext_round_trip",
    "test_trgsw.py::test_cmux_selects_n512",
    "test_radix.py::test_signed_radix",
    "test_radix.py::test_mul",
    "test_radix.py::test_unsigned_select_min_max",
    "test_radix.py::test_bridge_backed_divmod_bitwise",
    "test_radix.py::test_signed_radix_divmod",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        base = f"{item.path.name}::{item.originalname or item.name}"
        if base in _SLOW_TESTS:
            item.add_marker(pytest.mark.slow)
