"""Noise-budget model tests: the analytic margin must separate the
parameter sets whose on-device behavior is known — DEFAULT decodes
8192/8192 gates correctly (>=5 sigma), the FAST preset measured 12/8192
failures (~3 sigma)."""

from rustfhe.params import DEFAULT_PARAMS, FAST_PARAMS, N2048_PARAMS, TEST_PARAMS
from rustfhe.utils.noise import check_params, noise_budget


def test_default_params_have_margin():
    ok, msg = check_params(DEFAULT_PARAMS)
    assert ok, msg
    assert noise_budget(DEFAULT_PARAMS).margin_sigmas > 8


def test_fast_preset_flagged_unsound():
    # Measured on device (BENCH.md 2026-08-18): 12/8192 wrong NANDs ~ 3 sigma.
    b = noise_budget(FAST_PARAMS)
    assert 2.5 < b.margin_sigmas < 4.5, b
    ok, msg = check_params(FAST_PARAMS)
    assert not ok, msg
    # and the failure is decomposition-dominated, as diagnosed.
    comps = b.components()
    assert max(comps, key=comps.get) == "blind_rotate"


def test_other_presets_sound():
    # TEST_PARAMS and N2048_PARAMS are UNMEASURED presets: under the
    # restated contract (VERDICT r4 #2) their margins are worst-case-
    # direction lower bounds — TEST predicts 6.7 sigma (4.2 bound), N2048
    # predicts 7.6 (4.8 bound).  Both clear a 4-sigma bar; neither clears
    # the default 5 any more, and the message must carry the pair.
    for p, name in ((TEST_PARAMS, "TEST"), (N2048_PARAMS, "N2048")):
        ok, msg = check_params(p)
        assert not ok, (name, msg)
        assert "lower bound" in msg and "predicted" in msg, msg
        assert check_params(p, min_sigmas=4.0)[0], (name, msg)


def test_calibrated_margin_pairs():
    # The API returns (predicted, lower-bound) pairs with per-preset
    # corrections: DEFAULT (anchor 3) divides by 1.6; PBS_PARAMS (anchor 4,
    # measured conservative) keeps the prediction as its bound; unmeasured
    # sets get the worst measured direction.
    from rustfhe.params import PBS_PARAMS
    from rustfhe.utils.noise import calibrated_margin

    cm_d = calibrated_margin(DEFAULT_PARAMS)
    assert cm_d.anchored
    assert abs(cm_d.lower_bound_sigmas - cm_d.predicted_sigmas / 1.6) < 1e-9
    cm_p = calibrated_margin(PBS_PARAMS)
    assert cm_p.anchored and cm_p.sigma_correction < 1.0
    assert cm_p.lower_bound_sigmas == cm_p.predicted_sigmas  # clamped at 1
    cm_u = calibrated_margin(N2048_PARAMS)
    assert not cm_u.anchored
    assert abs(cm_u.lower_bound_sigmas - cm_u.predicted_sigmas / 1.6) < 1e-9


def test_default_borderline_pbs_many_gated():
    # VERDICT r4 #2: the DEFAULT-set borderline combo pbs_many(space=4,
    # t=2) — 4.2-sigma calibrated lower bound — must not run silently: the
    # check flags it below the 5-sigma bar and the runtime gate WARNS
    # (below 3 it raises instead — asserted at space=8, a 1.8-sigma bound
    # measured failing 18/4096 on device).
    import jax.numpy as jnp
    import pytest

    from rustfhe import pbs

    ok, msg = pbs.check_pbs_many(DEFAULT_PARAMS, 4, 2)
    assert not ok and "4.2" in msg, msg
    with pytest.warns(UserWarning, match="lower-bound margin"):
        pbs._gate_margin(DEFAULT_PARAMS, 4, 2, False, "pbs_many")
    # below 3 sigma (space=8 at DEFAULT: 1.8-sigma bound, measured failing
    # 18/4096 on device) the public entry refuses before touching the key.
    dummy_ct = jnp.zeros((2, DEFAULT_PARAMS.n + 1), jnp.uint32)
    with pytest.raises(ValueError, match="lower-bound margin"):
        pbs.pbs(None, dummy_ct, jnp.zeros((8,), jnp.uint32),
                space=8, params=DEFAULT_PARAMS)
    # ...and unsafe=True restores the measurement escape hatch (no raise at
    # the gate; the None key then fails later, proving the gate was passed).
    with pytest.raises(Exception) as exc:
        pbs.pbs(None, dummy_ct, jnp.zeros((8,), jnp.uint32),
                space=8, params=DEFAULT_PARAMS, unsafe=True)
    assert "lower-bound margin" not in str(exc.value)


def test_second_calibration_anchor_recorded():
    # Anchor 2 (BK-noise axis, measured 2026-08-20 on device at B=131072,
    # benches/noise_calibration_probe.py): the marginal presets below
    # PREDICT 2.8/3.4 sigma here but MEASURED 0 failures each — the model
    # must keep scoring them in that (conservative) band so the docstring's
    # calibration claim stays true, and must keep flagging them unsound.
    for exp, lo, hi in ((21.5, 2.5, 3.2), (21.8, 3.1, 3.8)):
        p = DEFAULT_PARAMS.replace(alpha_lv1=2.0 ** -exp)
        b = noise_budget(p)
        assert lo < b.margin_sigmas < hi, (exp, b.margin_sigmas)
        ok, _ = check_params(p)
        assert not ok


def test_budget_components_positive():
    b = noise_budget(DEFAULT_PARAMS)
    assert all(v > 0 for v in b.components().values())
    assert abs(
        sum(b.components().values()) - b.sigma_total**2
    ) < 1e-12
