"""Analytic noise-budget model for gate bootstrapping parameter sets.

The reference hard-codes one parameter set and offers no way to sanity-check
another; this round-1 lesson (the FAST preset decoded 12/8192 gates wrong on
device — a ~3-sigma margin, invisible at test dimensions) is encoded here as
a reusable tool: ``noise_budget(params)`` returns the per-stage error
variances of one bootstrapped gate and the decision margin in sigmas, and
``check_params`` turns that into a pass/warn verdict.

Model (standard TFHE analysis, variances of torus-valued errors in [0,1)):

* fresh gate input: two lv0 ciphertexts summed -> 2 * alpha_lv0^2;
* blind-rotate phase rounding to 2N buckets: the n+1 rounded coefficients
  each contribute U(+-2^-(nbit+2)) -> (n+1) * 2^(-2*(nbit+2)) / 3;
* per CMux step (external product, trgsw.rs:264-306):
    - BK noise term      2 * l * N * (Bg/2)^2 * alpha_lv1^2
      (WORST-CASE digit magnitude Bg/2, deliberately not the uniform-digit
      E[d^2] = Bg^2/12 — see anchor 2 below: the worst-case form is the
      measured-safe direction for a go/no-go tool)
    - gadget rounding    CAL_ROUNDING * (1 + N) * eps^2,
      eps = 2^-(l*bgbit): the production decomp mask's quirky double-added
      rounding bit (params.py make_decomp_mask) BIASES every coefficient's
      rounding the same way within a step, so the N+1 error terms are
      correlated and the effective variance exceeds the independent-uniform
      value; CAL_ROUNDING = 2.5 is fitted to anchor 1
  accumulated over the n steps of the rotation;
* identity key switch (tlwe.rs:43-73):
    - KSK noise          N * iks_l * alpha_lv0^2
    - decomposition drop N * 2^(-2*(iks_basebit*iks_l + 1)) / 3.

The decode decision needs the total phase error below 1/16 (the distance
from the +-1/8 gate constellation to the blind-rotate bucket boundary).

MEASURED CALIBRATION ANCHORS (at production dimensions,
benches/noise_calibration_probe.py; decode-failure statistics of exact
integer arithmetic, so they hold on any device):

1. rounding-dominated axis — FAST preset (l=2, Bg=2^8), 2026-08-18:
   12/8192 wrong gates on device ~ 3.0 sigma one-sided.  This model scores
   FAST at 3.0 sigma (the pre-calibration form scored it 4.3 — optimistic,
   the unsafe direction; CAL_ROUNDING fixes exactly this).
2. BK-noise-dominated axis — DEFAULT with alpha_lv1 raised to 2^-21.5 and
   2^-21.8, 2026-08-20, B=131072 each: this model predicts margins of
   2.8/3.4 sigma (295 and 38 expected failures); MEASURED 0/131072 at
   both, i.e. true margin >= ~4.4 sigma.  The worst-case-digit BK term is
   therefore conservative by >= 1.5x in sigma (consistent with uniform
   digits, E[d^2] = Bg^2/12 = (Bg/2)^2 / 3) — failures it predicts may not
   materialize, but parameter sets it passes are safe on BOTH measured
   axes.
3. direct output-phase measurement at the DEFAULT set — PBS probe,
   B=4096: decrypted bootstrap-output phase error std
   1.08e-2 vs 6.9e-3 predicted (and 18/4096 beyond the 1/32 bucket
   half-width of space-8 PBS — a 2.9-sigma Gaussian tail, self-
   consistent).  At the default axis the model is therefore ~1.6x
   OPTIMISTIC in sigma: a predicted margin of k sigma is ~k/1.6 measured
   (the gates' predicted 9.1 sigma is a true 5.8 — still sound, matching
   0/131072 measured failures).  ``DEFAULT_SIGMA_INFLATION`` below carries
   this anchor; verdicts with tight margins (pbs.check_pbs_space) apply
   it, and predicted margins in the 5-8 sigma band should be read as
   3-5 true sigma.  (Raising CAL_ROUNDING to absorb the excess would
   break anchor 1: FAST would then predict ~2x the failures measured, so
   the excess is NOT of the eps^2 gadget-rounding form; it is recorded
   empirically rather than attributed.)
4. direct output-phase measurement at the PBS preset (params.PBS_PARAMS:
   N=2048, n=714, l=4) — identity-LUT PBS, B=65536:
   measured phase-error std 7.5e-4 vs 2.02e-3 predicted (uninflated) —
   the model is ~2.7x CONSERVATIVE in sigma at this preset (vs ~1.6x
   optimistic at the DEFAULT set, anchor 3; the sign flips because the
   dominant term differs: here it is the modulus-switch drift, whose
   (n+1)-term accounting ignores that only the s_i = 1 coefficients'
   rounding errors reach the phase — binary secrets thin it ~2x — while
   anchor 3's unattributed excess lives elsewhere).  True space-8 margin
   at the preset: 41.6 sigma (0/65536 beyond the half-bucket).  The
   model verdicts therefore carry LARGE real headroom at PBS_PARAMS;
   they are kept as the API gates because conservative-at-the-preset /
   calibrated-at-the-default is the safe direction on both measured
   axes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ..params import TFHEParams

MARGIN = 1.0 / 16.0

# Fitted to anchor 1 (FAST: 12/8192 ~ 3 sigma); see module docstring.
CAL_ROUNDING = 2.5

# Anchor 3: measured/predicted output sigma at the DEFAULT set (1.08e-2 /
# 6.9e-3 ~= 1.6).  Kept as the named constant the round-3/4 BENCH rows
# quote; calibrated_margin() below is the per-preset generalization.
DEFAULT_SIGMA_INFLATION = 1.6

# ---------------------------------------------------------------------- #
# Per-preset calibration (VERDICT r4 #2): the fitted bias is NOT one
# constant — it flips sign between presets (anchor 3 vs anchor 4), so each
# measured preset carries its own true-sigma multiplier, and every shipped
# margin is stated as a LOWER bound under the worst measured direction.
# ---------------------------------------------------------------------- #

#: Measured true-sigma multipliers (measured / predicted output sigma),
#: keyed by the anchor presets.  >1: the model was optimistic there (the
#: unsafe direction); <1: conservative (real headroom).
def _preset_corrections():
    from ..params import DEFAULT_PARAMS, FAST_PARAMS, PBS_PARAMS

    return {
        FAST_PARAMS: 1.0,  # anchor 1: CAL_ROUNDING fitted on this axis
        DEFAULT_PARAMS: DEFAULT_SIGMA_INFLATION,  # anchor 3: 1.08e-2/6.9e-3
        PBS_PARAMS: 7.5e-4 / 2.02e-3,  # anchor 4: ~2.7x conservative
    }


#: Correction applied to UNMEASURED parameter sets: the worst bias
#: direction ever measured (anchor 3's 1.6x optimism).
WORST_CASE_SIGMA_CORRECTION = DEFAULT_SIGMA_INFLATION


def sigma_correction(params: TFHEParams) -> tuple[float, bool]:
    """(true-sigma multiplier, anchored?) for ``params``.

    Anchored presets get their measured correction; anything else gets the
    worst measured direction (a margin quoted through this is a lower
    bound, never a best case)."""
    corr = _preset_corrections().get(params)
    if corr is not None:
        return corr, True
    return WORST_CASE_SIGMA_CORRECTION, False


@dataclass(frozen=True)
class CalibratedMargin:
    """A decision margin stated both ways (VERDICT r4 #2).

    ``predicted_sigmas``: the uncorrected analytic model's margin.
    ``lower_bound_sigmas``: the margin after applying the preset's measured
    sigma correction IN THE UNSAFE DIRECTION ONLY — corrections < 1 (the
    model measured conservative, e.g. PBS_PARAMS) are clamped to 1, so the
    bound never takes credit beyond the analytic prediction from a single
    measured batch.  This is the number every verdict gates on.
    """

    predicted_sigmas: float
    lower_bound_sigmas: float
    sigma_predicted: float
    sigma_correction: float
    anchored: bool

    def describe(self) -> str:
        src = "anchored" if self.anchored else "worst-case (unmeasured set)"
        return (
            f"margin {self.lower_bound_sigmas:.1f} sigma lower bound "
            f"(predicted {self.predicted_sigmas:.1f} sigma, "
            f"sigma={self.sigma_predicted:.2e}, "
            f"correction x{self.sigma_correction:.2f} {src})"
        )


def calibrate(params: TFHEParams, sigma_predicted: float,
              decision_margin: float) -> CalibratedMargin:
    """Apply the preset's measured correction to an already-modeled sigma
    (custom variance models — radix carry sums etc. — enter here)."""
    corr, anchored = sigma_correction(params)
    return CalibratedMargin(
        predicted_sigmas=decision_margin / sigma_predicted,
        lower_bound_sigmas=decision_margin / (sigma_predicted * max(corr, 1.0)),
        sigma_predicted=sigma_predicted,
        sigma_correction=corr,
        anchored=anchored,
    )


def calibrated_margin(params: TFHEParams, decision_margin: float = MARGIN,
                      extra_var: float = 0.0) -> CalibratedMargin:
    """Calibrated (predicted, lower-bound) margin pair for a decision
    half-width ``decision_margin`` (1/16 for gates, 1/(4*space) for PBS),
    with ``extra_var`` added to the modeled phase variance (e.g. the
    pbs_many t^2 drift excess)."""
    nb = noise_budget(params)
    sigma = math.sqrt(nb.sigma_total**2 + extra_var)
    return calibrate(params, sigma, decision_margin)


@dataclass(frozen=True)
class NoiseBudget:
    var_fresh: float
    var_rounding: float
    var_bootstrap: float  # accumulated over the n CMux steps
    var_keyswitch: float
    sigma_total: float
    margin_sigmas: float

    def components(self) -> dict:
        return {
            "fresh_inputs": self.var_fresh,
            "phase_rounding": self.var_rounding,
            "blind_rotate": self.var_bootstrap,
            "key_switch": self.var_keyswitch,
        }


def noise_budget(params: TFHEParams) -> NoiseBudget:
    p = params
    var_fresh = 2.0 * p.alpha_lv0**2
    var_rounding = (p.n + 1) * (2.0 ** (-2 * (p.nbit + 2))) / 3.0

    eps = 2.0 ** -(p.l * p.bgbit)  # uncentered: biased quirky-mask rounding
    var_step = (
        2.0 * p.l * p.N * (p.bg / 2.0) ** 2 * p.alpha_lv1**2
        + CAL_ROUNDING * (1.0 + p.N) * eps**2
    )
    var_bootstrap = p.n * var_step

    var_ks = (
        p.N * p.iks_l * p.alpha_lv0**2
        + p.N * (2.0 ** (-2 * (p.iks_basebit * p.iks_l + 1))) / 3.0
    )

    sigma = math.sqrt(var_fresh + var_rounding + var_bootstrap + var_ks)
    return NoiseBudget(
        var_fresh=var_fresh,
        var_rounding=var_rounding,
        var_bootstrap=var_bootstrap,
        var_keyswitch=var_ks,
        sigma_total=sigma,
        margin_sigmas=MARGIN / sigma,
    )


def check_params(params: TFHEParams, min_sigmas: float = 5.0) -> tuple[bool, str]:
    """(ok, message): ok iff the decode margin's calibrated LOWER BOUND
    exceeds ``min_sigmas``.

    5 sigma ~= 3e-7 per-gate failure — comfortably correct at batch 10^5.
    The bound applies the preset's measured sigma correction in the unsafe
    direction only (``calibrated_margin``): the FAST preset scores 3.0
    sigma here, matching its measured 12/8192 on-device failures; DEFAULT's
    predicted 9.1 sigma is stated as its measured-true 5.7; PBS_PARAMS
    (measured 2.7x conservative) keeps its uncorrected prediction as the
    bound."""
    b = noise_budget(params)
    cm = calibrated_margin(params)
    dominant = max(b.components(), key=lambda k: b.components()[k])
    msg = f"{cm.describe()}; dominant term: {dominant}"
    return cm.lower_bound_sigmas >= min_sigmas, msg
