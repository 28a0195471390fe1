"""ORCA core, PyTorch port: the paper's contribution.

probe        — probe variants (no-QK / QK / +LN / +residual / +MLP / eta)
ttt          — inner-loop unroll + outer meta-training (Algorithm 1)
calibration  — LTT (binomial p-values + fixed-sequence testing), conformal
stopping     — deployed procedure A_lambda, risk / savings metrics (Alg. 2)
labels       — supervised / consistent step labels
static_probe — PCA + logistic-regression baseline (Thought Calibration)
pipeline     — end-to-end train -> calibrate -> evaluate convenience API
recalibration — rolling-window online LTT under drift

calibration, stopping, labels and recalibration are numpy, shared
verbatim with the JAX package.
"""
from repro_torch.core.probe import ProbeConfig, init_outer, smooth_scores
from repro_torch.core.ttt import (batched_unroll, deployed_scores,
                                  inner_unroll, meta_train, outer_loss)
from repro_torch.core.calibration import (LTTResult, binomial_pvalue,
                                          conformal_quantile, default_grid,
                                          ltt_calibrate)
from repro_torch.core.stopping import (EvalResult, calibrate_and_evaluate,
                                       procedure_risk, savings, step_savings,
                                       stop_times, sweep_deltas)
from repro_torch.core.labels import (consistent_labels, supervised_labels,
                                     transition_time)
from repro_torch.core.static_probe import StaticProbe, fit_static_probe
from repro_torch.core.calibrator import (Calibrator, GroupCalibrator,
                                         GroupTrace, StaticCalibrator,
                                         TTTCalibrator,
                                         groups_from_trajectories,
                                         make_calibrator)

__all__ = [
    "ProbeConfig", "init_outer", "smooth_scores", "batched_unroll",
    "deployed_scores", "inner_unroll", "meta_train", "outer_loss",
    "LTTResult", "binomial_pvalue", "conformal_quantile", "default_grid",
    "ltt_calibrate", "EvalResult", "calibrate_and_evaluate", "procedure_risk",
    "savings", "step_savings", "stop_times", "sweep_deltas",
    "consistent_labels", "supervised_labels", "transition_time",
    "StaticProbe", "fit_static_probe", "Calibrator", "GroupCalibrator",
    "GroupTrace", "StaticCalibrator", "TTTCalibrator",
    "groups_from_trajectories", "make_calibrator",
]
