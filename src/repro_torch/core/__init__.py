"""ORCA core, PyTorch port: probe, TTT inner/outer loops, LTT calibration
(numpy, shared verbatim with the JAX package), stopping and labels."""
from repro_torch.core.probe import ProbeConfig, init_outer, smooth_scores
from repro_torch.core.ttt import (batched_unroll, deployed_scores,
                                  inner_unroll, meta_train, outer_loss)
from repro_torch.core.calibrator import (Calibrator, TTTCalibrator,
                                         make_calibrator)

__all__ = ["Calibrator", "ProbeConfig", "TTTCalibrator", "batched_unroll",
           "deployed_scores", "init_outer", "inner_unroll",
           "make_calibrator", "meta_train", "outer_loss", "smooth_scores"]
