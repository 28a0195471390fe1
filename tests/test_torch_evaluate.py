"""The port's offline evaluation (``api.evaluate``, ``core/pipeline.py``,
``core/static_probe.py``, ``StaticCalibrator``, ``core/recalibration.py``)
held to the JAX package on the CPU.  The TTT probe's slow weights are
trained once in JAX and carried across as numpy, and the static probe's
PCA + logreg likewise: the two packages draw minibatches in different
orders, so scoring and evaluation are compared from the same weights, not
training runs."""
import dataclasses
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import ttt as jttt
from repro.core.calibrator import StaticCalibrator as JStaticCalibrator
from repro.core.calibrator import TTTCalibrator as JTTTCalibrator
from repro.core.calibrator import make_calibrator as j_make_calibrator
from repro.core.pipeline import evaluate_probe as j_evaluate_probe
from repro.core.pipeline import make_labels as j_make_labels
from repro.core.pipeline import train_ttt_probe as j_train
from repro.core.probe import ProbeConfig as JProbeConfig
from repro.core.probe import init_outer as j_init_outer
from repro.core.recalibration import OnlineRecalibrator as JRecalibrator
from repro.core.recalibration import RecalibratorConfig as JRecalConfig
from repro.core.static_probe import fit_static_probe as j_fit_static
from repro.trajectories import corpus_splits as j_corpus_splits

from repro_torch import api
from repro_torch.core import ttt
from repro_torch.core.calibrator import (StaticCalibrator, TTTCalibrator,
                                         make_calibrator)
from repro_torch.core.pipeline import (TrainedProbe, evaluate_probe,
                                       make_labels, run_orca)
from repro_torch.core.probe import ProbeConfig
from repro_torch.core.recalibration import (OnlineRecalibrator,
                                            RecalibratorConfig)
from repro_torch.core.static_probe import StaticProbe, fit_static_probe
from repro_torch.models.convert import from_jax_theta
from repro_torch.trajectories import corpus_splits

D = 16
DELTAS = (0.05, 0.1, 0.15, 0.2)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def splits():
    """(JAX splits, port splits): the same numpy generator in each."""
    j = j_corpus_splits(60, 40, 40, d_phi=D, seed=3)
    t = corpus_splits(60, 40, 40, d_phi=D, seed=3)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(a.phis, b.phis)
    return j, t


@pytest.fixture(scope="module")
def jprobe(splits):
    """The TTT probe, meta-trained once in JAX (full batch, no epoch
    selection)."""
    (jtrain, _, _), _ = splits
    return j_train(jtrain, "supervised", JProbeConfig(d_phi=D), epochs=3,
                   batch_size=len(jtrain), epoch_select=False, seed=3)


def _as_port_theta(jtheta):
    return from_jax_theta({k: np.asarray(v) for k, v in jtheta.items()},
                          device="cpu")


def _calibrators(jprobe, mode):
    """The JAX TTT calibrator around ``jprobe`` and the port's around the
    same slow weights, both bound to ``mode``."""
    jcal = JTTTCalibrator(pc=jprobe.pc)
    jcal.probe, jcal.mode = jprobe, mode
    pc = ProbeConfig(**dataclasses.asdict(jprobe.pc))
    cal = TTTCalibrator(pc=pc, device="cpu")
    cal.probe = TrainedProbe(pc, _as_port_theta(jprobe.theta), [])
    cal.mode = mode
    return jcal, cal


def _same_results(port, ref):
    """Equal lambda* at every delta, savings and error to float64 noise."""
    assert [r.delta for r in port] == [r.delta for r in ref]
    for a, b in zip(port, ref):
        assert a.lam == b.lam, (a.delta, a.lam, b.lam)
        assert a.savings == pytest.approx(b.savings, abs=1e-12)
        assert a.error == pytest.approx(b.error, abs=1e-12)


@pytest.mark.parametrize("variant,extra", [
    ("noqk", {}), ("qk", dict(layernorm=True, mlp=True))])
def test_deployed_scores_match_jax(splits, variant, extra):
    (_, jcal, _), (_, cal, _) = splits
    jpc = JProbeConfig(d_phi=D, variant=variant, d_h=8, smooth_window=4,
                       **extra)
    jtheta = j_init_outer(jpc, jax.random.PRNGKey(7))
    pc = ProbeConfig(**dataclasses.asdict(jpc))
    j_s = np.asarray(jttt.deployed_scores(jpc, jtheta, jnp.asarray(jcal.phis),
                                          jnp.asarray(jcal.mask)))
    t_s = ttt.deployed_scores(pc, _as_port_theta(jtheta),
                              torch.from_numpy(cal.phis),
                              torch.from_numpy(cal.mask)).numpy()
    # f32 sums in another order than XLA's, over up to 120 dependent steps
    np.testing.assert_allclose(t_s, j_s, rtol=0, atol=2e-5)


@pytest.mark.parametrize("mode", ["supervised", "consistent"])
def test_ttt_evaluate_matches_jax_at_every_delta(splits, jprobe, mode):
    (_, jc, jt), (_, c, t) = splits
    jcal, cal = _calibrators(jprobe, mode)
    ref = japi.evaluate(jcal, jc, jt, deltas=DELTAS)
    ev = api.evaluate(cal, c, t, deltas=DELTAS)
    assert (ev.method, ev.mode) == ("ttt", mode)
    _same_results(ev.results, ref.results)
    # and the pipeline function on the port's own scores
    direct = evaluate_probe(cal.scores(c), c, cal.scores(t), t, mode, DELTAS)
    _same_results(direct.results, j_evaluate_probe(
        jcal.scores(jc), jc, jcal.scores(jt), jt, mode, DELTAS).results)
    assert ev.at(0.1).lam == ref.at(0.1).lam
    with pytest.raises(KeyError):
        ev.at(0.3)
    if mode == "supervised":
        assert any(math.isfinite(r.lam) and r.savings > 0
                   for r in ev.results)


@pytest.fixture(scope="module")
def statics(splits):
    """JAX's fitted static probe and the port's fit on the same data."""
    (jtrain, _, _), (train, _, _) = splits
    args = (j_make_labels(jtrain, "supervised"), jtrain.mask)
    jp = j_fit_static(jtrain.phis, *args)
    tp = fit_static_probe(train.phis, make_labels(train, "supervised"),
                          train.mask, device="cpu")
    return jp, tp


def test_fit_static_probe_matches_jax(statics):
    jp, tp = statics
    np.testing.assert_allclose(tp.mean, jp.mean, rtol=0, atol=1e-10)
    np.testing.assert_allclose(tp.components, jp.components, rtol=0,
                               atol=1e-10)
    # 200 full-batch Adam steps in f32, another reduction order than XLA's
    np.testing.assert_allclose(tp.w, jp.w, rtol=0, atol=1e-5)
    assert tp.b == pytest.approx(jp.b, abs=1e-5)
    assert (tp.smooth_window, tp.components.shape) == (10, (D, D))


def _static_pair(jp, mode):
    jcal = JStaticCalibrator()
    jcal.probe, jcal.mode = jp, mode
    cal = StaticCalibrator(device="cpu")
    cal.probe = StaticProbe(jp.mean, jp.components, jp.w, jp.b,
                            jp.smooth_window)
    cal.mode = mode
    return jcal, cal


def test_static_evaluate_matches_jax_at_every_delta(splits, statics):
    (_, jc, jt), (_, c, t) = splits
    jcal, cal = _static_pair(statics[0], "supervised")
    np.testing.assert_allclose(cal.scores(t), jcal.scores(jt), rtol=0,
                               atol=1e-6)
    ev = api.evaluate(cal, c, t, deltas=DELTAS)
    assert ev.method == "static"
    _same_results(ev.results, japi.evaluate(jcal, jc, jt,
                                            deltas=DELTAS).results)
    assert cal.calibrate(c, 0.2) == jcal.calibrate(jc, 0.2)


def test_static_serving_params_round_trip(splits, statics):
    """PCA + logreg flattened into a frozen no-QK probe (eta = 0): JAX's
    flattening, and the deployed TTT pass over it (K5's plain version with
    eta = 0) gives back ``scores()``."""
    (_, jc, _), (_, c, _) = splits
    jcal, cal = _static_pair(statics[0], "supervised")
    pc, theta = cal.serving_params()
    jpc, jtheta = jcal.serving_params()
    assert pc == ProbeConfig(**dataclasses.asdict(jpc))
    assert pc.eta == 0.0 and pc.variant == "noqk" and pc.d_phi == D
    for k in ("W0", "b0"):
        assert theta[k].dtype == torch.float32
        np.testing.assert_allclose(theta[k].numpy(), np.asarray(jtheta[k]),
                                   rtol=0, atol=1e-6)
    served = ttt.deployed_scores(pc, theta, torch.from_numpy(c.phis),
                                 torch.from_numpy(c.mask)).numpy() * c.mask
    np.testing.assert_allclose(served, cal.scores(c), rtol=0, atol=1e-5)
    with pytest.raises(RuntimeError):
        StaticCalibrator(device="cpu").serving_params()


def test_make_calibrator_registry():
    assert isinstance(make_calibrator("ttt", epochs=1), TTTCalibrator)
    assert isinstance(make_calibrator("static", device="cpu"),
                      StaticCalibrator)
    with pytest.raises(ValueError) as port:
        make_calibrator("nope")
    with pytest.raises(ValueError) as ref:
        j_make_calibrator("nope")
    assert str(port.value) == str(ref.value)
    assert "known: ['static', 'ttt']" in str(port.value)


def test_online_recalibrator_matches_jax(splits, jprobe):
    """One seeded stream of deployed problems through both: the same
    lambda* history and the same decisions."""
    (_, jc, jt), _ = splits
    jcal, _ = _calibrators(jprobe, "supervised")
    stream = [(jcal.scores(ts), j_make_labels(ts, "supervised"), ts)
              for ts in (jc, jt)]
    kw = dict(delta=0.2, window=50, every=10, min_window=20)
    rec, jrec = (OnlineRecalibrator(RecalibratorConfig(**kw)),
                 JRecalibrator(JRecalConfig(**kw)))
    order = np.random.default_rng(4).permutation(80)
    for i in order:
        s, lab, ts = stream[i // 40]
        T = ts.lengths[i % 40]
        assert rec.decide(s[i % 40, :T]) == jrec.decide(s[i % 40, :T])
        rec.observe(s[i % 40, :T], lab[i % 40, :T])
        jrec.observe(s[i % 40, :T], lab[i % 40, :T])
    assert rec.history == jrec.history
    assert len(rec.history) >= 5 and np.isfinite(rec.lam)


def test_run_orca_equals_the_facade(splits):
    """The deprecated shim gives the facade's numbers exactly."""
    _, (train, cal, test) = splits
    kw = dict(pc=ProbeConfig(d_phi=D), epochs=2, seed=3, device="cpu")
    with pytest.warns(DeprecationWarning, match="run_orca"):
        out = run_orca(train, cal, test, deltas=(0.1, 0.2), **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ttt_cal = api.fit(train, mode="supervised", method="ttt", **kw)
        static = api.fit(train, mode="supervised", method="static",
                         device="cpu")
    for key, calib in (("ttt", ttt_cal), ("static", static)):
        _same_results(out[key].results,
                      api.evaluate(calib, cal, test, deltas=(0.1, 0.2))
                      .results)
    assert isinstance(out["_probe"], TrainedProbe)
    assert isinstance(out["_static"], StaticProbe)
