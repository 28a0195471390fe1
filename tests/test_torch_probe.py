"""The port's probe path (K1's plain version, the engine's probe update, the
TTT unroll and meta-training, LTT calibration) held to the JAX package on
the CPU, on the same numpy-made inputs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ttt as jttt
from repro.core.calibrator import TTTCalibrator as JTTTCalibrator
from repro.core.pipeline import make_labels as j_make_labels
from repro.core.pipeline import train_ttt_probe as j_train
from repro.core.probe import ProbeConfig as JProbeConfig
from repro.core.probe import init_outer as j_init_outer
from repro.kernels import ref as jref
from repro.kernels.ttt_probe import serving_probe_step as j_probe_step
from repro.optim import Adam as JAdam
from repro.serving import engine as jeng
from repro.trajectories import synthetic as jsyn

from repro_torch.core import ttt as tttt
from repro_torch.core.calibrator import TTTCalibrator
from repro_torch.core.pipeline import train_ttt_probe as t_train
from repro_torch.core.probe import ProbeConfig
from repro_torch.kernels.probe_step import serving_probe_step
from repro_torch.models.convert import from_jax_theta
from repro_torch.optim import Adam
from repro_torch.serving import engine as teng
from repro_torch.trajectories import synthetic as tsyn

# s, W, b, smoothed: f32 sums in another order than XLA's
ATOL_PROBE = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _probe_inputs(B, f=24, win=4, seed=0):
    """Per-slot state covering stopped, burn-in, mid-ring and full-ring
    rows, with a stop that fires this step on row 0."""
    rng = np.random.default_rng(seed)
    zq = rng.standard_normal((B, f)).astype(np.float32)
    zk = rng.standard_normal((B, f)).astype(np.float32)
    W = (rng.standard_normal((B, f)) / np.sqrt(f)).astype(np.float32)
    b = rng.uniform(-3, 3, B).astype(np.float32)
    ring = rng.uniform(0.0, 1.0, (B, win)).astype(np.float32)
    n = rng.integers(0, 9, B).astype(np.int32)
    stopped = rng.random(B) < 0.25
    stop_step = np.where(stopped, n, -1).astype(np.int32)
    boundary = rng.random(B) < 0.7
    # row 0: a stop fires now (high score, full high ring, past burn-in)
    b[0], ring[0], n[0] = 6.0, 0.95, 5
    stopped[0], stop_step[0], boundary[0] = False, -1, True
    if B > 1:   # row 1: in burn-in, boundary, low scores
        b[1], n[1], stopped[1], stop_step[1], boundary[1] = -4.0, 0, False, -1, True
    return dict(zq=zq, zk=zk, boundary=boundary, W=W, b=b, ring=ring,
                n_scores=n, stopped=stopped, stop_step=stop_step)


def _check_out(port, ref):
    for name in ("s", "W", "b", "ring", "smoothed"):
        np.testing.assert_allclose(port[name], ref[name], rtol=0,
                                   atol=ATOL_PROBE, err_msg=name)
    for name in ("n_scores", "stopped", "stop_step"):
        np.testing.assert_array_equal(port[name], ref[name], err_msg=name)


@pytest.mark.parametrize("B", [1, 3, 8])
def test_probe_step_plain_matches_pallas_and_ref(B):
    x = _probe_inputs(B, seed=B)
    eta, lam, burn_in = 0.05, 0.7, 2
    args = [x[k] for k in ("zq", "zk", "boundary", "W", "b", "ring",
                           "n_scores", "stopped", "stop_step")]
    j_kernel = j_probe_step(*[jnp.asarray(a) for a in args], eta, lam,
                            burn_in=burn_in, interpret=True)
    j_oracle = jref.serving_probe_step_ref(*[jnp.asarray(a) for a in args],
                                           eta, lam, burn_in=burn_in)
    t_args = [torch.from_numpy(np.array(a)) for a in args]
    out = serving_probe_step(*t_args, eta, lam, burn_in=burn_in)
    port = {k: getattr(out, k).numpy() for k in out._fields}
    assert out.W is t_args[3] and out.stopped is t_args[7]   # in place
    assert port["stopped"][0] and port["stop_step"][0] == 6
    for ref in (j_kernel, j_oracle):
        _check_out(port, {k: np.asarray(getattr(ref, k))
                          for k in ref._fields})


def _hidden_run(B, d, T, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((T, B, d)).astype(np.float32)


@pytest.mark.parametrize("tps", [1, 3])
def test_probe_update_state_matches_jax_over_token_run(tps):
    """The port launches K1 every token; the JAX engine skips its kernel
    unless some row is at a boundary.  The resulting states must agree
    over runs with (tps=1) and without (tps=3, mid-step tokens)
    boundaries."""
    B, d, T = 3, 16, 12
    jpc = JProbeConfig(d_phi=d, smooth_window=3)
    jtheta = j_init_outer(jpc, jax.random.PRNGKey(1))
    jtheta["b0"] = jnp.asarray(1.5)
    pc = ProbeConfig(d_phi=d, smooth_window=3)
    theta = from_jax_theta({k: np.asarray(v) for k, v in jtheta.items()},
                           device="cpu")
    lam, burn_in = 0.6, 1
    jst = jeng.init_probe_state(jpc, jtheta, B, d)
    jst = jst._replace(stopped=jst.stopped.at[2].set(True))
    st = teng.init_probe_state(pc, theta, B, d)
    st.stopped[2] = True
    hid = _hidden_run(B, d, T, seed=tps)
    eta = float(np.asarray(jnp.asarray(jpc.eta, jnp.float32)))
    jupdate = jax.jit(lambda th, s_, h: jeng.probe_update(
        jpc, th, s_, h, lam, tps, burn_in, interpret=True))
    for t in range(T):
        jst = jupdate(jtheta, jst, jnp.asarray(hid[t]))
        st = teng.probe_update(pc, theta, st, torch.from_numpy(hid[t]), lam,
                               tps, burn_in, eta)
        for name in jst._fields:
            a, b = np.asarray(getattr(jst, name)), getattr(st, name).numpy()
            if a.dtype.kind in "fc":
                np.testing.assert_allclose(b, a, rtol=0, atol=ATOL_PROBE,
                                           err_msg=f"{name} @ token {t}")
            else:
                np.testing.assert_array_equal(b, a, err_msg=f"{name} @ {t}")
    assert np.asarray(jst.n_scores).max() > 0


def _traj_pair(n=16, d=24, seed=0):
    kw = dict(d_phi=d, t_min=8, t_max=14)
    return (jsyn.generate(jsyn.TrajectoryDistribution("p", **kw), n, seed),
            tsyn.generate(tsyn.TrajectoryDistribution("p", **kw), n, seed))


@pytest.mark.parametrize("variant", ["noqk", "qk"])
def test_deployed_scores_match_jax(variant):
    jts, ts = _traj_pair()
    np.testing.assert_array_equal(jts.phis, ts.phis)
    jpc = JProbeConfig(d_phi=24, variant=variant, d_h=8, smooth_window=3)
    pc = ProbeConfig(**dataclasses.asdict(jpc))
    jtheta = j_init_outer(jpc, jax.random.PRNGKey(3))
    theta = from_jax_theta({k: np.asarray(v) for k, v in jtheta.items()},
                           device="cpu")
    j_s = np.asarray(jttt.deployed_scores(jpc, jtheta, jnp.asarray(jts.phis),
                                          jnp.asarray(jts.mask)))
    t_s = tttt.deployed_scores(pc, theta, torch.from_numpy(ts.phis),
                               torch.from_numpy(ts.mask)).numpy()
    np.testing.assert_allclose(t_s, j_s, rtol=0, atol=1e-5)


def test_train_ttt_probe_and_ltt_lambda_match_jax():
    """A few full-batch epochs from the same theta (the minibatch order is
    then immaterial): trained slow weights, deployed scores within 1e-5 and
    the same LTT lambda*."""
    jts, ts = _traj_pair(n=16, seed=1)
    jcal_ts, cal_ts = _traj_pair(n=16, seed=2)
    jpc = JProbeConfig(d_phi=24, smooth_window=3)
    pc = ProbeConfig(**dataclasses.asdict(jpc))
    kw = dict(epochs=3, batch_size=16, outer_lr=1e-2, seed=0,
              epoch_select=False)
    jprobe = j_train(jts, "consistent", jpc, **kw)
    theta0 = from_jax_theta({k: np.asarray(v) for k, v in
                             j_init_outer(jpc, jax.random.PRNGKey(0)).items()},
                            device="cpu")
    cal = TTTCalibrator(pc=pc, device="cpu", **kw).fit(ts, "consistent",
                                                       theta0=theta0)
    for k, v in jprobe.theta.items():
        np.testing.assert_allclose(cal.probe.theta[k].numpy(), np.asarray(v),
                                   rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(cal.scores(cal_ts), jprobe.scores(jcal_ts),
                               rtol=0, atol=1e-5)
    jcal = JTTTCalibrator(pc=jpc, **kw)
    jcal.probe, jcal.pc, jcal.mode = jprobe, jpc, "consistent"
    lams = [cal.calibrate(cal_ts, delta) for delta in (0.1, 0.2, 0.3)]
    assert lams == [jcal.calibrate(jcal_ts, d) for d in (0.1, 0.2, 0.3)]
    assert np.isfinite(lams).any()


# Probe variants past the no-QK default, for the training parity tests
_TRAIN_VARIANTS = {
    "qk": dict(variant="qk", d_h=8),
    "qk-ln-mlp": dict(variant="qk", d_h=8, layernorm=True, mlp=True),
    "qk-bptt4": dict(variant="qk", d_h=8, bptt_truncation=4),
    "learnable-eta": dict(learnable_eta=True),
    "true-labels": dict(inner_label_mode="true"),
}


def _jax_theta0(jpc, seed=0):
    jtheta = j_init_outer(jpc, jax.random.PRNGKey(seed))
    return jtheta, from_jax_theta({k: np.asarray(v) for k, v in
                                   jtheta.items()}, device="cpu")


def _assert_theta_close(theta, jtheta, atol):
    assert sorted(theta) == sorted(jtheta)
    for k, v in jtheta.items():
        np.testing.assert_allclose(theta[k].numpy(), np.asarray(v), rtol=0,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("name", sorted(_TRAIN_VARIANTS))
def test_full_batch_fit_matches_jax(name):
    """Three full-batch epochs (order-free) from the same theta0, with the
    paper's epoch selection on: per-epoch loss and validation savings, the
    kept slow weights within 1e-5 and the deployed scores within 1e-5."""
    jts, ts = _traj_pair(n=24, seed=4)
    jpc = JProbeConfig(d_phi=24, smooth_window=3, **_TRAIN_VARIANTS[name])
    pc = ProbeConfig(**dataclasses.asdict(jpc))
    kw = dict(epochs=3, batch_size=16, outer_lr=1e-2, seed=0,
              epoch_select=True)     # 24 = 8 validation + 16 training
    jprobe = j_train(jts, "supervised", jpc, **kw)
    probe = t_train(ts, "supervised", pc, device="cpu",
                    theta0=_jax_theta0(jpc)[1], **kw)
    for h, jh in zip(probe.history, jprobe.history, strict=True):
        assert h["loss"] == pytest.approx(jh["loss"], rel=1e-5)
        assert h["val_savings"] == pytest.approx(jh["val_savings"], abs=1e-9)
    _assert_theta_close(probe.theta, jprobe.theta, 1e-5)
    np.testing.assert_allclose(probe.scores(ts), jprobe.scores(jts), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["qk-ln-mlp", "learnable-eta"])
def test_minibatch_meta_train_matches_jax_outer_steps(name):
    """The port's minibatch loop, in the order its generator draws (the
    remainder of each epoch dropped), against the JAX package's jitted
    outer step fed the same minibatches in the same order: per-epoch loss
    and the slow weights after two epochs."""
    jts, ts = _traj_pair(n=16, seed=5)
    jpc = JProbeConfig(d_phi=24, smooth_window=3, **_TRAIN_VARIANTS[name])
    pc = ProbeConfig(**dataclasses.asdict(jpc))
    labels = j_make_labels(jts, "supervised")
    epochs, bs = 2, 6
    jtheta, theta0 = _jax_theta0(jpc, seed=1)
    theta, hist = tttt.meta_train(
        pc, theta0, Adam(lr=1e-2, clip_norm=1.0), torch.from_numpy(ts.phis),
        torch.from_numpy(labels), torch.from_numpy(ts.mask), epochs=epochs,
        batch_size=bs, generator=torch.Generator().manual_seed(7))
    jopt = JAdam(lr=1e-2, clip_norm=1.0)
    jstep, jstate = jttt.make_outer_step(jpc, jopt), jopt.init(jtheta)
    gen = torch.Generator().manual_seed(7)
    for epoch in range(epochs):
        order = torch.randperm(len(jts), generator=gen).numpy()
        losses = []
        for i in range(0, len(jts) - bs + 1, bs):
            idx = order[i:i + bs]
            jtheta, jstate, loss = jstep(
                jtheta, jstate, jnp.asarray(jts.phis[idx]),
                jnp.asarray(labels[idx]), jnp.asarray(jts.mask[idx]))
            losses.append(float(loss))
        assert len(losses) == 2
        assert hist[epoch]["loss"] == pytest.approx(np.mean(losses), rel=1e-5)
    _assert_theta_close(theta, jtheta, 1e-5)
