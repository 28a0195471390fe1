"""Meta-training of the TTT probe at the offline phase's width (d_phi 960,
smollm-360m's), held to the JAX package on the CPU.

The tests hold the outer loss and its gradient at that width, for the
no-QK probe and the QK probe (d_h 128), on corpus trajectories from the
same theta0: everything a minibatch step of ``meta_train`` differentiates.

Run as a script, it fits both packages' TTT calibrators with the offline
phase's recipe (supervised, 35 epochs, batch 64, outer lr 1e-2, epoch
selection) on ``corpus_splits(500, 170, 170, d_phi=960)`` from one theta0,
evaluates them at every delta, and prints one JSON line per run: the
per-epoch loss and validation savings and the Table 2 row.  A third run
repeats the JAX fit on features moved by one ulp, which shows how far
float summation order alone carries the training curve:

    PYTHONPATH=src python tests/test_torch_train_reference.py \\
        [--epochs 35] [--variants noqk,qk]
"""
import argparse
import json
import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import ttt as jttt
from repro.core.pipeline import make_labels as j_make_labels
from repro.core.probe import ProbeConfig as JProbeConfig
from repro.core.probe import init_outer as j_init_outer
from repro.trajectories import corpus_splits as j_corpus_splits

from repro_torch import api
from repro_torch.core import ttt
from repro_torch.core.probe import ProbeConfig
from repro_torch.models.convert import from_jax_theta
from repro_torch.trajectories import corpus_splits

D_PHI = 960
VARIANTS = {"noqk": {}, "qk": dict(variant="qk", d_h=128)}
# f32 sums over 120 steps and 960 features in another order than XLA's
RTOL_GRAD = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _theta0(variant, seed=0):
    jtheta = j_init_outer(JProbeConfig(d_phi=D_PHI, **VARIANTS[variant]),
                          jax.random.PRNGKey(seed))
    return jtheta, from_jax_theta({k: np.asarray(v) for k, v in
                                   jtheta.items()}, device="cpu")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_outer_gradient_matches_jax_at_offline_width(variant):
    jtrain = j_corpus_splits(12, 2, 2, d_phi=D_PHI)[0]
    train = corpus_splits(12, 2, 2, d_phi=D_PHI)[0]
    np.testing.assert_array_equal(train.phis, jtrain.phis)
    labels = j_make_labels(jtrain, "supervised")
    jpc = JProbeConfig(d_phi=D_PHI, **VARIANTS[variant])
    pc = ProbeConfig(d_phi=D_PHI, **VARIANTS[variant])
    jtheta, theta = _theta0(variant)
    jloss, jgrad = jax.value_and_grad(lambda th: jttt.outer_loss(
        jpc, th, jnp.asarray(jtrain.phis), jnp.asarray(labels),
        jnp.asarray(jtrain.mask)))(jtheta)
    leaves = {k: v.requires_grad_(True) for k, v in theta.items()}
    loss = ttt.outer_loss(pc, leaves, torch.from_numpy(train.phis),
                          torch.from_numpy(labels).float(),
                          torch.from_numpy(train.mask))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-6)
    for k, g in zip(leaves, grads):
        ref = np.asarray(jgrad[k])
        rel = np.linalg.norm(g.numpy() - ref) / np.linalg.norm(ref)
        assert rel < RTOL_GRAD, (k, rel)


def _row(ev):
    return [dict(delta=r.delta, lam=r.lam if math.isfinite(r.lam) else None,
                 savings=r.savings, error=r.error) for r in ev.results]


def _run(name, fit, evaluate):
    t0 = time.perf_counter()
    cal = fit()
    fit_s = time.perf_counter() - t0
    hist = cal.probe.history
    print(json.dumps(dict(
        run=name, fit_s=fit_s, loss=[h["loss"] for h in hist],
        val_savings=[h["val_savings"] for h in hist],
        rows=_row(evaluate(cal)))), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=35)
    ap.add_argument("--variants", default="noqk,qk")
    args = ap.parse_args()
    torch.set_num_threads(4)
    jsplits = j_corpus_splits(500, 170, 170, d_phi=D_PHI)
    splits = corpus_splits(500, 170, 170, d_phi=D_PHI)
    deltas = api.DELTAS
    for variant in args.variants.split(","):
        kw = dict(epochs=args.epochs, batch_size=64, outer_lr=1e-2, seed=0,
                  epoch_select=True)
        jpc = JProbeConfig(d_phi=D_PHI, **VARIANTS[variant])
        _run(f"jax-{variant}",
             lambda: japi.fit(jsplits[0], "supervised", "ttt", pc=jpc, **kw),
             lambda c: japi.evaluate(c, *jsplits[1:], deltas=deltas))
        theta0 = _theta0(variant)[1]
        _run(f"torch-cpu-{variant}",
             lambda: api.make_calibrator(
                 "ttt", pc=ProbeConfig(d_phi=D_PHI, **VARIANTS[variant]),
                 device="cpu", **kw).fit(splits[0], "supervised",
                                         theta0=theta0),
             lambda c: api.evaluate(c, *splits[1:], deltas=deltas))
        moved = jsplits[0].subset(np.arange(len(jsplits[0])))
        moved.phis = np.nextafter(moved.phis, np.float32(np.inf))
        _run(f"jax-{variant}-1ulp",
             lambda: japi.fit(moved, "supervised", "ttt", pc=jpc, **kw),
             lambda c: japi.evaluate(c, *jsplits[1:], deltas=deltas))


if __name__ == "__main__":
    main()
