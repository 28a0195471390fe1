"""The port's serving stack (``ContinuousServingEngine`` under
``OrcaScheduler``, dense and paged KV) held to the JAX package's on the
reduced smollm-360m with weights and probe slow weights carried across:
per-request stop steps, emitted tokens, admission and completion steps are
exactly equal, and the page pool drains.  Plus one CPU run of the port's
serving driver."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.probe import ProbeConfig as JProbeConfig
from repro.core.probe import init_outer as j_init_outer
from repro.models import build as j_build
from repro.serving import OrcaScheduler as JOrcaScheduler
from repro.serving import ServeConfig as JServeConfig
from repro.serving import make_request as j_make_request

from repro_torch.configs import get_config
from repro_torch.core.probe import ProbeConfig
from repro_torch.launch import serve as tserve
from repro_torch.models import build
from repro_torch.models.convert import from_jax_params, from_jax_theta
from repro_torch.serving import OrcaScheduler, RequestState, ServeConfig
from repro_torch.serving import make_request

# prompt lengths: the third repeats the first prompt (a prefix hit in paged
# mode: shared full pages plus a copied partial tail page)
LENS = (9, 13, 9, 6, 11)
# per-request budgets: the short ones FINISH before the burn-in lets them
# stop, the rest are STOPPED by the probe
BUDGETS = (12, 3, 12, 12, 4)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def models():
    jcfg = j_get_config("smollm-360m").reduced()
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build(get_config("smollm-360m").reduced())
    params = from_jax_params(jax.tree.map(np.asarray, jparams),
                             device="cpu")
    # decisive probe (the ``_probe(cfg, 3.0)`` pattern of the JAX suite):
    # scores sit far above lambda*, so no stop hangs on a near tie
    jpc = JProbeConfig(d_phi=jcfg.d_model, smooth_window=2)
    jtheta = j_init_outer(jpc, jax.random.PRNGKey(1))
    jtheta["b0"] = jnp.asarray(3.0)
    pc = ProbeConfig(d_phi=jcfg.d_model, smooth_window=2)
    theta = from_jax_theta({k: np.asarray(v) for k, v in jtheta.items()},
                           device="cpu")
    return (jmodel, jparams, jpc, jtheta), (model, params, pc, theta)


def _prompts(vocab):
    rng = np.random.default_rng(17)
    out = [rng.integers(0, vocab, n).astype(np.int32) for n in LENS]
    out[2] = out[0].copy()
    return out


@pytest.mark.parametrize("paged", [False, True])
def test_scheduler_stops_and_tokens_match_jax(models, paged):
    (jmodel, jparams, jpc, jtheta), (model, params, pc, theta) = models
    kw = dict(tokens_per_step=2, max_new_tokens=12, lam=0.6, burn_in=1,
              n_slots=2, paged=paged, block_size=4)
    prompts = _prompts(model.cfg.vocab_size)
    jsched = JOrcaScheduler(jmodel, jparams, jpc, jtheta, JServeConfig(**kw))
    jdone, jfleet = jsched.run([j_make_request(p, max_new_tokens=n)
                                for p, n in zip(prompts, BUDGETS)])
    sched = OrcaScheduler(model, params, pc, theta, ServeConfig(**kw))
    done, fleet = sched.run([make_request(p, max_new_tokens=n)
                             for p, n in zip(prompts, BUDGETS)])
    states = [r.state.value for r in done]
    assert states == [r.state.value for r in jdone]
    assert set(states) == {RequestState.STOPPED.value,
                           RequestState.FINISHED.value}
    for r, jr in zip(done, jdone):
        assert r.stop_step == jr.stop_step, r.req_id
        assert r.tokens == jr.tokens, r.req_id
        assert r.admitted_step == jr.admitted_step, r.req_id
        assert r.completed_step == jr.completed_step, r.req_id
        assert r.slot == jr.slot, r.req_id
        np.testing.assert_allclose(r.scores, jr.scores, rtol=0, atol=1e-5)
    assert fleet.engine_steps == jfleet.engine_steps
    if paged:
        assert fleet.prefill_skips == jfleet.prefill_skips == 1
        assert sched.pool.blocks_in_use == 0
        sched.pool.check()
        assert (sched.engine.state["block_tables"] == 0).all()


def test_serve_driver_runs_on_cpu(capsys):
    rc = tserve.main(["--arch", "smollm-360m", "--reduced", "--device", "cpu",
                      "--paged", "--requests", "3", "--slots", "2",
                      "--max-new-tokens", "16", "--tokens-per-step", "4",
                      "--train-trajectories", "8", "--epochs", "2",
                      "--prompt-len", "8"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "[serve] fleet: 3 requests / 2 slots" in out
    assert "on cpu" in out
