"""The port's serving stack on RWKV6 (an O(1) recurrent state, no page
layout, no chunked prefill, no speculative decode) held to the JAX
package's on the reduced rwkv6-1.6b with weights and probe slow weights
carried across: per-request stop steps, tokens, admission and completion
steps and scores equal through ``OrcaScheduler``, with ``paged=True``
(the pool admission-controls, the device state stays dense) and with
``chunk_tokens``, ``spec_tokens`` and ``spec_tree`` (each warns and
falls back, as in JAX); the static-batch engine; a CPU run of the
serving driver."""
import warnings

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
from repro.serving import ServingEngine as JServingEngine
from repro.serving import make_request as j_make_request
from repro.serving import serve_queue_static as j_serve_queue_static

from repro_torch.configs import get_config
from repro_torch.core.probe import ProbeConfig
from repro_torch.launch import serve as tserve
from repro_torch.models import build
from repro_torch.models.convert import from_jax_params, from_jax_theta
from repro_torch.serving import (OrcaScheduler, RequestState, ServeConfig,
                                 ServingEngine, make_request,
                                 serve_queue_static)

# prompt lengths; the third repeats the first prompt (a prefix hit only
# for a family with pages: none here)
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
    jcfg = j_get_config("rwkv6_1b6").reduced()
    cfg = get_config("rwkv6_1b6").reduced()
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build(cfg)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), model,
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


def _requests(make, prompts):
    return [make(p, max_new_tokens=n) for p, n in zip(prompts, BUDGETS)]


def _run_both(models, **kw):
    (jmodel, jparams, jpc, jtheta), (model, params, pc, theta) = models
    kw = dict(dict(tokens_per_step=2, max_new_tokens=12, lam=0.6, burn_in=1,
                   n_slots=2, block_size=4), **kw)
    prompts = _prompts(model.cfg.vocab_size)
    jsched = JOrcaScheduler(jmodel, jparams, jpc, jtheta, JServeConfig(**kw))
    jdone, jfleet = jsched.run(_requests(j_make_request, prompts))
    sched = OrcaScheduler(model, params, pc, theta, ServeConfig(**kw))
    done, fleet = sched.run(_requests(make_request, prompts))
    states = [r.state.value for r in done]
    assert states == [r.state.value for r in jdone]
    assert set(states) == {RequestState.STOPPED.value,
                           RequestState.FINISHED.value}
    for r, jr in zip(done, jdone):
        assert r.stop_step == jr.stop_step, r.req_id
        assert r.tokens == jr.tokens, r.req_id
        assert r.admitted_step == jr.admitted_step, r.req_id
        assert r.first_token_step == jr.first_token_step, r.req_id
        assert r.completed_step == jr.completed_step, r.req_id
        assert r.slot == jr.slot, r.req_id
        np.testing.assert_allclose(r.scores, jr.scores, rtol=0, atol=1e-5)
    assert fleet.engine_steps == jfleet.engine_steps
    assert fleet.prefill_chunks == jfleet.prefill_chunks == 0
    assert fleet.prefill_skips == jfleet.prefill_skips == 0
    assert fleet.spec_tokens_proposed == jfleet.spec_tokens_proposed == 0
    assert not sched.engine.paged and sched.engine.state.keys() == {
        "wkv", "tm_x", "cm_x"}
    return sched, fleet, jsched, jfleet


def test_rwkv_fleet_matches_jax(models):
    sched, _, _, _ = _run_both(models)
    assert sched.pool is None


def test_rwkv_paged_fleet_keeps_the_pool_on_the_host(models):
    """``paged=True`` on a family without a page layout: both schedulers
    admit through the block pool (backpressure) and serve from a dense
    recurrent state; the pool drains."""
    sched, fleet, jsched, jfleet = _run_both(models, paged=True)
    assert not jsched._engine.paged
    assert sched.pool.num_blocks == jsched.pool.num_blocks
    assert fleet.peak_blocks_in_use == jfleet.peak_blocks_in_use > 0
    assert sched.pool.blocks_in_use == 0
    sched.pool.check()


def test_rwkv_paged_pool_admission_control_matches_jax(models):
    """A pool of 7 usable pages, too small for two of the 6-page
    reservations: a request waits for pages with a slot free, in both
    packages alike."""
    _, fleet, _, jfleet = _run_both(models, paged=True, num_blocks=8)
    _, free, _, _ = _run_both(models, paged=True)
    assert fleet.peak_blocks_in_use == jfleet.peak_blocks_in_use <= 7
    assert fleet.engine_steps > free.engine_steps


@pytest.mark.parametrize("knob,match", [("chunk_tokens", "admission-time"),
                                        ("spec_tokens", "one-token decode"),
                                        ("spec_tree", "one-token decode")])
def test_chunk_and_spec_tokens_warn_and_fall_back(models, knob, match):
    """As the JAX scheduler does: a RuntimeWarning, then the admission-time
    one-token fleet, equal to JAX's under the same knob."""
    (jmodel, jparams, jpc, jtheta), (model, params, pc, theta) = models
    value = {"chunk_tokens": 4, "spec_tokens": 3, "spec_tree": "2.2"}[knob]
    with pytest.warns(RuntimeWarning, match=match):
        JOrcaScheduler(jmodel, jparams, jpc, jtheta,
                       JServeConfig(**{knob: value}))
    with pytest.warns(RuntimeWarning, match=match):
        sched = OrcaScheduler(model, params, pc, theta,
                              ServeConfig(**{knob: value}))
    assert getattr(sched, knob) is None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        _run_both(models, **{knob: value})


def test_static_batch_queue_matches_jax(models):
    """The static-batch baseline on the recurrent state: stop steps,
    steps run and engine steps equal JAX's, and its stops equal the
    continuous fleet's.  At lam 0.97 one row runs to its budget, its
    scores at least 0.003 from lam."""
    (jmodel, jparams, jpc, jtheta), (model, params, pc, theta) = models
    kw = dict(tokens_per_step=2, max_new_tokens=12, lam=0.97, burn_in=1)
    prompts = np.stack([p[:9] for p in _prompts(model.cfg.vocab_size)
                        if len(p) >= 9] + [np.arange(9, dtype=np.int32)])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = j_serve_queue_static(
            JServingEngine(jmodel, jparams, jpc, jtheta, JServeConfig(**kw)),
            {"tokens": prompts}, 9, 2)
    eng = ServingEngine(model, params, pc, theta, ServeConfig(**kw))
    out = serve_queue_static(eng, {"tokens": prompts}, 9, 2)
    for name in ("stop_step", "steps_run"):
        np.testing.assert_array_equal(getattr(out, name), getattr(ref, name),
                                      err_msg=name)
    for name in ("engine_steps", "active_slot_steps", "total_slot_steps"):
        assert getattr(out, name) == getattr(ref, name), name
    for a, b in zip(out.scores, ref.scores):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    assert len(set(out.stop_step.tolist())) > 1
    done, _ = OrcaScheduler(model, params, pc, theta,
                            ServeConfig(n_slots=2, **kw)).run(
        [make_request(p) for p in prompts])
    assert [r.stop_step for r in done] == out.stop_step.tolist()


def test_serve_driver_runs_rwkv_on_cpu(capsys):
    with pytest.warns(RuntimeWarning, match="admission-time"):
        out = tserve.serve(["--arch", "rwkv6-1.6b", "--reduced", "--device",
                            "cpu", "--paged", "--chunk-tokens", "8",
                            "--requests", "3", "--slots", "2",
                            "--max-new-tokens", "16", "--tokens-per-step",
                            "4", "--train-trajectories", "8", "--epochs",
                            "2", "--prompt-len", "8", "--static-baseline"])
    text = capsys.readouterr().out
    assert "[serve] rwkv6-1.6b on cpu" in text
    assert "[serve] fleet: 3 requests / 2 slots" in text
    assert "[serve] static-batch baseline: " in text
    assert out.static.stop_step.tolist() == [r.stop_step
                                             for r in out.requests]
    assert out.scheduler.pool.blocks_in_use == 0
    assert not out.scheduler.engine.paged


def test_serve_driver_without_device_raises_without_cuda(monkeypatch):
    """``--device`` defaults to CUDA: without a card the RWKV driver
    raises and names the CPU option; it never moves to the CPU itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--arch", "rwkv6-1.6b", "--reduced"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(get_config("rwkv6-1.6b").reduced()).init_decode_state(2, 8)
