"""The port's serving stack (``ContinuousServingEngine`` under
``OrcaScheduler``, dense and paged KV) held to the JAX package's on the
reduced smollm-360m (and, where marked, the reduced llama3.2-3b,
qwen1.5-32b and stablelm-3b, the last also at its served head dim of 80,
and the reduced MoE configs granite-moe-1b and phi3.5-moe)
with weights and probe slow weights carried across:
per-request stop steps, emitted tokens, admission and completion steps are
exactly equal, and the page pool drains — with admission-time prefill and
with chunked, packed prefill through the unified token-budget step (dense
and paged, packed and unpacked, a budget that spreads prefill over many
steps, paged int8); the static-batch engine and a static-probe fleet.
Plus CPU runs of the port's serving driver (with ``--group-size``, its
``[serve] groups:`` line against JAX's driver's), the ServeConfig knobs
the port accepts and refuses, and a session mixing priority classes, where
both packages preempt."""
import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import get_config as j_get_config
from repro.core.probe import ProbeConfig as JProbeConfig
from repro.core.probe import init_outer as j_init_outer
from repro.models import build as j_build
from repro.serving import OrcaScheduler as JOrcaScheduler
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro.serving import make_request as j_make_request
from repro.serving import serve_queue_static as j_serve_queue_static
from repro.trajectories import synthetic as jsyn

from repro_torch import api
from repro_torch.configs import get_config
from repro_torch.core.calibrator import StaticCalibrator
from repro_torch.core.probe import ProbeConfig
from repro_torch.launch import serve as tserve
from repro_torch.models import build
from repro_torch.models.convert import from_jax_params, from_jax_theta
from repro_torch.serving import (OrcaScheduler, RequestState, ServeConfig,
                                 ServingEngine, make_request,
                                 serve_queue_static)

# prompt lengths: the third repeats the first prompt (a prefix hit in paged
# mode: shared full pages plus a copied partial tail page)
LENS = (9, 13, 9, 6, 11)
# per-request budgets: the short ones FINISH before the burn-in lets them
# stop, the rest are STOPPED by the probe
BUDGETS = (12, 3, 12, 12, 4)
# the ported dense configs, each at .reduced(), and the MoE ones
DENSE_ARCHS = ("smollm-360m", "llama3.2-3b", "qwen1.5-32b", "stablelm-3b")
MOE_ARCHS = ("granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b")
ARCHS = DENSE_ARCHS + MOE_ARCHS


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@functools.lru_cache(maxsize=None)
def _models(kv_cache_dtype=None, arch="smollm-360m", d_head=None):
    jcfg = j_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    changes = {}
    if kv_cache_dtype:
        changes["kv_cache_dtype"] = kv_cache_dtype
    if d_head:
        changes["d_head"] = d_head
    jcfg = dataclasses.replace(jcfg, **changes)
    cfg = dataclasses.replace(cfg, **changes)
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


@pytest.fixture(scope="module")
def models():
    return _models()


def _prompts(vocab):
    rng = np.random.default_rng(17)
    out = [rng.integers(0, vocab, n).astype(np.int32) for n in LENS]
    out[2] = out[0].copy()
    return out


def _run_both(models, **kw):
    (jmodel, jparams, jpc, jtheta), (model, params, pc, theta) = models
    kw = dict(dict(tokens_per_step=2, max_new_tokens=12, lam=0.6, burn_in=1,
                   n_slots=2, block_size=4), **kw)
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
        assert r.first_token_step == jr.first_token_step, r.req_id
        assert r.completed_step == jr.completed_step, r.req_id
        assert r.slot == jr.slot, r.req_id
        assert r.prefill_progress == jr.prefill_progress, r.req_id
        np.testing.assert_allclose(r.scores, jr.scores, rtol=0, atol=1e-5)
    assert fleet.engine_steps == jfleet.engine_steps
    assert fleet.prefill_chunks == jfleet.prefill_chunks
    assert fleet.packed_chunks == jfleet.packed_chunks
    assert fleet.peak_step_tokens == jfleet.peak_step_tokens
    if kw.get("paged"):
        assert fleet.prefill_skips == jfleet.prefill_skips
        assert sched.pool.blocks_in_use == 0
        sched.pool.check()
        assert (sched.engine.state["block_tables"] == 0).all()
    return fleet


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("paged", [False, True])
def test_scheduler_stops_and_tokens_match_jax(paged, arch):
    fleet = _run_both(_models(None, arch), paged=paged)
    assert fleet.prefill_chunks == 0
    if paged:
        assert fleet.prefill_skips == 1


@pytest.mark.parametrize("paged,pack", [(False, True), (False, False),
                                        (True, True), (True, False)])
def test_chunked_fleet_matches_jax(models, paged, pack):
    """Chunks of 4 prompt tokens through the unified step; packed, the
    tail of one prompt rides with the head of the next."""
    fleet = _run_both(models, paged=paged, chunk_tokens=4, pack_chunks=pack)
    assert fleet.prefill_chunks > 0
    assert (fleet.packed_chunks > 0) == pack


def test_chunked_fleet_under_a_tight_budget_matches_jax(models):
    """A budget of n_slots + 1 = 3 tokens a step: a chunk carries at most
    3 prompt tokens, and one token while the other slot decodes, so every
    prompt spreads over several steps."""
    fleet = _run_both(models, paged=True, chunk_tokens=4, token_budget=3)
    assert fleet.prefill_chunks >= -(-sum(LENS) // 3)
    assert fleet.peak_step_tokens <= 3


@pytest.mark.parametrize("arch", DENSE_ARCHS)
@pytest.mark.parametrize("chunk_tokens", [None, 4])
def test_paged_int8_fleet_matches_jax(monkeypatch, chunk_tokens, arch):
    """int8 pages end to end, admission-time and chunked: prefill (or each
    chunk) quantises its K/V into the pool, later chunks and decode read
    them back dequantised.  The JAX package runs its Pallas paged kernels
    (interpret mode), whose f32 contract the port's kernels keep; its jnp
    path dequantises int8 pages to bf16."""
    monkeypatch.setenv("REPRO_PAGED_ATTN", "pallas")
    fleet = _run_both(_models("int8", arch), paged=True,
                      chunk_tokens=chunk_tokens)
    assert (fleet.packed_chunks > 0) == bool(chunk_tokens)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_chunked_fleet_matches_jax(monkeypatch, arch):
    """A reduced MoE fleet on paged f32 pages in packed chunks of 4
    tokens against the JAX package's (its Pallas paged kernels in
    interpret mode): stops, tokens and schedule equal, every chunk token
    and decode step routed through the experts."""
    monkeypatch.setenv("REPRO_PAGED_ATTN", "pallas")
    fleet = _run_both(_models(None, arch), paged=True, chunk_tokens=4)
    assert fleet.packed_chunks > 0


@pytest.mark.parametrize("kv,chunk_tokens", [(None, None), ("int8", 4)])
def test_d80_paged_fleet_matches_jax(monkeypatch, kv, chunk_tokens):
    """stablelm-3b at its served head dim of 80 (d_rot 20): a paged fleet
    at admission-time prefill, and on int8 pages in packed chunks, against
    the JAX package's Pallas paged kernels (interpret mode)."""
    monkeypatch.setenv("REPRO_PAGED_ATTN", "pallas")
    models = _models(kv, "stablelm-3b", d_head=80)
    assert models[1][0].cfg.d_head == 80
    fleet = _run_both(models, paged=True, chunk_tokens=chunk_tokens)
    assert (fleet.packed_chunks > 0) == bool(chunk_tokens)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_driver_runs_on_cpu(capsys, arch):
    rc = tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--paged", "--requests", "3", "--slots", "2",
                      "--max-new-tokens", "16", "--tokens-per-step", "4",
                      "--train-trajectories", "8", "--epochs", "2",
                      "--prompt-len", "8"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "[serve] fleet: 3 requests / 2 slots" in out
    assert "on cpu" in out


def test_serve_driver_runs_chunked_on_cpu(capsys):
    rc = tserve.main(["--arch", "smollm-360m", "--reduced", "--device", "cpu",
                      "--paged", "--requests", "3", "--slots", "2",
                      "--max-new-tokens", "8", "--tokens-per-step", "4",
                      "--train-trajectories", "8", "--epochs", "2",
                      "--prompt-len", "12", "--chunk-tokens", "8"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "prefill chunks (" in out and "packed" in out


GROUP_DRIVER = ["--arch", "smollm-360m", "--reduced", "--paged",
                "--requests", "2", "--slots", "4", "--group-size", "4"]


def _line(out, prefix):
    return next(ln for ln in out.splitlines() if ln.startswith(prefix))


@pytest.mark.parametrize("extra", [(), ("--no-consensus",),
                                   ("--consensus-delta", "0.1")])
def test_serve_driver_groups_line_matches_jax(capsys, extra):
    """``--group-size 4`` on the reduced model: the port's driver prints
    JAX's driver's ``[serve] groups:`` line on the same seed (both fleets
    decode each group's shared prompt alike, so the schedule does not
    depend on the weights); ``--no-consensus`` cancels nothing and
    ``--consensus-delta`` calibrates at its own delta."""
    from repro.launch import serve as jserve
    assert jserve.main(GROUP_DRIVER + list(extra)) == 0
    jout = capsys.readouterr().out
    res = tserve.serve(GROUP_DRIVER + ["--device", "cpu"] + list(extra))
    out = capsys.readouterr().out
    assert _line(out, "[serve] groups:") == _line(jout, "[serve] groups:")
    assert len(res.groups) == 2 and res.groups == res.scheduler.groups
    states = {r.state.value for r in res.requests}
    if extra == ("--no-consensus",):
        assert res.scheduler.consensus is None
        assert "consensus threshold" not in out
        assert states <= {"stopped", "finished"}
    else:
        delta = "0.1" if extra else "0.2"
        assert f"(delta={delta}, 3 calibration groups)" in out
        assert _line(out, "[serve] groups:").startswith(
            "[serve] groups: 2 consensus stops (mean step 2.0), 8 siblings "
            "cancelled, group savings 72 steps")
        assert all(g.decided and g.consensus_index == 2
                   for g in res.groups)
        assert res.scheduler.pool.blocks_in_use == 0


def test_serve_config_takes_chunk_knobs_and_refuses_the_rest(models):
    cfg = ServeConfig(chunk_tokens=8, token_budget=12, pack_chunks=False,
                      pack_max=2)
    assert (cfg.chunk_tokens, cfg.token_budget, cfg.pack_chunks,
            cfg.pack_max) == (8, 12, False, 2)
    with pytest.raises(ValueError, match="pack_max"):
        ServeConfig(pack_max=0)
    _, (model, params, pc, theta) = models
    assert OrcaScheduler(model, params, pc, theta, ServeConfig(
        n_slots=3, chunk_tokens=8)).token_budget == 11
    with pytest.raises(ValueError, match="token_budget=2 < n_slots=3"):
        OrcaScheduler(model, params, pc, theta, ServeConfig(
            n_slots=3, chunk_tokens=8, token_budget=2))
    assert ServeConfig().preemption
    assert not ServeConfig(preemption=False).preemption
    for name in ("fifo", "priority", "edf", "ttft"):
        assert OrcaScheduler(model, params, pc, theta, ServeConfig(
            policy=name)).policy.name == name
    with pytest.raises(ValueError, match="unknown scheduling policy"):
        ServeConfig(policy="lifo")
    # the fleet's fields are ported: n_hosts is checked with JAX's
    # message, and an unknown placement is refused as JAX refuses it
    cfg = ServeConfig(n_hosts=2, placement="roundrobin")
    assert (cfg.n_hosts, cfg.placement) == (2, "roundrobin")
    for bad in (0, -1, True):
        with pytest.raises(ValueError) as got:
            ServeConfig(n_hosts=bad)
        with pytest.raises(ValueError) as want:
            JServeConfig(n_hosts=bad)
        assert str(got.value) == str(want.value)
        assert "must be an int >= 1" in str(got.value)
    from repro.serving import make_placement as j_make_placement

    from repro_torch.serving import make_placement
    with pytest.raises(ValueError) as got:
        make_placement("nearest")
    with pytest.raises(ValueError) as want:
        j_make_placement("nearest")
    assert str(got.value) == str(want.value)
    assert "unknown placement policy 'nearest'" in str(got.value)
    # groups and consensus are ported: no longer refused
    cfg = ServeConfig(group_size=2, consensus=0.5)
    assert (cfg.group_size, cfg.consensus) == (2, 0.5)


@pytest.mark.parametrize("margin", [None, 2])
@pytest.mark.parametrize("n_running,near", [(0, 0), (3, 1), (3, 2), (4, 4)])
def test_fifo_prefill_share_matches_jax(margin, n_running, near):
    """The composer's prefill share, with and without probe-aware chunk
    sizing, is the JAX FIFO policy's."""
    from repro.serving.policy import ComposeView as JComposeView
    from repro.serving.policy import FIFOPolicy as JFIFOPolicy

    from repro_torch.serving import ComposeView, FIFOPolicy
    kw = dict(n_running=n_running, n_slots=4, n_prefilling=1, n_waiting=2,
              token_budget=12, chunk_tokens=8, near_boundary=near)
    assert FIFOPolicy(probe_margin=margin).prefill_share(ComposeView(**kw)) \
        == JFIFOPolicy(probe_margin=margin).prefill_share(JComposeView(**kw))


@pytest.mark.parametrize("lam", [0.9, 0.95])
def test_static_batch_queue_matches_jax_and_the_continuous_fleet(models,
                                                                 lam):
    """The deprecated static-batch baseline serves the queue in groups of
    n_slots: stop steps, reasoning steps run and engine steps equal the
    JAX package's, and its stops equal the continuous fleet's (the
    assertion of ``benchmarks/serving_throughput.py``).  At lam 0.9 rows
    stop at steps 2 and 3; at 0.95 some run to the budget."""
    (jmodel, jparams, jpc, jtheta), (model, params, pc, theta) = models
    kw = dict(tokens_per_step=2, max_new_tokens=12, lam=lam, burn_in=1)
    prompts = np.stack([p[:9] for p in _prompts(model.cfg.vocab_size)
                        if len(p) >= 9] + [np.arange(9, dtype=np.int32)])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = j_serve_queue_static(
            JServingEngine(jmodel, jparams, jpc, jtheta, JServeConfig(**kw)),
            {"tokens": prompts}, 9, 2)
    eng = ServingEngine(model, params, pc, theta, ServeConfig(**kw))
    with pytest.warns(DeprecationWarning, match="static-batch baseline"):
        eng.serve({"tokens": prompts[:1]}, prompt_len=9)
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


def test_static_probe_fleet_through_the_facade_matches_jax(models):
    """The static baseline (PCA + logreg fitted in JAX, carried across)
    served through ``api.engine``: flattened into a frozen no-QK probe
    (eta = 0) on the fused step, so every slot's W stays at W0; stops,
    tokens and scores equal JAX's."""
    (jmodel, jparams, _, _), (model, params, _, _) = models
    ts = jsyn.generate(jsyn.TrajectoryDistribution(
        "p", d_phi=model.cfg.d_model, t_min=8, t_max=16), 24, 0)
    jcal = japi.fit(ts, mode="supervised", method="static", n_components=8)
    cal = StaticCalibrator(device="cpu")
    cal.probe, cal.mode = jcal.probe, jcal.mode
    kw = dict(tokens_per_step=2, max_new_tokens=12, lam=0.58, burn_in=1,
              n_slots=2, block_size=4, paged=True)
    prompts = _prompts(model.cfg.vocab_size)
    jdone, jfleet = japi.engine(jmodel, jparams, jcal,
                                config=JServeConfig(**kw)).run(
        [j_make_request(p, max_new_tokens=n)
         for p, n in zip(prompts, BUDGETS)])
    sched = api.engine(model, params, cal, config=ServeConfig(**kw))
    assert sched.pc.eta == 0.0
    sched.submit([make_request(p, max_new_tokens=n)
                  for p, n in zip(prompts, BUDGETS)])
    for _ in range(3):
        sched.step()
        assert torch.equal(sched.engine.st.W,
                           sched.theta["W0"].expand_as(sched.engine.st.W))
    done, fleet = sched.drain()
    assert [r.stop_step for r in done] == [r.stop_step for r in jdone]
    assert len({r.stop_step for r in done}) > 1
    for r, jr in zip(done, jdone):
        assert r.tokens == jr.tokens
        np.testing.assert_allclose(r.scores, jr.scores, rtol=0, atol=1e-5)
    assert fleet.engine_steps == jfleet.engine_steps


@pytest.mark.parametrize("paged", [False, True])
def test_mixed_priority_session_matches_jax(models, paged):
    """A session mixing priority classes under the default config
    (preemption on, FIFO): the urgent requests spill batch residents to
    host RAM and the victims restore later; every request's stop step,
    tokens, scores and schedule (admission, restore, completion, spills)
    and the fleet's preemption counters equal JAX's, and the stops equal
    the same prompts served in one class."""
    (jmodel, jparams, jpc, jtheta), (model, params, pc, theta) = models
    kw = dict(tokens_per_step=2, max_new_tokens=12, lam=0.6, burn_in=1,
              n_slots=2, block_size=4, paged=paged)
    prios = (1, 1, 0, 1, 0)
    prompts = _prompts(model.cfg.vocab_size)
    jdone, jfleet = JOrcaScheduler(jmodel, jparams, jpc, jtheta,
                                   JServeConfig(**kw)).run(
        [j_make_request(p, max_new_tokens=n, priority=c)
         for p, n, c in zip(prompts, BUDGETS, prios)])
    sched = OrcaScheduler(model, params, pc, theta, ServeConfig(**kw))
    assert sched.preemption
    done, fleet = sched.run([make_request(p, max_new_tokens=n, priority=c)
                             for p, n, c in zip(prompts, BUDGETS, prios)])
    assert fleet.preemptions == jfleet.preemptions > 0
    assert fleet.restores == jfleet.restores == fleet.preemptions
    assert fleet.spilled_blocks == jfleet.spilled_blocks
    assert fleet.engine_steps == jfleet.engine_steps
    for r, jr in zip(done, jdone):
        for f in ("stop_step", "tokens", "admitted_step", "restored_step",
                  "completed_step", "n_preempted"):
            assert getattr(r, f) == getattr(jr, f), (r.req_id, f)
        np.testing.assert_allclose(r.scores, jr.scores, rtol=0, atol=1e-5)
    one, _ = OrcaScheduler(model, params, pc, theta, ServeConfig(**kw)).run(
        [make_request(p, max_new_tokens=n) for p, n in zip(prompts, BUDGETS)])
    assert [r.stop_step for r in done] == [r.stop_step for r in one]
    if paged:
        assert sched.pool.blocks_in_use == 0
        sched.pool.check()


def test_serve_driver_static_baseline_on_cpu(capsys):
    out = tserve.serve(["--arch", "smollm-360m", "--reduced", "--device",
                        "cpu", "--requests", "3", "--slots", "2",
                        "--max-new-tokens", "16", "--tokens-per-step", "4",
                        "--train-trajectories", "8", "--epochs", "2",
                        "--prompt-len", "8", "--static-baseline"])
    assert "[serve] static-batch baseline: " in capsys.readouterr().out
    assert out.static.stop_step.tolist() == [r.stop_step
                                             for r in out.requests]
