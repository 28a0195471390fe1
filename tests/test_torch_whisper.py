"""whisper-tiny (``repro_torch.models.whisper``) held to the JAX package's
on the reduced config (2 encoder and 2 decoder layers, d 256, 4 heads of
32, 16 stub frames), weights carried across from JAX's ``init`` through
numpy and frames drawn from a numpy seed:

* the sinusoidal positions and ``encode`` (the bidirectional encoder);
* ``prefill``: the cross K/V of every decoder layer, flat leaves
  ``cross_k`` / ``cross_v`` (L, B, H, F, dh), and an empty self cache;
* ``decode_step`` logits, hidden states and self cache from position 0;
* the serving path's audio branch: decode starts at position 0 and the
  decoder cache holds generated tokens only (``extract_trajectories``,
  the static-batch engine and ``OrcaScheduler``'s ``cache_len`` and page
  reservations), against JAX's; a fleet with decisive probe parameters
  stops and emits exactly as JAX's, dense and under ``paged=True``;
* the serving driver on the CPU, its frames drawn as JAX's driver draws
  them.

Tolerances are float32's (the reduced config's dtype), relative to the
largest value: sums in another order than XLA's through a random-weight
stack."""
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
from repro.models import whisper as jwhisper
from repro.serving import OrcaScheduler as JOrcaScheduler
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro.serving import extract_trajectories as j_extract
from repro.serving import make_request as j_make_request
from repro.serving import serve_queue_static as j_serve_queue_static

from repro_torch.configs import get_config
from repro_torch.core.probe import ProbeConfig
from repro_torch.launch import serve as tserve
from repro_torch.models import build, whisper
from repro_torch.models.convert import from_jax_params, from_jax_theta
from repro_torch.serving import (OrcaScheduler, RequestState, ServeConfig,
                                 ServingEngine, extract_trajectories,
                                 make_request, serve_queue_static)

ARCH = "whisper_tiny"
# hidden states, logits, K/V and step embeddings, relative to the largest
# (at least 1): f32 matmuls, LayerNorms and softmax in another order than
# XLA's, test_torch_model.py's 1e-4
RTOL = 1e-4
# decode steps: the JAX package's f32 decode and the port's each sit up to
# 9e-4 (relative) from a float64 run of the port on the same weights, the
# final LayerNorm amplifying the residual stream's rounding; the argmax
# tokens are held equal at every step besides
RTOL_DECODE = 2e-3
LENS = (9, 13, 9, 6, 11)
BUDGETS = (12, 3, 12, 12, 4)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def models():
    jcfg = j_get_config(ARCH).reduced()
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    # nonzero biases and norms, so that every leaf's place is checked
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.02 * jax.random.normal(
            jax.random.PRNGKey(len(str(path))), a.shape)
        if str(path[-1]).strip("[]'") in ("bq", "bk", "bv", "b_in",
                                          "b_out", "bias")
        else a, jparams)
    model = build(get_config(ARCH).reduced())
    params = from_jax_params(jax.tree.map(np.asarray, jparams), model,
                             device="cpu")
    jpc = JProbeConfig(d_phi=jcfg.d_model, smooth_window=2)
    jtheta = j_init_outer(jpc, jax.random.PRNGKey(1))
    jtheta["b0"] = jnp.asarray(3.0)
    pc = ProbeConfig(d_phi=jcfg.d_model, smooth_window=2)
    theta = from_jax_theta({k: np.asarray(v) for k, v in jtheta.items()},
                           device="cpu")
    return (jmodel, jparams, jpc, jtheta), (model, params, pc, theta)


def _close(got, want, msg, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    atol = rtol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=msg)


def _frames(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return (0.02 * rng.standard_normal(
        (n, cfg.frontend.n_tokens, cfg.d_model))).astype(np.float32)


def test_config_and_decls():
    cfg = get_config("whisper-tiny")
    assert (cfg.n_layers, cfg.n_encoder_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.d_head, cfg.frontend.n_tokens,
            cfg.tie_embeddings, cfg.norm, cfg.mlp, cfg.qkv_bias) == \
        (4, 4, 384, 6, 6, 64, 1500, True, "layernorm", "gelu", True)
    assert cfg.param_count() == 34_111_488
    model = build(cfg.reduced())
    assert not (model.supports_paged or model.supports_chunked
                or model.supports_spec)
    assert "lm_head" not in model.decls
    st = model.init_decode_state(3, 40, device="cpu")
    assert st["k"].shape == (2, 3, 4, 40, 32)
    assert st["cross_k"].shape == st["cross_v"].shape == (2, 3, 4, 16, 32)


@pytest.mark.parametrize("length,d", [(16, 256), (1500, 384), (5, 2)])
def test_sinusoid_matches_jax(length, d):
    # angles up to length - 1 radians in f32, whose ulp there (1.2e-4 at
    # 1,499) bounds how far two libraries' sin and cos of them can part
    _close(whisper._sinusoid(length, d, "cpu"), jwhisper._sinusoid(length, d),
           "sinusoid", rtol=4 * max(length, 1) * 2.0 ** -24)


def test_encode_and_cross_kv_match_jax(models):
    (jmodel, jparams, _, _), (model, params, _, _) = models
    cfg = model.cfg
    frames = _frames(cfg, 2, 3)
    toks = np.zeros((2, 5), np.int32)
    jenc = jwhisper.encode(jmodel.cfg, jparams, jnp.asarray(frames))
    enc = whisper.encode(cfg, params, torch.as_tensor(frames))
    _close(enc, jenc, "encoder output")
    jst, _, jenc2 = jmodel.prefill(jmodel.cfg, jparams,
                                   {"tokens": jnp.asarray(toks),
                                    "frames": jnp.asarray(frames)}, 24)
    st, last, enc2 = model.prefill(cfg, params,
                                   {"tokens": torch.as_tensor(toks),
                                    "frames": torch.as_tensor(frames)}, 24)
    assert last is None
    _close(enc2, jenc2, "prefill's encoder output")
    assert set(st) == {"k", "v", "cross_k", "cross_v"}
    for key in ("cross_k", "cross_v"):
        _close(st[key], jst[key], key)
    for key in ("k", "v"):
        assert st[key].shape == jst["self"][key].shape
        assert not st[key].any()


def test_decode_steps_match_jax(models):
    """16 steps from position 0 over the self cache and the frames' cross
    K/V: logits, hidden and the self cache equal JAX's at every step."""
    (jmodel, jparams, _, _), (model, params, _, _) = models
    cfg = model.cfg
    frames = _frames(cfg, 2, 4)
    toks = np.zeros((2, 3), np.int32)
    jst, _, _ = jmodel.prefill(jmodel.cfg, jparams,
                               {"tokens": jnp.asarray(toks),
                                "frames": jnp.asarray(frames)}, 20)
    st, _, _ = model.prefill(cfg, params, {"tokens": torch.as_tensor(toks),
                                           "frames": torch.as_tensor(frames)},
                             20)
    step = jax.jit(lambda tok, state, pos: jmodel.decode_step(
        jmodel.cfg, jparams, tok, state, pos))
    tok = np.zeros(2, np.int32)
    for i in range(16):
        pos = np.asarray([i, i], np.int32)
        jl, jh, jst = step(jnp.asarray(tok), jst, jnp.asarray(pos))
        lg, h, st = model.decode_step(cfg, params, torch.as_tensor(tok), st,
                                      torch.as_tensor(pos))
        _close(lg, jl, f"step {i} logits", RTOL_DECODE)
        _close(h, jh, f"step {i} hidden", RTOL_DECODE)
        tok = np.array(jnp.argmax(jl[:, :cfg.vocab_size], -1), np.int32)
        assert tok.tolist() == lg[:, :cfg.vocab_size].argmax(-1).tolist()
    for key in ("k", "v"):
        _close(st[key], jst["self"][key], key, RTOL_DECODE)


def test_harvest_decodes_from_position_zero(models):
    """``extract_trajectories`` on audio: the decoder starts at position 0
    with a cache of prompt + budget positions, as JAX's; step embeddings
    and tokens equal JAX's."""
    (jmodel, jparams, _, _), (model, params, _, _) = models
    frames = _frames(model.cfg, 3, 5)
    toks = np.random.default_rng(6).integers(
        0, model.cfg.vocab_size, (3, 7)).astype(np.int32)
    jphis, jtoks = j_extract(jmodel, jparams,
                             {"tokens": jnp.asarray(toks),
                              "frames": jnp.asarray(frames)}, 7, 12, 4)
    phis, out = extract_trajectories(model, params,
                                     {"tokens": toks, "frames": frames}, 7,
                                     12, 4)
    np.testing.assert_array_equal(out, np.asarray(jtoks))
    _close(phis, jphis, "step embeddings", RTOL_DECODE)


def _prompts(cfg):
    rng = np.random.default_rng(17)
    out = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in LENS]
    return out, _frames(cfg, len(LENS), 18)


def _requests(make, cfg):
    prompts, frames = _prompts(cfg)
    return [make(p, extra={"frames": frames[i:i + 1]}, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, BUDGETS))]


def _run_both(models, **kw):
    (jmodel, jparams, jpc, jtheta), (model, params, pc, theta) = models
    kw = dict(dict(tokens_per_step=2, max_new_tokens=12, lam=0.6, burn_in=1,
                   n_slots=2, block_size=4), **kw)
    jsched = JOrcaScheduler(jmodel, jparams, jpc, jtheta, JServeConfig(**kw))
    jdone, jfleet = jsched.run(_requests(j_make_request, model.cfg))
    sched = OrcaScheduler(model, params, pc, theta, ServeConfig(**kw))
    done, fleet = sched.run(_requests(make_request, model.cfg))
    states = [r.state.value for r in done]
    assert states == [r.state.value for r in jdone]
    assert set(states) == {RequestState.STOPPED.value,
                           RequestState.FINISHED.value}
    for r, jr in zip(done, jdone):
        assert r.stop_step == jr.stop_step, r.req_id
        assert r.tokens == jr.tokens, r.req_id
        assert (r.admitted_step, r.completed_step, r.slot) == \
            (jr.admitted_step, jr.completed_step, jr.slot), r.req_id
        np.testing.assert_allclose(r.scores, jr.scores, rtol=0, atol=1e-5)
    assert fleet.engine_steps == jfleet.engine_steps
    eng = sched.engine
    assert not eng.paged
    # the decoder cache holds generated tokens only: the budget, no prompt
    assert eng.cache_len == jsched._engine.cache_len == 12
    assert eng.state.keys() == {"k", "v", "cross_k", "cross_v"}
    return sched, fleet, jsched, jfleet


def test_fleet_matches_jax(models):
    sched, _, _, _ = _run_both(models)
    assert sched.pool is None


def test_paged_fleet_reserves_the_budget_only(models):
    """``paged=True``: each request reserves pages for its budget alone (3
    pages of 4 for 12 tokens), in both packages; the state stays dense."""
    sched, fleet, jsched, jfleet = _run_both(models, paged=True)
    req = make_request(np.zeros(9, np.int32), max_new_tokens=12)
    assert sched._request_tokens(req) == 12
    assert sched.pool.num_blocks == jsched.pool.num_blocks
    assert fleet.peak_blocks_in_use == jfleet.peak_blocks_in_use == 6
    assert sched.pool.blocks_in_use == 0


def test_static_batch_queue_matches_jax(models):
    (jmodel, jparams, jpc, jtheta), (model, params, pc, theta) = models
    kw = dict(tokens_per_step=2, max_new_tokens=12, lam=0.6, burn_in=1)
    prompts, frames = _prompts(model.cfg)
    batch = {"tokens": np.stack([p[:6] for p in prompts]), "frames": frames}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = j_serve_queue_static(
            JServingEngine(jmodel, jparams, jpc, jtheta, JServeConfig(**kw)),
            {k: jnp.asarray(v) for k, v in batch.items()}, 6, 2)
    out = serve_queue_static(
        ServingEngine(model, params, pc, theta, ServeConfig(**kw)), batch,
        6, 2)
    for name in ("stop_step", "steps_run"):
        np.testing.assert_array_equal(getattr(out, name), getattr(ref, name),
                                      err_msg=name)
    assert out.engine_steps == ref.engine_steps


def test_serve_driver_runs_whisper_on_cpu(capsys):
    out = tserve.serve(["--arch", "whisper-tiny", "--reduced", "--device",
                        "cpu", "--requests", "3", "--slots", "2",
                        "--max-new-tokens", "16", "--tokens-per-step", "4",
                        "--train-trajectories", "8", "--epochs", "2",
                        "--prompt-len", "8", "--static-baseline"])
    text = capsys.readouterr().out
    assert "[serve] whisper-tiny on cpu" in text
    assert out.static.stop_step.tolist() == [r.stop_step
                                             for r in out.requests]
    batch = tserve.model_inputs(out.scheduler.model.cfg,
                                torch.Generator().manual_seed(0), 2, 8)
    assert batch["frames"].shape == (2, 16, 256)
    assert batch["frames"].dtype == np.float32
    assert 0.005 < batch["frames"].std() < 0.05
