"""hymba-1.5b (``repro_torch.models.hymba``) held to the JAX package's on
the reduced config (2 layers, d 256, 4 heads on 2 KV heads of 32, window
64, 8 meta tokens, Mamba state 8), weights carried across from JAX's
``init`` through numpy and inputs drawn from a numpy seed:

* the window's ring mask and write slot (``decode_valid_mask``) against
  JAX's;
* ``mamba_branch`` over a prompt at once and token by token, from a
  nonzero state;
* ``prefill`` for a sequence shorter than the window (the ring
  zero-padded) and longer (rolled into ring order), its hidden states,
  KV ring and Mamba states; the meta tokens leave the ring once the
  positions pass it (what the code does);
* ``decode_step`` logits and state over steps that wrap the ring;
* a fleet served by ``OrcaScheduler`` with decisive probe parameters
  stops and emits exactly as JAX's, also under ``paged=True`` (admission
  control only: no page layout) and on the static-batch engine;
* a request preempted mid-decode and restored replays its undisturbed
  future bit for bit, its Mamba state restored bitwise, its spill equal to
  JAX's;
* the serving driver on the CPU.

Tolerances are float32's (the reduced config's dtype): sums in another
order than XLA's, through a recurrence and a random-weight stack."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.probe import ProbeConfig as JProbeConfig
from repro.core.probe import init_outer as j_init_outer
from repro.models import attention as jattn
from repro.models import build as j_build
from repro.models import hymba as jhymba
from repro.serving import ContinuousServingEngine as JEngine
from repro.serving import OrcaScheduler as JOrcaScheduler
from repro.serving import ServeConfig as JServeConfig
from repro.serving import make_request as j_make_request

from repro_torch.configs import get_config
from repro_torch.core.probe import ProbeConfig
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as attn
from repro_torch.models import build, hymba
from repro_torch.models.convert import from_jax_params, from_jax_theta
from repro_torch.serving import (ContinuousServingEngine, OrcaScheduler,
                                 RequestState, ServeConfig, make_request)

ARCH = "hymba_1b5"
# hidden states and logits: f32 through the scan and 2 random-weight
# layers, summed in another order than XLA's; relative to the largest
RTOL = 2e-5
# the SSM states: with random weights they reach 1e7, sums of dt B x over
# the sequence whose inputs carry the layer below's f32 differences (the
# first layer's states sit within 1e-5 of JAX's, the second's within
# 2e-4), relative to the largest
RTOL_SSM = 5e-4
# decode steps: each step's hidden state carries the SSM states' spread
# above, step after step, into the next token's inputs
RTOL_DECODE = 1e-4
# prompt lengths of the fleet: with the 8 meta tokens, 17 to 60 positions
# of a 64-position window, decoded past it
LENS = (9, 30, 9, 52, 14)
BUDGETS = (24, 3, 24, 24, 4)


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


def _flat(jstate):
    """JAX's nested hymba state as the port's flat leaves."""
    return {"k": jstate["kv"]["k"], "v": jstate["kv"]["v"],
            "conv": jstate["mamba"]["conv"], "ssm": jstate["mamba"]["ssm"]}


def _states_close(state, jstate, msg):
    jflat = _flat(jstate)
    assert set(state) == set(jflat)
    for key, val in state.items():
        _close(val, jflat[key], f"{msg}: {key}",
               RTOL_SSM if key == "ssm" else RTOL)


def test_config_and_decls():
    cfg = get_config("hymba-1.5b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_head, cfg.sliding_window, cfg.n_meta_tokens,
            cfg.ssm.state_dim, cfg.ssm.expand, cfg.ssm.conv_dim) == \
        (32, 1600, 25, 5, 64, 1024, 128, 16, 2, 4)
    assert cfg.param_count() == 1_391_001_600
    model = build(cfg.reduced())
    assert not (model.supports_paged or model.supports_chunked
                or model.supports_spec)
    mamba = model.decls["layers"]["mamba"]
    assert {k for k, p in mamba.items() if p.dtype == "float32"} == \
        {"A_log", "D"}
    assert model.decls["layers"]["beta"].dtype == "float32"
    st = model.init_decode_state(3, 40, device="cpu")
    assert st["k"].shape == (2, 3, 2, 40, 32)           # ring of min(40, 64)
    assert st["conv"].shape == (2, 3, 3, 512)
    assert st["ssm"].shape == (2, 3, 512, 8)
    assert st["ssm"].dtype == torch.float32
    assert model.init_decode_state(1, 500, device="cpu")["k"].shape[3] == 64


@pytest.mark.parametrize("pos", [[0, 5, 63, 64, 65, 130], [200] * 6])
def test_ring_mask_matches_jax(pos):
    p = np.asarray(pos, np.int32)
    slot, valid = attn.decode_valid_mask(torch.as_tensor(p), 6, 64, 64)
    jslot, jvalid = jattn.decode_valid_mask(jnp.asarray(p), 6, 64, 64)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    # without a window: [0, pos)
    _, plain = attn.decode_valid_mask(torch.as_tensor(p), 6, 256)
    np.testing.assert_array_equal(plain.numpy(), np.arange(256)[None]
                                  < p[:, None])


def test_mamba_branch_at_once_and_token_by_token(models):
    (jmodel, jparams, _, _), (model, params, _, _) = models
    cfg = model.cfg
    rng = np.random.default_rng(3)
    b, t, di = 2, 21, cfg.ssm.expand * cfg.d_model
    x = rng.standard_normal((b, t, cfg.d_model)).astype(np.float32)
    st0 = {"conv": rng.standard_normal((b, 3, di)).astype(np.float32),
           "ssm": 0.1 * rng.standard_normal(
               (b, di, cfg.ssm.state_dim)).astype(np.float32)}
    jp = jax.tree.map(lambda a: a[1], jparams["layers"]["mamba"])
    p = {k: v[1] for k, v in params["layers"]["mamba"].items()}
    jout, jst = jhymba.mamba_branch(
        jmodel.cfg, jp, jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in st0.items()})
    tst = {k: torch.as_tensor(v) for k, v in st0.items()}
    out, st = hymba.mamba_branch(cfg, p, torch.as_tensor(x), tst)
    _close(out, jout, "at once")
    for k in st:
        _close(st[k], jst[k], f"at once: {k}")
    steps, sst = [], tst
    for i in range(t):
        o, sst = hymba.mamba_branch(cfg, p, torch.as_tensor(x[:, i:i + 1]),
                                    sst)
        steps.append(o)
    _close(torch.cat(steps, 1), jout, "token by token")
    for k in sst:
        _close(sst[k], jst[k], f"token by token: {k}")


@pytest.mark.parametrize("prompt", [20, 60, 100])
def test_prefill_ring_and_states_match_jax(models, prompt):
    """20 + 8 positions (the ring zero-padded), 60 + 8 (rolled by 4) and
    100 + 8 (rolled by 44): hidden states, KV ring, conv and SSM states."""
    (jmodel, jparams, _, _), (model, params, _, _) = models
    rng = np.random.default_rng(prompt)
    toks = rng.integers(0, model.cfg.vocab_size, (2, prompt)).astype(
        np.int32)
    jst, jlast, jh = jmodel.prefill(jmodel.cfg, jparams,
                                    {"tokens": jnp.asarray(toks)}, 96)
    st, last, h = model.prefill(model.cfg, params,
                                {"tokens": torch.as_tensor(toks)}, 96)
    _close(h, jh, "hidden")
    _close(last, jlast, "last hidden")
    _states_close(st, jst, "prefill")
    s = prompt + model.cfg.n_meta_tokens
    if s < 64:
        assert not st["k"][:, :, :, s:].any()


def test_meta_tokens_leave_the_ring(models):
    """The meta tokens sit at positions 0..7 of the ring: a prompt of 50
    (58 positions) keeps them readable at its first decode step; past 64
    positions their slots hold prompt tokens."""
    _, (model, params, _, _) = models
    n_meta = model.cfg.n_meta_tokens
    meta_k = hymba._with_meta(model.cfg, params, torch.zeros(
        (1, 0), dtype=torch.int32))
    assert meta_k.shape == (1, n_meta, model.cfg.d_model)
    short, _, _ = model.prefill(model.cfg, params,
                                {"tokens": torch.ones((1, 50),
                                                      dtype=torch.int32)}, 96)
    long, _, _ = model.prefill(model.cfg, params,
                               {"tokens": torch.ones((1, 70),
                                                     dtype=torch.int32)}, 96)
    _, valid = attn.decode_valid_mask(torch.tensor([50 + n_meta]), 1, 64, 64)
    assert valid[0, :n_meta].all()
    _, valid = attn.decode_valid_mask(torch.tensor([70 + n_meta]), 1, 64, 64)
    # the ring is full: positions 15 to 77, all but the slot about to take
    # position 78
    assert int(valid.sum()) == 63 and not valid[0, 78 % 64]
    # slot 0 now holds position 64 (a prompt token), not meta token 0
    assert not torch.equal(short["k"][:, :, :, 0], long["k"][:, :, :, 0])


def test_decode_steps_wrap_the_ring(models):
    """A 40-token prompt (48 positions) decoded 30 steps, through position
    77: logits, hidden and the whole state equal JAX's at every step."""
    (jmodel, jparams, _, _), (model, params, _, _) = models
    rng = np.random.default_rng(11)
    toks = rng.integers(0, model.cfg.vocab_size, (2, 40)).astype(np.int32)
    jst, _, _ = jmodel.prefill(jmodel.cfg, jparams,
                               {"tokens": jnp.asarray(toks)}, 96)
    st, _, _ = model.prefill(model.cfg, params,
                             {"tokens": torch.as_tensor(toks)}, 96)
    step = jax.jit(lambda tok, state, pos: jmodel.decode_step(
        jmodel.cfg, jparams, tok, state, pos))
    tok = np.zeros(2, np.int32)
    for i in range(30):
        pos = np.asarray([48 + i, 48 + i], np.int32)
        jl, jh, jst = step(jnp.asarray(tok), jst, jnp.asarray(pos))
        lg, h, st = model.decode_step(model.cfg, params, torch.as_tensor(tok),
                                      st, torch.as_tensor(pos))
        _close(lg, jl, f"step {i} logits", RTOL_DECODE)
        _close(h, jh, f"step {i} hidden", RTOL_DECODE)
        tok = np.array(jnp.argmax(jl[:, :model.cfg.vocab_size], -1),
                       np.int32)
        assert tok.tolist() == lg[:, :model.cfg.vocab_size].argmax(
            -1).tolist()
    _states_close(st, jst, "after 30 steps")


# ---------------------------------------------------------------------------
# serving

def _prompts(vocab):
    rng = np.random.default_rng(17)
    out = [rng.integers(0, vocab, n).astype(np.int32) for n in LENS]
    out[2] = out[0].copy()
    return out


def _run_both(models, **kw):
    (jmodel, jparams, jpc, jtheta), (model, params, pc, theta) = models
    kw = dict(dict(tokens_per_step=2, max_new_tokens=24, lam=0.6, burn_in=1,
                   n_slots=2, block_size=8), **kw)
    prompts = _prompts(model.cfg.vocab_size)
    reqs = lambda make: [make(p, max_new_tokens=n)
                         for p, n in zip(prompts, BUDGETS)]
    jdone, jfleet = JOrcaScheduler(jmodel, jparams, jpc, jtheta,
                                   JServeConfig(**kw)).run(
        reqs(j_make_request))
    sched = OrcaScheduler(model, params, pc, theta, ServeConfig(**kw))
    done, fleet = sched.run(reqs(make_request))
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
    assert not sched.engine.paged
    assert sched.engine.state.keys() == {"k", "v", "conv", "ssm"}
    # the ring: min(cache_len, window) positions
    assert sched.engine.state["k"].shape[3] == 64
    return sched, fleet, jfleet


def test_fleet_matches_jax(models):
    sched, _, _ = _run_both(models)
    assert sched.pool is None


def test_paged_fleet_keeps_the_state_dense(models):
    """``paged=True``: both schedulers admit through the block pool (each
    request reserves its meta tokens, prompt and budget) and serve from the
    dense state; the pool drains."""
    sched, fleet, jfleet = _run_both(models, paged=True)
    assert fleet.peak_blocks_in_use == jfleet.peak_blocks_in_use > 0
    assert sched.pool.blocks_in_use == 0


def _engines(models, n=2):
    (jmodel, jparams, jpc, jtheta), (model, params, pc, theta) = models
    ekw = dict(n_slots=3, cache_len=96)
    scfg = dict(tokens_per_step=2, max_new_tokens=40, lam=0.6, burn_in=4)
    jeng = JEngine(jmodel, jparams, jpc, jtheta, JServeConfig(**scfg), **ekw)
    engs = [ContinuousServingEngine(model, params, pc, theta,
                                    ServeConfig(**scfg), **ekw)
            for _ in range(n)]
    rng = np.random.default_rng(5)
    for slot, n_tok in enumerate((45, 13)):
        p = rng.integers(0, model.cfg.vocab_size, n_tok).astype(np.int32)
        jeng.admit(slot, {"tokens": jnp.asarray(p[None])}, n_tok)
        for e in engs:
            e.admit(slot, {"tokens": p[None]}, n_tok)
    return jeng, engs


def test_preempted_request_replays_its_future(models):
    """Slot 0 (45 tokens + 8 meta, its ring about to wrap) preempted after
    6 steps: its Spill equals JAX's (ring, conv and SSM lanes, position
    past the meta tokens), restored into slot 2 its Mamba state is
    bitwise the spilled one, and its next 12 steps (through ring
    positions 59 to 70) equal the undisturbed twin's bit for bit and JAX's
    restored engine's."""
    jeng, (eng_a, eng_b) = _engines(models)
    for _ in range(6):
        for e in (jeng, eng_a, eng_b):
            e.step()
    ssm_before = eng_a.state["ssm"][:, 0].clone()
    jspill, spill = jeng.preempt(0), eng_a.preempt(0)
    assert (spill.pos, spill.token) == (jspill.pos, jspill.token)
    assert spill.pos == 45 + 8 + 6
    assert set(spill.lane) == {"k", "v", "conv", "ssm"}
    jlane = _flat(jspill.lane)
    for key, val in spill.lane.items():
        _close(val, jlane[key], f"spill {key}",
               RTOL_SSM if key == "ssm" else RTOL)
    for got, want in zip(spill.probe, jspill.probe):
        _close(got, want, "probe row", rtol=1e-5)
    assert torch.equal(spill.lane["ssm"], ssm_before)
    jeng.restore(2, jspill)
    eng_a.restore(2, spill)
    assert torch.equal(eng_a.state["ssm"][:, 2], ssm_before)
    assert torch.equal(eng_a.state["conv"][:, 2], eng_b.state["conv"][:, 0])
    for i in range(12):
        va, vb, jv = eng_a.step(), eng_b.step(), jeng.step()
        for f in ("tokens", "smoothed", "n_scores", "stopped", "stop_step"):
            np.testing.assert_array_equal(getattr(va, f)[2],
                                          getattr(vb, f)[0],
                                          err_msg=f"step {i}: {f}")
            _close(np.asarray(getattr(va, f)[2], np.float32),
                   np.asarray(np.asarray(getattr(jv, f))[2], np.float32),
                   f"step {i}: {f} against JAX", rtol=1e-5)
        if va.stopped[2]:
            break
    assert torch.equal(eng_a.state["ssm"][:, 2], eng_b.state["ssm"][:, 0])


def test_serve_driver_runs_hymba_on_cpu(capsys):
    out = tserve.serve(["--arch", "hymba-1.5b", "--reduced", "--device",
                        "cpu", "--requests", "3", "--slots", "2",
                        "--max-new-tokens", "16", "--tokens-per-step", "4",
                        "--train-trajectories", "8", "--epochs", "2",
                        "--prompt-len", "8", "--static-baseline"])
    text = capsys.readouterr().out
    assert "[serve] hymba-1.5b on cpu" in text
    assert out.static.stop_step.tolist() == [r.stop_step
                                             for r in out.requests]
