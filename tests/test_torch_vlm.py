"""The VLM family (llava-next-34b) in the port, held to the JAX package on
the reduced config (2 layers, d_model 256, 4 heads of 32 on 2 KV heads:
G 2; 16 patch tokens of width 64) with weights carried across by
``models/convert.py``:

* the config equals JAX's field by field;
* ``project_patches`` (w1 + b1, gelu, w2 + b2) against JAX's, with the
  projector's biases drawn nonzero so both products and the gelu count;
* ``prefill`` with the patch prefix in front of the prompt (the cache's
  prefix and prompt positions, the hidden states over both), then 4
  decode steps after the prefix, from a dense cache and from pages;
* the JAX suite's paged-prefix test (``tests/test_paged_kv.py``): the
  reservation covers prefix + budget and decode resumes after the prefix;
* a paged fleet of 2 image and 2 text requests (the text prefilled in
  chunks, the images at admission) and a linear spec fleet of image
  requests, served by both packages: stops and tokens exactly equal;
* the serving driver on ``--arch llava-next-34b --reduced``.

Patches are drawn with numpy from a seed at std 1: zero patches project to
exact zeros (zero biases, gelu(0) = 0) and would hold nothing.
"""
import dataclasses
import functools

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
from repro.models import transformer as jtf
from repro.serving import OrcaScheduler as JOrcaScheduler
from repro.serving import ServeConfig as JServeConfig
from repro.serving import make_request as j_make_request

from repro_torch.configs import get_config
from repro_torch.core.probe import ProbeConfig
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import build
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import from_jax_params, from_jax_theta
from repro_torch.serving import (OrcaScheduler, RequestState, ServeConfig,
                                 blocks_needed, make_request)

ARCH = "llava-next-34b"
# f32 products and gelu in another order than XLA's; the projected
# patches are O(1)
ATOL_PROJ = 1e-5
# logits and final-norm hidden states absolute, as tests/test_torch_model.py
# holds them (the worst seen here 2.4e-5); K/V relative to the largest
# entry, twice that file's 2e-5: the patch prefix (O(1) projected patches,
# biases drawn at std 0.5) adds 16 positions to every attention sum, and
# the worst entry seen is 2.23e-5 of the largest (layer 1's prefill K,
# about 39)
ATOL_LOGITS = 1e-4
ATOL_HIDDEN = 1e-4
RTOL_KV = 4e-5
# the scheduler's per-request scores (tests/test_torch_serve.py)
ATOL_SCORES = 1e-5
B, S, BS, STEPS = 2, 11, 8, 4


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@functools.lru_cache(maxsize=None)
def _pair(biases: bool = False):
    """Both packages' reduced llava-next-34b on the same weights; with
    ``biases`` the projector's b1 and b2 are drawn at random (the JAX init
    leaves them zero)."""
    jcfg = j_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jparams = j_build(jcfg).init(jax.random.PRNGKey(0))
    if biases:
        rng = np.random.default_rng(5)
        proj = dict(jparams["projector"])
        for name in ("b1", "b2"):
            proj[name] = jnp.asarray(
                0.5 * rng.standard_normal(proj[name].shape), jnp.float32)
        jparams = dict(jparams, projector=proj)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), build(cfg),
                             device="cpu")
    return jcfg, jparams, cfg, params


def _patches(cfg, n, seed=0):
    """(n, patch tokens, embed_dim) float32 patch embeddings, std 1."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (n, cfg.frontend.n_tokens, cfg.frontend.embed_dim)).astype(np.float32)


def _close(port, ref, atol, msg):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), rtol=0,
                               atol=atol, err_msg=msg)


def _close_kv(port, ref, msg):
    ref = np.asarray(ref, np.float32)
    _close(port, ref, RTOL_KV * max(1.0, float(np.abs(ref).max())), msg)


# ---------------------------------------------------------------------------
# config, params, projector

def test_config_equals_jax_field_by_field():
    cfg, jcfg = get_config(ARCH), j_get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert type(cfg).__module__.startswith("repro_torch.")
    assert cfg.param_count() == jcfg.param_count() == 34_388_049_920
    assert (cfg.arch_type, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.d_head, cfg.d_ff, cfg.vocab_size,
            cfg.frontend.n_tokens, cfg.frontend.embed_dim) == \
        ("vlm", 60, 7168, 56, 8, 128, 20480, 64000, 2880, 1024)
    assert dataclasses.asdict(cfg.reduced()) == \
        dataclasses.asdict(jcfg.reduced())
    assert (cfg.reduced().frontend.n_tokens,
            cfg.reduced().frontend.embed_dim) == (16, 64)


def test_from_jax_params_carries_the_projector():
    jcfg, jparams, cfg, params = _pair(biases=True)
    decls = build(cfg).decls
    assert decls.keys() == jparams.keys()
    assert set(decls["projector"]) == {"w1", "b1", "w2", "b2"}
    for name, leaf in jparams["projector"].items():
        assert tuple(decls["projector"][name].shape) == leaf.shape, name
        np.testing.assert_array_equal(params["projector"][name].numpy(),
                                      np.asarray(leaf))
    assert float(params["projector"]["b1"].abs().max()) > 0


@pytest.mark.parametrize("biases", [False, True])
def test_project_patches_matches_jax(biases):
    jcfg, jparams, cfg, params = _pair(biases)
    patches = _patches(cfg, B)
    want = jtf.project_patches(jcfg, jparams, jnp.asarray(patches))
    got = ttf.project_patches(cfg, params, torch.from_numpy(patches))
    assert tuple(got.shape) == (B, cfg.frontend.n_tokens, cfg.d_model)
    assert float(np.abs(np.asarray(want)).max()) > 0.1
    _close(got, want, ATOL_PROJ, "projected patches")


# ---------------------------------------------------------------------------
# prefill with the prefix, then decode

def _inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab_size, (STEPS, B)).astype(np.int32)
    return prompt, _patches(cfg, B, seed), feed


def _prefill_both(jcfg, jparams, cfg, params, prompt, patches, cache_len):
    jout = jtf.prefill(jcfg, jparams, {"tokens": jnp.asarray(prompt),
                                       "patch_embeds": jnp.asarray(patches)},
                       cache_len)
    out = ttf.prefill(cfg, params, {"tokens": torch.from_numpy(prompt),
                                    "patch_embeds": torch.from_numpy(patches)},
                      cache_len)
    return jout, out


def test_prefill_with_the_prefix_matches_jax():
    jcfg, jparams, cfg, params = _pair(biases=True)
    prompt, patches, _ = _inputs(cfg)
    n = cfg.frontend.n_tokens + S
    (jcache, jlast, jh), (cache, last, h) = _prefill_both(
        jcfg, jparams, cfg, params, prompt, patches, n + STEPS)
    assert tuple(h.shape) == (B, n, cfg.d_model)
    for key in ("k", "v"):
        assert tuple(cache[key].shape)[3] == n + STEPS
        _close_kv(cache[key][:, :, :, :n], jcache[key][:, :, :, :n], key)
        assert float(cache[key][:, :, :, n:].abs().max()) == 0.0
    _close(h, jh, ATOL_HIDDEN, "h_all")
    _close(last, jlast, ATOL_HIDDEN, "last hidden")
    # the prefix is not the text: the patch positions differ from a
    # text-only prefill's
    _, _, h_text = ttf.prefill(cfg, params,
                               {"tokens": torch.from_numpy(prompt)}, S)
    assert float((h[:, -S:] - h_text).abs().max()) > 1e-2


def _decode_both(jcfg, jparams, cfg, params, jstate, state, feed, pos0):
    jstep = jax.jit(functools.partial(jtf.decode_step, jcfg))
    for t in range(STEPS):
        pos = np.full((B,), pos0 + t, np.int32)
        jlog, jhid, jstate = jstep(jparams, jnp.asarray(feed[t]), jstate,
                                   jnp.asarray(pos))
        log, hid, state = ttf.decode_step(cfg, params,
                                          torch.from_numpy(feed[t]), state,
                                          torch.from_numpy(pos))
        _close(log, jlog, ATOL_LOGITS, f"logits @ step {t}")
        _close(hid, jhid, ATOL_HIDDEN, f"hidden @ step {t}")
    return jstate, state


def test_dense_decode_after_the_prefix_matches_jax():
    jcfg, jparams, cfg, params = _pair(biases=True)
    prompt, patches, feed = _inputs(cfg, seed=2)
    n = cfg.frontend.n_tokens + S
    (jcache, _, _), (cache, _, _) = _prefill_both(
        jcfg, jparams, cfg, params, prompt, patches, n + STEPS)
    jcache, cache = _decode_both(jcfg, jparams, cfg, params, jcache, cache,
                                 feed, n)
    for key in ("k", "v"):
        _close_kv(cache[key], jcache[key], key)


def test_paged_decode_after_the_prefix_matches_jax():
    """Each row's prefix and prompt scattered into a shuffled set of pages
    (page 0 the NULL page), then 4 steps through each package's paged
    decode (the port's K2 plain version, JAX's jnp gather)."""
    jcfg, jparams, cfg, params = _pair(biases=True)
    prompt, patches, feed = _inputs(cfg, seed=3)
    n = cfg.frontend.n_tokens + S
    nb = -(-(n + STEPS) // BS)
    n_pre = -(-n // BS)
    rows = (1 + np.random.default_rng(7).permutation(B * nb)).reshape(B, nb)
    rows = rows.astype(np.int32)
    jstate = j_build(jcfg).init_paged_state(B, B * nb + 1, BS, nb)
    state = build(cfg).init_paged_state(B, B * nb + 1, BS, nb, device="cpu")
    jpages = {k: v for k, v in jstate.items() if k != "block_tables"}
    pages = {k: v for k, v in state.items() if k != "block_tables"}
    (jpre, _, _), (pre, _, _) = _prefill_both(
        jcfg, jparams, cfg, params, prompt, patches, n_pre * BS)
    for i in range(B):
        jpages = jattn.prefill_to_pages(
            jpages, {k: v[:, i:i + 1] for k, v in jpre.items()},
            jnp.asarray(rows[i]), n_pre)
        tattn.prefill_to_pages(pages, {k: v[:, i:i + 1]
                                       for k, v in pre.items()},
                               torch.from_numpy(rows[i]), n_pre)
    jstate = dict(jpages, block_tables=jnp.asarray(rows))
    state["block_tables"].copy_(torch.from_numpy(rows))
    jstate, state = _decode_both(jcfg, jparams, cfg, params, jstate, state,
                                 feed, n)
    for key in ("k", "v"):
        _close_kv(state[key], jstate[key], key)


# ---------------------------------------------------------------------------
# serving

@functools.lru_cache(maxsize=None)
def _served():
    """Both packages' reduced model and a decisive probe (the
    ``_probe(cfg, 3.0)`` pattern of the JAX suite: scores far above
    lambda*, so no stop hangs on a near tie)."""
    jcfg, jparams, cfg, params = _pair(biases=True)
    jpc = JProbeConfig(d_phi=jcfg.d_model, smooth_window=2)
    jtheta = j_init_outer(jpc, jax.random.PRNGKey(1))
    jtheta["b0"] = jnp.asarray(3.0)
    pc = ProbeConfig(d_phi=cfg.d_model, smooth_window=2)
    theta = from_jax_theta({k: np.asarray(v) for k, v in jtheta.items()},
                           device="cpu")
    return (j_build(jcfg), jparams, jpc, jtheta), (build(cfg), params, pc,
                                                   theta)


def _requests(cfg, kinds, lens, budgets, maker):
    """One request per kind: "image" carries seeded patches, "text"
    none."""
    rng = np.random.default_rng(17)
    out = []
    for i, (kind, n, budget) in enumerate(zip(kinds, lens, budgets)):
        prompt = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
        extra = ({"patch_embeds": _patches(cfg, 1, seed=20 + i)}
                 if kind == "image" else None)
        out.append(maker(prompt, extra=extra, max_new_tokens=budget))
    return out


def _fleets(kw, kinds, lens, budgets, jkw=()):
    (jmodel, jparams, jpc, jtheta), (model, params, pc, theta) = _served()
    cfg = model.cfg
    jdone, jfleet = JOrcaScheduler(
        jmodel, jparams, jpc, jtheta, JServeConfig(**kw, **dict(jkw))).run(
        _requests(cfg, kinds, lens, budgets, j_make_request))
    sched = OrcaScheduler(model, params, pc, theta, ServeConfig(**kw))
    done, fleet = sched.run(_requests(cfg, kinds, lens, budgets,
                                      make_request))
    assert [r.state.value for r in done] == [r.state.value for r in jdone]
    return sched, (done, fleet), (jdone, jfleet)


def test_mixed_image_and_text_paged_fleet_matches_jax():
    """2 image requests prefilled in one shot at admission (the patch
    prefix is never chunked) beside 2 text requests prefilled in 4-token
    chunks, on 2 slots of paged KV: per request the stop, tokens, schedule
    and scores equal JAX's (run with its jnp probe oracle,
    ``probe_impl="ref"``), and the pool drains."""
    kinds = ("image", "text", "image", "text")
    lens, budgets = (6, 13, 9, 11), (12, 12, 3, 12)
    kw = dict(tokens_per_step=2, max_new_tokens=12, lam=0.6, burn_in=1,
              n_slots=2, block_size=4, paged=True, chunk_tokens=4)
    sched, (done, fleet), (jdone, jfleet) = _fleets(
        kw, kinds, lens, budgets, jkw=dict(probe_impl="ref"))
    assert {r.state.value for r in done} == {RequestState.STOPPED.value,
                                             RequestState.FINISHED.value}
    for r, jr in zip(done, jdone):
        for fld in ("stop_step", "tokens", "admitted_step",
                    "first_token_step", "completed_step", "slot",
                    "prefill_progress"):
            assert getattr(r, fld) == getattr(jr, fld), (r.req_id, fld)
        np.testing.assert_allclose(r.scores, jr.scores, rtol=0,
                                   atol=ATOL_SCORES)
    for fld in ("engine_steps", "prefill_chunks", "packed_chunks",
                "peak_step_tokens", "prefill_skips"):
        assert getattr(fleet, fld) == getattr(jfleet, fld), fld
    assert fleet.prefill_chunks > 0
    # the image requests reserved their prefix: 16 patches + prompt + budget
    n_patch = sched.model.cfg.frontend.n_tokens
    for r, kind, n, budget in zip(done, kinds, lens, budgets):
        extra = n_patch if kind == "image" else 0
        assert len(r.block_ids) == blocks_needed(extra + n + budget, 4), \
            r.req_id
    assert sched.pool.blocks_in_use == 0
    sched.pool.check()


def test_image_spec_fleet_matches_jax():
    """Linear speculative decode (``spec_tokens=4``) over 3 image requests
    on paged KV, the verify pass reading each request's patch prefix from
    its pages: per request the stop, tokens, drafts proposed and accepted
    equal JAX's (run with its jnp probe oracle, ``probe_impl="ref"``), and
    the port's one-token fleet stops alike."""
    kinds = ("image", "image", "image")
    kw = dict(tokens_per_step=2, max_new_tokens=12, lam=0.6, burn_in=1,
              n_slots=2, block_size=4, paged=True)
    skw = dict(kw, spec_tokens=4, draft_cache_size=4096)
    lens, budgets = (9, 13, 7), (12, 12, 12)
    sched, (done, fleet), (jdone, jfleet) = _fleets(
        skw, kinds, lens, budgets, jkw=dict(probe_impl="ref"))
    for r, jr in zip(done, jdone):
        for fld in ("stop_step", "tokens", "completed_step", "admitted_step",
                    "spec_proposed", "spec_accepted", "accepted_lens",
                    "draft_hits", "draft_misses"):
            assert getattr(r, fld) == getattr(jr, fld), (r.req_id, fld)
        np.testing.assert_allclose(r.scores, jr.scores, rtol=0,
                                   atol=ATOL_SCORES)
    for fld in ("engine_steps", "spec_tokens_proposed",
                "spec_tokens_accepted", "draft_cache_hits",
                "draft_cache_misses"):
        assert getattr(fleet, fld) == getattr(jfleet, fld), fld
    assert fleet.spec_tokens_proposed > 0
    assert sched.pool.blocks_in_use == 0
    (_, _, _, _), (model, params, pc, theta) = _served()
    one, _ = OrcaScheduler(model, params, pc, theta, ServeConfig(**kw)).run(
        _requests(model.cfg, kinds, lens, budgets, make_request))
    assert [r.stop_step for r in done] == [r.stop_step for r in one]
    assert [r.tokens for r in done] == [r.tokens for r in one]


def test_paged_vlm_prefix_reserved_and_decode_resumes_after_it():
    """The port of the JAX suite's test of the same name: the paged
    reservation covers prefix + decode budget, the auto-sized pool fits
    it, and decode resumes AFTER the whole prefix (pos = patches +
    prompt)."""
    (_, _, _, _), (model, params, pc, theta) = _served()
    cfg = model.cfg
    scfg = ServeConfig(tokens_per_step=2, max_new_tokens=8, lam=0.6,
                       burn_in=1)
    # prefix = 4 prompt + 16 patches = 20; need 20 + 8 decode = 28 tokens
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, cfg.vocab_size, (3, 4)).astype(np.int32)
    patches = _patches(cfg, 1, seed=4)
    reqs = [make_request(p, extra={"patch_embeds": patches})
            for p in prompts]
    sched = OrcaScheduler(model, params, pc, theta, scfg, n_slots=2,
                          paged=True, block_size=4)
    done, fleet = sched.run(reqs)
    assert all(r.done for r in done)
    assert all(len(r.block_ids) == blocks_needed(20 + 8, 4) for r in done)
    assert fleet.pool_blocks >= 2 * blocks_needed(20 + 8, 4)
    eng = sched._engine
    eng.admit(0, reqs[0].inputs, reqs[0].prompt_len,
              block_row=sched.pool.allocate(blocks_needed(28, 4)))
    assert int(eng.pos[0]) == 20


def test_serve_driver_runs_llava_on_cpu(capsys):
    rc = tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--paged", "--requests", "3", "--slots", "2",
                      "--max-new-tokens", "16", "--tokens-per-step", "4",
                      "--train-trajectories", "8", "--epochs", "2",
                      "--prompt-len", "8"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "[serve] llava-next-34b on cpu" in out
    assert "[serve] fleet: 3 requests / 2 slots" in out
