"""The port's linear speculative decode held to the JAX package on the
reduced smollm-360m with weights and probe slow weights carried across:
K4's plain version against the chained one-token oracle
(``repro/kernels/ref.py:80``) and against per-slot chains of K1's plain
version; ``probe_update_spec``; ``verify_packed_chunk`` (dense and
paged); the shared ``DraftCache``; the engine's spec step; and spec fleets
through ``OrcaScheduler`` (k 2 and 4, dense and paged, chunked and not,
draft cache on and off), whose stops also equal the port's one-token
fleet's.  The JAX side runs with ``probe_impl="ref"``: its Pallas spec
probe kernel needs ``pallas.load``, which this JAX lacks.  Plus the spec
and tree knobs of ``ServeConfig`` and the serving driver (the tree path
itself is held in ``test_torch_tree.py``)."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.probe import ProbeConfig as JProbeConfig
from repro.core.probe import init_outer as j_init_outer
from repro.kernels import ref as jref
from repro.launch import serve as jserve
from repro.models import transformer as jtf
from repro.serving import ContinuousServingEngine as JEngine
from repro.serving import DraftCache as JDraftCache
from repro.serving import OrcaScheduler as JOrcaScheduler
from repro.serving import ServeConfig as JServeConfig
from repro.serving import make_request as j_make_request
from repro.serving import engine as jengine

from repro_torch.core.probe import ProbeConfig
from repro_torch.kernels.probe_spec import serving_probe_spec_step
from repro_torch.kernels.probe_step import serving_probe_step
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import from_jax_theta
from repro_torch.serving import (ContinuousServingEngine, DraftCache,
                                 OrcaScheduler, ServeConfig, make_request)
from repro_torch.serving import engine as tengine
from tests.test_torch_serve import BUDGETS, _models, _prompts

# f32 on both sides, reduced in another order: the probe's floats agree to
# a few ulps of their O(1) values
ATOL = 1e-5
# K/V entries reach ~45 at this init: f32 rounding relative to the largest
RTOL_KV = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def models():
    return _models()


# ---------------------------------------------------------------------------
# K4's plain version

B, T, F, WIN, BURN = 5, 4, 48, 4, 2
ETA, LAM = 0.05, 0.6
# per-slot biases far from lambda* 0.6 in score: sigmoid gives .05, .95,
# .27, .98, .92, so every smoothed score keeps a margin of about 0.3
BIASES = np.array([-3.0, 3.0, -1.0, 4.0, 2.5], np.float32)


def _accepts(mode):
    if mode == "mixed":
        return np.array([(i * 3) % (T + 1) for i in range(B)], np.int32)
    n = {"zero": 0, "one": 1, "km1": T - 1, "k": T}[mode]
    return np.full((B,), n, np.int32)


def _spec_inputs(mode, warm, seed=3):
    """``warm``: every slot is at the burn-in with its ring holding its own
    score, so a high-bias slot stops on its first boundary token (mid-chain
    when later tokens are accepted), and slot 1 is stopped on entry.  Not
    warm: fresh state, where the burn-in holds every stop for two scores."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    zq = (rng.normal(size=(B, T, F)) / np.sqrt(F)).astype(f32)
    zk = (rng.normal(size=(B, T, F)) / np.sqrt(F)).astype(f32)
    bnd = rng.random((B, T)) < 0.7
    bnd[:, 0] = True
    W = (rng.normal(size=(B, F)) / np.sqrt(F)).astype(f32)
    ring = np.zeros((B, WIN), f32)
    n = np.zeros((B,), np.int32)
    stopped = np.zeros((B,), bool)
    stop_step = np.full((B,), -1, np.int32)
    if warm:
        ring[:, -BURN:] = (1.0 / (1.0 + np.exp(-BIASES)))[:, None]
        n[:] = BURN
        stopped[1], stop_step[1] = True, BURN
    return (zq, zk, bnd, _accepts(mode)), (W, BIASES.copy(), ring, n,
                                           stopped, stop_step)


@pytest.mark.parametrize("warm", [True, False])
@pytest.mark.parametrize("mode", ["zero", "one", "km1", "k", "mixed"])
def test_spec_probe_plain_matches_jax_and_chained_k1(mode, warm):
    """Integer and boolean state exactly JAX's, floats within ATOL; and
    bit for bit the state of ``accept[i]`` sequential K1 plain calls on
    slot i alone."""
    (zq, zk, bnd, acc), state = _spec_inputs(mode, warm)
    ref = jref.serving_probe_spec_step_ref(
        jnp.asarray(zq), jnp.asarray(zk), jnp.asarray(bnd), jnp.asarray(acc),
        *(jnp.asarray(a) for a in state), jnp.asarray(ETA, jnp.float32),
        jnp.asarray(LAM, jnp.float32), burn_in=BURN)
    tst = [torch.from_numpy(a.copy()) for a in state]
    out = serving_probe_spec_step(
        torch.from_numpy(zq), torch.from_numpy(zk), torch.from_numpy(bnd),
        torch.from_numpy(acc), *tst, ETA, LAM, burn_in=BURN)
    for fld in ("n_seq", "n_scores", "stopped", "stop_step"):
        np.testing.assert_array_equal(getattr(out, fld).numpy(),
                                      np.asarray(getattr(ref, fld)),
                                      err_msg=fld)
    for fld in ("s", "smoothed_seq", "W", "b", "ring", "smoothed"):
        np.testing.assert_allclose(getattr(out, fld).numpy(),
                                   np.asarray(getattr(ref, fld)), rtol=0,
                                   atol=ATOL, err_msg=fld)
    # the spec-decode invariant, per slot
    for i in range(B):
        row = [torch.from_numpy(a[i:i + 1].copy()) for a in state]
        for t in range(int(acc[i])):
            serving_probe_step(torch.from_numpy(zq[i:i + 1, t]),
                               torch.from_numpy(zk[i:i + 1, t]),
                               torch.from_numpy(bnd[i:i + 1, t]), *row, ETA,
                               LAM, burn_in=BURN)
            assert int(row[3]) == int(out.n_seq[i, t]), (i, t)
        for name, a, b in zip(("W", "b", "ring", "n", "stopped", "stop"),
                              row, tst):
            assert torch.equal(a[0], b[i]), (name, i)
    if mode == "zero":
        for a, b in zip(state, tst):
            np.testing.assert_array_equal(b.numpy(), a)
    if warm and mode == "k":
        # a stop fired on a first token and froze the rest of the chain
        fired = (out.stop_step.numpy() == BURN + 1) & ~state[4]
        assert fired.any()
        assert (out.n_seq.numpy()[fired, -1] == BURN + 1).all()
    if not warm and mode in ("one", "km1"):
        assert not out.stopped.numpy().any()


# ---------------------------------------------------------------------------
# probe_update_spec

@pytest.mark.parametrize("variant", ["noqk", "qk"])
def test_probe_update_spec_matches_jax(variant):
    """The same hidden sequence and accept vector through both packages'
    multi-token probe advance, from a mid-step state (some tokens pooled,
    one slot parked)."""
    d, bsz, k = 32, 4, 4
    jpc = JProbeConfig(d_phi=d, variant=variant, d_h=16, smooth_window=3)
    jtheta = j_init_outer(jpc, jax.random.PRNGKey(4))
    pc = ProbeConfig(d_phi=d, variant=variant, d_h=16, smooth_window=3)
    theta = from_jax_theta({kk: np.asarray(v) for kk, v in jtheta.items()},
                           device="cpu")
    rng = np.random.default_rng(5)
    hidden = rng.normal(size=(bsz, k, d)).astype(np.float32)
    accept = np.array([4, 2, 0, 3], np.int32)
    jst = jengine.init_probe_state(jpc, jtheta, bsz, d)
    jst = jst._replace(
        hid_sum=jnp.asarray(rng.normal(size=(bsz, d)).astype(np.float32)),
        tok_count=jnp.asarray([1, 0, 1, 0], jnp.int32),
        stopped=jnp.asarray([False, False, True, False]))
    st = tengine.ProbeState(*(torch.from_numpy(np.array(a)) for a in jst))
    kw = dict(lam=0.7, tokens_per_step=2, burn_in=0)
    jnew, jsm, jn = jengine.probe_update_spec(
        jpc, jtheta, jst, jnp.asarray(hidden), jnp.asarray(accept),
        probe_impl="ref", **kw)
    eta = float(np.asarray(jpc.eta))
    new, sm, n = tengine.probe_update_spec(
        pc, theta, st, torch.from_numpy(hidden), torch.from_numpy(accept),
        eta=eta, **kw)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_allclose(sm.numpy(), np.asarray(jsm), rtol=0,
                               atol=ATOL)
    for fld in new._fields:
        got, want = getattr(new, fld).numpy(), np.asarray(getattr(jnew, fld))
        if got.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL,
                                       err_msg=fld)
        else:
            np.testing.assert_array_equal(got, want, err_msg=fld)
    assert int(np.asarray(jn).max()) > 0


# ---------------------------------------------------------------------------
# verify_packed_chunk

BS, NB = 4, 6


@pytest.mark.parametrize("paged", [False, True])
def test_verify_packed_chunk_matches_jax(monkeypatch, models, paged):
    """Two slots with 5 and 3 prompt positions cached, then one verify
    chunk of k = 4 per slot laid out as the engine lays it out: slot 0
    verifies 3 tokens, slot 1 all 4, one padding token.  Logits, hidden
    and the written pages (or lanes) against JAX's."""
    if paged:
        monkeypatch.setenv("REPRO_PAGED_ATTN", "pallas")
    (jmodel, jparams, _, _), (model, params, _, _) = models
    jcfg, cfg = jmodel.cfg, model.cfg
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 3)]
    rows = (1 + rng.permutation(2 * NB)).reshape(2, NB).astype(np.int32)
    if paged:
        jst = jmodel.init_paged_state(2, 2 * NB + 1, BS, NB)
        st = model.init_paged_state(2, 2 * NB + 1, BS, NB, device="cpu")
    else:
        jst = jmodel.init_decode_state(2, BS * NB)
        st = model.init_decode_state(2, BS * NB, device="cpu")
    # the prompts, packed into one chunk, through both packages; then the
    # verify chunk
    jrows = None if not paged else jnp.asarray(rows)
    trows = None if not paged else torch.from_numpy(rows)
    toks = rng.integers(0, cfg.vocab_size, 8).astype(np.int32)
    toks[7] = 0
    chunks = [(np.concatenate(prompts), np.array([0] * 5 + [1] * 3, np.int32),
               np.array([0, 0], np.int32), np.array([5, 3], np.int32)),
              (toks, np.array([0, 0, 0, 1, 1, 1, 1, 0], np.int32),
               np.array([5, 3], np.int32), np.array([3, 4], np.int32))]
    slots = np.array([0, 1], np.int32)
    (tk, sg, sp, ln) = chunks[0]
    jst = jtf.prefill_packed_chunk(jcfg, jparams, jnp.asarray(tk), jst,
                                   jnp.asarray(sg), jnp.asarray(slots),
                                   jnp.asarray(sp), jnp.asarray(ln), jrows)
    ttf.prefill_packed_chunk(cfg, params, torch.from_numpy(tk), st,
                             torch.from_numpy(sg), torch.from_numpy(slots),
                             torch.from_numpy(sp), torch.from_numpy(ln),
                             trows)
    (tk, sg, sp, ln) = chunks[1]
    jl, jh, jst = jtf.verify_packed_chunk(
        jcfg, jparams, jnp.asarray(tk), jst, jnp.asarray(sg),
        jnp.asarray(slots), jnp.asarray(sp), jnp.asarray(ln), jrows)
    tl, th, st = ttf.verify_packed_chunk(
        cfg, params, torch.from_numpy(tk), st, torch.from_numpy(sg),
        torch.from_numpy(slots), torch.from_numpy(sp), torch.from_numpy(ln),
        trows)
    real = np.arange(7)                    # the padding token is not scored
    for got, want in ((tl, jl), (th, jh)):
        want = np.asarray(want, np.float32)[real]
        np.testing.assert_allclose(
            got.float().numpy()[real], want, rtol=0,
            atol=RTOL_KV * max(1.0, float(np.abs(want).max())))
    for key in st:
        if key == "block_tables":
            continue
        got, want = st[key].float().numpy(), np.asarray(jst[key], np.float32)
        if paged:                      # page 0, the NULL page, is scratch
            got, want = got[:, 1:], want[:, 1:]
        np.testing.assert_allclose(
            got, want, rtol=0, atol=RTOL_KV * max(1.0, np.abs(want).max()),
            err_msg=key)


# ---------------------------------------------------------------------------
# DraftCache

def test_draft_cache_matches_jax():
    """One seeded stream of observe/lookup calls on a small vocabulary (so
    n-grams recur) and a capacity of 12 keys (so LRU eviction runs):
    every lookup, the counters and the table equal JAX's."""
    rng = np.random.default_rng(7)
    ours, theirs = DraftCache(capacity=12), JDraftCache(capacity=12)
    for step in range(200):
        ctx = rng.integers(0, 6, rng.integers(0, 5)).tolist()
        if rng.random() < 0.5:
            acc = rng.integers(0, 6, rng.integers(0, 5)).tolist()
            ours.observe(ctx, acc)
            theirs.observe(ctx, acc)
        else:
            w, d = int(rng.integers(1, 3)), int(rng.integers(1, 5))
            (a, hit_a), (b, hit_b) = ours.lookup(ctx, w, d), \
                theirs.lookup(ctx, w, d)
            assert hit_a == hit_b, step
            np.testing.assert_array_equal(a, b, err_msg=str(step))
        assert list(ours._table.items()) == list(theirs._table.items())
    assert (ours.hits, ours.misses) == (theirs.hits, theirs.misses)
    assert ours.hits > 0 and ours.misses > 0 and len(ours) == 12
    assert ours.hit_rate == theirs.hit_rate


# ---------------------------------------------------------------------------
# the engine's spec step

@pytest.mark.parametrize("paged", [False, True])
def test_spec_engine_step_matches_jax(models, paged):
    """Two slots admitted in both engines, then four spec steps of k = 4
    with per-slot lengths (a parked length, a short block, host drafts):
    gen, seq, seq_scores, seq_n, pos, the next token and the stop state
    equal JAX's after every step.  Step 2 drafts slot 0 with the last
    step's own tokens; step 3 drafts both slots with their one-token
    continuations, which the verifier accepts whole (gen 3, two probe
    boundaries in one chain)."""
    (jmodel, jparams, jpc, jtheta), (model, params, pc, theta) = models
    kw = dict(tokens_per_step=2, max_new_tokens=16, lam=0.99, burn_in=1)
    ekw = dict(n_slots=3, cache_len=32, paged=paged, block_size=BS)
    jeng = JEngine(jmodel, jparams, jpc, jtheta, JServeConfig(**kw),
                   probe_impl="ref", spec_tokens=4, **ekw)
    eng = ContinuousServingEngine(model, params, pc, theta,
                                  ServeConfig(**kw), spec_tokens=4, **ekw)
    one = ContinuousServingEngine(model, params, pc, theta,
                                  ServeConfig(**kw), **ekw)
    prompts = _prompts(model.cfg.vocab_size)[:2]
    for slot, p in enumerate(prompts):
        row = (np.arange(8, dtype=np.int32) + 1 + 8 * slot) if paged \
            else None
        jeng.admit(slot, {"tokens": jnp.asarray(p[None])}, len(p),
                   **({"block_row": row} if paged else {}))
        for e in (eng, one):
            e.admit(slot, {"tokens": p[None]}, len(p),
                    **({"block_row": row} if paged else {}))
    # the one-token engine's tokens: what the spec steps commit, in order
    cont = np.stack([one.step().tokens[:2] for _ in range(14)], axis=1)
    done = np.zeros((2,), int)
    drafts = np.zeros((3, 3), np.int32)
    have = np.zeros((3,), bool)
    for step, lens in enumerate(([4, 4, 0], [2, 4, 0], [4, 1, 0],
                                 [3, 3, 0])):
        if step == 2:              # host drafts: the last step's own tokens
            drafts[0], have[0] = jview.seq[0, :3], True
        if step == 3:              # host drafts: the one-token continuation
            for slot in range(2):
                drafts[slot] = cont[slot, done[slot]:done[slot] + 3]
            have[:2] = True
        lens = np.array(lens, np.int32)
        jview = jeng.step(spec_lens=lens, spec_drafts=drafts, spec_have=have)
        view = eng.step(spec_lens=lens, spec_drafts=drafts, spec_have=have)
        for fld in ("tokens", "stopped", "stop_step", "n_scores", "gen",
                    "seq", "seq_n"):
            np.testing.assert_array_equal(getattr(view, fld),
                                          np.asarray(getattr(jview, fld)),
                                          err_msg=f"step {step} {fld}")
        for fld in ("smoothed", "seq_scores"):
            np.testing.assert_allclose(getattr(view, fld),
                                       np.asarray(getattr(jview, fld)),
                                       rtol=0, atol=ATOL,
                                       err_msg=f"step {step} {fld}")
        np.testing.assert_array_equal(eng.pos, jeng.pos)
        assert view.gen[2] == 0 and (view.gen[:2] >= 1).all()
        for slot in range(2):
            g = int(view.gen[slot])
            np.testing.assert_array_equal(
                view.seq[slot, :g], cont[slot, done[slot]:done[slot] + g])
            done[slot] += g
    np.testing.assert_array_equal(view.gen[:2], [3, 3])


# ---------------------------------------------------------------------------
# spec fleets through OrcaScheduler

FLEETS = [  # (spec_tokens, paged, chunk_tokens, draft_cache_size)
    (2, False, None, 4096),
    (4, False, None, 0),
    (4, True, None, 4096),
    (2, True, 4, 4096),
    (4, False, 8, 4096),
    (4, True, 8, 0),
]


@pytest.mark.parametrize("spec,paged,chunk,cache", FLEETS)
def test_spec_fleet_matches_jax_and_the_one_token_fleet(models, spec, paged,
                                                         chunk, cache):
    """Per request: tokens, stop steps, completion steps, scores, proposed
    and accepted drafts, draft-cache hits and misses equal JAX's, and the
    fleet's spec counters too.  The third prompt repeats the first, so the
    draft cache hits and the verifier accepts.  The same fleet with
    one-token decode stops every request at the same step with the same
    tokens."""
    (jmodel, jparams, jpc, jtheta), (model, params, pc, theta) = models
    kw = dict(tokens_per_step=2, max_new_tokens=12, lam=0.6, burn_in=1,
              n_slots=2, block_size=4, paged=paged, chunk_tokens=chunk)
    skw = dict(kw, spec_tokens=spec, draft_cache_size=cache)
    prompts = _prompts(model.cfg.vocab_size)
    jdone, jfleet = JOrcaScheduler(
        jmodel, jparams, jpc, jtheta,
        JServeConfig(probe_impl="ref", **skw)).run(
        [j_make_request(p, max_new_tokens=n)
         for p, n in zip(prompts, BUDGETS)])
    sched = OrcaScheduler(model, params, pc, theta, ServeConfig(**skw))
    done, fleet = sched.run([make_request(p, max_new_tokens=n)
                             for p, n in zip(prompts, BUDGETS)])
    assert [r.state.value for r in done] == [r.state.value for r in jdone]
    for r, jr in zip(done, jdone):
        for fld in ("stop_step", "tokens", "completed_step", "admitted_step",
                    "spec_proposed", "spec_accepted", "accepted_lens",
                    "draft_hits", "draft_misses"):
            assert getattr(r, fld) == getattr(jr, fld), (r.req_id, fld)
        np.testing.assert_allclose(r.scores, jr.scores, rtol=0, atol=ATOL)
    for fld in ("engine_steps", "spec_tokens_proposed",
                "spec_tokens_accepted", "acceptance_rate",
                "accepted_len_p50", "accepted_len_p99", "draft_cache_hits",
                "draft_cache_misses", "draft_cache_hit_rate",
                "prefill_chunks", "peak_step_tokens"):
        assert getattr(fleet, fld) == getattr(jfleet, fld), fld
    assert fleet.spec_tokens_proposed > 0
    assert (fleet.draft_cache_hits > 0) == bool(cache)
    if cache:
        assert fleet.spec_tokens_accepted > 0
        assert max(g for r in done for g in r.accepted_lens) >= 2
    assert len({r.stop_step for r in done}) > 1
    if paged:
        assert sched.pool.blocks_in_use == 0
        sched.pool.check()
    one, _ = OrcaScheduler(model, params, pc, theta, ServeConfig(**kw)).run(
        [make_request(p, max_new_tokens=n) for p, n in zip(prompts, BUDGETS)])
    assert [r.stop_step for r in done] == [r.stop_step for r in one]
    assert [r.tokens for r in done] == [r.tokens for r in one]


# ---------------------------------------------------------------------------
# ServeConfig and the driver

@pytest.mark.parametrize("kw", [dict(spec_tokens=1),
                                dict(spec_tokens=4, chunk_tokens=4),
                                dict(spec_tokens=5, token_budget=4),
                                dict(draft_cache_size=-1)])
def test_spec_config_validation_matches_jax(kw):
    with pytest.raises(ValueError) as want:
        JServeConfig(**kw)
    with pytest.raises(ValueError) as got:
        ServeConfig(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(spec_tree="2x3"),
                                dict(spec_tree="2.x"),
                                dict(spec_tree="2.2", spec_tokens=4),
                                dict(spec_tree="0.3"),
                                dict(spec_tree="2.3", chunk_tokens=7),
                                dict(spec_tree="3.3", token_budget=9)])
def test_spec_tree_config_validation_matches_jax(kw):
    with pytest.raises(ValueError) as want:
        JServeConfig(**kw)
    with pytest.raises(ValueError) as got:
        ServeConfig(**kw)
    assert str(got.value) == str(want.value)


def test_spec_tree_config_normalises_as_jax():
    for tree in ("2.3", (2, 3), [3, 3], " 1.4 ", ""):
        ours, theirs = ServeConfig(spec_tree=tree), JServeConfig(
            spec_tree=tree)
        assert ours.spec_tree == theirs.spec_tree
        assert ours.tree_shape() == theirs.tree_shape()
    assert ServeConfig(spec_tree="3.3", chunk_tokens=11,
                       token_budget=10).tree_shape() == (3, 3)


def test_serve_driver_spec_tree_on_cpu(capsys):
    """``--spec-tree 2.2`` serves; its tree line has the JAX driver's
    format (``repro/launch/serve.py``), beside the speculative line."""
    rc = tserve.main(["--arch", "smollm-360m", "--reduced", "--device", "cpu",
                      "--paged", "--requests", "3", "--slots", "2",
                      "--max-new-tokens", "16", "--tokens-per-step", "4",
                      "--train-trajectories", "8", "--epochs", "2",
                      "--prompt-len", "8", "--spec-tree", "2.2"])
    assert rc == 0
    out = capsys.readouterr().out
    assert re.search(r"\[serve\] speculative: \d+/\d+ drafts accepted", out)
    tree = re.search(r"^\[serve\] tree: (\d+) nodes proposed, accepted path "
                     r"length p50/p99 (\d+\.\d)/(\d+\.\d)$", out, re.M)
    assert tree and int(tree.group(1)) > 0
    assert float(tree.group(2)) >= 1.0
    assert "[serve] draft cache: " in out


def test_serve_driver_spec_on_cpu(capsys):
    rc = tserve.main(["--arch", "smollm-360m", "--reduced", "--device", "cpu",
                      "--paged", "--requests", "3", "--slots", "2",
                      "--max-new-tokens", "16", "--tokens-per-step", "4",
                      "--train-trajectories", "8", "--epochs", "2",
                      "--prompt-len", "8", "--spec-tokens", "3"])
    assert rc == 0
    out = capsys.readouterr().out
    assert re.search(r"\[serve\] speculative: \d+/\d+ drafts accepted", out)
    assert "[serve] draft cache: " in out
    assert "[serve] tree: " not in out


def test_serve_driver_flags_are_the_jax_drivers(capsys):
    """Every flag of the port's driver but ``--device`` is the JAX
    driver's."""
    flags = {}
    for name, mod in (("jax", jserve), ("port", tserve)):
        with pytest.raises(SystemExit):
            mod.main(["--help"])
        flags[name] = set(re.findall(r"--[a-z][a-z0-9-]*",
                                     capsys.readouterr().out))
    assert {"--spec-tokens", "--spec-tree", "--draft-cache"} <= flags["port"]
    assert flags["port"] - {"--device"} <= flags["jax"]
