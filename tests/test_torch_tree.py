"""The port's tree speculative decode held to the JAX package on the
reduced smollm-360m (and one reduced llama3.2-3b fleet at G 3) with
weights and probe slow weights carried across: the ancestor mask (BFS
combs, random trees, any parent array, width one equal to the causal
chain); ``verify_packed_tree``'s logits, hidden states and K/V, dense and
paged; the cache after ``commit_packed_kv``, dense, paged and int8, with
off-path nodes never written; the engine's tree step; and tree fleets
through ``OrcaScheduler`` (1.2, 2.2 and 3.3, dense and paged, chunked and
not, draft cache on and off), whose stops and tokens equal JAX's tree
fleet and the port's one-token fleet; ``1.3`` equal to
``spec_tokens=4`` step for step; and grouped consensus on the replay
model under ``2.2`` with partial acceptance, against JAX's.  The JAX side runs with
``probe_impl="ref"``: its Pallas spec probe needs ``pallas.load``, which
this JAX lacks; paged JAX cases run its Pallas paged attention in
interpret mode (``REPRO_PAGED_ATTN=pallas``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.serving import ContinuousServingEngine as JEngine
from repro.serving import OrcaScheduler as JOrcaScheduler
from repro.serving import ServeConfig as JServeConfig
from repro.serving import make_request as j_make_request

from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.serving import (ContinuousServingEngine, OrcaScheduler,
                                 ServeConfig, make_request)
from tests.test_torch_serve import BUDGETS, _models, _prompts

# f32 on both sides, reduced in another order: the probe's floats agree to
# a few ulps of their O(1) values
ATOL = 1e-5
# logits, hidden states and K/V entries reach ~45 at this init: f32
# rounding relative to the largest
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


def _comb(n_segs, width, depth):
    """The engine's BFS comb, packed back to back: per segment 1 + W*D
    nodes; node 1 + j*W + b is branch b at depth j + 1, its parent the root
    at j = 0, else the same branch one level up.  Returns (seg, ancestors,
    depths) as int32 arrays."""
    kk = 1 + width * depth
    seg, anc, dep = [], [], []
    for s in range(n_segs):
        off = s * kk
        seg += [s] * kk
        anc.append(off)
        dep.append(0)
        for j in range(depth):
            for b in range(width):
                i = 1 + j * width + b
                anc.append(off if j == 0 else off + i - width)
                dep.append(j + 1)
    return (np.asarray(seg, np.int32), np.asarray(anc, np.int32),
            np.asarray(dep, np.int32))


def _masks(seg, valid, anc=None):
    want = np.asarray(jattn.packed_chunk_mask(
        jnp.asarray(seg), jnp.asarray(valid),
        None if anc is None else jnp.asarray(anc)))
    got = tattn.packed_chunk_mask(
        torch.from_numpy(seg), torch.from_numpy(valid),
        None if anc is None else torch.from_numpy(anc)).numpy()
    return got, want


# ---------------------------------------------------------------------------
# the ancestor mask

@pytest.mark.parametrize("n_segs,width,depth", [(1, 2, 3), (2, 3, 2),
                                                (3, 1, 4), (2, 4, 1),
                                                (4, 3, 3)])
def test_ancestor_mask_matches_jax_on_combs(n_segs, width, depth):
    seg, anc, _ = _comb(n_segs, width, depth)
    valid = np.array([i % 5 != 3 for i in range(len(seg))])
    got, want = _masks(seg, valid, anc)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.diag(got), valid)


@pytest.mark.parametrize("forest", [True, False])
def test_ancestor_mask_matches_jax_on_random_parents(forest):
    """Forests whose parents precede their children, and (``forest``
    False) any parent array at all, cycles included: the pointer-doubling
    closure reaches what JAX's C-step walk reaches."""
    rng = np.random.default_rng(11)
    for trial in range(8):
        c = int(rng.integers(1, 40))
        seg = np.sort(rng.integers(0, 4, c)).astype(np.int32)
        if forest:
            anc = np.arange(c, dtype=np.int32)
            for i in range(c):
                lo = int(np.argmax(seg == seg[i]))
                if i > lo and rng.random() < 0.9:
                    anc[i] = rng.integers(lo, i)
        else:
            anc = rng.integers(0, c, c).astype(np.int32)
        valid = rng.random(c) > 0.2
        got, want = _masks(seg, valid, anc)
        np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")


def test_width_one_tree_mask_equals_the_causal_chain():
    seg = np.array([0, 0, 0, 1, 1, 1, 1, 2], np.int32)
    anc = np.arange(len(seg), dtype=np.int32)
    anc[1:] = np.where(seg[1:] == seg[:-1], anc[1:] - 1, anc[1:])
    valid = np.array([1, 1, 0, 1, 1, 1, 1, 1], bool)
    tree, want = _masks(seg, valid, anc)
    chain, _ = _masks(seg, valid)
    np.testing.assert_array_equal(tree, chain)
    np.testing.assert_array_equal(tree, want)


# ---------------------------------------------------------------------------
# verify_packed_tree and commit_packed_kv

BS, NB = 4, 6
W, D = 2, 2
KK = 1 + W * D


def _tree_chunk(rng, vocab):
    """Two slots with 5 and 3 prompt positions cached, then one tree chunk
    of 2 x KK nodes laid out as the engine lays it out: slot 0's whole 2.2
    tree, slot 1's truncated to 4 nodes, one padding token."""
    seg, anc, dep = _comb(2, W, D)
    lens = np.array([KK, 4], np.int32)
    keep = np.r_[np.arange(KK), KK + np.arange(4)]
    c = 2 * KK
    pad = c - len(keep)
    seg = np.r_[seg[keep], np.zeros(pad, np.int32)]
    # slot 1's nodes move up by nothing (slot 0 is whole); the tail keeps 0
    anc = np.r_[anc[keep], np.zeros(pad, np.int32)]
    dep = np.r_[dep[keep], np.zeros(pad, np.int32)]
    toks = rng.integers(0, vocab, c).astype(np.int32)
    toks[len(keep):] = 0
    return toks, seg, anc, dep, lens


def _prefill_both(models, paged, rng):
    (jmodel, jparams, _, _), (model, params, _, _) = models
    jcfg, cfg = jmodel.cfg, model.cfg
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 3)]
    rows = (1 + rng.permutation(2 * NB)).reshape(2, NB).astype(np.int32)
    if paged:
        jst = jmodel.init_paged_state(2, 2 * NB + 1, BS, NB)
        st = model.init_paged_state(2, 2 * NB + 1, BS, NB, device="cpu")
    else:
        jst = jmodel.init_decode_state(2, BS * NB)
        st = model.init_decode_state(2, BS * NB, device="cpu")
    jrows = jnp.asarray(rows) if paged else None
    trows = torch.from_numpy(rows) if paged else None
    tk = np.concatenate(prompts)
    sg = np.array([0] * 5 + [1] * 3, np.int32)
    sp, ln = np.zeros(2, np.int32), np.array([5, 3], np.int32)
    slots = np.array([0, 1], np.int32)
    jst = jtf.prefill_packed_chunk(jcfg, jparams, jnp.asarray(tk), jst,
                                   jnp.asarray(sg), jnp.asarray(slots),
                                   jnp.asarray(sp), jnp.asarray(ln), jrows)
    ttf.prefill_packed_chunk(cfg, params, torch.from_numpy(tk), st,
                             torch.from_numpy(sg), torch.from_numpy(slots),
                             torch.from_numpy(sp), torch.from_numpy(ln),
                             trows)
    return jst, st, jrows, trows


def _close(got, want, msg=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got.float().numpy(), want, rtol=0,
        atol=RTOL_KV * max(1.0, float(np.abs(want).max())), err_msg=msg)


def _cache_close(st, jst, paged):
    for key in st:
        if key == "block_tables":
            continue
        got, want = st[key].float(), np.asarray(jst[key], np.float32)
        if paged:                      # page 0, the NULL page, is scratch
            got, want = got[:, 1:], want[:, 1:]
        _close(got, want, key)


@pytest.mark.parametrize("paged", [False, True])
def test_verify_packed_tree_matches_jax(monkeypatch, models, paged):
    """Logits and hidden states of every real node, and the chunk's K/V,
    against JAX's; the cache is not written."""
    if paged:
        monkeypatch.setenv("REPRO_PAGED_ATTN", "pallas")
    (jmodel, jparams, _, _), (model, params, _, _) = models
    rng = np.random.default_rng(6)
    jst, st, jrows, trows = _prefill_both(models, paged, rng)
    toks, seg, anc, dep, lens = _tree_chunk(rng, model.cfg.vocab_size)
    before = {k: v.clone() for k, v in st.items()}
    starts, slots = np.array([5, 3], np.int32), np.array([0, 1], np.int32)
    jl, jh, jks, jvs = jtf.verify_packed_tree(
        jmodel.cfg, jparams, jnp.asarray(toks), jst, jnp.asarray(seg),
        jnp.asarray(slots), jnp.asarray(starts), jnp.asarray(lens),
        jnp.asarray(dep), jnp.asarray(anc), jrows)
    tl, th, tks, tvs = ttf.verify_packed_tree(
        model.cfg, params, torch.from_numpy(toks), st, torch.from_numpy(seg),
        torch.from_numpy(slots), torch.from_numpy(starts),
        torch.from_numpy(lens), torch.from_numpy(dep), torch.from_numpy(anc),
        trows)
    real = np.arange(int(lens.sum()))     # the padding token is not scored
    for name, got, want in (("logits", tl, jl), ("hidden", th, jh)):
        _close(got[real], np.asarray(want)[real], name)
    for name, got, want in (("ks", tks, jks), ("vs", tvs, jvs)):
        _close(got[:, :, real], np.asarray(want)[:, :, real], name)
    for key in st:
        assert torch.equal(st[key], before[key]), key
    # siblings differ: a tree, not a chain, was scored
    assert not torch.equal(th[1], th[2])


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("paged", [False, True])
def test_commit_packed_kv_matches_jax(monkeypatch, paged, int8):
    """The verify chunk's deferred K/V committed on an accepted path of
    each slot (slot 0 branch 1 to depth 2, slot 1 branch 0 to depth 1):
    the cache equals JAX's, and the port's cache changed exactly at the
    path's (lane, position) targets."""
    if paged:
        monkeypatch.setenv("REPRO_PAGED_ATTN", "pallas")
    models = _models("int8" if int8 else None)
    (jmodel, jparams, _, _), (model, params, _, _) = models
    rng = np.random.default_rng(8)
    jst, st, jrows, trows = _prefill_both(models, paged, rng)
    toks, seg, anc, dep, lens = _tree_chunk(rng, model.cfg.vocab_size)
    starts, slots = np.array([5, 3], np.int32), np.array([0, 1], np.int32)
    _, _, jks, jvs = jtf.verify_packed_tree(
        jmodel.cfg, jparams, jnp.asarray(toks), jst, jnp.asarray(seg),
        jnp.asarray(slots), jnp.asarray(starts), jnp.asarray(lens),
        jnp.asarray(dep), jnp.asarray(anc), jrows)
    _, _, tks, tvs = ttf.verify_packed_tree(
        model.cfg, params, torch.from_numpy(toks), st, torch.from_numpy(seg),
        torch.from_numpy(slots), torch.from_numpy(starts),
        torch.from_numpy(lens), torch.from_numpy(dep), torch.from_numpy(anc),
        trows)
    valid = np.zeros(len(toks), bool)
    valid[[0, 2, 4, KK, KK + 1]] = True
    positions = (starts[seg] + dep).astype(np.int32)
    before = {k: v.clone() for k, v in st.items()}
    jst = jtf.commit_packed_kv(jmodel.cfg, jst, jks, jvs, jnp.asarray(slots),
                               jnp.asarray(seg), jnp.asarray(positions),
                               jnp.asarray(valid), jrows)
    st = ttf.commit_packed_kv(model.cfg, st, tks, tvs,
                              torch.from_numpy(slots), torch.from_numpy(seg),
                              torch.from_numpy(positions),
                              torch.from_numpy(valid), trows)
    _cache_close(st, jst, paged)
    # the targets that changed: (lane, position), or (page, offset) off
    # the NULL page
    changed = (st["k"] != before["k"]).any(-1).any(0).any(1)  # (B|P, S|bs)
    if paged:
        changed[0] = False
        lane_pos = {(int(trows[s, p // BS]), p % BS)
                    for s, p in zip(seg[valid], positions[valid])}
    else:
        lane_pos = {(int(s), int(p)) for s, p in zip(seg[valid],
                                                     positions[valid])}
    assert {tuple(int(x) for x in ix) for ix in changed.nonzero()} \
        == lane_pos
    if int8:
        assert st["k"].dtype == torch.int8


# ---------------------------------------------------------------------------
# the engine's tree step

@pytest.mark.parametrize("paged", [False, True])
def test_tree_engine_step_matches_jax(monkeypatch, models, paged):
    """Two slots admitted in both engines (2.2 trees, 5 nodes), then four
    tree steps with per-slot node counts (a parked slot, truncated trees,
    host drafts): gen, seq, seq_scores, seq_n, pos, the next token and the
    stop state equal JAX's after every step, and the cache and probe state
    after the last.  Step 2 drafts slot 0's branch 1 with its one-token
    continuation (the path through branch 1 is accepted whole); step 3
    drafts both slots' branch 0 with theirs."""
    if paged:
        monkeypatch.setenv("REPRO_PAGED_ATTN", "pallas")
    (jmodel, jparams, jpc, jtheta), (model, params, pc, theta) = models
    kw = dict(tokens_per_step=2, max_new_tokens=16, lam=0.99, burn_in=1)
    ekw = dict(n_slots=3, cache_len=32, paged=paged, block_size=BS)
    jeng = JEngine(jmodel, jparams, jpc, jtheta, JServeConfig(**kw),
                   probe_impl="ref", spec_tree=(W, D), **ekw)
    eng = ContinuousServingEngine(model, params, pc, theta,
                                  ServeConfig(**kw), spec_tree=(W, D), **ekw)
    one = ContinuousServingEngine(model, params, pc, theta,
                                  ServeConfig(**kw), **ekw)
    assert eng.spec_tokens == KK
    prompts = _prompts(model.cfg.vocab_size)[:2]
    for slot, p in enumerate(prompts):
        row = (np.arange(8, dtype=np.int32) + 1 + 8 * slot) if paged \
            else None
        jeng.admit(slot, {"tokens": jnp.asarray(p[None])}, len(p),
                   **({"block_row": row} if paged else {}))
        for e in (eng, one):
            e.admit(slot, {"tokens": p[None]}, len(p),
                    **({"block_row": row} if paged else {}))
    cont = np.stack([one.step().tokens[:2] for _ in range(12)], axis=1)
    done = np.zeros((2,), int)
    rng = np.random.default_rng(9)
    drafts = rng.integers(0, model.cfg.vocab_size, (3, W, D)).astype(np.int32)
    have = np.zeros((3,), bool)
    for step, lens in enumerate(([5, 5, 0], [3, 4, 0], [5, 2, 0],
                                 [4, 5, 0])):
        if step == 1:
            have[:2] = True
        if step == 2:
            drafts[0, 1] = cont[0, done[0]:done[0] + D]
        if step == 3:
            for slot in range(2):
                drafts[slot, 0] = cont[slot, done[slot]:done[slot] + D]
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
        assert view.seq.shape == (3, D + 1)
        assert view.gen[2] == 0 and (view.gen[:2] >= 1).all()
        for slot in range(2):
            g = int(view.gen[slot])
            np.testing.assert_array_equal(
                view.seq[slot, :g], cont[slot, done[slot]:done[slot] + g])
            done[slot] += g
        if step == 2:
            assert view.gen[0] == D + 1
    np.testing.assert_array_equal(view.gen[:2], [3, 3])
    _cache_close(eng.state, jeng.state, paged)
    for fld in eng.st._fields:
        got = getattr(eng.st, fld).numpy()
        want = np.asarray(getattr(jeng.st, fld))
        if got.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL,
                                       err_msg=fld)
        else:
            np.testing.assert_array_equal(got, want, err_msg=fld)


# ---------------------------------------------------------------------------
# tree fleets through OrcaScheduler

REQ_FIELDS = ("stop_step", "tokens", "completed_step", "admitted_step",
              "spec_proposed", "spec_accepted", "accepted_lens", "tree_nodes",
              "tree_path_lens", "draft_hits", "draft_misses")
FLEET_FIELDS = ("engine_steps", "spec_tokens_proposed", "spec_tokens_accepted",
                "acceptance_rate", "accepted_len_p50", "accepted_len_p99",
                "tree_nodes_proposed", "tree_path_accepted_p50",
                "tree_path_accepted_p99", "draft_cache_hits",
                "draft_cache_misses", "draft_cache_hit_rate",
                "prefill_chunks", "peak_step_tokens")
TREE_FLEETS = [  # (spec_tree, paged, chunk_tokens, draft_cache_size)
    ("1.2", False, None, 4096),
    ("2.2", False, None, 0),
    ("2.2", True, None, 4096),
    ("3.3", True, None, 4096),
    ("2.2", True, 8, 4096),
    ("3.3", False, 12, 4096),
    ("3.3", True, 12, 0),
]


def _fleet_vs_jax(monkeypatch, models, tree, paged, chunk, cache):
    if paged:
        monkeypatch.setenv("REPRO_PAGED_ATTN", "pallas")
    (jmodel, jparams, jpc, jtheta), (model, params, pc, theta) = models
    kw = dict(tokens_per_step=2, max_new_tokens=12, lam=0.6, burn_in=1,
              n_slots=2, block_size=4, paged=paged, chunk_tokens=chunk)
    skw = dict(kw, spec_tree=tree, draft_cache_size=cache)
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
        for fld in REQ_FIELDS:
            assert getattr(r, fld) == getattr(jr, fld), (r.req_id, fld)
        np.testing.assert_allclose(r.scores, jr.scores, rtol=0, atol=ATOL)
    for fld in FLEET_FIELDS:
        assert getattr(fleet, fld) == getattr(jfleet, fld), fld
    assert fleet.tree_nodes_proposed > 0
    assert (fleet.draft_cache_hits > 0) == bool(cache)
    if paged:
        assert sched.pool.blocks_in_use == 0
        sched.pool.check()
    one, _ = OrcaScheduler(model, params, pc, theta, ServeConfig(**kw)).run(
        [make_request(p, max_new_tokens=n) for p, n in zip(prompts, BUDGETS)])
    assert [r.stop_step for r in done] == [r.stop_step for r in one]
    assert [r.tokens for r in done] == [r.tokens for r in one]
    assert len({r.stop_step for r in done}) > 1
    return done, fleet


@pytest.mark.parametrize("tree,paged,chunk,cache", TREE_FLEETS)
def test_tree_fleet_matches_jax_and_the_one_token_fleet(monkeypatch, models,
                                                         tree, paged, chunk,
                                                         cache):
    """Per request: tokens, stop and completion steps, scores, proposed
    and accepted drafts, tree nodes and accepted path lengths, draft-cache
    hits and misses equal JAX's, and the fleet's spec and tree counters
    too.  The third prompt repeats the first, so the draft cache hits and
    a path longer than the root is accepted.  The same fleet one token at
    a time stops every request at the same step with the same tokens."""
    done, fleet = _fleet_vs_jax(monkeypatch, models, tree, paged, chunk,
                                cache)
    if cache:
        assert max(g for r in done for g in r.tree_path_lens) >= 2
        assert fleet.spec_tokens_accepted > 0


def test_tree_fleet_llama_g3_matches_jax(monkeypatch):
    """The reduced llama3.2-3b (d_head 32, G 3), paged and chunked, 2.2."""
    _fleet_vs_jax(monkeypatch, _models(arch="llama3.2-3b"), "2.2", True, 8,
                  4096)


def test_width_one_tree_equals_linear_spec_step_for_step(models):
    """``spec_tree="1.3"`` serves as ``spec_tokens=4`` does: every engine
    step commits the same tokens with the same probe state (bit for bit),
    and the requests and counters are equal."""
    _, (model, params, pc, theta) = models
    kw = dict(tokens_per_step=2, max_new_tokens=12, lam=0.6, burn_in=1,
              n_slots=2, paged=True, block_size=4, chunk_tokens=8)
    prompts = _prompts(model.cfg.vocab_size)
    runs = []
    for spec in (dict(spec_tokens=4), dict(spec_tree="1.3")):
        sched = OrcaScheduler(model, params, pc, theta,
                              ServeConfig(**kw, **spec))
        sched.prepare([make_request(p, max_new_tokens=n)
                       for p, n in zip(prompts, BUDGETS)])
        views, served = [], sched.engine.step

        def step(*a, served=served, views=views, **k):
            views.append(served(*a, **k))
            return views[-1]
        sched.engine.step = step
        done, fleet = sched.run([make_request(p, max_new_tokens=n)
                                 for p, n in zip(prompts, BUDGETS)])
        runs.append((views, done, fleet))
    (lv, ld, lf), (tv, td, tf) = runs
    assert len(lv) == len(tv) == lf.engine_steps == tf.engine_steps
    for i, (a, b) in enumerate(zip(lv, tv)):
        for fld in ("tokens", "stopped", "stop_step", "n_scores", "smoothed",
                    "gen"):
            np.testing.assert_array_equal(getattr(a, fld), getattr(b, fld),
                                          err_msg=f"step {i} {fld}")
        # what a step commits: each slot's first gen entries (past them
        # the linear block keeps the outputs after its rejected drafts)
        for slot, g in enumerate(a.gen):
            for fld in ("seq", "seq_scores", "seq_n"):
                np.testing.assert_array_equal(
                    getattr(a, fld)[slot, :g], getattr(b, fld)[slot, :g],
                    err_msg=f"step {i} slot {slot} {fld}")
    for a, b in zip(ld, td):
        for fld in ("stop_step", "tokens", "scores", "accepted_lens",
                    "spec_proposed", "spec_accepted", "draft_hits"):
            assert getattr(a, fld) == getattr(b, fld), (a.req_id, fld)
    assert tf.tree_nodes_proposed == lf.spec_tokens_proposed
    assert max(g for r in td for g in r.tree_path_lens) >= 2


def test_tree_consensus_groups_match_jax_and_cancelled_excluded():
    """JAX ``tests/test_tree_spec.py:342`` on the port, each fleet held to
    JAX's: grouped consensus on the replay model with partial acceptance
    (``draft_wrong_rate`` 0.35), one-token and under ``spec_tree="2.2"``.
    The same groups fire with the same answers and agreement, the same
    siblings cancel, the survivors' stops and scores equal the one-token
    fleet's, and CANCELLED samples are left out of the acceptance and
    tree statistics."""
    from repro.serving import replay_requests as j_replay_requests

    from repro_torch.serving import RequestState, replay_requests
    from tests.test_torch_groups import Replay

    n_groups, gsz, t = 3, 3, 10
    n = n_groups * gsz
    rs = np.random.RandomState(6)
    drift = np.linspace(0, 1.0, t)[None, :, None]
    bank = (rs.randn(n, t, 8) * 0.3
            + drift * rs.rand(n, 1, 8)).astype(np.float32)
    answers = np.repeat(np.arange(n_groups), gsz)
    fl = Replay(bank, answers=answers, bias=1.5, smooth_window=2,
                draft_wrong_rate=0.35, key=4)

    def reqs(mk):
        out = (replay_requests if mk is make_request
               else j_replay_requests)([t] * n)
        for i, r in enumerate(out):
            r.group_id, r.sample_idx = int(i // gsz), int(i % gsz)
        return out
    runs = {}
    for tree in (None, "2.2"):
        sched, done, fleet = fl.run(
            dict(tokens_per_step=1, max_new_tokens=t, lam=2.0, burn_in=2,
                 probe_impl="ref"), reqs, consensus=0.8, n_slots=4,
            paged=True, block_size=4, spec_tree=tree)
        runs[tree] = (done, fleet, sched.groups)
        assert fleet.consensus_groups == n_groups
    done_o, fleet_o, grp_o = runs[None]
    done_s, fleet_s, grp_s = runs["2.2"]
    assert [r.state for r in done_s] == [r.state for r in done_o]
    assert ([(g.consensus_answer, g.consensus_agreement) for g in grp_s]
            == [(g.consensus_answer, g.consensus_agreement) for g in grp_o])
    assert fleet_s.samples_cancelled == fleet_o.samples_cancelled
    for rs_, ro in zip(done_s, done_o):
        if ro.state is not RequestState.CANCELLED:
            assert rs_.stop_step == ro.stop_step
            np.testing.assert_array_equal(np.asarray(rs_.scores),
                                          np.asarray(ro.scores))
    live = [r for r in done_s if r.state is not RequestState.CANCELLED]
    assert fleet_s.tree_nodes_proposed == sum(r.tree_nodes for r in live)
    assert fleet_s.spec_tokens_proposed == sum(r.spec_proposed for r in live)
    cancelled = [r for r in done_s if r.state is RequestState.CANCELLED]
    assert cancelled and any(r.tree_nodes for r in cancelled)
