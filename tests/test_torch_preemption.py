"""Involuntary preemption and the scheduling policies of the port held to
the JAX package on the reduced smollm-360m (and rwkv6-1.6b for the
recurrent lane), weights and probe slow weights carried across.

Engine level: a slot's ``Spill`` (probe row, token, position, its pages
or dense lane, int8 scales too) equals JAX's, and the restored slot —
on other pages, or in another lane — replays the undisturbed future bit
for bit; dense, paged, paged int8, mid-prefill, mid-tree-verify, and the
RWKV6 state.  A restore writes only its own pages: never the NULL page
nor a page another slot owns.  Scheduler level: fleets under forced
preemption (policy x packing x paging, and a tree fleet) equal JAX's
per request (stop step, tokens, admission and restore steps, spills) and
in the fleet counters, and stop as the abundant fleet does; wait-only
admission, SWAPPED before WAITING, the oversized-gang skip and its aging
pin; ``select_victim``, EDF and ``make_policy`` on the same inputs as
JAX's; the serving driver's ``--policy``, ``--batch-every`` and
``--no-preempt``.  JAX's tree path runs with ``probe_impl="ref"`` (its
Pallas spec probe needs ``pallas.load``, which this JAX lacks)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.probe import ProbeConfig as JProbeConfig
from repro.core.probe import init_outer as j_init_outer
from repro.models import build as j_build
from repro.serving import ChunkSeg as JChunkSeg
from repro.serving import ChunkWork as JChunkWork
from repro.serving import ContinuousServingEngine as JEngine
from repro.serving import OrcaScheduler as JOrcaScheduler
from repro.serving import ServeConfig as JServeConfig
from repro.serving import make_request as j_make_request
from repro.serving import policy as jpolicy

from repro_torch.configs import get_config
from repro_torch.core.probe import ProbeConfig
from repro_torch.launch import serve as tserve
from repro_torch.models import build
from repro_torch.models.convert import from_jax_params, from_jax_theta
from repro_torch.serving import (ChunkSeg, ChunkWork,
                                 ContinuousServingEngine, EDFPolicy,
                                 FIFOPolicy, OrcaScheduler, RequestState,
                                 ServeConfig, make_policy, make_request)
from repro_torch.serving import policy as tpolicy
from tests.test_torch_serve import _models

ATOL = 1e-5
RTOL_KV = 2e-5          # K/V (and RWKV state) to their largest magnitude


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
# engine level: a spill equals JAX's, and preempt -> restore is bit for bit

STEP_FIELDS = ("tokens", "smoothed", "n_scores", "stopped", "stop_step")
EKW = dict(tokens_per_step=2, max_new_tokens=16, lam=0.6, burn_in=4)


def _close(got, want, msg, kv=False):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if kv:
        got, want = got.astype(np.float32), want.astype(np.float32)
    if got.dtype.kind == "f":
        atol = RTOL_KV * max(1.0, float(np.abs(want).max())) if kv else ATOL
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=msg)
    else:
        np.testing.assert_array_equal(got, want, err_msg=msg)


def _spill_matches(spill, jspill, n_blocks=0):
    """The port's Spill against JAX's: probe rows, token, pos, armed and
    n_blocks; pages over the victim's real blocks (JAX pads to the table
    width), or the dense lane."""
    assert (spill.token, spill.pos, spill.armed, spill.prompt_len,
            spill.n_blocks) == (jspill.token, jspill.pos, jspill.armed,
                                jspill.prompt_len, jspill.n_blocks)
    assert spill.n_blocks == n_blocks
    for i, (got, want) in enumerate(zip(spill.probe, jspill.probe)):
        _close(got, want, f"probe leaf {i}")
    if n_blocks:
        assert spill.lane is None and set(spill.pages) == set(jspill.pages)
        for k, v in spill.pages.items():
            assert v.device.type == "cpu"
            _close(v, np.asarray(jspill.pages[k])[:, :n_blocks], k, kv=True)
    else:
        assert spill.pages is None and set(spill.lane) == set(jspill.lane)
        for k, v in spill.lane.items():
            _close(v, jspill.lane[k], k, kv=True)
    assert spill.nbytes == sum(t.numel() * t.element_size() for t in
                               (spill.pages or spill.lane).values()) > 0


def _same_future(eng_a, eng_b, slot_a, slot_b, steps, jeng=None, jslot=None,
                 **step_kw):
    """Up to ``steps`` engine steps: the restored slot of ``eng_a`` against
    the undisturbed ``eng_b`` bit for bit (and against JAX's restored engine
    to tolerance), until the slot stops (the step a scheduler evicts it);
    returns whether it stopped."""
    for i in range(steps):
        kw_a = {k: v[0] for k, v in step_kw.items()}
        kw_b = {k: v[1] for k, v in step_kw.items()}
        va, vb = eng_a.step(**kw_a), eng_b.step(**kw_b)
        for f in va._fields:
            a, b = getattr(va, f), getattr(vb, f)
            if a is None:
                continue
            np.testing.assert_array_equal(
                a[slot_a], b[slot_b], err_msg=f"step {i}: {f} diverged")
        if jeng is not None:
            jv = jeng.step(**kw_a)
            for f in STEP_FIELDS:
                _close(getattr(va, f)[slot_a],
                       np.asarray(getattr(jv, f))[jslot],
                       f"step {i}: {f} against JAX")
        if va.stopped[slot_a]:
            return True
    return False


def _admit(models, paged, rows=None, ekw=None, **kw):
    """A JAX engine and two port engines with two prompts admitted."""
    (jmodel, jparams, jpc, jtheta), (model, params, pc, theta) = models
    ekw = dict(dict(n_slots=3, cache_len=32, paged=paged, block_size=4,
                    num_blocks=25 if paged else None), **(ekw or {}))
    jeng = JEngine(jmodel, jparams, jpc, jtheta, JServeConfig(**EKW, **kw),
                   **ekw)
    engs = [ContinuousServingEngine(model, params, pc, theta,
                                    ServeConfig(**EKW), **ekw)
            for _ in range(2)]
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)
               for n in (9, 13)]
    for slot, p in enumerate(prompts):
        row = {"block_row": rows[slot]} if paged else {}
        jeng.admit(slot, {"tokens": jnp.asarray(p[None])}, len(p), **row)
        for e in engs:
            e.admit(slot, {"tokens": p[None]}, len(p), **row)
    return jeng, engs


ROW0, ROW1 = list(range(1, 9)), list(range(9, 17))
ROW_NEW = list(range(24, 16, -1))        # other pages, in reverse order


def test_dense_spill_restore_matches_jax_and_is_bit_for_bit(models):
    """Dense engine: slot 0's Spill equals JAX's (its KV lane and probe
    row), and restored into ANOTHER lane (slot 2) it replays the
    undisturbed future bit for bit; slot 1 never moves."""
    jeng, (eng_a, eng_b) = _admit(models, paged=False)
    for _ in range(3):
        jeng.step()
        eng_a.step()
        eng_b.step()
    before = [leaf[0].clone() for leaf in eng_a.st]
    jspill, spill = jeng.preempt(0), eng_a.preempt(0)
    _spill_matches(spill, jspill)
    assert bool(eng_a.st.stopped[0])          # the slot is parked
    for got, want in zip(spill.probe, before):
        assert torch.equal(got, want)
    jeng.restore(2, jspill)
    eng_a.restore(2, spill)
    for leaf, want in zip(eng_a.st, before):
        assert torch.equal(leaf[2], want)
    assert _same_future(eng_a, eng_b, 2, 0, 8, jeng, 2)
    _same_future(eng_a, eng_b, 1, 1, 1)


@pytest.mark.parametrize("kv", [None, "int8"])
def test_paged_spill_restore_matches_jax_and_is_bit_for_bit(monkeypatch, kv):
    """Paged engine: slot 0 preempted mid-decode, its Spill (every page
    leaf, int8 scales too) equal to JAX's over its 8 real blocks, restored
    into the same slot on 8 OTHER pages in reverse order; its future equals
    the undisturbed twin's bit for bit and JAX's restored engine's."""
    if kv:
        monkeypatch.setenv("REPRO_PAGED_ATTN", "pallas")
    jeng, (eng_a, eng_b) = _admit(_models(kv), paged=True,
                                  rows=(ROW0, ROW1))
    for _ in range(3):
        jeng.step()
        eng_a.step()
        eng_b.step()
    jspill = jeng.preempt(0, block_row=ROW0)
    spill = eng_a.preempt(0, block_row=ROW0)
    _spill_matches(spill, jspill, n_blocks=8)
    want = {"k", "v", "k_scale", "v_scale"} if kv else {"k", "v"}
    assert set(spill.pages) == want
    jeng.restore(0, jspill, block_row=ROW_NEW)
    eng_a.restore(0, spill, block_row=ROW_NEW)
    pages = {k: v[:, ROW_NEW] for k, v in eng_a._pages().items()}
    for k, v in spill.pages.items():
        assert torch.equal(pages[k], v), k
    assert _same_future(eng_a, eng_b, 0, 0, 8, jeng, 0)


def test_mid_prefill_spill_restore_matches_jax_and_is_bit_for_bit(models):
    """A victim preempted BETWEEN prefill chunks (probe parked, table row
    still NULL) spills like JAX's, resumes on new pages still parked, and
    decodes the undisturbed future after its last chunk."""
    (jmodel, jparams, jpc, jtheta), (model, params, pc, theta) = models
    ekw = dict(n_slots=2, cache_len=24, paged=True, block_size=4,
               num_blocks=16, chunk_tokens=4)
    jeng = JEngine(jmodel, jparams, jpc, jtheta, JServeConfig(**EKW), **ekw)
    eng_a, eng_b = (ContinuousServingEngine(model, params, pc, theta,
                                            ServeConfig(**EKW), **ekw)
                    for _ in range(2))
    tokens = np.random.default_rng(3).integers(
        0, model.cfg.vocab_size, 8).astype(np.int32)
    row_a, row_new = [1, 2, 3, 4, 5, 6], [12, 11, 10, 9, 8, 7]

    def chunk(mod, row, start):
        seg = (JChunkSeg if mod == "jax" else ChunkSeg)(
            slot=0, tokens=tokens, start=start, length=4,
            row=np.asarray(row, np.int32))
        return (JChunkWork if mod == "jax" else ChunkWork)(segs=(seg,))

    for eng, mod in ((jeng, "jax"), (eng_a, "torch"), (eng_b, "torch")):
        eng.begin_prefill(0)
        eng.step(chunk(mod, row_a, 0))
    jspill = jeng.preempt(0, block_row=row_a, armed=False, prompt_len=4)
    spill = eng_a.preempt(0, block_row=row_a, armed=False, prompt_len=4)
    assert not spill.armed and spill.prompt_len == 4
    _spill_matches(spill, jspill, n_blocks=6)
    jeng.restore(0, jspill, block_row=row_new)
    eng_a.restore(0, spill, block_row=row_new)
    assert bool(eng_a.st.stopped[0])          # still parked mid-prefill
    assert (eng_a.state["block_tables"][0] == 0).all()
    for eng, mod, row in ((jeng, "jax", row_new), (eng_a, "torch", row_new),
                          (eng_b, "torch", row_a)):
        eng.step(chunk(mod, row, 4))
        batch = {"tokens": (jnp.asarray if mod == "jax" else np.asarray)(
            tokens[None])}
        eng.finish_prefill(0, batch, 8, block_row=row)
    assert _same_future(eng_a, eng_b, 0, 0, 10, jeng, 0)


@pytest.mark.parametrize("kv,armed", [(None, True), ("int8", True),
                                      (None, False)])
def test_restore_writes_only_its_own_pages(kv, armed):
    """The NULL page and the pages another slot owns hold a sentinel
    before a restore and read it back unchanged after it, every page leaf;
    every other page but the restore's own is untouched too.  A row with
    the NULL page or a page twice is refused, not scattered."""
    _, (model, params, pc, theta) = _models(kv)
    eng = ContinuousServingEngine(model, params, pc, theta,
                                  ServeConfig(**EKW), n_slots=2, cache_len=32,
                                  paged=True, block_size=4, num_blocks=25)
    prompt = np.arange(9, dtype=np.int32)[None]
    eng.admit(0, {"tokens": prompt}, 9, block_row=ROW0)
    eng.admit(1, {"tokens": prompt + 3}, 9, block_row=ROW1)
    eng.step()
    spill = eng.preempt(0, block_row=ROW0, armed=armed)
    for v in eng._pages().values():
        v[:, [0] + ROW1] = 7            # the NULL page and slot 1's pages
    before = {k: v.clone() for k, v in eng._pages().items()}
    new = ROW_NEW[:4] + [3, 1, 2, 4]    # some old pages, some new
    eng.restore(0, spill, block_row=new)
    others = [b for b in range(25) if b not in new]
    for k, v in eng._pages().items():
        assert (v[:, [0] + ROW1] == 7).all(), k
        assert torch.equal(v[:, others], before[k][:, others]), k
        assert torch.equal(v[:, new], spill.pages[k]), k
    table = eng.state["block_tables"][0].tolist()
    assert table == (new if armed else [0] * 8)
    for bad in (ROW_NEW[:7] + [0], ROW_NEW[:7] + [ROW_NEW[0]]):
        with pytest.raises(ValueError, match="distinct real pages"):
            eng.restore(0, spill, block_row=bad)


def test_rwkv_lane_spill_restore_matches_jax_and_is_bit_for_bit():
    """RWKV6's O(1) recurrent state (WKV state and both token shifts) is
    the dense lane: spilled like JAX's, restored into another lane, the
    future bit for bit."""
    jcfg = j_get_config("rwkv6_1b6").reduced()
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build(get_config("rwkv6_1b6").reduced())
    params = from_jax_params(jax.tree.map(np.asarray, jparams), model,
                             device="cpu")
    jpc = JProbeConfig(d_phi=jcfg.d_model, smooth_window=2)
    jtheta = j_init_outer(jpc, jax.random.PRNGKey(1))
    jtheta["b0"] = jnp.asarray(3.0)
    theta = from_jax_theta({k: np.asarray(v) for k, v in jtheta.items()},
                           device="cpu")
    pc = ProbeConfig(d_phi=jcfg.d_model, smooth_window=2)
    jeng, (eng_a, eng_b) = _admit(
        ((jmodel, jparams, jpc, jtheta), (model, params, pc, theta)),
        paged=False)
    for _ in range(3):
        jeng.step()
        eng_a.step()
        eng_b.step()
    jspill, spill = jeng.preempt(0), eng_a.preempt(0)
    assert set(spill.lane) == {"wkv", "tm_x", "cm_x"}
    _spill_matches(spill, jspill)
    jeng.restore(2, jspill)
    eng_a.restore(2, spill)
    assert _same_future(eng_a, eng_b, 2, 0, 8, jeng, 2)


def test_tree_engine_spill_restore_mid_verify_is_bit_for_bit(models):
    """A tree engine (2.2, 5 nodes a slot): slot 0 preempted between tree
    verify steps, restored into slot 2; its multi-token future — gen, seq,
    seq_scores, seq_n and the stop state — equals the undisturbed twin's
    bit for bit and JAX's restored engine's."""
    kk = 5
    (jmodel, jparams, jpc, jtheta), (model, params, pc, theta) = models
    ekw = dict(n_slots=3, cache_len=64, spec_tree=(2, 2))
    jeng = JEngine(jmodel, jparams, jpc, jtheta, JServeConfig(**EKW),
                   probe_impl="ref", **ekw)
    engs = [ContinuousServingEngine(model, params, pc, theta,
                                    ServeConfig(**EKW), **ekw)
            for _ in range(2)]
    rng = np.random.default_rng(5)
    for slot, n in enumerate((9, 13)):
        p = rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)
        jeng.admit(slot, {"tokens": jnp.asarray(p[None])}, n)
        for e in engs:
            e.admit(slot, {"tokens": p[None]}, n)
    eng_a, eng_b = engs
    lens = np.asarray([kk, kk, 0], np.int32)
    for _ in range(2):
        for e in (jeng, eng_a, eng_b):
            e.step(spec_lens=lens)
    jspill, spill = jeng.preempt(0), eng_a.preempt(0)
    _spill_matches(spill, jspill)
    jeng.restore(2, jspill)
    eng_a.restore(2, spill)
    moved = np.asarray([0, kk, kk], np.int32)
    assert _same_future(eng_a, eng_b, 2, 0, 10, jeng, 2,
                        spec_lens=(moved, lens))


# ---------------------------------------------------------------------------
# scheduler level: forced preemption against JAX, stops never move

N_REQ, PROMPT = 9, 6
# per-request budgets: 3 FINISHES before the burn-in lets it stop, 10
# STOPS on the decisive probe
BUDGET = (10, 3, 10, 10, 10, 10, 10, 10, 10)
BLOCKS = 4                              # ceil((6 + 10) / 4)
# BURST (FIFO ignores class at admission): batch traffic fills every slot,
# then two urgent requests hit the full fleet and each spills the newest
# batch resident.  GANG (priority, EDF): the urgent singleton finishes
# early, and the mid-class gang of 3 waiting for slots spills the
# low-class residents to complete its quota.
BURST_PRIO = [1, 1, 1, 0, 0, 2, 2, 2, 2]
GANG_PRIO = [1, 0, 2, 2, 1, 1, 2, 2, 2]
GANG = [0, 4, 5]
REQ_FIELDS = ("state", "stop_step", "tokens", "admitted_step",
              "restored_step", "n_preempted", "completed_step")
FLEET_FIELDS = ("preemptions", "restores", "spilled_blocks", "engine_steps",
                "prefill_chunks", "packed_chunks")


def _layout(policy):
    return (BURST_PRIO, None) if policy == "fifo" else (GANG_PRIO, GANG)


@functools.lru_cache(maxsize=None)
def _fleet_prompts(vocab):
    rng = np.random.default_rng(23)
    return [rng.integers(0, vocab, PROMPT).astype(np.int32)
            for _ in range(N_REQ)]


def _requests(make, prompts, priorities, group=None):
    reqs = [make(p, max_new_tokens=n, priority=c)
            for p, n, c in zip(prompts, BUDGET, priorities)]
    for i, r in enumerate(reqs):
        if group is not None and i in group:
            r.group_id, r.sample_idx = 0, group.index(i)
    return reqs


def _fleet_both(models, priorities, group=None, n_slots=3, jax_kw=None,
                **kw):
    """The same traffic through JAX's scheduler and the port's: every
    request's lifecycle and the fleet counters exactly equal."""
    (jmodel, jparams, jpc, jtheta), (model, params, pc, theta) = models
    kw = dict(dict(tokens_per_step=2, max_new_tokens=10, lam=0.6, burn_in=3,
                   n_slots=n_slots, block_size=4), **kw)
    prompts = _fleet_prompts(model.cfg.vocab_size)
    jkw = dict(kw, **(jax_kw or {}))
    if isinstance(kw.get("policy"), FIFOPolicy):
        jkw["policy"] = jpolicy.FIFOPolicy(
            max_head_skips=kw["policy"].max_head_skips)
    jdone, jfleet = JOrcaScheduler(
        jmodel, jparams, jpc, jtheta,
        JServeConfig(**jkw)).run(
        _requests(j_make_request, prompts, priorities, group))
    sched = OrcaScheduler(model, params, pc, theta, ServeConfig(**kw))
    done, fleet = sched.run(_requests(make_request, prompts, priorities,
                                      group))
    for r, jr in zip(done, jdone):
        for f in REQ_FIELDS:
            got, want = getattr(r, f), getattr(jr, f)
            if f == "state":
                got, want = got.value, want.value
            assert got == want, (r.req_id, f, got, want)
        np.testing.assert_allclose(r.scores, jr.scores, rtol=0, atol=ATOL)
    for f in FLEET_FIELDS:
        assert getattr(fleet, f) == getattr(jfleet, f), f
    assert all(r.done for r in done)
    if kw.get("paged"):
        assert sched.pool.num_free == sched.pool.num_usable
        sched.pool.check()
        assert (sched.engine.state["block_tables"] == 0).all()
    return sched, done, fleet


@pytest.fixture(scope="module")
def abundant_stops(models):
    """Every request at once on 9 slots and a pool for all: nothing
    contends, the stop steps every schedule must reproduce."""
    _, (model, params, pc, theta) = models
    sched = OrcaScheduler(model, params, pc, theta, ServeConfig(
        tokens_per_step=2, max_new_tokens=10, lam=0.6, burn_in=3,
        n_slots=N_REQ, block_size=4, paged=True,
        num_blocks=1 + N_REQ * BLOCKS))
    done, fleet = sched.run(_requests(
        make_request, _fleet_prompts(model.cfg.vocab_size), BURST_PRIO))
    assert fleet.preemptions == 0
    stops = [r.stop_step for r in done]
    assert {s >= 0 for s in stops} == {True, False}   # stops and finishes
    return stops


@pytest.mark.parametrize("paged,chunk,policy,pack", [
    (True, None, "fifo", False),
    (True, 3, "fifo", False),
    (False, None, "fifo", False),
    (True, None, "priority", False),
    (True, 3, "priority", True),
    (False, None, "priority", False),
    (True, None, "edf", False),
    (False, 3, "edf", True),
])
def test_forced_preemption_matches_jax_and_is_stop_invariant(
        models, abundant_stops, paged, chunk, policy, pack):
    """A fleet under REAL contention (>= 1 victim spilled AND restored):
    per request the stop step, tokens, admission, restore and completion
    steps and spill count equal JAX's, and the fleet's preemptions,
    restores and spilled pages; the stops equal the abundant fleet's."""
    priorities, group = _layout(policy)
    sched, done, fleet = _fleet_both(
        models, priorities, group, paged=paged,
        num_blocks=1 + 3 * BLOCKS if paged else None, chunk_tokens=chunk,
        policy=policy, pack_chunks=pack)
    assert fleet.preemptions > 0, "contention never materialized (vacuous)"
    assert fleet.restores == fleet.preemptions
    assert (fleet.spilled_blocks > 0) == paged
    assert [r.stop_step for r in done] == abundant_stops
    victims = [r for r in done if r.n_preempted > 0]
    assert victims
    for r in victims:
        assert r.restored_step > r.admitted_step
        assert r.state in (RequestState.STOPPED, RequestState.FINISHED)
    if chunk and policy == "fifo":
        # the burst lands while the batch residents are mid-prefill
        assert fleet.prefill_chunks > 0


def test_preemption_off_is_wait_only(models, abundant_stops):
    sched, done, fleet = _fleet_both(
        models, BURST_PRIO, paged=True, num_blocks=1 + 3 * BLOCKS,
        preemption=False)
    assert fleet.preemptions == fleet.restores == 0
    assert all(r.n_preempted == 0 for r in done)
    assert [r.stop_step for r in done] == abundant_stops


def test_swapped_restores_before_waiting(models):
    """Victims spilled for an urgent gang restore BEFORE any same-class
    WAITING request is admitted."""
    sched, done, fleet = _fleet_both(
        models, [1, 0, 0, 1, 1, 1, 1, 1, 1], [1, 2], n_slots=2, paged=True,
        num_blocks=1 + 4 * BLOCKS)
    assert fleet.preemptions >= 1
    victims = [r for r in done if r.n_preempted > 0]
    fresh = [r for r in done if r.n_preempted == 0 and r.priority == 1
             and r.admitted_step > 0 and r.group_id is None]
    assert victims and fresh
    for v in victims:
        assert 0 <= v.restored_step <= min(w.admitted_step for w in fresh)


def _gang_layout(models, max_head_skips):
    # queue order: 2 singletons, a gang of 3, more singletons — the gang
    # starts only once a whole fleet's worth of slots is free
    return _fleet_both(models, [0] * N_REQ, [2, 3, 4], paged=True,
                       num_blocks=1 + 6 * BLOCKS, preemption=False,
                       policy=FIFOPolicy(max_head_skips=max_head_skips))


def test_singleton_admits_past_a_blocked_gang(models):
    """FIFO, no preemption: the gang of 3 cannot start beside 2 residents;
    singletons behind it take the free slot while it waits, and it admits
    atomically, as in JAX."""
    _, done, fleet = _gang_layout(models, 8)
    gang = [r for r in done if r.group_id is not None]
    late = [r for r in done if r.group_id is None
            and r.req_id > max(g.req_id for g in gang)]
    assert min(s.admitted_step for s in late) \
        < min(g.admitted_step for g in gang)
    assert len({g.admitted_step for g in gang}) == 1
    assert fleet.preemptions == 0


def test_blocked_gang_ages_to_a_pin(models):
    """With max_head_skips=1 the gang is pinned after one skip: at most
    one singleton overtakes it."""
    _, done, _ = _gang_layout(models, 1)
    gang_step = min(r.admitted_step for r in done if r.group_id is not None)
    overtakers = [r for r in done if r.group_id is None
                  and 0 < r.admitted_step < gang_step]
    assert len(overtakers) <= 1


def test_tree_fleet_under_forced_preemption_matches_jax(monkeypatch, models,
                                                        abundant_stops):
    """The BURST fleet with ``spec_tree="2.2"`` on a paged engine: victims
    are spilled between tree verify steps and restored, the schedule and
    every stop equal JAX's tree fleet and the abundant fleet's."""
    monkeypatch.setenv("REPRO_PAGED_ATTN", "pallas")
    sched, done, fleet = _fleet_both(
        models, BURST_PRIO, paged=True, num_blocks=1 + 3 * BLOCKS,
        spec_tree="2.2", jax_kw=dict(probe_impl="ref"))
    assert fleet.preemptions > 0 and fleet.restores == fleet.preemptions
    assert fleet.tree_nodes_proposed > 0
    assert [r.stop_step for r in done] == abundant_stops
    victims = [r for r in done if r.n_preempted > 0]
    assert victims and all(r.tree_nodes > 0 for r in victims)


# ---------------------------------------------------------------------------
# the policies on the same inputs as JAX's

def _residents(make, priorities):
    res = [make(np.zeros(1, np.int32), priority=p) for p in priorities]
    for i, r in enumerate(res):
        r.admitted_step = i
    return res


def test_select_victim_lowest_class_newest_first():
    """Least-urgent class first, newest admission first, strictly lower
    classes only — the same index as JAX's for every request class."""
    for prios in ((2, 1, 2, 0), (0, 1, 2, 0), (1, 1, 1)):
        ours = _residents(make_request, prios)
        theirs = _residents(j_make_request, prios)
        for cls in range(-1, 4):
            assert FIFOPolicy().select_victim(ours, cls) \
                == jpolicy.FIFOPolicy().select_victim(theirs, cls)
    res = _residents(make_request, (2, 1, 2, 0))
    assert FIFOPolicy().select_victim(res, 0) == 2
    assert FIFOPolicy().select_victim(res, 2) is None


def test_edf_ranks_by_deadline_and_from_metrics():
    ours = _residents(make_request, (0, 1, 2))
    theirs = _residents(j_make_request, (0, 1, 2))
    slo = {0: 500.0, 1: 200.0}
    for deadline in (10.0, None):
        for reqs in (ours, theirs):
            reqs[2].deadline_ms = deadline
        got = EDFPolicy(class_slo_ms=slo).select_admit(ours, 0)
        assert got == jpolicy.EDFPolicy(class_slo_ms=slo).select_admit(
            theirs, 0)
        assert got == (2 if deadline else 1)
    assert EDFPolicy()._deadline(ours[2]) == pytest.approx(3000.0)
    per_class = {"c0_ttft_ms_p99": 80.0, "c1_ttft_ms_p99": 40.0,
                 "c0_queue_wait_ms_p99": 999.0}
    pol = EDFPolicy.from_metrics(per_class, slack=1.5)
    jpol = jpolicy.EDFPolicy.from_metrics(per_class, slack=1.5)
    assert pol.class_slo_ms == jpol.class_slo_ms \
        == {0: pytest.approx(120.0), 1: pytest.approx(60.0)}
    assert pol.select_admit(ours[:2], 0) == jpol.select_admit(theirs[:2], 0)


def test_make_policy_names_and_error():
    for name in ("fifo", "priority", "edf", "ttft", None):
        assert type(make_policy(name)).__name__ \
            == type(jpolicy.make_policy(name)).__name__
        ServeConfig(policy=name)
    pol = tpolicy.TTFTAwarePolicy(busy_share=3)
    assert make_policy(pol) is pol
    for mod in (tpolicy, jpolicy):
        with pytest.raises(ValueError, match="unknown scheduling policy"):
            mod.make_policy("lifo")
    with pytest.raises(ValueError, match="unknown scheduling policy"):
        ServeConfig(policy="lifo")
    # the TTFT-aware share throttles only a full fleet
    for n_running, n_prefilling in ((1, 1), (2, 2)):
        kw = dict(n_running=n_running, n_slots=4, n_prefilling=n_prefilling,
                  n_waiting=2, token_budget=12, chunk_tokens=8,
                  near_boundary=0)
        assert pol.prefill_share(tpolicy.ComposeView(**kw)) \
            == jpolicy.TTFTAwarePolicy(busy_share=3).prefill_share(
                jpolicy.ComposeView(**kw))


def test_pressure_reports_swapped_and_resident(models):
    """``pressure()`` mid-session: a swapped victim, the residents, free
    slots and pages, as JAX's scheduler reports them after the same step."""
    (jmodel, jparams, jpc, jtheta), (model, params, pc, theta) = models
    kw = dict(tokens_per_step=2, max_new_tokens=10, lam=0.6, burn_in=3,
              n_slots=3, block_size=4, paged=True, num_blocks=1 + 3 * BLOCKS)
    prompts = _fleet_prompts(model.cfg.vocab_size)
    jsched = JOrcaScheduler(jmodel, jparams, jpc, jtheta, JServeConfig(**kw))
    sched = OrcaScheduler(model, params, pc, theta, ServeConfig(**kw))
    assert sched.pressure().n_slots == 3 and sched.pressure().pool_blocks == 0
    jsched.submit(_requests(j_make_request, prompts, BURST_PRIO))
    sched.submit(_requests(make_request, prompts, BURST_PRIO))
    jsched.step()
    sched.step()
    got, want = sched.pressure(host=1), jsched.pressure(host=1)
    assert got.n_swapped == 2
    for f in ("host", "n_slots", "n_running", "n_prefilling", "n_swapped",
              "n_waiting", "queued_samples", "free_slots", "pool_blocks",
              "free_blocks", "blocks_in_use", "max_resident_priority"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.outstanding == want.outstanding == N_REQ
    sched.drain()


# ---------------------------------------------------------------------------
# the serving driver

@pytest.mark.parametrize("preempt", [True, False])
def test_serve_driver_policy_flags_on_cpu(capsys, preempt):
    """``--policy priority --batch-every 2``: the batch head is pinned by
    the aging guard, admitted, and spilled for the next urgent request —
    the preemption line; ``--no-preempt`` waits instead and prints none."""
    out = tserve.serve(["--arch", "smollm-360m", "--reduced", "--device",
                        "cpu", "--paged", "--policy", "priority",
                        "--batch-every", "2", "--requests", "20", "--slots",
                        "2", "--max-new-tokens", "16",
                        "--train-trajectories", "8", "--epochs", "2",
                        "--prompt-len", "8",
                        *([] if preempt else ["--no-preempt"])])
    text = capsys.readouterr().out
    assert ("[serve] preemption: " in text) == preempt
    assert out.scheduler.preemption == preempt
    assert [r.priority for r in out.requests[:4]] == [1, 0, 1, 0]
    if preempt:
        assert out.fleet.preemptions == out.fleet.restores > 0
        assert f"{out.fleet.preemptions} spills" in text
