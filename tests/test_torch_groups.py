"""The port's self-consistency groups and consensus stop held to the JAX
package's: the consensus math (``weighted_vote``, ``consensus_trace``,
``consensus_stop_times``, ``consensus_risk``), ``GroupCalibrator``
(calibrate with and without the per-sample stop, the gates of
``decide``), ``groups_from_trajectories``, the config's and the
scheduler's messages; then the serving tests of the JAX suite
(``tests/test_group_serving.py``), each served by both packages on the
same replay bank (``serving.replay``): consensus off is inert, singleton
groups are the ungrouped fleet, gang admission is atomic, the consensus
cancels siblings (RUNNING, mid-prefill and SWAPPED) and frees their pages,
the served decisions equal the offline trace, and the pinned cancellation
invariants; and grouped fleets of the reduced smollm-360m and llama3.2-3b
(paged, chunked, consensus on).  Every request's state, stop step, tokens,
scores and steps, every group's consensus fields and the fleet's group
metrics equal JAX's.  Pinned seeds stand in for the JAX suite's fuzz."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stopping as JS
from repro.core.calibrator import GroupCalibrator as JGroupCalibrator
from repro.core.calibrator import GroupTrace as JGroupTrace
from repro.core.calibrator import \
    groups_from_trajectories as j_groups_from_trajectories
from repro.core.probe import ProbeConfig as JProbeConfig
from repro.core.probe import init_outer as j_init_outer
from repro.serving import OrcaScheduler as JOrcaScheduler
from repro.serving import ServeConfig as JServeConfig
from repro.serving import make_group as j_make_group
from repro.serving import make_group_fleet as j_make_group_fleet
from repro.serving import make_request as j_make_request
from repro.serving import replay_model as j_replay_model
from repro.serving import replay_params as j_replay_params
from repro.trajectories import synthetic as jsyn

from repro_torch import api
from repro_torch.core import stopping as S
from repro_torch.core.calibrator import (GroupCalibrator, GroupTrace,
                                         groups_from_trajectories)
from repro_torch.core.probe import ProbeConfig
from repro_torch.models.convert import from_jax_theta
from repro_torch.serving import (OrcaScheduler, RequestState, ServeConfig,
                                 group_requests, make_group,
                                 make_group_fleet, make_request,
                                 replay_model, replay_params)
from repro_torch.trajectories import synthetic as tsyn
from tests.test_torch_serve import _models

D = 24
# f32 probe scores of the two packages agree to a few ulps
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _bank(n, t, seed=0, scale=0.6):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, t, D) * scale).astype(np.float32)


def _probes(bias, smooth_window=1, d=D, key=1):
    """The JAX suite's ``_probe`` and its port twin (same slow weights)."""
    jpc = JProbeConfig(d_phi=d, smooth_window=smooth_window)
    jtheta = j_init_outer(jpc, jax.random.PRNGKey(key))
    jtheta["b0"] = jnp.asarray(float(bias))
    theta = from_jax_theta({k: np.asarray(v) for k, v in jtheta.items()},
                           device="cpu")
    return (jpc, jtheta), (ProbeConfig(d_phi=d, smooth_window=smooth_window),
                           theta)


def _replay_reqs(mk, n, lengths, *, group_size=None, prompt_len=1,
                 priority=None):
    """Replay requests through ``mk`` (either package's make_request);
    ``group_size`` assigns consecutive group ids."""
    reqs = []
    for i in range(n):
        gid = (i // group_size) if group_size else None
        sj = (i % group_size) if group_size else 0
        reqs.append(mk(np.full((prompt_len,), i, np.int64),
                       max_new_tokens=int(lengths[i]), group_id=gid,
                       sample_idx=sj))
        if priority is not None:
            reqs[-1].priority = priority(i)
    return reqs


def _consensus_of(consensus, j):
    """A float passes as is; a GroupCalibrator spec (dict) is built in the
    package asked for."""
    if isinstance(consensus, dict):
        return (JGroupCalibrator if j else GroupCalibrator)(**consensus)
    return consensus


class Replay:
    """One replay fleet description, served by both packages."""

    def __init__(self, bank, answers=None, prompt_len=1, bias=1.5,
                 smooth_window=2, draft_wrong_rate=0.0, key=1):
        self.bank, self.answers = bank, answers
        kw = dict(prompt_len=prompt_len, answers=answers,
                  draft_wrong_rate=draft_wrong_rate)
        self.jmodel = j_replay_model(bank, **kw)
        self.jparams = j_replay_params(bank, answers=answers)
        self.model = replay_model(bank, **kw)
        self.params = replay_params(bank, answers=answers, device="cpu")
        (self.jpc, self.jtheta), (self.pc, self.theta) = _probes(
            bias, smooth_window, bank.shape[2], key)

    def scheds(self, cfg_kw, consensus=None, **kw):
        jcfg = JServeConfig(**cfg_kw)
        cfg = ServeConfig(**{k: v for k, v in cfg_kw.items()
                             if k != "probe_impl"})
        return (JOrcaScheduler(self.jmodel, self.jparams, self.jpc,
                               self.jtheta, jcfg,
                               consensus=_consensus_of(consensus, True),
                               **kw),
                OrcaScheduler(self.model, self.params, self.pc, self.theta,
                              cfg, consensus=_consensus_of(consensus, False),
                              **kw))

    def run(self, cfg_kw, reqs, consensus=None, **kw):
        """Serve ``reqs(mk)`` through both packages; assert they agree and
        return the port's (scheduler, done, fleet)."""
        jsched, sched = self.scheds(cfg_kw, consensus, **kw)
        jdone, jfleet = jsched.run(reqs(j_make_request))
        done, fleet = sched.run(reqs(make_request))
        assert_same(jsched, jdone, jfleet, sched, done, fleet)
        return sched, done, fleet


REQ_FIELDS = ("stop_step", "tokens", "steps_run", "admitted_step",
              "completed_step", "first_token_step", "slot",
              "prefill_progress", "prefill_skipped", "n_shared_blocks",
              "n_preempted", "restored_step", "answers", "group_id",
              "sample_idx")
GROUP_FIELDS = ("group_id", "consensus_step", "consensus_index",
                "consensus_answer", "decided", "done", "n_cancelled")
FLEET_FIELDS = ("engine_steps", "samples_cancelled", "consensus_groups",
                "consensus_steps", "group_savings", "group_savings_mean",
                "cancel_freed_blocks", "prefill_skips", "peak_blocks_in_use",
                "prefill_chunks", "packed_chunks", "preemptions",
                "restores", "spilled_blocks", "mean_step_savings",
                "spec_tokens_proposed", "spec_tokens_accepted",
                "tree_nodes_proposed")


def assert_same(jsched, jdone, jfleet, sched, done, fleet):
    assert len(done) == len(jdone)
    for r, jr in zip(done, jdone):
        assert r.state.value == jr.state.value, r.req_id
        for f in REQ_FIELDS:
            assert getattr(r, f) == getattr(jr, f), (f, r.req_id)
        np.testing.assert_allclose(r.scores, jr.scores, rtol=0, atol=ATOL)
    assert len(sched.groups) == len(jsched.groups)
    for g, jg in zip(sched.groups, jsched.groups):
        for f in GROUP_FIELDS:
            assert getattr(g, f) == getattr(jg, f), (f, g.group_id)
        assert g.consensus_agreement == pytest.approx(
            jg.consensus_agreement, abs=ATOL)
        assert [r.sample_idx for r in g.requests] \
            == [r.sample_idx for r in jg.requests]
    for f in FLEET_FIELDS:
        assert getattr(fleet, f) == pytest.approx(getattr(jfleet, f),
                                                  abs=1e-9), f
    if sched.pool is not None:
        assert sched.pool.num_free == sched.pool.num_usable
        sched.pool.check()


# ---------------------------------------------------------------------------
# the consensus math (core.stopping), on random inputs

@pytest.mark.parametrize("seed", range(4))
def test_consensus_math_matches_jax(seed):
    rs = np.random.RandomState(seed)
    n, t = 4, 12
    scores = rs.rand(n, t) * 1.2 - 0.1          # some clipped at 0
    answers = rs.randint(0, 3, size=(n, t))
    lengths = rs.randint(1, t + 1, size=n)
    active = rs.rand(n) > 0.3
    assert S.weighted_vote(scores[:, 0], answers[:, 0], active) \
        == JS.weighted_vote(scores[:, 0], answers[:, 0], active)
    tau = rs.randint(0, t + 2, size=n)
    for ps in (None, tau):
        ans, agr = S.consensus_trace(scores, answers, lengths,
                                     per_sample_tau=ps)
        jans, jagr = JS.consensus_trace(scores, answers, lengths,
                                        per_sample_tau=ps)
        np.testing.assert_array_equal(ans, jans)
        np.testing.assert_array_equal(agr, jagr)
    grid = np.sort(rs.rand(7))
    tau_g = S.consensus_stop_times(agr, grid, burn_in=seed)
    np.testing.assert_array_equal(
        tau_g, JS.consensus_stop_times(jagr, grid, burn_in=seed))
    for truth in (int(ans[-1]), 99, -1):
        np.testing.assert_array_equal(S.consensus_risk(tau_g, ans, truth),
                                      JS.consensus_risk(tau_g, jans, truth))


def test_weighted_vote_ties_inactive_and_nonpositive():
    assert S.weighted_vote([1.0, 1.0], [5, 3], [True, True]) == (3, 0.5)
    assert S.weighted_vote([0.9, 0.9], [1, 2], [False, False]) == (-1, 0.0)
    assert S.weighted_vote([-1.0, 0.5], [7, 2], [True, True]) == (2, 1.0)


# ---------------------------------------------------------------------------
# GroupCalibrator and groups_from_trajectories

def _traces(seed, n_groups=20, n=3, t=20):
    rs = np.random.RandomState(seed)
    out = []
    for g in range(n_groups):
        scores = rs.rand(n, t) * 0.5 + 0.4
        answers = np.where(rs.rand(n, t) < 0.8, g, 99 + g)
        lengths = rs.randint(t // 2, t + 1, size=n)
        truth = g if g % 5 else 99 + g
        out.append((scores, answers, lengths, truth))
    return ([JGroupTrace(*a) for a in out], [GroupTrace(*a) for a in out])


@pytest.mark.parametrize("per_sample_lam", [None, 0.75])
@pytest.mark.parametrize("seed", [0, 1])
def test_group_calibrator_calibrate_matches_jax(seed, per_sample_lam):
    jtr, tr = _traces(seed)
    jgc = JGroupCalibrator(min_votes=2, burn_in=2)
    gc = GroupCalibrator(min_votes=2, burn_in=2)
    kw = dict(eps=0.2, per_sample_lam=per_sample_lam, per_sample_burn_in=1)
    lam = gc.calibrate(tr, 0.3, **kw)
    jlam = jgc.calibrate(jtr, 0.3, **kw)
    assert lam == jlam and gc.delta == jgc.delta == 0.3
    for f in ("rejected", "pvalues", "emp_risk", "grid"):
        np.testing.assert_array_equal(getattr(gc.ltt, f),
                                      getattr(jgc.ltt, f))
    # a group below min_votes can never fire: zero risk, same threshold
    small = [GroupTrace(t.scores[:1], t.answers[:1], t.lengths[:1], t.truth)
             for t in tr]
    jsmall = [JGroupTrace(t.scores[:1], t.answers[:1], t.lengths[:1],
                          t.truth) for t in jtr]
    assert GroupCalibrator().calibrate(small, 0.3) \
        == JGroupCalibrator().calibrate(jsmall, 0.3)


def test_group_calibrator_threshold_requires_calibrate():
    with pytest.raises(RuntimeError, match="calibrate"):
        GroupCalibrator().threshold()


DECIDE_CASES = [
    ([[0.9, 0.9, 0.9]], [[4, 4, 4]]),                       # a lone voter
    ([[0.9], [0.9]], [[4], [4]]),                           # before burn-in
    ([[0.9, 0.9, 0.9], [0.8, 0.8, 0.8]], [[4, 4, 4], [4, 4, 4]]),
    ([[0.5, 0.5, 0.5], [0.5, 0.5, 0.5]], [[4, 4, 4], [9, 9, 9]]),
    ([[0.7, 0.2, 0.9], [], [0.4, 0.6, 0.3]], [[1, 2, 2], [], [2, 2, 1]]),
    ([[0.1, 0.2], [0.3, 0.4, 0.5, 0.6], [0.9]], [[1, 1], [3, 3, 3, 1], [1]]),
]


@pytest.mark.parametrize("case", range(len(DECIDE_CASES)))
def test_group_calibrator_decide_gates_match_jax(case):
    scores, answers = DECIDE_CASES[case]
    gc = GroupCalibrator(min_votes=2, burn_in=2, lam=0.6)
    jgc = JGroupCalibrator(min_votes=2, burn_in=2, lam=0.6)
    fire, ans, agr = gc.decide(scores, answers)
    assert (fire, ans, agr) == jgc.decide(scores, answers)
    assert fire == (case in (2, 4, 5))
    assert not fire or ans == {2: 4, 4: 2, 5: 1}[case]


@pytest.mark.parametrize("group_size,seed", [(1, 0), (3, 0), (4, 2), (5, 7)])
def test_groups_from_trajectories_matches_jax(group_size, seed):
    ts = tsyn.generate(tsyn.TrajectoryDistribution(
        "g", d_phi=8, t_min=6, t_max=12), 23, seed=seed)
    jts = jsyn.generate(jsyn.TrajectoryDistribution(
        "g", d_phi=8, t_min=6, t_max=12), 23, seed=seed)
    np.testing.assert_array_equal(ts.answers, jts.answers)
    scores = np.random.RandomState(seed).rand(*ts.mask.shape)
    got = groups_from_trajectories(ts, scores, group_size, seed=seed)
    want = j_groups_from_trajectories(jts, scores, group_size, seed=seed)
    assert len(got) == len(want) == 23 // group_size
    for g, jg in zip(got, want):
        assert g.truth == jg.truth
        for f in ("scores", "answers", "lengths"):
            np.testing.assert_array_equal(getattr(g, f), getattr(jg, f))
    with pytest.raises(ValueError, match="group_size must be >= 1"):
        groups_from_trajectories(ts, scores, 0)


# ---------------------------------------------------------------------------
# the messages: ServeConfig and the scheduler name the fix as JAX does

def _message(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def _stale(cls):
    gc = cls(lam=0.7)
    gc.delta = 0.2
    return gc


BAD_CONFIGS = [dict(group_size=0), dict(group_size=True),
               dict(n_slots=2, group_size=3),
               dict(group_size=1, consensus=0.9),
               dict(group_size=2, consensus=True),
               dict(group_size=2, consensus=1.5),
               dict(group_size=2, consensus=0.0),
               dict(group_size=2, consensus_delta=0.1),
               dict(group_size=2, consensus="stale", consensus_delta=0.3)]


@pytest.mark.parametrize("case", range(len(BAD_CONFIGS)))
def test_serve_config_group_messages_match_jax(case):
    kw = BAD_CONFIGS[case]

    def build(cfg_cls, gc_cls):
        return lambda: cfg_cls(**{k: (_stale(gc_cls) if v == "stale" else v)
                                  for k, v in kw.items()})
    assert _message(build(ServeConfig, GroupCalibrator)) \
        == _message(build(JServeConfig, JGroupCalibrator))


def test_serve_config_takes_groups_and_consensus():
    gc = GroupCalibrator(lam=0.7)
    gc.delta = 0.1
    cfg = ServeConfig(n_slots=4, group_size=4, consensus=gc,
                      consensus_delta=0.1)
    assert (cfg.group_size, cfg.consensus, cfg.consensus_delta) \
        == (4, gc, 0.1)
    assert ServeConfig(group_size=2, consensus=0.5).consensus == 0.5


@pytest.mark.parametrize("consensus", [True, 1.5, "gc", "0.9"])
def test_scheduler_rejects_bad_consensus_values_as_jax(consensus):
    args = (None, None, ProbeConfig(d_phi=4), None, ServeConfig(lam=0.5))
    jargs = (None, None, JProbeConfig(d_phi=4), None, JServeConfig(lam=0.5))
    got = _message(lambda: OrcaScheduler(
        *args, consensus=GroupCalibrator() if consensus == "gc"
        else consensus))
    want = _message(lambda: JOrcaScheduler(
        *jargs, consensus=JGroupCalibrator() if consensus == "gc"
        else consensus))
    assert got == want


def test_scheduler_rejects_group_larger_than_fleet():
    fl = Replay(_bank(3, 4), bias=0.0, smooth_window=1)
    _, sched = fl.scheds(dict(tokens_per_step=1, max_new_tokens=4, lam=2.0),
                         n_slots=2)
    with pytest.raises(ValueError, match="gang admission"):
        sched.run(_replay_reqs(make_request, 3, [4, 4, 4], group_size=3))


def test_group_requests_units_and_renumbering():
    g0 = make_group(np.zeros(4, np.int64), 2, group_id=0)
    solo = make_request(np.ones(4, np.int64))
    g1 = make_group(np.zeros(4, np.int64), 2, group_id=1)
    units, groups = group_requests([g0[0], solo, g0[1], g1[0], g1[1]])
    assert units == [g0, [solo], g1]
    reqs = [make_request(np.zeros(2, np.int64), group_id=5)
            for _ in range(3)]
    units, groups = group_requests(reqs)
    assert len(units) == 1 and groups[0].size == 3
    assert sorted(r.sample_idx for r in reqs) == [0, 1, 2]


# ---------------------------------------------------------------------------
# consensus off: the group layer is inert

@pytest.mark.parametrize("policy", ["fifo", "priority", "ttft"])
@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("paged", [False, True])
def test_grouping_without_consensus_is_inert_and_matches_jax(policy, pack,
                                                             paged):
    """JAX ``:224``: the fleet served ungrouped and as consensus-off groups
    gives the same stops, scores and tokens, each equal to JAX's."""
    n, t = 9, 12
    fl = Replay(_bank(n, t, seed=4), bias=1.0)
    lengths = [12, 8, 10, 12, 6, 12, 9, 12, 7]
    cfg = dict(tokens_per_step=1, max_new_tokens=t, lam=0.62, burn_in=2)

    def run(group_size):
        return fl.run(cfg, lambda mk: _replay_reqs(
            mk, n, lengths, group_size=group_size,
            priority=lambda i: i % 2), n_slots=4, paged=paged, block_size=4,
            chunk_tokens=3, pack_chunks=pack, policy=policy)

    _, base, _ = run(None)
    _, grouped, fleet = run(3)
    for rb, rg in zip(base, grouped):
        assert (rb.stop_step, rb.tokens, rb.scores) \
            == (rg.stop_step, rg.tokens, rg.scores)
        assert rg.state in (RequestState.STOPPED, RequestState.FINISHED)
    assert fleet.samples_cancelled == 0 and fleet.consensus_groups == 0


def test_singleton_groups_match_the_ungrouped_fleet():
    """JAX ``:257``: group_size 1 (every request its own group)."""
    n, t = 6, 10
    fl = Replay(_bank(n, t, seed=9), bias=1.2)
    cfg = dict(tokens_per_step=1, max_new_tokens=t, lam=0.6, burn_in=1)
    runs = [fl.run(cfg, lambda mk: _replay_reqs(mk, n, [t] * n,
                                                group_size=gs),
                   n_slots=3, paged=True, block_size=4)[1]
            for gs in (None, 1)]
    for rb, rg in zip(*runs):
        assert rb.stop_step == rg.stop_step and rb.tokens == rg.tokens


def test_gang_admission_is_atomic():
    """JAX ``:280``: all samples of a group land on the same engine step,
    even when slots free up one at a time."""
    n, t = 9, 8
    fl = Replay(_bank(n, t, seed=5), bias=0.0, smooth_window=1)
    lengths = [8, 5, 3, 8, 8, 8, 8, 8, 8]
    _, done, _ = fl.run(dict(tokens_per_step=1, max_new_tokens=t, lam=2.0),
                        lambda mk: _replay_reqs(mk, n, lengths,
                                                group_size=3),
                        n_slots=4, paged=True, block_size=4)
    _, groups = group_requests(done)
    for g in groups:
        assert len({r.admitted_step for r in g.requests}) == 1
    for a, b in itertools.combinations(done, 2):
        if a.slot == b.slot:
            assert (a.completed_step <= b.admitted_step
                    or b.completed_step <= a.admitted_step)


def test_intra_gang_prompt_sharing_on_the_reduced_model():
    """JAX ``:303``: the siblings share the leader's full prompt pages,
    skip prefill and decode the leader's tokens, as in JAX."""
    (jmodel, jparams, _, _), (model, params, _, _) = _models()
    (jpc, jtheta), (pc, theta) = _probes(0.0, 1, model.cfg.d_model)
    kw = dict(tokens_per_step=2, max_new_tokens=8, lam=2.0, burn_in=0,
              n_slots=3, paged=True, block_size=4)
    prompt = np.random.default_rng(3).integers(
        0, model.cfg.vocab_size, 8).astype(np.int32)
    jsched = JOrcaScheduler(jmodel, jparams, jpc, jtheta, JServeConfig(**kw))
    jdone, jfleet = jsched.run(j_make_group(prompt, 3, group_id=0))
    sched = OrcaScheduler(model, params, pc, theta, ServeConfig(**kw))
    done, fleet = sched.run(make_group(prompt, 3, group_id=0))
    assert_same(jsched, jdone, jfleet, sched, done, fleet)
    leader, *sibs = sorted(done, key=lambda r: r.sample_idx)
    assert not leader.prefill_skipped and leader.n_shared_blocks == 0
    for s in sibs:
        assert s.prefill_skipped and s.n_shared_blocks == 2
        assert s.tokens == leader.tokens
    assert fleet.prefill_skips == 2


# ---------------------------------------------------------------------------
# the consensus stop and the mid-flight cancellation

def _consensus_fleet(n_groups=3, group_size=3, t=10, *, lam_sample=2.0,
                     consensus=None, paged=True, chunk_tokens=None,
                     prompt_len=1, n_slots=4, burn_in=2, extra_solo=0,
                     **kw):
    """JAX's ``_consensus_fleet``, served by both packages."""
    n = n_groups * group_size
    answers = np.repeat(np.arange(n_groups), group_size)
    if extra_solo:
        answers = np.concatenate([answers, np.zeros(extra_solo, np.int64)])
    fl = Replay(_bank(n + extra_solo, t, seed=6), answers=answers,
                prompt_len=prompt_len, bias=1.5)
    cfg = dict(tokens_per_step=1, max_new_tokens=t, lam=lam_sample,
               burn_in=burn_in)

    def reqs(mk):
        out = _replay_reqs(mk, n, [t] * n, group_size=group_size,
                           prompt_len=prompt_len)
        out += [mk(np.full((prompt_len,), n + i, np.int64),
                   max_new_tokens=t) for i in range(extra_solo)]
        return out
    return fl.run(cfg, reqs, consensus=consensus, n_slots=n_slots,
                  paged=paged, block_size=4, chunk_tokens=chunk_tokens, **kw)


def test_consensus_cancels_siblings_and_frees_pages():
    """JAX ``:354``, every FleetMetrics group field equal to JAX's."""
    sched, done, fleet = _consensus_fleet(consensus=0.8)
    for g in sched.groups:
        assert g.decided and g.consensus_answer == g.group_id
        assert g.consensus_index == 2
        assert g.consensus_agreement == pytest.approx(1.0)
        for r in g.requests:
            assert r.state is RequestState.CANCELLED and r.done
            assert r.stop_step == -1
            assert r.completed_step == g.consensus_step
            assert len(r.scores) == 3
    assert fleet.samples_cancelled == 9 and fleet.consensus_groups == 3
    assert fleet.consensus_steps == pytest.approx(2.0)
    assert fleet.cancel_freed_blocks > 0
    assert fleet.group_savings == pytest.approx(3 * (3 * 10 - 9))
    assert fleet.group_savings_mean == pytest.approx(1.0 - 3 / 10)
    row = fleet.row()
    for f in ("samples_cancelled", "consensus_groups", "consensus_steps",
              "group_savings", "group_savings_mean", "cancel_freed_blocks"):
        assert row[f] == getattr(fleet, f)


def test_consensus_off_groups_run_to_their_own_stops():
    """JAX ``:380``."""
    _, done, fleet = _consensus_fleet(consensus=None)
    assert fleet.samples_cancelled == 0 and fleet.consensus_groups == 0
    assert all(r.state is RequestState.FINISHED for r in done)


def test_cancelled_samples_excluded_from_latency_tails():
    """JAX ``:388``."""
    _, done, fleet = _consensus_fleet(consensus=0.8, extra_solo=2)
    kept = [r for r in done if r.state is not RequestState.CANCELLED]
    assert len(kept) == 2
    ttft = np.array([r.ttft_s for r in kept if r.ttft_s >= 0]) * 1e3
    assert fleet.ttft_ms_p50 == pytest.approx(float(np.percentile(ttft, 50)))
    assert fleet.ttft_ms_p99 == pytest.approx(float(np.percentile(ttft, 99)))


def test_cancel_mid_prefill_leaves_pool_and_slot_clean():
    """JAX ``:398``: the consensus fires while the last sibling is still
    mid-prefill; cancelling it drops the parked row, its deferred donor
    plan and its pages before it decodes a token."""
    sched, done, fleet = _consensus_fleet(
        consensus=dict(min_votes=2, burn_in=0, lam=0.5), n_groups=1,
        prompt_len=24, chunk_tokens=4, burn_in=0, extra_solo=1)
    grp = sched.groups[0]
    assert grp.decided
    last = max(grp.requests, key=lambda r: r.sample_idx)
    assert last.state is RequestState.CANCELLED
    assert last.prefill_progress < last.prompt_len
    assert len(last.tokens) == 0
    assert fleet.cancel_freed_blocks > 0
    solo = done[-1]
    assert solo.group_id is None
    assert solo.state is RequestState.FINISHED and len(solo.tokens) == 10
    assert bool(sched.engine.st.stopped[last.slot])
    assert not sched._plans


def test_served_consensus_matches_offline_trace():
    """JAX ``:428``: the scheduler's per-step ``decide`` replays
    ``consensus_trace`` + ``consensus_stop_times``: same fire index, same
    answer, groups that never fire and samples frozen by budget too."""
    n_groups, gs, t = 4, 3, 12
    n = n_groups * gs
    answers = np.repeat(np.arange(n_groups), gs)
    answers[5] = 90
    answers[9:12] = [91, 92, 93]
    lengths = np.array([12, 9, 12, 12, 12, 7, 10, 12, 12, 12, 12, 12])
    fl = Replay(_bank(n, t, seed=12), answers=answers, bias=0.8)
    lam_g, burn = 0.6, 2
    cfg = dict(tokens_per_step=1, max_new_tokens=t, lam=2.0, burn_in=burn)
    _, base, _ = fl.run(cfg, lambda mk: _replay_reqs(mk, n, lengths),
                        n_slots=4, paged=True, block_size=4)
    sc = np.zeros((n, t))
    for i, r in enumerate(base):
        sc[i, :len(r.scores)] = r.scores
    an = np.repeat(answers[:, None], t, axis=1)
    sched, _, _ = fl.run(cfg, lambda mk: _replay_reqs(mk, n, lengths,
                                                      group_size=gs),
                         consensus=dict(min_votes=2, burn_in=burn,
                                        lam=lam_g),
                         n_slots=4, paged=True, block_size=4)
    fired = 0
    for g in sched.groups:
        rows = slice(g.group_id * gs, (g.group_id + 1) * gs)
        ans_t, agr_t = S.consensus_trace(sc[rows], an[rows], lengths[rows])
        tau = int(S.consensus_stop_times(agr_t, [lam_g], burn_in=burn)[0])
        if tau < int(lengths[rows].max()):
            assert g.decided and g.consensus_index == tau
            assert g.consensus_answer == int(ans_t[tau])
            fired += 1
        else:
            assert not g.decided
    assert 0 < fired < n_groups


def _fuzz_round(group_size, n_slots, policy, paged, consensus_on, seed):
    """JAX's ``_fuzz_round`` on both packages: every request terminal,
    cancelled ones only in decided groups, gangs atomic, no slot owned
    twice, every page home."""
    n, t = 12 - (12 % max(group_size, 1)), 10
    answers = (np.arange(n) // group_size if group_size else None)
    lengths = np.random.RandomState(seed).choice([6, 8, 10], size=n)
    fl = Replay(_bank(n, t, seed=seed), answers=answers, bias=1.2)
    consensus = 0.8 if (consensus_on and group_size >= 2) else None
    sched, done, fleet = fl.run(
        dict(tokens_per_step=1, max_new_tokens=t, lam=0.65, burn_in=1),
        lambda mk: _replay_reqs(mk, n, lengths,
                                group_size=group_size or None,
                                priority=lambda i: i % 2),
        consensus=consensus, n_slots=n_slots, paged=paged, block_size=4,
        policy=policy)
    assert all(r.done for r in done)
    for g in sched.groups:
        if g.n_cancelled:
            assert g.decided
        assert len({r.admitted_step for r in g.requests}) == 1

    def _resident_from(r):
        return r.restored_step if r.n_preempted else r.admitted_step
    for a, b in itertools.combinations(done, 2):
        if a.slot == b.slot:
            assert (a.completed_step <= _resident_from(b)
                    or b.completed_step <= _resident_from(a))
    if paged:
        assert fleet.peak_blocks_in_use <= sched.pool.num_usable
    return done


@pytest.mark.parametrize("policy", ["fifo", "priority", "ttft"])
@pytest.mark.parametrize("group_size,paged", [(1, True), (2, False),
                                              (3, True), (4, True)])
def test_cancellation_invariants_pinned(policy, group_size, paged):
    """JAX ``:528``."""
    _fuzz_round(group_size, max(4, group_size), policy, paged,
                consensus_on=True, seed=group_size)


# a few rounds of JAX's fuzz (``:538``), seeds pinned:
# (group_size, slot_pad, policy, paged, consensus_on, seed)
FUZZ_ROUNDS = [(1, 0, "fifo", True, True, 0), (2, 1, "priority", False,
                                                True, 3),
               (3, 2, "ttft", True, False, 5), (4, 0, "priority", True,
                                                True, 1)]


@pytest.mark.parametrize("round_", FUZZ_ROUNDS)
def test_cancellation_fuzz_rounds(round_):
    group_size, slot_pad, policy, paged, consensus_on, seed = round_
    slots = group_size + slot_pad + 1
    done = _fuzz_round(group_size, slots, policy, paged, consensus_on, seed)
    if group_size == 1 or not consensus_on:
        oracle = _fuzz_round(0, slots, policy, paged, consensus_on=False,
                             seed=seed)
        assert [r.stop_step for r in done] == [r.stop_step for r in oracle]


@pytest.mark.parametrize("paged", [False, True])
def test_swapped_sibling_is_cancelled_without_a_restore(paged):
    """A batch-class group under the priority policy: an interactive
    request arriving mid-flight spills the newest sibling to host RAM;
    the group's vote then fires on the two resident samples (the spilled
    one still votes its frozen score), and the SWAPPED sibling is
    cancelled off the swapped queue, its spill never restored.  Served by
    both packages through submit/step/drain."""
    t, gs = 12, 3
    answers = np.array([0, 0, 0, 7])
    fl = Replay(_bank(4, t, seed=8), answers=answers, bias=1.5)
    cfg = dict(tokens_per_step=1, max_new_tokens=t, lam=2.0, burn_in=4,
               n_slots=3, paged=paged, block_size=4, policy="priority")
    jsched, sched = fl.scheds(cfg, consensus=0.8)

    def serve(s, mk):
        group = _replay_reqs(mk, gs, [t] * gs, group_size=gs,
                             priority=lambda i: 1)
        urgent = mk(np.full((1,), gs, np.int64), max_new_tokens=t)
        s.prepare(group + [urgent])
        s.submit(group)
        for _ in range(2):
            s.step()
        s.submit([urgent])
        return s.drain()
    jdone, jfleet = serve(jsched, j_make_request)
    done, fleet = serve(sched, make_request)
    assert_same(jsched, jdone, jfleet, sched, done, fleet)
    victim = [r for r in done if r.n_preempted]
    assert len(victim) == 1 and victim[0].group_id == 0
    assert victim[0].state is RequestState.CANCELLED
    assert fleet.preemptions == 1 and fleet.restores == 0
    grp = sched.groups[0]
    assert grp.decided and grp.n_cancelled == gs
    assert done[-1].state is RequestState.FINISHED
    assert not sched._swapped


# ---------------------------------------------------------------------------
# grouped fleets of real (reduced) models, paged, chunked, consensus on

GROUP_FLEETS = [("smollm-360m", None), ("smollm-360m", 4),
                ("llama3.2-3b", 4)]


@pytest.mark.parametrize("arch,chunk_tokens", GROUP_FLEETS)
def test_grouped_model_fleet_matches_jax(arch, chunk_tokens):
    """Three prompts as groups of 3 (and one solo request) on the reduced
    model, paged, a consensus at 0.9 with no burn-in: every state, stop
    step, token, group outcome and group metric equal to JAX's.  Siblings
    sharing a prompt decode alike, so each group fires at its first vote,
    ahead of the per-sample burn-in, and cancels the siblings still
    running (with chunked prefill, those still mid-prefill too)."""
    (jmodel, jparams, jpc, jtheta), (model, params, pc, theta) = \
        _models(arch=arch)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)
               for n in (9, 13, 6, 11)]
    kw = dict(tokens_per_step=2, max_new_tokens=12, lam=0.6, burn_in=1,
              n_slots=4, paged=True, block_size=4, chunk_tokens=chunk_tokens,
              group_size=3)
    gc = dict(min_votes=2, burn_in=0, lam=0.9)
    jsched = JOrcaScheduler(jmodel, jparams, jpc, jtheta, JServeConfig(**kw),
                            consensus=JGroupCalibrator(**gc))
    sched = OrcaScheduler(model, params, pc, theta, ServeConfig(**kw),
                          consensus=GroupCalibrator(**gc))

    def reqs(mk, mk_group):
        out = [r for g, p in enumerate(prompts[:3])
               for r in mk_group(p, 3, group_id=g)]
        return out + [mk(prompts[3])]
    jdone, jfleet = jsched.run(reqs(j_make_request, j_make_group))
    done, fleet = sched.run(reqs(make_request, make_group))
    assert_same(jsched, jdone, jfleet, sched, done, fleet)
    assert fleet.consensus_groups == 3 and fleet.samples_cancelled > 0
    if chunk_tokens:
        assert fleet.prefill_chunks > 0
    else:
        assert fleet.prefill_skips == 6


def test_make_group_fleet_matches_jax_and_serves_through_the_facade():
    """``make_group_fleet`` forms JAX's groups, truths and answer hashes,
    and its replay fleet served through ``api.engine`` with a static probe
    (``group_size=3, consensus=0.8``) equals JAX's."""
    kw = dict(d_phi=D, t_min=8, t_max=12)
    ts = tsyn.generate(tsyn.TrajectoryDistribution("facade", **kw), 30,
                       seed=2)
    jts = jsyn.generate(jsyn.TrajectoryDistribution("facade", **kw), 30,
                        seed=2)
    fleet_ts = make_group_fleet(ts.subset(np.arange(15, 30)), 3, seed=0,
                                device="cpu")
    jfleet_ts = j_make_group_fleet(jts.subset(np.arange(15, 30)), 3, seed=0)
    for f in ("members", "truth", "answer_hash"):
        np.testing.assert_array_equal(getattr(fleet_ts, f),
                                      getattr(jfleet_ts, f))
    from repro import api as japi
    fit = dict(mode="consistent", method="static", n_components=8,
               smooth_window=2, epochs=40)
    calib = api.fit(ts.subset(np.arange(15)), device="cpu", **fit)
    jcalib = japi.fit(jts.subset(np.arange(15)), **fit)
    cfg = dict(n_slots=4, lam=2.0, tokens_per_step=1, max_new_tokens=12,
               group_size=3, consensus=0.8)
    sched = api.engine(fleet_ts.model, fleet_ts.params, calib,
                       ServeConfig(**cfg))
    jsched = japi.engine(jfleet_ts.model, jfleet_ts.params, jcalib,
                         config=JServeConfig(**cfg))
    assert sched.group_size == jsched.group_size == 3
    done, fleet = sched.run(fleet_ts.requests)
    jdone, jfleet = jsched.run(jfleet_ts.requests)
    assert [r.state.value for r in done] == [r.state.value for r in jdone]
    assert [r.stop_step for r in done] == [r.stop_step for r in jdone]
    assert fleet.consensus_groups == jfleet.consensus_groups
    assert fleet.samples_cancelled == jfleet.samples_cancelled
    assert [g.consensus_index for g in sched.groups] \
        == [g.consensus_index for g in jsched.groups]
