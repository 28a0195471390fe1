"""The port's fleet (``FleetRouter``, the placement policies,
``serve_replay``, ``api.fleet``/``serve_requests``, the driver's
``--hosts``/``--placement``) held to the JAX package's: the cases of
``tests/test_fleet_router.py``, each served by both packages on one replay
bank (or on the reduced smollm-360m with the decisive ``_probe(cfg, 3.0)``
probe) — stops and tokens equal across host counts, placements and the
policy x pack x paged x chunk matrix, each host's requests and the fleet's
counters equal to JAX's router, parallel stepping equal to serial, prefix
affinity against round-robin, gangs never split, the pressure-balanced
burst, the pressure snapshot, ``ServeConfig``'s fleet fields, the
``engine`` shim, ``serve_requests`` over both servers and the ownership
sweep as fixed seeds; the router cases of ``tests/test_tree_spec.py``
(replay tree fleets, the shared draft cache, the spec aggregation); and
the thread safety of what the hosts share (the kernels' launch counters,
the library's first load).  The JAX side runs ``probe_impl="ref"`` where
its Pallas spec probe would be reached."""
import argparse
import dataclasses
import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core.probe import ProbeConfig as JProbeConfig
from repro.core.probe import init_outer as j_init_outer
from repro.serving import DraftCache as JDraftCache
from repro.serving import FleetRouter as JFleetRouter
from repro.serving import OrcaScheduler as JOrcaScheduler
from repro.serving import ServeConfig as JServeConfig
from repro.serving import make_request as j_make_request
from repro.serving import replay_model as j_replay_model
from repro.serving import replay_params as j_replay_params
from repro.serving import replay_requests as j_replay_requests
from repro.serving import serve_replay as j_serve_replay

from repro_torch import api
from repro_torch.core.probe import ProbeConfig
from repro_torch.kernels import _build
from repro_torch.launch import serve as tserve
from repro_torch.models.convert import from_jax_theta
from repro_torch.serving import (DraftCache, FleetRouter, OrcaScheduler,
                                 RoundRobinPlacement, ServeConfig,
                                 make_placement, make_request, replay_model,
                                 replay_params, replay_requests,
                                 serve_replay, spec_stats)
from tests.test_torch_serve import GROUP_DRIVER, _line, _models

N_TRAJ, T_STEPS, D_PHI = 10, 20, 6
# f32 probe scores of the two packages agree to a few ulps
ATOL = 1e-5
# the bank's scores after the burn-in stay 1.6e-3 or more from 0.48, and
# half the requests cross it (JAX's 0.62 stops none of this bank)
LAM = 0.48


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def replay_bank():
    """JAX's ``replay_bank``: 10 trajectories of 20 steps at d 6."""
    rs = np.random.RandomState(7)
    drift = np.linspace(0, 1.2, T_STEPS)[None, :, None]
    bank = (rs.randn(N_TRAJ, T_STEPS, D_PHI) * 0.3
            + drift * rs.rand(N_TRAJ, 1, D_PHI)).astype(np.float32)
    theta = {"W0": (rs.randn(D_PHI) * 0.4).astype(np.float32),
             "b0": np.float32(-0.2)}
    return bank, theta


def _stops(requests):
    return [(r.stop_step, r.state.name, tuple(r.tokens)) for r in requests]


REQ_FIELDS = ("stop_step", "tokens", "steps_run", "host", "admitted_step",
              "completed_step", "first_token_step", "prefill_skipped",
              "n_preempted", "restored_step")
FLEET_FIELDS = ("n_hosts", "routed_affine", "engine_steps",
                "active_slot_steps", "slot_utilization", "prefill_skips",
                "pool_blocks", "peak_blocks_in_use", "prefill_chunks",
                "packed_chunks", "peak_step_tokens", "preemptions",
                "restores", "spilled_blocks", "mean_step_savings",
                "mean_queue_steps", "spec_tokens_proposed",
                "spec_tokens_accepted", "tree_nodes_proposed",
                "draft_cache_hits", "draft_cache_misses")


def assert_same(jdone, jfm, done, fm):
    """Every request's lifecycle, tokens and host, and the fleet's
    counters, equal JAX's; scores to f32 rounding."""
    assert len(done) == len(jdone)
    for r, jr in zip(done, jdone):
        assert r.state.value == jr.state.value, r.req_id
        for f in REQ_FIELDS:
            assert getattr(r, f) == getattr(jr, f), (f, r.req_id)
        np.testing.assert_allclose(r.scores, jr.scores, rtol=0, atol=ATOL)
    for f in FLEET_FIELDS:
        assert getattr(fm, f) == pytest.approx(getattr(jfm, f), abs=1e-9), f


def _pools_drained(server):
    for h in getattr(server, "hosts", [server]):
        if h.pool is not None:
            h.pool.check()
            assert h.pool.blocks_in_use == 0
            assert h.pool.num_free == h.pool.num_usable


# ---------------------------------------------------------------------------
# the fleet invariant: stops equal single-host serving's, and JAX's router

MATRIX = [("fifo", False, False, None), ("fifo", True, True, 2),
          ("priority", True, False, 2), ("priority", False, True, None),
          ("edf", True, True, 2), ("ttft", False, True, 2)]


@pytest.mark.parametrize("n_hosts", [2, 3])
@pytest.mark.parametrize("policy,pack,paged,chunk", MATRIX)
def test_stops_equal_across_host_counts_and_jax(replay_bank, policy, pack,
                                                paged, chunk, n_hosts):
    """JAX ``:59``: each case served by one port scheduler and by both
    packages' routers: the router's requests (host placement included) and
    counters equal JAX's router's, and its stops and tokens equal the
    single scheduler's."""
    bank, theta = replay_bank
    kw = dict(lam=LAM, burn_in=3, n_slots=3, policy=policy,
              pack_chunks=pack, paged=paged, block_size=4,
              chunk_tokens=chunk)
    prios = [i % 2 for i in range(N_TRAJ)]
    base, _, _ = serve_replay(bank, theta, n_hosts=1, priorities=prios,
                              device="cpu", **kw)
    assert {r.state.name for r in base} == {"STOPPED", "FINISHED"}
    jdone, jfm, _ = j_serve_replay(bank, theta, n_hosts=n_hosts,
                                   priorities=prios, parallel_hosts=False,
                                   **kw)
    done, fm, router = serve_replay(bank, theta, n_hosts=n_hosts,
                                    priorities=prios, parallel_hosts=False,
                                    device="cpu", **kw)
    assert_same(jdone, jfm, done, fm)
    assert _stops(done) == _stops(base)
    assert fm.n_hosts == n_hosts and len(router.hosts) == n_hosts
    assert {r.host for r in done} <= set(range(n_hosts))
    _pools_drained(router)


@pytest.mark.parametrize("n_hosts,paged,chunk", [(2, True, None),
                                                 (3, True, 2),
                                                 (3, False, None)])
def test_parallel_stepping_matches_serial(replay_bank, n_hosts, paged,
                                          chunk):
    """JAX ``:89``: the thread pool changes wall time only: every request's
    lifecycle, scores and host, and every counter, equal the serial
    fleet's bit for bit."""
    bank, theta = replay_bank
    kw = dict(lam=LAM, burn_in=3, n_slots=3, paged=paged, block_size=4,
              chunk_tokens=chunk, device="cpu")
    a, afm, _ = serve_replay(bank, theta, n_hosts=n_hosts,
                             parallel_hosts=False, **kw)
    b, bfm, router = serve_replay(bank, theta, n_hosts=n_hosts,
                                  parallel_hosts=True, **kw)
    assert router._pool is not None
    for ra, rb in zip(a, b):
        assert ra.scores == rb.scores
        for f in REQ_FIELDS:
            assert getattr(ra, f) == getattr(rb, f), f
    for f in FLEET_FIELDS:
        assert getattr(afm, f) == getattr(bfm, f), f
    assert len(router.step_ms) == bfm.engine_steps
    assert sum(m.engine_steps for m in router.host_metrics) \
        >= bfm.engine_steps
    router.close()


# ---------------------------------------------------------------------------
# placement on the reduced smollm-360m

@pytest.fixture(scope="module")
def models():
    return _models()


AFFINITY = dict(tokens_per_step=2, max_new_tokens=12, lam=0.6, burn_in=1,
                n_slots=4, paged=True, block_size=4)


@pytest.mark.parametrize("parallel", [False, True])
def test_prefix_affinity_routes_to_donor_host(models, parallel):
    """JAX ``:106``: four requests of one prompt on two hosts.  Pressure
    placement sends all to the donor's host (one cold prefill, three
    skips, three affine placements); round-robin spreads them (a cold
    prefill a host).  Stops equal both ways, and each fleet equals JAX's
    router's."""
    (jmodel, jparams, jpc, jtheta), (model, params, pc, theta) = models
    prompt = np.random.default_rng(3).integers(
        0, model.cfg.vocab_size, 8).astype(np.int32)

    def run(placement):
        jr = JFleetRouter(jmodel, jparams, jpc, jtheta,
                          JServeConfig(**AFFINITY), n_hosts=2,
                          placement=placement, parallel_hosts=False)
        jdone, jfm = jr.run([j_make_request(prompt) for _ in range(4)])
        router = FleetRouter(model, params, pc, theta,
                             ServeConfig(**AFFINITY), n_hosts=2,
                             placement=placement, parallel_hosts=parallel)
        done, fm = router.run([make_request(prompt) for _ in range(4)])
        assert_same(jdone, jfm, done, fm)
        _pools_drained(router)
        return done, fm

    done, fm = run("pressure")
    assert fm.prefill_skips == 3 and fm.routed_affine == 3
    assert len({r.host for r in done}) == 1
    rr_done, rr_fm = run("roundrobin")
    assert rr_fm.routed_affine < fm.routed_affine
    assert len({r.host for r in rr_done}) == 2
    assert rr_fm.prefill_skips == 2
    assert _stops(rr_done) == _stops(done)
    assert {r.state.name for r in done} == {"STOPPED"}


def _replay_router(pkg, bank, theta, cfg_kw, **kw):
    """A replay-model router of either package on one bank."""
    if pkg == "jax":
        return JFleetRouter(j_replay_model(bank), j_replay_params(bank),
                            JProbeConfig(d_phi=D_PHI, smooth_window=4),
                            theta, JServeConfig(**cfg_kw), **kw)
    return FleetRouter(replay_model(bank), replay_params(bank, device="cpu"),
                       ProbeConfig(d_phi=D_PHI, smooth_window=4),
                       {k: torch.as_tensor(v) for k, v in theta.items()},
                       ServeConfig(**cfg_kw), **kw)


def _groups_of(reqs, size):
    for i, r in enumerate(reqs):
        r.group_id, r.sample_idx = i // size, i % size
    return reqs


GANG = dict(tokens_per_step=1, max_new_tokens=T_STEPS, lam=LAM, burn_in=3,
            n_slots=4, paged=True, block_size=4)


def test_gang_never_split_across_hosts(replay_bank):
    """JAX ``:134``: every sample of a group lands on one host, as in JAX's
    router; a gang larger than a host raises JAX's message."""
    bank, theta = replay_bank
    out = {}
    for pkg, mk in (("jax", j_replay_requests), ("torch", replay_requests)):
        router = _replay_router(pkg, bank, theta, GANG, n_hosts=2,
                                parallel_hosts=False)
        out[pkg] = router.run(_groups_of(mk([T_STEPS] * 8), 4))
    (jdone, jfm), (done, fm) = out["jax"], out["torch"]
    assert_same(jdone, jfm, done, fm)
    for gid in (0, 1):
        assert len({r.host for r in done if r.group_id == gid}) == 1
    msgs = []
    for pkg, mk in (("jax", j_replay_requests), ("torch", replay_requests)):
        router = _replay_router(pkg, bank, theta, GANG, n_hosts=2,
                                parallel_hosts=False)
        big = mk([T_STEPS] * 5)
        for i, r in enumerate(big):
            r.group_id, r.sample_idx = 0, i
        with pytest.raises(ValueError, match="never split across hosts") \
                as err:
            router.submit(big)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_pressure_balanced_placement_under_burst(replay_bank):
    """JAX ``:164``: a burst spreads [5, 5] over two hosts, as in JAX."""
    bank, theta = replay_bank
    kw = dict(n_hosts=2, parallel_hosts=False, lam=0.62, burn_in=3,
              n_slots=3)
    jdone, jfm, _ = j_serve_replay(bank, theta, **kw)
    done, fm, _ = serve_replay(bank, theta, device="cpu", **kw)
    assert_same(jdone, jfm, done, fm)
    counts = [sum(1 for r in done if r.host == h) for h in (0, 1)]
    assert sorted(counts) == [5, 5], counts
    assert fm.n_hosts == 2


def test_pressure_snapshot_fields(replay_bank):
    """JAX ``:177``: the snapshots before any submit and after a step
    equal JAX's field for field."""
    bank, theta = replay_bank
    cfg_kw = dict(tokens_per_step=1, max_new_tokens=T_STEPS, lam=0.62,
                  burn_in=3, n_slots=3, paged=True, block_size=4)
    snaps = {}
    for pkg, mk in (("jax", j_replay_requests), ("torch", replay_requests)):
        router = _replay_router(pkg, bank, theta, cfg_kw, n_hosts=2,
                                parallel_hosts=False)
        before = [dataclasses.asdict(p) for p in router.pressures()]
        router.submit(mk([T_STEPS] * 8))
        router.step()
        after = [dataclasses.asdict(p) for p in router.pressures()]
        while router.step():
            pass
        done, _ = router.drain()
        assert all(r.done for r in done)
        snaps[pkg] = (before, after)
    assert snaps["torch"] == snaps["jax"]
    before, after = snaps["torch"]
    assert all(p["free_slots"] == p["n_slots"] == 3 for p in before)
    assert [p["host"] for p in after] == [0, 1]
    assert sum(p["n_running"] + p["n_prefilling"] for p in after) > 0
    assert all(p["pool_blocks"] > 0 for p in after)


def test_placement_policies_match_jax():
    """``select_host`` of both placements on one pressure list, with and
    without affinity and when nothing fits, equals JAX's."""
    from repro.serving import HostPressure as JHostPressure
    from repro.serving import make_placement as j_make_placement

    from repro_torch.serving import HostPressure
    rows = [dict(host=h, n_slots=4, n_running=r, n_prefilling=0,
                 n_swapped=0, n_waiting=0, queued_samples=q, free_slots=4 - r,
                 pool_blocks=20, free_blocks=20 - u, blocks_in_use=u)
            for h, r, q, u in ((0, 2, 1, 6), (1, 1, 1, 9), (2, 1, 1, 4))]
    for name in ("pressure", "roundrobin"):
        pol, jpol = make_placement(name), j_make_placement(name)
        got, want = [], []
        for slots, pages, affine in ((1, 0, None), (2, 5, 0), (4, 21, None),
                                     (5, 0, None), (1, 3, 1), (3, 20, 2)):
            got.append(pol.select_host(
                [], [HostPressure(**r) for r in rows], need_slots=slots,
                need_pages=pages, affine_host=affine))
            want.append(jpol.select_host(
                [], [JHostPressure(**r) for r in rows], need_slots=slots,
                need_pages=pages, affine_host=affine))
        assert got == want, name
    assert type(make_placement(None)).__name__ \
        == type(j_make_placement(None)).__name__ == "PressurePlacement"
    rr = RoundRobinPlacement()
    assert make_placement(rr) is rr


# ---------------------------------------------------------------------------
# ServeConfig: the fleet fields

@pytest.mark.parametrize("kwargs", [dict(tokens_per_step=0),
                                    dict(max_new_tokens=0),
                                    dict(block_size=0), dict(pack_max=0),
                                    dict(n_hosts=0)])
def test_serveconfig_validation_matches_jax(kwargs):
    """JAX ``:206``: each invalid configuration fails at construction with
    JAX's message (the group cases are in ``test_torch_groups.py``)."""
    with pytest.raises(ValueError) as got:
        ServeConfig(**kwargs)
    with pytest.raises(ValueError) as want:
        JServeConfig(**kwargs)
    assert str(got.value) == str(want.value)
    assert list(kwargs)[0] in str(got.value)


def test_serveconfig_is_frozen_and_normalizes():
    """JAX ``:228``."""
    cfg = ServeConfig(num_blocks=0, chunk_tokens=0, cache_len=0,
                      token_budget=0, n_hosts=3, placement="roundrobin")
    assert cfg.num_blocks is None and cfg.chunk_tokens is None
    assert cfg.cache_len is None and cfg.token_budget is None
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.n_hosts = 8
    with pytest.raises(ValueError, match="gang admission"):
        dataclasses.replace(cfg, group_size=99)
    with pytest.raises(ValueError, match="n_hosts"):
        dataclasses.replace(cfg, n_hosts=0)


def test_serveconfig_from_args_maps_cli_flags():
    """JAX ``:241``: one namespace, the driver's flag names (``hosts`` ->
    ``n_hosts`` among them), gives JAX's fields; partial namespaces work
    and overrides win."""
    ns = argparse.Namespace(slots=6, paged=True, block_size=8,
                            num_blocks=0, chunk_tokens=4, token_budget=0,
                            policy="priority", no_pack=True, pack_max=2,
                            group_size=2, no_preempt=True, hosts=3,
                            tokens_per_step=2, max_new_tokens=32,
                            burn_in=1)
    skip = {"probe_impl", "interpret"}     # the JAX config's alone
    for over in (dict(lam=0.7), dict(n_slots=9, lam=0.5,
                                     placement="roundrobin")):
        cfg = dataclasses.asdict(ServeConfig.from_args(ns, **over))
        jcfg = {k: v for k, v in dataclasses.asdict(
            JServeConfig.from_args(ns, **over)).items() if k not in skip}
        assert cfg == jcfg
    cfg = ServeConfig.from_args(ns, lam=0.7)
    assert cfg.n_hosts == 3 and cfg.n_slots == 6 and not cfg.preemption
    partial = ServeConfig.from_args(argparse.Namespace(slots=2))
    assert partial.n_slots == 2 and partial.n_hosts == 1


# ---------------------------------------------------------------------------
# the api facade: the engine shim, fleet, serve_requests

class _StubCalibrator:
    """The Calibrator surface engine()/fleet() read."""

    def __init__(self, pc, theta, lam=LAM):
        self._pc, self._theta, self._lam = pc, theta, lam

    def serving_params(self):
        return self._pc, self._theta

    def threshold(self):
        return self._lam


@pytest.fixture(scope="module")
def replay_calibrators(replay_bank):
    bank, theta = replay_bank
    return ((j_replay_model(bank), j_replay_params(bank),
             _StubCalibrator(JProbeConfig(d_phi=D_PHI, smooth_window=4),
                             theta)),
            (replay_model(bank), replay_params(bank, device="cpu"),
             _StubCalibrator(ProbeConfig(d_phi=D_PHI, smooth_window=4),
                             {k: torch.as_tensor(v)
                              for k, v in theta.items()})))


def test_engine_legacy_kwargs_shim_matches_config(replay_calibrators):
    """JAX ``:286``: the keyword form warns and serves as the config form
    does; the threshold comes from the calibrator either way."""
    _, (model, params, cal) = replay_calibrators
    kw = dict(tokens_per_step=1, max_new_tokens=T_STEPS, burn_in=3,
              n_slots=3, paged=True, block_size=4)
    with pytest.warns(DeprecationWarning, match="ServeConfig"):
        legacy = api.engine(model, params, cal, **kw)
    assert legacy.cfg.lam == LAM
    blessed = api.engine(model, params, cal,
                         config=ServeConfig(lam=LAM, **kw))
    l_done, _ = legacy.run(replay_requests([T_STEPS] * N_TRAJ))
    b_done, _ = blessed.run(replay_requests([T_STEPS] * N_TRAJ))
    assert _stops(l_done) == _stops(b_done)
    assert any(r.stop_step >= 0 for r in l_done)


def _message(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_engine_config_rejects_kwarg_mix(replay_calibrators):
    """JAX ``:301``: config= with keywords is ambiguous, serve= warns and
    is refused beside config= or keywords, with JAX's messages."""
    (jm, jp, jcal), (model, params, cal) = replay_calibrators
    cfg, jcfg = (ServeConfig(lam=LAM, tokens_per_step=1),
                 JServeConfig(lam=LAM, tokens_per_step=1))
    own = object()              # stands for each package's own config
    for kw in (dict(config=own, n_slots=3), dict(serve=own, config=own),
               dict(serve=own, lam=0.5), dict(serve=own, n_slots=2)):
        def call(engine, m, p, c, conf, kw=kw):
            return lambda: engine(m, p, c, **{k: conf if v is own else v
                                              for k, v in kw.items()})
        got = _message(call(api.engine, model, params, cal, cfg))
        assert got == _message(call(japi.engine, jm, jp, jcal, jcfg))
        assert ("not both" if "serve" in kw else "ambiguous") in got
    with pytest.warns(DeprecationWarning, match="serve="):
        sched = api.engine(model, params, cal, serve=cfg)
    assert sched.cfg is cfg


@pytest.mark.parametrize("group_size", [None, 2])
def test_serve_requests_duck_typed_over_scheduler_and_router(
        replay_calibrators, group_size):
    """JAX ``:311``: one entry point drives both servers of both packages
    on the same prompt rows: stops equal across the four, the router's
    equal to JAX's router's."""
    (jm, jp, jcal), (model, params, cal) = replay_calibrators
    kw = dict(lam=LAM, tokens_per_step=1, max_new_tokens=T_STEPS, burn_in=3,
              n_slots=3)
    prompts = np.arange(N_TRAJ, dtype=np.int64)[:, None]
    sched = api.engine(model, params, cal, config=ServeConfig(**kw))
    router = api.fleet(model, params, cal, config=ServeConfig(**kw),
                       n_hosts=2, parallel_hosts=False)
    jrouter = japi.fleet(jm, jp, jcal, config=JServeConfig(**kw), n_hosts=2,
                         parallel_hosts=False)
    s_done, s_fm = api.serve_requests(sched, prompts, group_size)
    r_done, r_fm = api.serve_requests(router, prompts, group_size)
    j_done, j_fm = japi.serve_requests(jrouter, prompts, group_size)
    assert _stops(s_done) == _stops(r_done)
    assert_same(j_done, j_fm, r_done, r_fm)
    assert s_fm.n_hosts == 1 and r_fm.n_hosts == 2
    assert len(r_done) == N_TRAJ * (group_size or 1)
    if group_size:
        for gid in range(N_TRAJ):
            assert len({r.host for r in r_done if r.group_id == gid}) == 1


def test_fleet_facade_overrides_the_config(replay_calibrators):
    """``api.fleet``'s ``n_hosts``/``lam``/``placement`` override the
    config, and without a config the calibrator's threshold serves."""
    _, (model, params, cal) = replay_calibrators
    cfg = ServeConfig(lam=0.3, n_hosts=3, placement="pressure", n_slots=2)
    router = api.fleet(model, params, cal, config=cfg, n_hosts=2, lam=0.7,
                       placement="roundrobin")
    assert router.n_hosts == 2 and len(router.hosts) == 2
    assert router.cfg.lam == 0.7 and router.hosts[1].cfg.lam == 0.7
    assert isinstance(router.placement, RoundRobinPlacement)
    assert api.fleet(model, params, cal).cfg.lam == LAM
    router.close()


# ---------------------------------------------------------------------------
# the ownership sweep: fixed seeds for JAX's hypothesis sweep

@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("policy", ["fifo", "priority"])
@pytest.mark.parametrize("n_hosts", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 271, 6043, 9999])
def test_no_cross_host_ownership(seed, n_hosts, policy, paged):
    """JAX ``:344``: random fleets terminate on exactly one host each, no
    host's pool references another's pages (each pool checks and drains
    to zero), and the stops equal one scheduler's."""
    rs = np.random.RandomState(seed)
    bank = (rs.randn(6, 12, 4) * 0.4
            + np.linspace(0, 1, 12)[None, :, None]).astype(np.float32)
    theta = {"W0": (rs.randn(4) * 0.4).astype(np.float32),
             "b0": np.float32(-0.1)}
    prios = rs.randint(0, 3, size=6).tolist()
    kw = dict(priorities=prios, lam=0.6, burn_in=2, n_slots=2, paged=paged,
              block_size=4, policy=policy, device="cpu")
    done, fm, server = serve_replay(bank, theta, n_hosts=n_hosts,
                                    parallel_hosts=False, **kw)
    assert all(r.done for r in done)
    _pools_drained(server)
    if n_hosts > 1:
        assert {r.host for r in done} <= set(range(n_hosts))
        assert make_placement(None).select_host(
            [done[0]], server.pressures(), need_slots=1,
            need_pages=0) in range(n_hosts)
        base, _, _ = serve_replay(bank, theta, n_hosts=1, **kw)
        assert _stops(done) == _stops(base)
    else:
        assert {r.host for r in done} == {-1}


# ---------------------------------------------------------------------------
# tree decode and the shared draft cache through the router
# (tests/test_tree_spec.py:303, :324, :485, :507, :526, :546)

def _tree_setup(seed=0, n=10, t=16, d=16, prompt_len=4, wrong=0.4):
    """JAX's ``_tree_setup`` for both packages: a replay bank with a
    drafter that is wrong at ``wrong``, its probe (b0 0.4), one config."""
    rs = np.random.RandomState(seed)
    bank = (rs.randn(n, t, d) * 0.6).astype(np.float32)
    jpc = JProbeConfig(d_phi=d, smooth_window=2)
    jtheta = j_init_outer(jpc, jax.random.PRNGKey(2))
    jtheta["b0"] = jnp.asarray(0.4)
    cfg = dict(tokens_per_step=1, max_new_tokens=t, lam=0.62, burn_in=2)
    kw = dict(prompt_len=prompt_len, draft_wrong_rate=wrong)
    return types.SimpleNamespace(
        bank=bank, cfg=cfg,
        jax=(j_replay_model(bank, **kw), j_replay_params(bank), jpc, jtheta),
        torch=(replay_model(bank, **kw), replay_params(bank, device="cpu"),
               ProbeConfig(d_phi=d, smooth_window=2),
               from_jax_theta({k: np.asarray(v) for k, v in jtheta.items()},
                              device="cpu")))


def _tree_reqs(mk, bank, ids, prompt_len=4):
    return [mk(np.full((prompt_len,), i, np.int64),
               max_new_tokens=int(bank.shape[1])) for i in ids]


def _serve(ts, pkg, ids, *, router=False, cache=None, **kw):
    """One fleet of ``ts`` through ``pkg``'s scheduler (or a 2-host
    router); the JAX side with the jnp spec probe."""
    if pkg == "jax":
        cfg = JServeConfig(probe_impl="ref", **ts.cfg)
        mk, sched_cls, router_cls = (j_make_request, JOrcaScheduler,
                                     JFleetRouter)
    else:
        cfg = ServeConfig(**ts.cfg)
        mk, sched_cls, router_cls = make_request, OrcaScheduler, FleetRouter
    if router:
        server = router_cls(*getattr(ts, pkg), dataclasses.replace(cfg, **kw),
                            n_hosts=2, parallel_hosts=False)
    else:
        server = sched_cls(*getattr(ts, pkg), cfg, draft_cache=cache, **kw)
    done, fm = server.run(_tree_reqs(mk, ts.bank, ids))
    return done, fm, server


def _identical(a, b):
    for f in ("stop_step", "steps_run", "tokens", "scores"):
        assert [getattr(r, f) for r in a] == [getattr(r, f) for r in b], f


@pytest.mark.parametrize("tree", ["1.3", "2.2", "3.2", "2.3"])
def test_replay_tree_matches_one_token_and_jax(tree):
    """``:303`` (and ``:324`` at 1.3): a partial-acceptance tree fleet's
    stops, tokens and scores equal one-token decode's exactly, in fewer
    engine steps, with its tree counters, and equal JAX's tree fleet;
    ``1.3`` serves as ``spec_tokens=4`` step for step."""
    ts = _tree_setup()
    ids = range(ts.bank.shape[0])
    one, one_fm, _ = _serve(ts, "torch", ids, n_slots=3)
    done, fm, _ = _serve(ts, "torch", ids, n_slots=3, spec_tree=tree)
    jdone, jfm, _ = _serve(ts, "jax", ids, n_slots=3, spec_tree=tree)
    _identical(one, done)
    assert_same(jdone, jfm, done, fm)
    assert fm.engine_steps < one_fm.engine_steps
    assert fm.tree_nodes_proposed == sum(r.tree_nodes for r in done) > 0
    assert fm.tree_path_accepted_p99 >= fm.tree_path_accepted_p50
    assert 0 < fm.acceptance_rate <= 1.0
    if tree == "1.3":
        lin, lin_fm, _ = _serve(ts, "torch", ids, n_slots=3, spec_tokens=4)
        _identical(lin, done)
        assert (lin_fm.engine_steps, lin_fm.spec_tokens_proposed,
                lin_fm.spec_tokens_accepted) == (
            fm.engine_steps, fm.spec_tokens_proposed,
            fm.spec_tokens_accepted)


def test_draft_cache_feeds_fleet_and_keeps_stops_identical():
    """``:485``: an injected cache fronting the replay drafter on repeated
    traffic: stops equal one-token decode's, its hits and misses surface in
    the fleet metrics, each equal to JAX's fleet with its own cache."""
    ts = _tree_setup(wrong=0.6)
    ids = list(range(ts.bank.shape[0])) * 2
    one, _, _ = _serve(ts, "torch", ids, n_slots=3)
    dc, jdc = DraftCache(capacity=256, ngram=3), JDraftCache(capacity=256,
                                                            ngram=3)
    done, fm, sched = _serve(ts, "torch", ids, n_slots=3, spec_tree="2.2",
                             cache=dc)
    jdone, jfm, _ = _serve(ts, "jax", ids, n_slots=3, spec_tree="2.2",
                           cache=jdc)
    assert sched.draft_cache is dc
    _identical(one, done)
    assert_same(jdone, jfm, done, fm)
    assert (dc.hits, dc.misses) == (jdc.hits, jdc.misses)
    assert fm.draft_cache_hits == dc.hits > 0
    assert fm.draft_cache_misses == dc.misses
    assert fm.draft_cache_hit_rate == pytest.approx(dc.hit_rate)


def test_scheduler_and_router_share_spec_aggregation():
    """``:526``: the scheduler's and the router's spec fields are
    ``spec_stats`` of their own requests, the router's equal to JAX's
    router's, and their stops equal."""
    ts = _tree_setup(wrong=0.4)
    ids = range(ts.bank.shape[0])
    fields = tuple(spec_stats([]))
    done_s, fm_s, _ = _serve(ts, "torch", ids, n_slots=3, spec_tree="2.2")
    assert {k: getattr(fm_s, k) for k in fields} == spec_stats(done_s)
    done_r, fm_r, _ = _serve(ts, "torch", ids, router=True, n_slots=3,
                             spec_tree="2.2")
    jdone, jfm, _ = _serve(ts, "jax", ids, router=True, n_slots=3,
                           spec_tree="2.2")
    assert {k: getattr(fm_r, k) for k in fields} == spec_stats(done_r)
    assert_same(jdone, jfm, done_r, fm_r)
    assert fm_r.spec_tokens_accepted + fm_r.spec_tokens_proposed > 0
    assert _stops(done_r) == _stops(done_s)


def test_router_shares_one_draft_cache_across_hosts(models):
    """``:507`` and ``:546``: no cache without speculation, none for the
    replay model (no self-draft), and for a self-draft family exactly one,
    every host holding the same object."""
    ts = _tree_setup()
    model, params, pc, theta = ts.torch
    cfg = ServeConfig(**ts.cfg)
    assert OrcaScheduler(model, params, pc, theta, cfg,
                         n_slots=2).draft_cache is None
    router = FleetRouter(model, params, pc, theta,
                         dataclasses.replace(cfg, spec_tree="2.2"),
                         n_hosts=2, parallel_hosts=False)
    assert router.draft_cache is None
    _, (dense, _, pc2, theta2) = models
    assert dense.self_draft
    router2 = FleetRouter(dense, None, pc2, theta2, ServeConfig(
        tokens_per_step=2, max_new_tokens=6, lam=0.6, burn_in=1,
        spec_tree="2.2", n_slots=2), n_hosts=2, parallel_hosts=False)
    assert isinstance(router2.draft_cache, DraftCache)
    assert all(h.draft_cache is router2.draft_cache for h in router2.hosts)
    assert FleetRouter(dense, None, pc2, theta2, ServeConfig(
        n_slots=2), n_hosts=2, parallel_hosts=False).draft_cache is None


# ---------------------------------------------------------------------------
# what the hosts share across threads

def _counted(monkeypatch):
    """The serving path's kernel entries, each its plain version (the CPU's
    path) adding to its kernel wrapper's launch count through
    ``_build.count_launch``, as the kernel does on the card."""
    from repro_torch.kernels import flash_attention as K7
    from repro_torch.kernels import flash_decode as K6
    from repro_torch.kernels import paged_chunk as K3
    from repro_torch.kernels import paged_decode as K2
    from repro_torch.kernels import probe_step as K1
    from repro_torch.models import attention as A
    from repro_torch.serving import engine as E
    wrappers = {"serving_probe_step": (E, K1.serving_probe_step),
                "paged_flash_decode": (A, K2.paged_flash_decode),
                "paged_flash_packed_chunk": (A, K3.paged_flash_packed_chunk),
                "flash_decode": (A, K6.flash_decode),
                "flash_attention": (A, K7.flash_attention)}
    for name, (mod, kernel) in wrappers.items():
        served = getattr(mod, name)

        def count(*a, served=served, kernel=kernel, **k):
            _build.count_launch(kernel)
            return served(*a, **k)
        monkeypatch.setattr(mod, name, count)
        monkeypatch.setattr(kernel, "launches", 0)
    return {name: kernel for name, (_, kernel) in wrappers.items()}


@pytest.mark.parametrize("chunk", [None, 8])
def test_three_host_parallel_fleet_counts_as_serial(models, monkeypatch,
                                                    chunk):
    """Three hosts stepping in parallel launch every counted kernel as
    often as three serial hosts, and K1 once a host step: the counts are
    exact under the hosts' threads.  Requests and counters equal."""
    _, (model, params, pc, theta) = models
    kernels = _counted(monkeypatch)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)
               for n in (9, 13, 6, 11, 9, 7, 12, 10)]
    cfg = ServeConfig(tokens_per_step=2, max_new_tokens=12, lam=0.6,
                      burn_in=1, n_slots=2, paged=True, block_size=4,
                      chunk_tokens=chunk)
    runs = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for parallel in (False, True):
            for k in kernels.values():
                k.launches = 0
            router = FleetRouter(model, params, pc, theta, cfg, n_hosts=3,
                                 parallel_hosts=parallel)
            done, fm = router.run([make_request(p) for p in prompts])
            runs.append((done, fm, {n: k.launches
                                    for n, k in kernels.items()},
                         sum(m.engine_steps for m in router.host_metrics)))
            router.close()
    finally:
        sys.setswitchinterval(old)
    (sd, sfm, sl, s_steps), (pd, pfm, pl, p_steps) = runs
    assert pl == sl and s_steps == p_steps
    assert sl["serving_probe_step"] == s_steps > 0
    assert sl["flash_attention" if chunk is None
              else "paged_flash_packed_chunk"] > 0
    assert sl["paged_flash_decode"] == model.cfg.n_layers * s_steps
    for a, b in zip(sd, pd):
        for f in REQ_FIELDS:
            assert getattr(a, f) == getattr(b, f), f
    for f in FLEET_FIELDS:
        assert getattr(sfm, f) == getattr(pfm, f), f


def test_count_launch_loses_no_count_under_threads():
    """16 threads adding 2,000 launches each to one counter, switching
    every microsecond: every count lands."""
    fn = types.SimpleNamespace(launches=0)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            _build.count_launch(fn) for _ in range(2000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert fn.launches == 16 * 2000


def test_library_loads_once_under_threads(monkeypatch):
    """Eight threads reaching the kernels' first load together build and
    load the library once and all get the same object."""
    import time as _time
    builds = []

    def build():
        builds.append(1)
        _time.sleep(0.05)
        return "libfake.so"

    class FakeLib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn
    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeLib())
    _build._load.cache_clear()
    got = []
    try:
        threads = [threading.Thread(target=lambda: got.append(
            _build.library())) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        _build._load.cache_clear()
    assert len(builds) == 1 and len(got) == 8
    assert all(lib is got[0] for lib in got)


# ---------------------------------------------------------------------------
# the driver

@pytest.mark.parametrize("placement", ["pressure", "roundrobin"])
def test_serve_driver_fleet_lines_match_jax(capsys, placement):
    """``--hosts 2`` with ``--group-size 4 --requests 2`` on the reduced
    model: the port's driver prints JAX's driver's ``[serve] fleet: 2
    hosts`` and ``[serve] routing:`` lines and its groups line, each group
    on one host, each host's pool drained."""
    from repro.launch import serve as jserve
    argv = GROUP_DRIVER + ["--hosts", "2", "--placement", placement]
    assert jserve.main(argv) == 0
    jout = capsys.readouterr().out
    res = tserve.serve(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    for prefix in ("[serve] fleet: 2 hosts", "[serve] routing:",
                   "[serve] groups:"):
        assert _line(out, prefix) == _line(jout, prefix)
    router = res.scheduler
    assert isinstance(router, FleetRouter) and router.n_hosts == 2
    assert res.fleet.n_hosts == 2 and len(res.groups) == 2
    for gid in (0, 1):
        assert len({r.host for r in res.requests if r.group_id == gid}) == 1
    assert {r.host for r in res.requests} == {0, 1}
    _pools_drained(router)
