"""Serving driver: a request queue through the continuous-batching ORCA
scheduler, on the card by default, with the static-batch engine as the
side-by-side baseline (``--static-baseline``).

    python -m repro_torch.launch.serve --arch smollm-360m --paged \
        --requests 8 --slots 4 --max-new-tokens 96 [--chunk-tokens 64]
    python -m repro_torch.launch.serve --arch hymba-1.5b
    python -m repro_torch.launch.serve --arch whisper-tiny

harvests step embeddings from THIS model (random weights from ``--seed``),
meta-trains the TTT probe, LTT-calibrates lambda* at ``--delta`` and serves
the queue: every ORCA stop evicts its slot, which is refilled from the
queue on the next step.  ``--chunk-tokens N`` prefills prompts in N-token
chunks through the unified token-budget step, packed across up to
``--pack-max`` requests.  ``--spec-tokens k`` serves linear speculative
draft-verify decode: each running slot proposes up to k tokens a step,
drafted by the shared n-gram draft cache (``--draft-cache`` keys) and the
model's self-draft, verified in one packed pass; ``--spec-tree W.D``
serves tree speculative decode: W draft chains of depth D a slot, verified
in one packed pass under per-token ancestor masks, the longest accepted
root path committed.  ``--policy`` picks the scheduling policy (fifo,
priority, edf, ttft) and ``--batch-every N`` makes every N-th request
batch class (priority 1); with preemption on (``--no-preempt`` turns it
off) a more urgent request spills batch residents to host RAM, which
restore later bit for bit.  ``--group-size N`` serves each request as a
self-consistency group of N samples of its prompt (gang-admitted, the
prompt's pages shared), stopped as a unit by the consensus stop: its
threshold g* is LTT-calibrated at ``--consensus-delta`` (default
``--delta``) over groups of the calibration split, and once a group's
vote clears it the siblings still running are cancelled
(``--no-consensus``: every sample runs to its own stop).  ``--hosts N``
serves through a ``FleetRouter`` (``api.fleet``) of N simulated hosts, each
with its own engine, page pool and policy on the shared weights, stepping
concurrently (on the card each on its own CUDA stream); ``--placement``
picks each unit's host (``pressure``: least loaded, prefix-affine;
``roundrobin``), ``--slots`` is per host and ``--num-blocks`` the fleet's
total.  ``--device cpu`` runs the plain PyTorch versions of the kernels
(use ``--reduced`` there).
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import api as orca
from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.labels import consistent_labels
from repro_torch.core.probe import ProbeConfig
from repro_torch.models import build
from repro_torch.serving import (RequestGroup, ServeConfig, ServingEngine,
                                 StaticQueueResult, extract_trajectories,
                                 make_group, make_request,
                                 serve_queue_static)
from repro_torch.trajectories.synthetic import (TrajectoryDistribution,
                                                TrajectorySet)


def model_inputs(cfg, generator: torch.Generator, n: int, prompt_len: int):
    """Random prompt tokens, host-side: {"tokens": (n, prompt_len) int32};
    for a VLM its patch embeddings as the JAX driver gives them, zeros of
    (n, patch tokens, embed_dim); for audio its stub frontend's frame
    embeddings as the JAX driver draws them, N(0, 1) x 0.02 of
    (n, frames, d_model), from ``generator``."""
    toks = torch.randint(0, cfg.vocab_size, (n, prompt_len),
                         generator=generator, dtype=torch.int32)
    batch = {"tokens": toks.numpy()}
    if cfg.arch_type == "vlm":
        batch["patch_embeds"] = np.zeros(
            (n, cfg.frontend.n_tokens, cfg.frontend.embed_dim), np.float32)
    if cfg.arch_type == "audio":
        batch["frames"] = (torch.randn(
            (n, cfg.frontend.n_tokens, cfg.d_model), generator=generator)
            * 0.02).numpy()
    return batch


def trajectories_from_model(model, params, n: int, prompt_len: int,
                            max_new: int, tokens_per_step: int, seed: int
                            ) -> TrajectorySet:
    """Harvest step embeddings + self-consistency answers from the model."""
    batch = model_inputs(model.cfg, torch.Generator().manual_seed(seed), n,
                         prompt_len)
    phis, toks = extract_trajectories(model, params, batch, prompt_len,
                                      max_new, tokens_per_step)
    return trajectory_set(phis, toks, tokens_per_step)


def trajectory_set(phis: np.ndarray, toks: np.ndarray,
                   tokens_per_step: int) -> TrajectorySet:
    """Harvested step embeddings (n, n_steps, d) and decoded tokens (n,
    max_new) -> trajectories labelled by self-consistency of each step's
    last token."""
    n, n_steps = phis.shape[:2]
    # "answer" proxy per step: the last token of the step
    answers = toks[:, tokens_per_step - 1::tokens_per_step][:, :n_steps]
    mask = np.ones((n, n_steps), bool)
    labels = consistent_labels(answers, mask)
    tau = np.argmax(labels > 0.5, axis=1)
    tau = np.where(labels.max(1) > 0.5, tau, n_steps)
    return TrajectorySet(phis=phis.astype(np.float32), mask=mask,
                         correct=labels > 0.5, answers=answers, tau=tau,
                         lengths=np.full(n, n_steps),
                         dist=TrajectoryDistribution("model"))


class ServeResult(NamedTuple):
    """What one driver run served: every request, the fleet metrics, the
    scheduler (its engine and page pool; with ``--hosts`` above 1 the
    ``FleetRouter``, its hosts' schedulers in ``.hosts``), the calibrated
    lambda*, with ``--static-baseline`` the static-batch run of the same
    queue, with ``--group-size`` above 1 the scheduler's groups (consensus
    outcomes), and the fitted calibrator (``api.engine``/``api.fleet``
    serve it again)."""
    requests: List
    fleet: object
    scheduler: object
    lam: float
    static: Optional[StaticQueueResult] = None
    groups: List[RequestGroup] = []
    calibrator: object = None


def serve(argv=None) -> ServeResult:
    """Parse the flags, harvest, fit, calibrate and serve; print the
    per-request lifecycle and the fleet line; return what was served."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cpu runs the plain "
                         "PyTorch versions of the kernels")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new-tokens", type=int, default=96)
    ap.add_argument("--tokens-per-step", type=int, default=8)
    ap.add_argument("--train-trajectories", type=int, default=24)
    ap.add_argument("--delta", type=float, default=0.2)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--burn-in", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--static-baseline", action="store_true",
                    help="also serve the same queue through the static-batch "
                         "engine and print the comparison")
    ap.add_argument("--paged", action="store_true",
                    help="serve from the paged KV cache (block-pool "
                         "admission, prefix sharing, eviction reclaims "
                         "pages)")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="pool size (0 -> dense-equivalent)")
    ap.add_argument("--chunk-tokens", type=int, default=0,
                    help="chunked prefill: schedule prompt prefill in "
                         "chunks of this many tokens through the unified "
                         "token-budget step (0 = admission-time prefill)")
    ap.add_argument("--token-budget", type=int, default=0,
                    help="max tokens per unified step (0 -> slots + chunk)")
    ap.add_argument("--spec-tokens", type=int, default=0,
                    help="speculative draft-verify decode: each running "
                         "slot proposes up to this many tokens per step "
                         "(current token + drafts), scored in one fused "
                         "verify pass; accepted prefix commits, rejects "
                         "roll back (0 = one-token decode)")
    ap.add_argument("--spec-tree", default="",
                    help="tree speculative decode as 'W.D': each running "
                         "slot proposes W branches x D tokens verified in "
                         "one pass under per-token ancestor masks; the "
                         "longest accepted root-to-leaf path commits "
                         "(exclusive with --spec-tokens; '' = off)")
    ap.add_argument("--draft-cache", type=int, default=4096,
                    help="capacity (n-gram keys) of the fleet-wide shared "
                         "draft cache that feeds speculation from "
                         "verifier-accepted continuations (0 = model "
                         "self-draft only)")
    ap.add_argument("--policy", default="fifo",
                    choices=("fifo", "priority", "edf", "ttft"),
                    help="scheduling policy: admission order, per-step "
                         "prefill share and victim selection (priority "
                         "classes come from --batch-every; edf ranks by "
                         "per-class deadline)")
    ap.add_argument("--no-preempt", action="store_true",
                    help="disable involuntary preemption (spill/restore "
                         "of lower-priority residents when capacity fails "
                         "for a more urgent unit) — wait-only admission")
    ap.add_argument("--no-pack", action="store_true",
                    help="disable multi-request chunk packing (one request "
                         "per prefill chunk)")
    ap.add_argument("--pack-max", type=int, default=4,
                    help="max requests fused into one packed chunk")
    ap.add_argument("--batch-every", type=int, default=0,
                    help="mark every Nth request as batch-class "
                         "(priority 1) to exercise the priority policy "
                         "(0 = all latency-class)")
    ap.add_argument("--group-size", type=int, default=1,
                    help="self-consistency samples per prompt: each request "
                         "becomes a gang-admitted group of N samples "
                         "sharing its prompt pages (1 = classic serving)")
    ap.add_argument("--no-consensus", action="store_true",
                    help="serve groups WITHOUT the consensus stop (every "
                         "sample runs to its own per-request ORCA stop)")
    ap.add_argument("--consensus-delta", type=float, default=0.0,
                    help="risk level for the group-consensus LTT "
                         "calibration (0 -> reuse --delta)")
    ap.add_argument("--hosts", type=int, default=1,
                    help="simulated fleet hosts: >1 serves through a "
                         "FleetRouter (per-host engine/pool/policy, "
                         "pressure-balanced prefix-affine placement; "
                         "--num-blocks is the TOTAL page budget split "
                         "across hosts, --slots is PER HOST)")
    ap.add_argument("--placement", default="pressure",
                    choices=("pressure", "roundrobin"),
                    help="fleet placement policy (--hosts > 1): 'pressure' "
                         "= least-loaded with prefix affinity, "
                         "'roundrobin' = locality-blind rotation")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    # validated before the harvest: an invalid flag fails fast
    serve_cfg = ServeConfig.from_args(args, placement=args.placement)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(args.seed), device)
    print(f"[serve] {cfg.name} on {device}: harvesting "
          f"{args.train_trajectories} calibration trajectories from the model")
    ts = trajectories_from_model(model, params, args.train_trajectories,
                                 args.prompt_len, args.max_new_tokens,
                                 args.tokens_per_step, args.seed)
    half = len(ts) // 2
    train, cal = ts.subset(np.arange(half)), ts.subset(np.arange(half, len(ts)))
    calib = orca.fit(train, mode="consistent", method="ttt",
                     pc=ProbeConfig(d_phi=cfg.d_model, smooth_window=4),
                     epochs=args.epochs, epoch_select=False, seed=args.seed,
                     device=str(device))
    # demo fallback keeps eviction observable on random-weight models
    lam = orca.calibrated_lambda(calib, cal, args.delta, fallback=0.99)
    print(f"[serve] LTT-calibrated lambda* = {lam:.3f}")

    # group consensus: LTT-calibrate the agreement threshold over groups
    # formed from the calibration split (group-level exchangeability),
    # with per-sample votes frozen at the deployed per-sample stop
    consensus = None
    if args.group_size > 1 and not args.no_consensus:
        c_delta = args.consensus_delta or args.delta
        g_cal = orca.GroupCalibrator(min_votes=2, burn_in=args.burn_in)
        traces = orca.groups_from_trajectories(cal, calib.scores(cal),
                                               args.group_size,
                                               seed=args.seed)
        g_cal.calibrate(traces, c_delta, per_sample_lam=lam,
                        per_sample_burn_in=args.burn_in)
        if not np.isfinite(g_cal.lam):
            # the calibrated_lambda demo fallback: keeps the consensus
            # observable on random-weight models
            g_cal.lam = 0.95
        consensus = g_cal
        print(f"[serve] consensus threshold g* = {g_cal.lam:.3f} "
              f"(delta={c_delta}, {len(traces)} calibration groups)")

    serve_cfg = dataclasses.replace(
        serve_cfg, lam=float(lam), consensus=consensus,
        consensus_delta=(args.consensus_delta or None
                         if consensus is not None else None))
    if args.hosts > 1:
        sched = orca.fleet(model, params, calib, config=serve_cfg)
        print(f"[serve] fleet: {args.hosts} hosts x {args.slots} slots, "
              f"placement={args.placement}")
    else:
        sched = orca.engine(model, params, calib, config=serve_cfg)
    batch = model_inputs(cfg, torch.Generator().manual_seed(args.seed + 1),
                         args.requests, args.prompt_len)

    extra_keys = [k for k in batch if k != "tokens"]

    def prio(i):
        return 1 if args.batch_every and i % args.batch_every == 0 else 0

    def extra(i):
        return {k: batch[k][i:i + 1] for k in extra_keys}
    if args.group_size > 1:
        reqs = [r for i in range(args.requests)
                for r in make_group(batch["tokens"][i], args.group_size,
                                    group_id=i, extra=extra(i),
                                    priority=prio(i))]
    else:
        reqs = [make_request(batch["tokens"][i], extra=extra(i),
                             priority=prio(i))
                for i in range(args.requests)]
    done, fleet = sched.run(reqs)
    for r in done:
        print(f"[serve]   req {r.req_id}: {r.state.value:8s} "
              f"admitted@{r.admitted_step:3d} done@{r.completed_step:3d} "
              f"stop_step={r.stop_step:3d} tokens={len(r.tokens)}")
    print(f"[serve] fleet: {fleet.n_requests} requests / {fleet.n_slots} "
          f"slots in {fleet.engine_steps} engine steps "
          f"({fleet.wall_time_s:.2f}s) — {fleet.requests_per_s:.2f} req/s, "
          f"{fleet.tokens_per_s:.1f} tok/s, slot utilization "
          f"{fleet.slot_utilization:.2f}, mean step savings "
          f"{fleet.mean_step_savings:.3f}")
    if args.paged:
        print(f"[serve] pool: {fleet.pool_blocks} pages "
              f"(x{args.block_size} tokens), peak in use "
              f"{fleet.peak_blocks_in_use}, prefill skips "
              f"{fleet.prefill_skips}")
    if args.hosts > 1:
        print(f"[serve] routing: {fleet.n_hosts} hosts, "
              f"{fleet.routed_affine} prefix-affine placements")
    if args.group_size > 1:
        print(f"[serve] groups: {fleet.consensus_groups} consensus stops "
              f"(mean step {fleet.consensus_steps:.1f}), "
              f"{fleet.samples_cancelled} siblings cancelled, group savings "
              f"{fleet.group_savings:.0f} steps (mean "
              f"{fleet.group_savings_mean:.3f}), "
              f"{fleet.cancel_freed_blocks} pages freed at cancel")
    if args.spec_tokens or args.spec_tree:
        print(f"[serve] speculative: {fleet.spec_tokens_accepted}/"
              f"{fleet.spec_tokens_proposed} drafts accepted "
              f"(rate {fleet.acceptance_rate:.2f}), accepted length "
              f"p50/p99 {fleet.accepted_len_p50:.1f}/"
              f"{fleet.accepted_len_p99:.1f}")
        if args.spec_tree:
            print(f"[serve] tree: {fleet.tree_nodes_proposed} nodes "
                  f"proposed, accepted path length p50/p99 "
                  f"{fleet.tree_path_accepted_p50:.1f}/"
                  f"{fleet.tree_path_accepted_p99:.1f}")
        if fleet.draft_cache_hits or fleet.draft_cache_misses:
            print(f"[serve] draft cache: {fleet.draft_cache_hits} hits / "
                  f"{fleet.draft_cache_misses} misses "
                  f"(rate {fleet.draft_cache_hit_rate:.2f})")
    if fleet.preemptions:
        print(f"[serve] preemption: {fleet.preemptions} spills / "
              f"{fleet.restores} restores ({fleet.spilled_blocks} pages "
              "copied to host)")
    print(f"[serve] latency: ttft p50/p99 {fleet.ttft_ms_p50:.1f}/"
          f"{fleet.ttft_ms_p99:.1f} ms, step stall p50/p99 "
          f"{fleet.stall_ms_p50:.1f}/{fleet.stall_ms_p99:.1f} ms"
          + (f", {fleet.prefill_chunks} prefill chunks "
             f"({fleet.packed_chunks} packed, peak "
             f"{fleet.peak_step_tokens} tok/step)"
             if args.chunk_tokens else " (admission-time prefill)"))
    base = None
    if args.static_baseline:
        pc, theta = calib.serving_params()
        scfg = ServeConfig(tokens_per_step=args.tokens_per_step,
                           max_new_tokens=args.max_new_tokens,
                           lam=float(lam), burn_in=args.burn_in)
        eng = ServingEngine(model, params, pc, theta, scfg)
        base = serve_queue_static(eng, batch, args.prompt_len, args.slots)
        print(f"[serve] static-batch baseline: {base.engine_steps} engine "
              f"steps ({base.wall_time_s:.2f}s) — "
              f"{args.requests / base.wall_time_s:.2f} req/s")
    return ServeResult(done, fleet, sched, float(lam), base,
                       list(sched.groups) if args.group_size > 1 else [],
                       calib)


def main(argv=None) -> int:
    serve(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
