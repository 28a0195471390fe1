#!/usr/bin/env python3
"""How far the FleetRouter's host threads overlap on one CUDA card.

    python3 tools/fleet_overlap.py [--steps 32] [--hosts 2]

Serves 8 requests of 16 random prompt tokens on smollm-360m (bf16, full
width and depth, random weights from seed 0, a random probe, nothing
stopping) through a ``FleetRouter`` of ``--hosts`` hosts of 4 slots,
stepping serially and in parallel (each host in its own thread on its own
CUDA stream), in turns, under three interpreter switch intervals (the
default 5 ms, 0.5 ms and 50 ms) and with torch's intra-op CPU threads at
their default and at 1; and through one host with all the slots.  Prints
one JSON line a run (the fleet step wall's p50 and p99 in ms), then the
card's name and power limit.  A switch interval that moves the parallel
step says the threads lose time to forced interpreter switches; one that
does not, to the lock's hand-overs at the ops' own releases.

Then, at the default settings, for the serial and the parallel fleet and
for the one host: the peak memory a run allocates above what was allocated
before it (the weights, made before, are not in it), and a profiled
window of ``--window`` steps over fresh requests after 4 steps of warm-up
(one JSON line each, ``"window": true``): the card's busy share of the
window's wall, as the union of the device kernels' intervals (two hosts'
kernels counted once where they overlap) and as their sum.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def covered_us(intervals) -> float:
    """The length of the union of (start, end) intervals: the time at
    least one kernel ran, overlapping kernels of two streams once."""
    total, end = 0.0, -math.inf
    for t0, t1 in sorted(intervals):
        if t1 > end:
            total += t1 - max(t0, end)
            end = t1
    return total


def fleet_window(torch, server, prompts, steps):
    """A profiled window of ``steps`` steps of ``server`` (a FleetRouter or
    an OrcaScheduler) serving ``prompts`` afresh, after 4 steps of
    warm-up: the wall a step, the kernels a step and the card's busy
    share, as the union of the kernels' intervals and as their sum."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    from repro_torch.serving import make_request
    server.submit([make_request(t, max_new_tokens=steps + 8)
                   for t in prompts])
    for _ in range(4):
        server.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            server.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    while server.step():
        pass
    server.drain()
    device = [(a, b) for _, dev, a, b in cs.profiled_events(prof)
              if dev == DeviceType.CUDA]
    busy_us = covered_us(device)
    return dict(steps=steps, wall_ms_per_step=wall_us / steps / 1e3,
                kernels_per_step=len(device) / steps,
                device_busy_ms_per_step=busy_us / steps / 1e3,
                device_busy_share=busy_us / wall_us,
                device_kernel_sum_share=sum(b - a for a, b in device)
                / wall_us)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("fleet_overlap: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.core.probe import ProbeConfig, init_outer
    from repro_torch.models import build
    from repro_torch.serving import (FleetRouter, OrcaScheduler, ServeConfig,
                                     make_request)

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--window", type=int, default=16)
    args = ap.parse_args()
    cfg = get_config("smollm-360m")
    model = build(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, "cuda")
    pc = ProbeConfig(d_phi=cfg.d_model, smooth_window=4)
    theta = init_outer(pc, device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (4 * args.hosts, 16),
                            generator=gen, dtype=torch.int32).numpy()
    serve = ServeConfig(n_slots=4, paged=True, tokens_per_step=8,
                        max_new_tokens=args.steps, lam=2.0, burn_in=2)

    def make(hosts, parallel):
        if hosts > 1:
            return FleetRouter(model, params, pc, theta, serve,
                               n_hosts=hosts, parallel_hosts=parallel)
        return OrcaScheduler(model, params, pc, theta, ServeConfig(
            n_slots=4 * args.hosts, paged=True, tokens_per_step=8,
            max_new_tokens=args.steps, lam=2.0, burn_in=2))

    def run(hosts, parallel, window=False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        server = make(hosts, parallel)
        t0 = time.perf_counter()
        done, fl = server.run([make_request(t) for t in prompts])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - start) / 2 ** 30
        step = np.asarray(server.step_ms) if hosts > 1 else None
        extra = {}
        if window:
            extra = dict(window=True, peak_over_start_gib=peak,
                         **fleet_window(torch, server, prompts, args.window))
        if hosts > 1:
            server.close()
        return dict(extra, wall_s=wall, engine_steps=fl.engine_steps,
                    step_ms_p50=(float(np.percentile(step, 50))
                                 if step is not None else fl.stall_ms_p50),
                    step_ms_p99=(float(np.percentile(step, 99))
                                 if step is not None else fl.stall_ms_p99),
                    tokens=sum(len(r.tokens) for r in done))

    run(args.hosts, True)                    # warm-up: both paths' first use
    run(args.hosts, False)
    default_interval = sys.getswitchinterval()
    default_threads = torch.get_num_threads()
    cases = [(default_interval, default_threads),
             (0.0005, default_threads), (0.05, default_threads),
             (default_interval, 1)]
    for interval, threads in cases:
        sys.setswitchinterval(interval)
        torch.set_num_threads(threads)
        try:
            for parallel in (False, True, True, False):
                rec = run(args.hosts, parallel)
                rec.update(hosts=args.hosts, parallel=parallel,
                           switch_interval_s=interval, torch_threads=threads)
                print(json.dumps(rec), flush=True)
        finally:
            sys.setswitchinterval(default_interval)
            torch.set_num_threads(default_threads)
    rec = run(1, False)
    rec.update(hosts=1, slots=4 * args.hosts)
    print(json.dumps(rec), flush=True)
    import chip_smoke as cs
    weights_gib = sum(t.numel() * t.element_size() for t in
                      cs._leaves(params)) / 2 ** 30
    for hosts, parallel in ((args.hosts, False), (args.hosts, True),
                            (1, False)):
        rec = run(hosts, parallel, window=True)
        rec.update(hosts=hosts, parallel=parallel and hosts > 1,
                   slots=4 * args.hosts // hosts, weights_gib=weights_gib)
        print(json.dumps(rec), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
