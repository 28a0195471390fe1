#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the script exits
non-zero:

1. build    -- compile the hand-written kernels from ``src/repro_torch/csrc``
2. k1       -- the serving probe step against its plain PyTorch version
               over 12 chained steps at B=8 and at the serving shape B=4
               (f=960); the same chain with zk the same tensor as zq (the
               served no-QK view, one row read) and with another tensor
               at f 128, 130, 960, 2048 and 5120, and K1(zq, zq) equal to
               K1(zq, zq.clone()) bit for bit at each; the Timer's floor
               (``floor_ms``: one launch of ``torch.empty(1).zero_()``);
               timed at B=4 in both views; the same chain and timing at
               the RWKV fleet's probe width (B 4, f 2048); 30 steps with a
               smoothing window of 17, wider than the registers hold (the
               window in shared memory), in both views; each timed row
               names its instance (threads, features a thread, registers)
3. k2       -- paged flash decode against its plain version, bf16, int8
               and f32 pages, the serving shape and nb in {8, 64, 256}
               (past 256 positions split over blocks and merged); timed
               beside scaled_dot_product_attention over the gathered
               pages, with per_step_ms (32 layers); untimed at nb 256,
               rows with holes (bf16, int8) and rows whose valid positions
               fall in one split, in the end splits only, or in none
               (the empty-row contract); each row names its splits
4. k3       -- paged chunk attention against its plain versions, B4
               (packed chunks: 1 to 4 segments, an empty cache, padding
               and zero-length segments, nb 256) and B3 (chunks of B
               requests), bf16, int8 and f32 pages, at the served chunk of
               64 tokens; timed beside scaled_dot_product_attention over
               the gathered pages with the same mask; untimed, validity
               rows with holes (nb 16, and nb 256 split over 16 blocks)
               and a split-KV case whose last split holds no valid
               position; each row names its split count, and timed rows
               carry bound_tc_ms (the products at the tensor cores' bf16
               rate) beside bound_ms
5. k4       -- the masked multi-token probe step against its plain version
               and against T masked K1 launches on copies of the same
               state, bit for bit in every case: B 1, 4, 8; T 1, 2, 4, 8;
               f 128, 960, 5120; accepted lengths 0, 1, T-1, T and mixed;
               a stop mid-chain, a slot stopped on entry, the burn-in not
               reached; zk the same tensor as zq and another tensor at f
               128, 130, 960, 2048 and 5120; smoothing windows of 17 (a
               chain of 24 tokens, so the window wraps) and 40, in shared
               memory; the Timer's floor; timed at the served shape (4
               slots, k 4, f 960) and three wider ones, at the served
               shape with a window of 40, and over T 1, 2, 4, 8 at (4, T,
               960) in both views with the slope per token; then K3 timed
               at the verify shape (k3-verify: 4 segments of 4 tokens)
6. k5       -- the offline TTT scan against its plain version and against
               its own L-step form (``ttt_probe_lookahead_plain`` at the
               kernel's L for the width): f 128, 960, 5120 and 2048 (the
               RWKV fleet's no-QK view), N 1 and 170, T 1, 37 and 120,
               c = 0 and c = labels, a per-trajectory and a shared init
               (96 cases on the synthetic corpus's step embeddings and
               masks); timed at N 170, T 120 for each f, with the L-step
               form's error at L 1, 2, 4 and 8; every instance of the
               kernel (L, threads, registers, shared memory); a width
               above 7168 and a tensor that requires grad refused
7. k6       -- dense flash decode against its plain version, partials and
               normalised output: B 1, 4, 24; S 16, 112, 113, 4096; bf16
               and f32 caches; full, ragged, window-band and empty rows;
               S 1024 and 4096 split over blocks (f32 too) and merged;
               timed at (4, 112), (24, 112), (8, 4096), (24, 4096) and
               (4, 1024) beside scaled_dot_product_attention over the same
               cache and mask, with per_step_ms; each row names its splits
8. k7       -- flash prefill attention against its plain version: (B, S)
               (1, 16), (24, 16), (1, 160), (24, 160), (4, 2048); window
               64; Sq < Sk; a window past the keys; bf16 and f32; timed
               (all but the window cases) beside SDPA with is_causal, with
               bound_ms and bound_tc_ms
9. model    -- full-width smollm-360m (bf16, random weights from a seed,
               then the same weights in f32): prefill 16 tokens, 64
               teacher-forced paged decode steps through K2 (every call
               held against the plain version on its inputs) and through
               the plain paged attention; then the dense path, the prompt
               through K7 and 64 dense decode steps through K6, every call
               checked, against the plain versions (f32: every argmax
               equal)
10. model-chunked -- the same model: a 160-token prompt through
               ``Model.prefill_chunk`` on a paged state in 64-token chunks
               (B3), then one ``prefill_packed`` chunk of two requests
               (B4), every K3 call held against its plain version; pages
               and next-step logits against one-shot prefill, bf16 and f32
11. model-spec -- the same model: ``verify_packed_chunk`` on 4 slots x k 4
               against 4 sequential paged ``decode_step``s, bf16 and f32
               (f32: every argmax equal)
12. serve   -- ``repro_torch.launch.serve`` end to end on the card:
               harvest, meta-train, calibrate, serve 8 requests on 4 slots;
               K1, K2, and K6 and K7 (the harvest and every admission)
13. trace   -- a profiler window over 16 engine steps of the same fleet:
               the card's busy share and the kernels that take it, and the
               split-KV merges a step (none at the served shapes)
14. harvest -- the driver's harvest (24 trajectories, 96 dense decode
               steps) timed through K6 and K7 and through their plain
               versions in turns; K7 once a layer, K6 once a layer a step
15. serve-dense, trace-dense, trace-dense-plain -- the driver without
               ``--paged``: K1 and K6 every step (K6 32 times), K7 at the
               harvest and each admission, K2 never; the fleet line beside
               serve's and its bf16 tokens against serve's (not asserted);
               profiled windows through the kernels and through the plain
               versions
16. serve-dense-f32 -- the serve fleet in f32 through ``OrcaScheduler``,
               dense and paged, at a lambda* between its scores: stops and
               tokens equal
17. serve-chunked -- the driver with ``--chunk-tokens 64`` on 160-token
               prompts: the third chunk of each prompt packs with the head
               of the next; K1, K2, K3, K6 and K7 launch
18. trace-chunked -- a 24-step window over the chunked fleet, launches and
               busy share split into steps with a chunk and without one
19. serve-spec, trace-spec, serve-spec-chunked -- the fleets of 12 and 17
               again with ``--spec-tokens 4``: K4 launches once per engine
               step, its first 16 calls held against the plain version;
               requests compared with the one-token fleets (tokens and
               stops); a 16-step profiled window of the spec fleet
20. serve-spec-f32 -- the serve fleet in f32 through ``OrcaScheduler``
               at a lambda* between its scores: the spec fleet's stops
               and tokens equal the one-token fleet's, with the default
               draft cache and with one primed by the one-token tokens
               (drafts accepted, several tokens per step, its first 16
               K4 calls held against the plain version)
21. offline  -- the paper's procedure on the synthetic corpus at d_phi 960
               (``corpus_splits(500, 170, 170)``): ``orca.fit`` of the TTT
               probe (no-QK, QK d_h 128) and the static probe, then
               ``orca.evaluate`` at every delta; K5 launches in fit and in
               evaluate, and its plain version's scores give the same
               lambda*, savings and error
22. serve-static -- the driver with ``--static-baseline`` on 4 requests:
               the static-batch engine's stops equal the fleet's (its
               prefill runs K7, its dense decode K6); then the static probe
               (``api.fit(method="static")``) served through
               ``api.engine``: K1 runs and leaves every W at W0 (eta = 0)
23. k8       -- the RWKV6 WKV scan against its plain version, H 32, d 64:
               (B, T) (4, 1) served decode, (1, 16) admission, (24, 16)
               and (24, 1) the harvest's prefill and decode, (1, 100),
               (1, 512), (1, 2048), T 31, 32 and 33 around the staged
               chunk; bf16 r, k and v at (4, 1) and (1, 16); s0 zero and
               random; w near 0, mid and near 1; relative f32 error under
               1e-5 of max |plain|; T 100 in two calls carrying the state,
               in place at 4 column blocks, one call in place at 2; d 32
               refused; timed at (4, 1), (1, 16), (24, 16), (1, 512) and
               (1, 2048), and in bf16, with its bound; each row names its
               column split, staged chunk, registers and shared memory
24. model-rwkv -- full-width rwkv6-1.6b (bf16, then the same weights in
               f32): prefill 16 tokens, 64 teacher-forced decode steps
               through K8, every K8 call held against the plain version;
               each step's logits against one prefill over the whole
               sequence (f32: every argmax equal; bf16: gap and argmax
               agreement held to the same run through the plain scan)
25. serve-rwkv -- ``launch.serve --arch rwkv6-1.6b``, the serve fleet on
               the recurrent state: K8 launches 24 x (1 harvest prefill +
               96 harvest steps + 8 admissions + the engine steps); K1 and
               K5 run; K2, K3, K4, K6 and K7 never
26. trace-rwkv, harvest-rwkv -- a 16-step profiled window of the RWKV
               fleet; its harvest timed through K8 and through the plain
               scan in turns (K8 once a layer a prefill or decode step)
27. serve-rwkv-f32 -- the RWKV fleet in f32 through ``OrcaScheduler`` at
               a lambda* between its scores, through K8 and through the
               plain scan: stops and tokens equal
28. kernels  -- one entry per kernel: launches on its path (phase 12 for
               K1, K2 and K7, 10 for K3-B3, 17 for K3-B4, 19 for K4, 21
               for K5, 15 for K6, 25 for K8), error against its plain
               version, kernel / plain / library / bound ms

The line before the last is ``nvidia-smi``'s card name and power limit;
the last line is ``{"ok": true, "device": {...}}``.  Exits non-zero with no
result when there is no CUDA device or the package is missing.
"""
from __future__ import annotations

import bisect
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and the
# float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# dense bf16 on the tensor cores (the same data sheet)
TC_FLOPS_PER_S = 989e12
SEED = 0
# the card; a CPU rehearsal of the phases at a reduced size may set "cpu"
DEV = "cuda"


def sync(torch) -> None:
    if DEV == "cuda":
        torch.cuda.synchronize()


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries t_s, the seconds since the
    script started."""
    if "phase" in obj:
        obj = dict(obj, t_s=time.perf_counter() - T0)
    print(json.dumps(obj), flush=True)


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_tc_ms(n_bytes: float, tc_flops: float, f32_flops: float) -> float:
    """The bound with the products on the tensor cores: the products'
    operations at the bf16 rate, the rest at the f32 rate, against the
    same bytes."""
    t_ops = (tc_flops / TC_FLOPS_PER_S + f32_flops / F32_FLOPS_PER_S) * 1e3
    return max(n_bytes / HBM_BYTES_PER_S * 1e3, t_ops)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


class Timer:
    """Per-call CUDA-event timing of the device work, after a few warm-up
    calls.  Before every call a 1 GiB buffer is zeroed: that flushes the
    50 MB L2 (a served layer finds its pages cold) and keeps the card busy
    for about 0.3 ms while the host enqueues the call, so the events time
    the kernels and not the host's Python in front of them."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(2 ** 30, dtype=torch.uint8, device=DEV)

    def __call__(self, fn, reps: int = 30, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(reps):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        sync(torch)
        return sum(a.elapsed_time(b) for a, b in pairs) / reps


# ---------------------------------------------------------------------------
# phase k1

def probe_state(torch, gen, B, f, win):
    """Slots spread over scores far from lambda* = 0.6: a few climb past it
    after the burn-in (a stop inside the run), the others stay below."""
    dev = DEV
    W = (torch.randn(B, f, generator=gen) / f ** 0.5).to(dev)
    b = torch.linspace(-3.0, 4.0, B).to(dev)
    ring = torch.zeros(B, win, device=dev)
    n = torch.zeros(B, dtype=torch.int32, device=dev)
    stopped = torch.zeros(B, dtype=torch.bool, device=dev)
    stopped[1] = True                      # a slot parked from the start
    stop_step = torch.full((B,), -1, dtype=torch.int32, device=dev)
    return [W, b, ring, n, stopped, stop_step]


def k1_chain(torch, K1, gen, B, f, win, steps, eta, lam, burn_in,
             same=False):
    """K1 and its plain version over ``steps`` chained steps from the same
    state, with mixed boundaries and a stop inside the run; ``same``: zk
    is zq, one tensor (the served no-QK view).  Returns the largest
    differences of s, W, b and smoothed, the smallest distance of a
    smoothed score from lambda*, and the stop steps."""
    zs = [(torch.randn(B, f, generator=gen) / f ** 0.5).to(DEV)
          for _ in range(2 * steps)]
    bnd = (torch.rand(steps, B, generator=gen) < 0.7).to(DEV)
    bnd[:, 0] = True
    kern = probe_state(torch, gen, B, f, win)
    plain = [t.clone() for t in kern]
    err = {"s": 0.0, "W": 0.0, "b": 0.0, "smoothed": 0.0}
    margin = float("inf")
    for t in range(steps):
        zq, zk = zs[2 * t], zs[2 * t + (0 if same else 1)]
        ko = K1.serving_probe_step(zq, zk, bnd[t], *kern, eta, lam,
                                   burn_in=burn_in)
        po = K1.serving_probe_step_plain(zq, zk, bnd[t], *plain, eta, lam,
                                         burn_in=burn_in)
        sync(torch)
        for name in ("n_scores", "stopped", "stop_step"):
            a, b_ = getattr(ko, name), getattr(po, name)
            if not torch.equal(a, b_):
                raise AssertionError(f"K1 B={B} f={f} step {t}: {name} "
                                     f"differs: {a.tolist()} vs "
                                     f"{b_.tolist()}")
        for name in err:
            err[name] = max(err[name], float(
                (getattr(ko, name) - getattr(po, name)).abs().max()))
        scored = po.n_scores > 0
        if scored.any():
            margin = min(margin, float((po.smoothed[scored] - lam).abs()
                                       .min()))
    if margin < 1e-3:
        raise AssertionError(f"K1 B={B} f={f}: inputs came within {margin} "
                             "of lambda*")
    if int(kern[5].max()) < 0:
        raise AssertionError(f"K1 B={B} f={f}: no slot stopped")
    tol = 1e-5      # f32, another reduction order than the plain version
    if max(err.values()) > tol:
        raise AssertionError(f"K1 B={B} f={f} off its plain version: {err}")
    return err, margin, kern[5].tolist()


# K1's outputs and state
PROBE_FIELDS = ("s", "W", "b", "ring", "n_scores", "smoothed", "stopped",
                "stop_step")


def k1_shared_bitwise(torch, K1, gen, B, f, win, eta, lam, burn_in):
    """K1(zq, zq) -- one tensor, one row read -- against K1(zq, zq.clone())
    -- two rows -- from copies of one state, every slot at a boundary:
    every output and every state tensor equal bit for bit."""
    zq = (torch.randn(B, f, generator=gen) / f ** 0.5).to(DEV)
    bnd = torch.ones(B, dtype=torch.bool, device=DEV)
    st = probe_state(torch, gen, B, f, win)
    one, two = [t.clone() for t in st], [t.clone() for t in st]
    a = K1.serving_probe_step(zq, zq, bnd, *one, eta, lam, burn_in=burn_in)
    b = K1.serving_probe_step(zq, zq.clone(), bnd, *two, eta, lam,
                              burn_in=burn_in)
    sync(torch)
    for name in PROBE_FIELDS:
        if not torch.equal(getattr(a, name), getattr(b, name)):
            raise AssertionError(f"K1 f={f}: zk is zq and zk a clone of zq "
                                 f"differ in {name}")
    return True


def floor_ms(torch, timer) -> float:
    """The Timer around one launch of the smallest kernel: what a call
    that does nothing costs in the Timer's window."""
    return timer(lambda: torch.empty(1, device=DEV).zero_(), reps=200)


def chain_config(K1, f, same, win):
    """The K1/K4 instance of width f, view and window, with its registers
    (on the card; figures only on the CPU)."""
    if DEV != "cuda":
        fig = K1.instance(f, same, win)
        return dict(threads=fig[0], features_per_thread=fig[1], same=fig[2],
                    smem_window=fig[3])
    return K1.kernel_config(f, same, win)


def k1_timed(torch, timer, K1, gen, Bs, f, win, eta, burn_in, same=False):
    """K1 and its plain version timed at (Bs, f), every slot at a
    boundary; ``same``: zk is zq.  lambda* above 1 is out of reach of any
    smoothed score, so no slot stops and every timed call updates every
    slot's W, b and ring (a stopped slot would skip them) -- the work the
    bound counts."""
    lam_t = 1.5
    zq = (torch.randn(Bs, f, generator=gen) / f ** 0.5).to(DEV)
    zk = zq if same else (torch.randn(Bs, f, generator=gen)
                          / f ** 0.5).to(DEV)
    bnd_all = torch.ones(Bs, dtype=torch.bool, device=DEV)
    st = probe_state(torch, gen, Bs, f, win)
    st[4].zero_()
    ms = timer(lambda: K1.serving_probe_step(zq, zk, bnd_all, *st, eta,
                                             lam_t, burn_in=burn_in),
               reps=200)
    plain_ms = timer(lambda: K1.serving_probe_step_plain(
        zq, zk, bnd_all, *st, eta, lam_t, burn_in=burn_in), reps=200)
    if bool(st[4].any()):
        raise AssertionError("K1 timing: a slot stopped")
    # read zq (and zk), boundary and the whole state once; write W, b,
    # ring, n_scores and stopped (stop_step is untouched without a stop)
    # and the two outputs (s, smoothed); ~7 f32 operations per feature
    # (two dots, the update; 5 where zk is zq)
    W, b, ring, n, stopped, stop_step = st
    rows = (zq,) if same else (zq, zk)
    moved = (nbytes(*rows, bnd_all, *st) + nbytes(W, b, ring, n, stopped)
             + 2 * 4 * Bs)
    bms, by = bound_ms(moved, (5 if same else 7) * Bs * f)
    return dict(timed_shape=dict(B=Bs, f=f, window=win, lam=lam_t,
                                 view="same" if same else "distinct"),
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                bytes=moved, **chain_config(K1, f, same, win))


# a smoothing window wider than the kernel's registers hold (its window
# then lies in shared memory), and the K1 chain's length that makes
# scores leave it
WIDE_WINDOW, WIDE_STEPS = 17, 30

# the widths of the view cases: QK d_h 128, a width that is no multiple of
# 4, smollm-360m's 960, rwkv6-1.6b's 2048, qwen1.5-32b's 5120
VIEW_WIDTHS = (128, 130, 960, 2048, 5120)


def phase_k1(torch, timer):
    from repro_torch.kernels import probe_step as K1
    gen = torch.Generator().manual_seed(SEED)
    f, win, steps = 960, 4, 12
    eta, lam, burn_in = 0.05, 0.6, 2
    floor = floor_ms(torch, timer)
    # the 12-step chain at B = 8 and at the serving shape, B = 4 slots
    chains = {}
    for B in (8, 4):
        err, margin, stops = k1_chain(torch, K1, gen, B, f, win, steps, eta,
                                      lam, burn_in)
        chains[B] = dict(max_abs_err=err, lambda_margin=margin,
                         stopped_at=stops)
    # zk the same tensor as zq and a different one, at every view width
    views = []
    for fv in VIEW_WIDTHS:
        for same in (True, False):
            err_v, margin_v, stops_v = k1_chain(
                torch, K1, gen, 4, fv, win, steps, eta, lam, burn_in,
                same=same)
            views.append(dict(f=fv, view="same" if same else "distinct",
                              max_abs_err=err_v, lambda_margin=margin_v,
                              stopped_at=stops_v))
        k1_shared_bitwise(torch, K1, gen, 4, fv, win, eta, lam, burn_in)
    timed = k1_timed(torch, timer, K1, gen, 4, f, win, eta, burn_in)
    served = k1_timed(torch, timer, K1, gen, 4, f, win, eta, burn_in,
                      same=True)
    f_rwkv = RWKV_PROBE_F
    err_r, margin_r, stops_r = k1_chain(torch, K1, gen, 4, f_rwkv, win,
                                        steps, eta, lam, burn_in)
    rwkv = dict(f=f_rwkv, B=4, max_abs_err=err_r, lambda_margin=margin_r,
                stopped_at=stops_r,
                **k1_timed(torch, timer, K1, gen, 4, f_rwkv, win, eta,
                           burn_in))
    rwkv_served = k1_timed(torch, timer, K1, gen, 4, f_rwkv, win, eta,
                           burn_in, same=True)
    wide = []
    for same in (True, False):
        err_w, margin_w, stops_w = k1_chain(
            torch, K1, gen, 4, f, WIDE_WINDOW, WIDE_STEPS, eta, lam,
            burn_in, same=same)
        wide.append(dict(window=WIDE_WINDOW, steps=WIDE_STEPS,
                         view="same" if same else "distinct",
                         max_abs_err=err_w, lambda_margin=margin_w,
                         stopped_at=stops_w))
    err = {k: max([c["max_abs_err"][k] for c in chains.values()]
                  + [v["max_abs_err"][k] for v in views + wide]
                  + [err_r[k]])
           for k in chains[8]["max_abs_err"]}
    # the kernels line's K1 time: two rows (zk another tensor) at 4 slots,
    # as every slice has reported it; the served view (zk is zq) beside it
    res = dict(phase="k1", steps=steps, f=f, window=win, floor_ms=floor,
               chains={str(B): c for B, c in chains.items()},
               views=views, shared_bitwise=len(VIEW_WIDTHS),
               wide_window=wide, max_abs_err=err, ms=timed["ms"],
               plain_ms=timed["plain_ms"], bound_ms=timed["bound_ms"],
               bound_by=timed["bound_by"], library_ms=None,
               served_ms=served["ms"], served_plain_ms=served["plain_ms"],
               served_bound_ms=served["bound_ms"], served=served,
               distinct=timed, rwkv_width=rwkv, rwkv_served=rwkv_served)
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phase k2

def paged_case(torch, gen, B, nb, dtype, H=15, KV=5, d=64, bs=16):
    """A pool of B*nb+1 pages (page 0 NULL), shuffled tables, partly valid
    rows (ragged tails; one row behind a NULL entry)."""
    P = B * nb + 1
    q = torch.randn(B, H, d, generator=gen).to(DEV)
    if dtype == "int8":
        k = torch.randint(-127, 128, (P, KV, bs, d), generator=gen,
                          dtype=torch.int8).to(DEV)
        v = torch.randint(-127, 128, (P, KV, bs, d), generator=gen,
                          dtype=torch.int8).to(DEV)
        ks = (torch.rand(P, KV, bs, 1, generator=gen) * 0.02 + 1e-3).to(DEV)
        vs = (torch.rand(P, KV, bs, 1, generator=gen) * 0.02 + 1e-3).to(DEV)
    else:
        dt = torch.bfloat16 if dtype == "bf16" else torch.float32
        k = torch.randn(P, KV, bs, d, generator=gen).to(dt).to(DEV)
        v = torch.randn(P, KV, bs, d, generator=gen).to(dt).to(DEV)
        ks = vs = None
    tables = (1 + torch.randperm(B * nb, generator=gen)).reshape(B, nb)
    lens = torch.randint(1, nb * bs + 1, (B,), generator=gen)
    lens[0] = nb * bs
    valid = torch.arange(nb * bs)[None, :] < lens[:, None]
    if B > 2 and nb > 1:
        tables[2, 0] = 0                    # NULL entry, masked off
        valid[2, :bs] = False
    return (q, k, v, tables.to(torch.int32).to(DEV), valid.to(DEV), ks, vs)


# bf16 / int8 inputs upcast exactly; f32 accumulation in another order
# (per-warp online softmax, then a cross-warp merge) than the plain one-shot
# softmax: m to 1e-4, normalised output to 2e-3
K2_M_TOL, K2_OUT_TOL = 1e-4, 2e-3


def partial_errors(kern, plain, valid, m_relative=False):
    """Largest m and normalised-output differences between two (o, l, m)
    partials, over the rows with a valid position.  ``m_relative`` divides
    each m difference by max(1, |m|): f32 rounding of a score grows with
    the score, and a random-weight model's scores reach tens."""
    (o, l, m), (po, pl_, pm) = kern, plain
    live = valid.any(1)
    dm = (m - pm)[live].abs()
    if m_relative:
        dm = dm / pm[live].abs().clamp_min(1.0)
    out = (o / l.clamp_min(1e-30)[..., None])[live]
    pout = (po / pl_.clamp_min(1e-30)[..., None])[live]
    return float(dm.max()), float((out - pout).abs().max())


def k2_shape_rows(torch, gen, valid, case):
    """Phase k2's untimed split cases, on a (B >= 8, nb 256) validity row
    set.  "holes": every row keeps about 30% of its valid positions (its
    first and last kept), so each split's share has holes.  "one split":
    row 5 keeps one valid position, which lands in one split of 8 (the
    others empty), row 6 only its first 8 and last 8 positions (the middle
    splits empty), row 7 none (the empty-row contract after the merge)."""
    n_pos = valid.shape[1]
    if case == "holes":
        keep = (torch.rand(valid.shape, generator=gen) < 0.3).to(DEV)
        ends = torch.zeros_like(valid)
        for b in range(valid.shape[0]):
            idx = torch.nonzero(valid[b]).flatten()
            if idx.numel():
                ends[b, idx[0]] = ends[b, idx[-1]] = True
        return valid & (keep | ends)
    valid = valid.clone()
    valid[5] = False
    valid[5, 2345] = True
    valid[6] = False
    valid[6, :8] = True
    valid[6, n_pos - 8:] = True
    valid[7] = False
    return valid


def empty_rows_hold(o, l, m, valid) -> bool:
    """Rows with no valid position return exactly o = 0, l = 0 and
    m = -1e30."""
    empty = ~valid.any(1)
    return not empty.any() or (float(o[empty].abs().max()) == 0.0
                                and float(l[empty].abs().max()) == 0.0
                                and bool((m[empty] == -1e30).all()))


SPLIT_SWEEP = (4, 8, 12, 16)


def split_sweep(torch, timer, name, launch, outs, n_pos):
    """Time one K2 or K6 call through its launcher at each split count of
    SPLIT_SWEEP (the wrapper takes split.split_count): what the cap of
    split.DECODE_MAX_SPLITS rests on.  ``launch(n_split, parts)`` runs
    the launcher with the scratch ``parts``; no launch count moves."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import split as SP

    def call(n_split):
        parts = SP.split_scratch(n_split, *outs)
        err = launch(n_split, [_build.opt_ptr(t) for t in parts])
        _build.check(err, f"{name} split sweep")
    ms = {str(n): timer(lambda: call(n)) for n in SPLIT_SWEEP}
    emit(dict(phase=f"{name}-splits", positions=n_pos, ms_by_splits=ms,
              chosen=SP.split_count(n_pos, SP.DECODE_MAX_SPLITS)))


def phase_k2(torch, timer):
    import torch.nn.functional as F
    from repro_torch.kernels import paged_decode as K2
    from repro_torch.kernels import split as SP
    gen = torch.Generator().manual_seed(SEED + 1)
    # (B, nb, dtype, timed, case): the serving shape of phase serve first (4
    # slots, 7 pages of 16 for 16 + 96 positions), then the wider cases;
    # f32 pages (the float32 model of phase model) at the serving shape;
    # then nb 64 (1,024 positions, 4 splits) and the untimed split cases
    cases = [(4, 7, "bf16", True, None), (8, 8, "bf16", True, None),
             (8, 256, "bf16", True, None), (8, 8, "int8", True, None),
             (8, 256, "int8", True, None), (4, 7, "f32", True, None),
             (8, 64, "bf16", True, None), (8, 256, "bf16", False, "holes"),
             (8, 256, "int8", False, "holes"),
             (8, 256, "bf16", False, "one split")]
    rows = []
    for B, nb, dtype, timed, case in cases:
        q, k, v, tables, valid, ks, vs = paged_case(torch, gen, B, nb, dtype)
        if case is not None:
            valid = k2_shape_rows(torch, gen, valid, case)
        o, l, m = K2.paged_flash_decode(q, k, v, tables, valid, ks, vs,
                                        return_partials=True)
        po, pl_, pm = K2.paged_decode_plain(q, k, v, tables, valid, ks, vs,
                                            return_partials=True)
        m_err, o_err = partial_errors((o, l, m), (po, pl_, pm), valid)
        if not (m_err <= K2_M_TOL and o_err <= K2_OUT_TOL):
            raise AssertionError(f"K2 {B}x{nb} {dtype} {case}: m err "
                                 f"{m_err}, output err {o_err}")
        if not empty_rows_hold(o, l, m, valid):
            raise AssertionError(f"K2 {B}x{nb} {dtype} {case}: an empty row "
                                 "is not (o, l, m) = (0, 0, -1e30)")
        n_split = SP.split_count(nb * 16, SP.DECODE_MAX_SPLITS)
        row = dict(B=B, nb=nb, pages=dtype, case=case, H=q.shape[1],
                   KV=k.shape[1], d=q.shape[2], bs=16,
                   valid_positions=int(valid.sum()),
                   empty_rows=int((~valid.any(1)).sum()), splits=n_split,
                   merge=n_split > 1, m_err=m_err, out_err=o_err)
        if not timed:
            emit(dict(phase="k2", **row))
            rows.append(row)
            continue
        ms = timer(lambda: K2.paged_flash_decode(
            q, k, v, tables, valid, ks, vs, return_partials=True))
        plain_ms = timer(lambda: K2.paged_decode_plain(
            q, k, v, tables, valid, ks, vs, return_partials=True))
        # yardstick: SDPA over the pages gathered (outside the timing) into
        # per-row caches, KV heads repeated to the query heads; bf16, or
        # f32 for f32 pages
        H, KV, d = q.shape[1], k.shape[1], q.shape[2]
        lib_dt = torch.float32 if dtype == "f32" else torch.bfloat16
        kg = K2._gather(k, ks, tables).to(lib_dt)
        vg = K2._gather(v, vs, tables).to(lib_dt)
        kg = kg.repeat_interleave(H // KV, dim=1)
        vg = vg.repeat_interleave(H // KV, dim=1)
        qg = q.to(lib_dt)[:, :, None, :]
        mask = valid[:, None, None, :]
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            qg, kg, vg, attn_mask=mask))
        # bytes this data needs: K and V (and int8 scales) of the valid
        # positions, q, tables, valid, and the (o, l, m) written
        n_valid = int(valid.sum())
        per_pos = KV * d * k.element_size() * 2
        if ks is not None:
            per_pos += KV * 4 * 2
        moved = (n_valid * per_pos + nbytes(q, tables, valid)
                 + nbytes(o, l, m))
        # per valid position and query head: q.k and p.v (2 d each) + softmax
        bms, by = bound_ms(moved, n_valid * H * (4 * d + 4))
        # per_step_ms: the kernel's share of one decode step, 32 layers
        row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=bms, bound_by=by, bytes=moved,
                   per_step_ms=32 * ms)
        emit(dict(phase="k2", **row))
        rows.append(row)
        if (nb, dtype) == (256, "bf16"):
            from repro_torch.kernels import _build
            p = _build.ptr
            qg = q.reshape(B, KV, H // KV, d)
            split_sweep(torch, timer, "k2", lambda n, parts: (
                _build.library().paged_decode_launch(
                    p(qg), p(k), p(v), None, None, p(tables), p(valid),
                    p(o), p(l), p(m), *parts, B, KV, H // KV, d, 16, nb, n,
                    K2._DTYPE_CODE[k.dtype], float(1.0 / d ** 0.5),
                    _build.stream_of(q))), (o, l, m), nb * 16)
    return rows


# ---------------------------------------------------------------------------
# phase k3

def chunk_partial_errors(kern, plain, m_relative=False):
    """Largest m and normalised-output differences between two chunk
    partials (o, l, m) over the rows the plain version finds a valid
    position for (l > 0); every other row must hold the empty-row contract
    exactly: m = -1e30, l = 0, o = 0."""
    (o, l, m), (po, pl_, pm) = kern, plain
    o, po = o.reshape(-1, o.shape[-1]), po.reshape(-1, po.shape[-1])
    l, pl_, m, pm = l.reshape(-1), pl_.reshape(-1), m.reshape(-1), \
        pm.reshape(-1)
    live = pl_ > 0
    dead = ~live
    if dead.any():
        if not (bool((l[dead] == 0).all()) and bool((o[dead] == 0).all())
                and bool((m[dead] == -1e30).all())):
            raise AssertionError("K3: a row with no valid position broke "
                                 "the m = -1e30, l = 0, o = 0 contract")
    if not live.any():
        return 0.0, 0.0
    dm = (m - pm)[live].abs()
    if m_relative:
        dm = dm / pm[live].abs().clamp_min(1.0)
    out = o[live] / l[live, None]
    pout = po[live] / pl_[live, None]
    return float(dm.max()), float((out - pout).abs().max())


def chunk_pool(torch, gen, n_seg, nb, dtype, KV=5, d=64, bs=16):
    """A pool of n_seg*nb+1 pages (page 0 NULL) and shuffled tables."""
    P = n_seg * nb + 1
    if dtype == "int8":
        k = torch.randint(-127, 128, (P, KV, bs, d), generator=gen,
                          dtype=torch.int8).to(DEV)
        v = torch.randint(-127, 128, (P, KV, bs, d), generator=gen,
                          dtype=torch.int8).to(DEV)
        ks = (torch.rand(P, KV, bs, 1, generator=gen) * 0.02 + 1e-3).to(DEV)
        vs = (torch.rand(P, KV, bs, 1, generator=gen) * 0.02 + 1e-3).to(DEV)
    else:
        dt = torch.bfloat16 if dtype == "bf16" else torch.float32
        k = torch.randn(P, KV, bs, d, generator=gen).to(dt).to(DEV)
        v = torch.randn(P, KV, bs, d, generator=gen).to(dt).to(DEV)
        ks = vs = None
    tables = (1 + torch.randperm(n_seg * nb, generator=gen)).reshape(
        n_seg, nb).to(torch.int32)
    return k, v, ks, vs, tables


def k3_bytes_ops(k, ks, n_valid_by_seg, tok_valid, H, d, inputs, outputs):
    """Bytes the call must move (the valid K and V of every segment with a
    token, read once, the small inputs read once, the partials written
    once), the f32 operations it must do (per query head and valid
    position of its segment: q.k and p.v, 2 d each, and the softmax), and
    the share of them that are products."""
    KV = k.shape[1]
    per_pos = KV * d * k.element_size() * 2
    if ks is not None:
        per_pos += KV * 4 * 2
    moved = sum(n_valid_by_seg) * per_pos + nbytes(*inputs) + nbytes(
        *outputs)
    return moved, tok_valid * H * (4 * d + 4), tok_valid * H * 4 * d


# B4 cases at the served chunk of 64 tokens, R = 4 segments (pack_max):
# (name, nb, pages, [(tokens, cached positions) per segment]); the rest of
# the 64 tokens are padding with the last real segment's id, and the rest
# of the 4 segments are zero-length.  The first is the serving shape of
# phase serve-chunked: a prompt's third chunk (32 tokens, 128 cached) packed with the
# head of the next prompt (32 tokens, no cache yet).
K3_B4_CASES = [
    ("served", 16, "bf16", [(32, 128), (32, 0)]),
    ("served", 16, "int8", [(32, 128), (32, 0)]),
    ("served", 16, "f32", [(32, 128), (32, 0)]),
    ("one segment", 16, "bf16", [(64, 128)]),
    ("four segments", 16, "bf16", [(16, 200), (16, 0), (16, 37), (8, 255)]),
    ("padding", 16, "bf16", [(30, 64), (20, 129)]),
    ("nb 256", 256, "bf16", [(64, 4000)]),
    ("nb 256", 256, "int8", [(40, 4000), (24, 1500)]),
]
# B3 cases: (B, C, nb, pages, cached positions per request); the first is
# the shape of phase model-chunked's last chunk
K3_B3_CASES = [
    (1, 64, 16, "bf16", [128]),
    (1, 64, 16, "int8", [128]),
    (1, 64, 16, "f32", [128]),
    (4, 64, 256, "bf16", [0, 64, 1000, 4000]),
    (4, 64, 256, "int8", [0, 64, 1000, 4000]),
]
# untimed B4 cases of the split-KV and holed-row paths: validity rows with
# holes inside the valid range (every other position, at random, of the
# cached ones; the first and last kept), at the served width and split
# over 16 blocks; and one segment over 64 pages (4 splits) whose 130
# cached positions fill 3 tiles, so the last split holds no valid position
K3_B4_UNTIMED = [
    ("holes", 16, "bf16", [(32, 200), (32, 100)], True),
    ("holes, split", 256, "int8", [(40, 4000), (24, 1500)], True),
    ("split, last split empty", 64, "bf16", [(64, 130)], False),
]
# bf16 / int8 inputs upcast exactly; f32 sums in another order than the
# plain one-shot softmax: K2's tolerances
K3_M_TOL, K3_OUT_TOL = 1e-4, 2e-3


def _sdpa_ms(torch, timer, q4, k, v, ks, vs, tables, mask, dtype):
    """SDPA over the pages gathered (outside the timing) per segment, KV
    heads repeated to the query heads: the yardstick, never the port's."""
    import torch.nn.functional as F
    from repro_torch.models import attention as A
    H, KV = q4.shape[1], k.shape[1]
    lib_dt = torch.float32 if dtype == "f32" else torch.bfloat16
    pages = {"k": k, "v": v}
    if ks is not None:
        pages.update(k_scale=ks, v_scale=vs)
    kg, vg = (x.to(lib_dt).repeat_interleave(H // KV, 1)
              for x in A.gather_page_rows(pages, tables))
    qg = q4.to(lib_dt)
    return timer(lambda: F.scaled_dot_product_attention(qg, kg, vg,
                                                        attn_mask=mask))


def k3_b4_case(torch, timer, gen, name, nb, dtype, segs, C=64, R=4,
               holes=False, timed=True):
    """One packed chunk of C tokens in R segments ((tokens, cached
    positions) each) through K3 and its plain version: errors, the merged
    output, times beside SDPA and the bounds.  ``holes`` drops about half
    of each segment's cached positions (not its first and last)."""
    from repro_torch.kernels import paged_chunk as K3
    from repro_torch.models import attention as A
    H, KV, d, bs = 15, 5, 64, 16
    k, v, ks, vs, tables = chunk_pool(torch, gen, R, nb, dtype)
    n_tok = sum(t for t, _ in segs)
    seg = torch.full((C,), len(segs) - 1, dtype=torch.int32)
    lengths = torch.zeros(R, dtype=torch.int32)
    starts = torch.zeros(R, dtype=torch.int32)
    off = 0
    for i, (t, cached) in enumerate(segs):
        seg[off:off + t] = i
        lengths[i], starts[i] = t, cached
        off += t
    valid = torch.arange(nb * bs)[None, :] < starts[:, None]
    if holes:
        valid &= torch.rand(R, nb * bs, generator=gen) < 0.5
        for i, (_, cached) in enumerate(segs):
            if cached:
                valid[i, [0, cached - 1]] = True
    q = torch.randn(C, H, d, generator=gen)
    q, seg, tables, valid = (t.to(DEV) for t in (q, seg, tables, valid))
    got = K3.paged_flash_packed_chunk(q, k, v, seg, tables, valid, ks, vs)
    want = K3.paged_packed_chunk_plain(q, k, v, seg, tables, valid, ks, vs)
    m_err, o_err = chunk_partial_errors(got, want)
    # the merged output every token sees, the chunk's own keys folded in
    # under the block-diagonal mask: holds the empty-cache segment
    offsets = torch.cumsum(lengths, 0) - lengths
    sl = seg.long().cpu()
    tpos = torch.arange(C) - offsets[sl]
    vt = ((tpos >= 0) & (tpos < lengths[sl])).to(DEV)
    mask = A.packed_chunk_mask(seg, vt)
    kn = torch.randn(C, KV, d, generator=gen).to(DEV)
    vn = torch.randn(C, KV, d, generator=gen).to(DEV)
    qg = q.reshape(C, KV, H // KV, d)
    merged = []
    for o_, l_, m_ in (got, want):
        o2, l2 = A._merge_packed_block(qg, o_, l_, m_, kn, vn, mask)
        merged.append(o2 / l2[..., None])
    merged_err = float((merged[0] - merged[1]).abs().max())
    if not (m_err <= K3_M_TOL and o_err <= K3_OUT_TOL
            and merged_err <= K3_OUT_TOL):
        raise AssertionError(f"K3-B4 {name} {dtype}: m err {m_err}, "
                             f"output err {o_err}, merged {merged_err}")
    row = dict(fn="B4", case=name, nb=nb, pages=dtype, C=C, R=R,
               segments=segs, padding=C - n_tok, holes=holes, H=H, KV=KV,
               d=d, bs=bs, split=K3.split_count(nb * bs, k.dtype),
               m_err=m_err, out_err=o_err, merged_err=merged_err)
    if not timed:
        return row
    ms = timer(lambda: K3.paged_flash_packed_chunk(
        q, k, v, seg, tables, valid, ks, vs))
    plain_ms = timer(lambda: K3.paged_packed_chunk_plain(
        q, k, v, seg, tables, valid, ks, vs))
    # SDPA: every segment's queries (all C tokens, masked to the segment's
    # own) against its gathered pages
    smask = (valid[:, None, :] & (seg[None, :, None] == torch.arange(
        R, device=DEV)[:, None, None]))[:, None]
    q4 = q.permute(1, 0, 2)[None].expand(R, H, C, d)
    lib_ms = _sdpa_ms(torch, timer, q4, k, v, ks, vs, tables, smask, dtype)
    per_seg = valid.sum(1).cpu()
    n_valid = [int(per_seg[i]) if t else 0 for i, (t, _) in enumerate(segs)]
    tok_valid = int(per_seg[seg.long().cpu()].sum())
    moved, ops, tc_ops = k3_bytes_ops(k, ks, n_valid, tok_valid, H, d,
                                      (q, seg, tables, valid), got)
    bms, by = bound_ms(moved, ops)
    row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
               bound_by=by, bound_tc_ms=bound_tc_ms(moved, tc_ops,
                                                    ops - tc_ops),
               bytes=moved)
    return row


def phase_k3(torch, timer):
    from repro_torch.kernels import paged_chunk as K3
    gen = torch.Generator().manual_seed(SEED + 3)
    H, KV, d, bs = 15, 5, 64, 16
    rows = []
    for name, nb, dtype, segs in K3_B4_CASES:
        row = k3_b4_case(torch, timer, gen, name, nb, dtype, segs)
        emit(dict(phase="k3", **row))
        rows.append(row)
    for B, Cb, nb, dtype, cached in K3_B3_CASES:
        k, v, ks, vs, tables = chunk_pool(torch, gen, B, nb, dtype)
        valid = torch.arange(nb * bs)[None, :] < torch.tensor(cached)[:, None]
        q = torch.randn(B, Cb, H, d, generator=gen)
        q, tables, valid = (t.to(DEV) for t in (q, tables, valid))
        got = K3.paged_flash_prefill_chunk(q, k, v, tables, valid, ks, vs)
        want = K3.paged_prefill_chunk_plain(q, k, v, tables, valid, ks, vs)
        m_err, o_err = chunk_partial_errors(got, want)
        if not (m_err <= K3_M_TOL and o_err <= K3_OUT_TOL):
            raise AssertionError(f"K3-B3 {B}x{Cb} nb {nb} {dtype}: m err "
                                 f"{m_err}, output err {o_err}")
        ms = timer(lambda: K3.paged_flash_prefill_chunk(
            q, k, v, tables, valid, ks, vs))
        plain_ms = timer(lambda: K3.paged_prefill_chunk_plain(
            q, k, v, tables, valid, ks, vs))
        lib_ms = _sdpa_ms(torch, timer, q.permute(0, 2, 1, 3), k, v, ks, vs,
                          tables, valid[:, None, None, :], dtype)
        moved, ops, tc_ops = k3_bytes_ops(k, ks, cached, Cb * sum(cached),
                                          H, d, (q, tables, valid), got)
        bms, by = bound_ms(moved, ops)
        row = dict(fn="B3", B=B, C=Cb, nb=nb, pages=dtype, cached=cached,
                   H=H, KV=KV, d=d, bs=bs,
                   split=K3.split_count(nb * bs, k.dtype), m_err=m_err,
                   out_err=o_err, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bms, bound_by=by,
                   bound_tc_ms=bound_tc_ms(moved, tc_ops, ops - tc_ops),
                   bytes=moved)
        emit(dict(phase="k3", **row))
        rows.append(row)
    for name, nb, dtype, segs, holes in K3_B4_UNTIMED:
        row = k3_b4_case(torch, timer, gen, name, nb, dtype, segs,
                         holes=holes, timed=False)
        emit(dict(phase="k3", **row))
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# phase k4: the masked multi-token probe step of speculative decode

# f32, another reduction order than the plain version: K1's tolerance
K4_TOL = 1e-5
# per-slot biases whose scores (.05, .95, .27, .98, .92, .12, .97, .38)
# keep every smoothed score at least about 0.2 from lambda* = 0.6
K4_BIASES = (-3.0, 3.0, -1.0, 4.0, 2.5, -2.0, 3.5, -0.5)
K4_MODES = ("zero", "one", "T-1", "T", "mixed")


def k4_accept(torch, mode, B, T):
    if mode == "mixed":
        acc = [(i * 3) % (T + 1) for i in range(B)]
    else:
        acc = [{"zero": 0, "one": 1, "T-1": T - 1, "T": T}[mode]] * B
    return torch.tensor(acc, dtype=torch.int32, device=DEV)


def k4_state(torch, gen, B, f, win, burn_in, warm):
    """``warm``: every slot at the burn-in with its ring holding its own
    score, so a high-bias slot stops on its first boundary token and the
    rest of its chain is frozen, and slot 1 stopped on entry; otherwise a
    fresh state, where the burn-in holds every stop for burn_in scores."""
    W = (torch.randn(B, f, generator=gen) / f ** 0.5).to(DEV)
    b = torch.tensor(K4_BIASES[:B] if B > 1 else (3.0,)).to(DEV)
    ring = torch.zeros(B, win, device=DEV)
    n = torch.zeros(B, dtype=torch.int32, device=DEV)
    stopped = torch.zeros(B, dtype=torch.bool, device=DEV)
    stop_step = torch.full((B,), -1, dtype=torch.int32, device=DEV)
    if warm:
        ring[:, -burn_in:] = torch.sigmoid(b)[:, None]
        n.fill_(burn_in)
        if B > 1:
            stopped[1], stop_step[1] = True, burn_in
    return [W, b, ring, n, stopped, stop_step]


def k4_case(torch, K1, K4, gen, B, T, f, mode, warm, win=4, burn_in=2,
            eta=0.05, lam=0.6, same=False):
    """K4, its plain version and ``accept[i]`` K1 launches (T masked K1
    launches) from copies of one CUDA state: the integer and boolean state
    must be equal, the floats within K4_TOL, and K4 must equal the chained
    K1 launches bit for bit.  ``same``: zk is zq, one tensor, in K4 and in
    every K1 launch (the served no-QK view)."""
    zq = (torch.randn(B, T, f, generator=gen) / f ** 0.5).to(DEV)
    zk = zq if same else (torch.randn(B, T, f, generator=gen)
                          / f ** 0.5).to(DEV)
    bnd = torch.rand(B, T, generator=gen) < 0.7
    bnd[:, 0] = True
    bnd = bnd.to(DEV)
    acc = k4_accept(torch, mode, B, T)
    st = k4_state(torch, gen, B, f, win, burn_in, warm)
    kern, plain, chain = ([t.clone() for t in st] for _ in range(3))
    ko = K4.serving_probe_spec_step(zq, zk, bnd, acc, *kern, eta, lam,
                                    burn_in=burn_in)
    po = K4.serving_probe_spec_step_plain(zq, zk, bnd, acc, *plain, eta, lam,
                                          burn_in=burn_in)
    k1_n, k1_s, k1_sm = [], [], []
    for t in range(T):
        zq_t = zq[:, t].contiguous()
        zk_t = zq_t if same else zk[:, t].contiguous()
        o = K1.serving_probe_step(zq_t, zk_t,
                                  (bnd[:, t] & (t < acc)).contiguous(),
                                  *chain, eta, lam, burn_in=burn_in)
        k1_n.append(chain[3].clone())
        k1_s.append(o.s)
        k1_sm.append(o.smoothed)
    sync(torch)
    k1 = dict(n_seq=torch.stack(k1_n, 1), s=torch.stack(k1_s, 1),
              smoothed_seq=torch.stack(k1_sm, 1), W=chain[0], b=chain[1],
              ring=chain[2], n_scores=chain[3], stopped=chain[4],
              stop_step=chain[5])
    case = dict(B=B, T=T, f=f, accept=mode, warm=warm,
                view="same" if same else "distinct", window=win)
    for name in ("n_seq", "n_scores", "stopped", "stop_step"):
        a = getattr(ko, name)
        for other, want in (("plain", getattr(po, name)),
                            ("chained K1", k1[name])):
            if not torch.equal(a, want):
                raise AssertionError(f"K4 {case}: {name} differs from "
                                     f"{other}: {a.tolist()} vs "
                                     f"{want.tolist()}")
    err = {name: float((getattr(ko, name) - getattr(po, name)).abs().max())
           for name in ("s", "smoothed_seq", "W", "b", "ring")}
    k1_err = {name: float((getattr(ko, name) - k1[name]).abs().max())
              for name in ("s", "smoothed_seq", "W", "b", "ring")}
    if max(err.values()) > K4_TOL or max(k1_err.values()) > K4_TOL:
        raise AssertionError(f"K4 {case}: off its plain version {err} or "
                             f"chained K1 {k1_err}")
    # the spec-decode invariant: accept[i] = a is a sequential K1 launches,
    # bit for bit
    bitwise = all(torch.equal(getattr(ko, name), k1[name])
                  for name in ("s", "smoothed_seq", "W", "b", "ring"))
    if DEV == "cuda" and not bitwise:
        raise AssertionError(f"K4 {case}: not bit-equal to chained K1: "
                             f"{k1_err}")
    if mode == "zero" and not all(torch.equal(a, b)
                                  for a, b in zip(kern, st)):
        raise AssertionError(f"K4 {case}: accept = 0 moved the state")
    emitted = po.n_seq > torch.cat([st[3][:, None], po.n_seq[:, :-1]], 1)
    margin = (float((po.smoothed_seq[emitted] - lam).abs().min())
              if emitted.any() else float("inf"))
    # a stop that fired on token t < accept - 1: the rest of the chain was
    # accepted but frozen
    fired = (ko.stop_step != st[5]) & (ko.stop_step >= 0)
    fired_at = (po.n_seq == ko.stop_step[:, None]).int().argmax(1)
    mid_chain = bool((fired & (fired_at < acc - 1)).any())
    return dict(case, max_abs_err=err, chained_k1_err=k1_err,
                chained_k1_bitwise=bitwise, lambda_margin=margin,
                stops=int(fired.sum()), mid_chain_stop=mid_chain)


# timed shapes (B slots, T verify tokens, f): the served shape first (4
# slots, k = 4, smollm-360m's f 960), then more slots, a longer block, and
# both at qwen1.5-32b's width; zq and zk two tensors
K4_TIMED = ((4, 4, 960), (8, 4, 960), (4, 8, 960), (8, 8, 5120))
# the slope over the chain's length at the served width, in both views
K4_SLOPE_T = (1, 2, 4, 8)


def k4_timed(torch, timer, K1, K4, gen, B, T, f, win=4, eta=0.05, lam=1.5,
             same=False):
    """K4 and its plain version timed with every token accepted and at a
    boundary; lambda* above 1 is out of reach, so every timed call updates
    every slot's W, b and ring for all T tokens: the work the bound
    counts.  ``same``: zk is zq."""
    zq = (torch.randn(B, T, f, generator=gen) / f ** 0.5).to(DEV)
    zk = zq if same else (torch.randn(B, T, f, generator=gen)
                          / f ** 0.5).to(DEV)
    bnd = torch.ones(B, T, dtype=torch.bool, device=DEV)
    acc = k4_accept(torch, "T", B, T)
    st = k4_state(torch, gen, B, f, win, 2, False)
    ms = timer(lambda: K4.serving_probe_spec_step(zq, zk, bnd, acc, *st, eta,
                                                  lam, burn_in=2), reps=200)
    plain_ms = timer(lambda: K4.serving_probe_spec_step_plain(
        zq, zk, bnd, acc, *st, eta, lam, burn_in=2), reps=200)
    if bool(st[4].any()):
        raise AssertionError("K4 timing: a slot stopped")
    # read the inputs and the whole state once; write W, b, ring, n_scores
    # and stopped (stop_step is untouched without a stop) and the three
    # (B, T) outputs; ~7 f32 operations per feature and token (5 where zk
    # is zq: one dot)
    W, b, ring, n, stopped, _ = st
    rows = (zq,) if same else (zq, zk)
    moved = (nbytes(*rows, bnd, acc, *st) + nbytes(W, b, ring, n, stopped)
             + 3 * 4 * B * T)
    bms, by = bound_ms(moved, (5 if same else 7) * B * T * f)
    return dict(B=B, T=T, f=f, window=win, lam=lam,
                view="same" if same else "distinct", ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by, bytes=moved,
                **chain_config(K1, f, same, win))


def slope(rows) -> float:
    """Least-squares ms per token over the rows' T."""
    ts = [r["T"] for r in rows]
    ms = [r["ms"] for r in rows]
    tm, mm = sum(ts) / len(ts), sum(ms) / len(ms)
    return (sum((t - tm) * (m - mm) for t, m in zip(ts, ms))
            / sum((t - tm) ** 2 for t in ts))


def phase_k4(torch, timer):
    from repro_torch.kernels import probe_spec as K4
    from repro_torch.kernels import probe_step as K1
    gen = torch.Generator().manual_seed(SEED + 7)
    floor = floor_ms(torch, timer)
    rows = []
    for B in (1, 4, 8):
        for T in (1, 2, 4, 8):
            for f in (128, 960, 5120):
                for mode in K4_MODES:
                    rows.append(k4_case(torch, K1, K4, gen, B, T, f, mode,
                                        warm=True))
    # burn-in not reached: fresh slots at the served shape
    for T in (1, 2, 4, 8):
        row = k4_case(torch, K1, K4, gen, 4, T, 960, "T", warm=False)
        if T <= 2 and row["stops"]:
            raise AssertionError(f"K4 stopped before the burn-in: {row}")
        rows.append(row)
    # zk the same tensor as zq (one row read) and a different one, at every
    # view width, f 130 (no multiple of 4: rows move as floats) among them
    for f in VIEW_WIDTHS:
        for same in (True, False):
            for T in (1, 4, 8):
                for mode in ("T", "mixed"):
                    rows.append(k4_case(torch, K1, K4, gen, 4, T, f, mode,
                                        warm=True, same=same))
    # a smoothing window wider than the registers hold (in shared memory):
    # 24 tokens wrap a window of 17
    for win, T in ((WIDE_WINDOW, 24), (40, 8)):
        for same in (True, False):
            for mode in ("T", "mixed"):
                rows.append(k4_case(torch, K1, K4, gen, 4, T, 960, mode,
                                    warm=True, win=win, same=same))
    if not any(r["mid_chain_stop"] for r in rows):
        raise AssertionError("K4: no case stopped mid-chain")
    if min(r["lambda_margin"] for r in rows) < 1e-3:
        raise AssertionError("K4: inputs came within 1e-3 of lambda*")
    # a width above the widest config is refused
    wide = K4.MAX_F + 1
    try:
        z = torch.zeros(1, 1, wide, device=DEV)
        K4.serving_probe_spec_step(
            z, z, torch.ones(1, 1, dtype=torch.bool, device=DEV),
            torch.ones(1, dtype=torch.int32, device=DEV),
            *k4_state(torch, gen, 1, wide, 4, 2, False), 0.05, 0.6,
            burn_in=2)
    except ValueError:
        pass
    else:
        if DEV == "cuda":
            raise AssertionError(f"K4 accepted f = {wide}")

    timed = [k4_timed(torch, timer, K1, K4, gen, *shape)
             for shape in K4_TIMED]
    slopes = {}
    for same in (True, False):
        view = "same" if same else "distinct"
        slopes[view] = [k4_timed(torch, timer, K1, K4, gen, 4, T, 960,
                                 same=same) for T in K4_SLOPE_T]
    # the served shape with its window in shared memory
    wide_timed = k4_timed(torch, timer, K1, K4, gen, 4, 4, 960, win=40)
    # the kernels line's K4 time: two rows (zk another tensor) at the
    # served shape, as every slice has reported it; the served view (zk is
    # zq) beside it
    main = timed[0]
    served = next(r for r in slopes["same"] if r["T"] == 4)
    worst = max(max(r["max_abs_err"].values()) for r in rows)
    worst_k1 = max(max(r["chained_k1_err"].values()) for r in rows)
    res = dict(phase="k4", cases=len(rows), max_abs_err=worst, tol=K4_TOL,
               chained_k1_max_abs_err=worst_k1,
               chained_k1_bitwise=sum(r["chained_k1_bitwise"] for r in rows),
               mid_chain_stops=sum(r["mid_chain_stop"] for r in rows),
               lambda_margin=min(r["lambda_margin"] for r in rows),
               floor_ms=floor, timed=timed, wide_window_timed=wide_timed,
               slope_rows=slopes,
               slope_ms_per_token={v: slope(r) for v, r in slopes.items()},
               ms=main["ms"], plain_ms=main["plain_ms"],
               bound_ms=main["bound_ms"], bound_by=main["bound_by"],
               library_ms=None, served_ms=served["ms"],
               served_plain_ms=served["plain_ms"],
               served_bound_ms=served["bound_ms"], served=served,
               per_case=[(r["B"], r["T"], r["f"], r["accept"], r["warm"],
                          r["view"], r["window"],
                          max(r["max_abs_err"].values()), r["stops"])
                         for r in rows])
    emit(res)
    # K3 at the verify shape of a spec step: 4 slots x k = 4 tokens, each
    # segment with its own cache (16 to 112 positions over 7 pages)
    k3v = k3_b4_case(torch, timer, torch.Generator().manual_seed(SEED + 8),
                     "verify", 7, "bf16", [(4, 20), (4, 45), (4, 70),
                                           (4, 100)], C=16)
    emit(dict(phase="k3-verify", **k3v))
    return res


# ---------------------------------------------------------------------------
# phase k5: the offline TTT scan

# the offline split of benchmarks/common.py at smollm-360m's width
N_TRAIN, N_CAL, N_TEST, D_PHI = 500, 170, 170, 960
# the RWKV fleet's probe width: rwkv6-1.6b's d_model
RWKV_PROBE_F = 2048
K5_TOL = 1e-5


def corpus():
    from repro_torch.trajectories import corpus_splits
    return corpus_splits(N_TRAIN, N_CAL, N_TEST, d_phi=D_PHI, seed=SEED)


def k5_bytes_ops(zq, zk, c, m, w0, b0, eta, outs):
    """Each distinct input read once (the served no-QK view passes one
    tensor as both zq and zk), each output written once; about 7 f32
    operations per feature and step (two dots, the update)."""
    ins = {id(t): t for t in (zq, zk, c, m, w0, b0, eta)}
    n, T, f = zq.shape
    return nbytes(*ins.values(), *outs), 7 * n * T * f


def k5_cases(torch, test):
    """Phase k5's inputs on the card: f 128 (a QK view, d_h 128), D_PHI
    960 (the served no-QK view: the corpus's step embeddings as both zq and
    zk), 5120 (N(0, 1) features at qwen1.5-32b's width) and 2048 (the
    no-QK view at rwkv6-1.6b's d_model, as serve-rwkv fits its probe: the
    embeddings projected to 2048, one tensor as zq and zk); N 1 and 170; T
    1, 37 and 120; masks from the corpus's ragged lengths; c = 0 (deployed)
    or c = the supervised labels (the "true" inner-label mode); W0 per
    trajectory (``ttt_probe_batched``) or shared (``ttt_probe_scan``).
    The four widths run four of the kernel's instances, those of every
    width a phase of this script fits at."""
    from repro_torch.core.labels import supervised_labels
    gen = torch.Generator().manual_seed(SEED + 5)
    phis = torch.as_tensor(test.phis).to(DEV)
    mask = torch.as_tensor(test.mask).float().to(DEV)
    labels = torch.as_tensor(supervised_labels(test.correct, test.mask)
                             ).float().to(DEV)
    theta_qk = [(torch.randn(D_PHI, 128, generator=gen) / D_PHI ** 0.5)
                .to(DEV) for _ in range(2)]
    # its own generator, so that the other widths' draws stay as they were
    theta_up = (torch.randn(D_PHI, RWKV_PROBE_F, generator=torch.Generator(
        ).manual_seed(SEED + 52)) / RWKV_PROBE_F ** 0.5).to(DEV)
    z_up = phis @ theta_up
    feats = {128: (phis @ theta_qk[0], phis @ theta_qk[1]),
             D_PHI: (phis, phis),
             5120: tuple(torch.randn(len(test), phis.shape[1], 5120,
                                     generator=gen).to(DEV)
                         for _ in range(2)),
             RWKV_PROBE_F: (z_up, z_up)}
    for f, (zq_all, zk_all) in feats.items():
        w0 = (torch.randn(f, generator=gen) / f ** 0.5).to(DEV)
        w0_rows = w0 + 0.1 * (torch.randn(len(test), f, generator=gen)
                              / f ** 0.5).to(DEV)
        b0_rows = torch.linspace(-1.0, 1.0, len(test)).to(DEV)
        for n in (1, len(test)):
            for T in (1, 37, 120):
                zq = zq_all[:n, :T].contiguous()
                zk = zq if zk_all is zq_all else zk_all[:n, :T].contiguous()
                for labelled in (False, True):
                    c = (labels[:n, :T].contiguous() if labelled
                         else torch.zeros(n, T, device=DEV))
                    for shared in (True, False):
                        init = ((w0, torch.tensor(0.3, device=DEV)) if shared
                                else (w0_rows[:n].contiguous(),
                                      b0_rows[:n].contiguous()))
                        yield (dict(f=f, N=n, T=T, c="labels" if labelled
                                    else "zero", w0="shared" if shared
                                    else "per-trajectory"),
                               (zq, zk, c, mask[:n, :T].contiguous(), *init,
                                torch.tensor(0.01, device=DEV)), shared)


def k5_instances(K5):
    """Every instance of the kernel (each band of ``BANDS`` in both views):
    its figures, and on the card the library's registers, shared bytes and
    spill bytes (the query fails for an instance the library does not
    build)."""
    out = []
    for band in K5.BANDS:
        for same in (True, False):
            row = dict(f_max=band.f_max, same=same,
                       L=K5.lookahead_steps(band.f_max, same))
            if DEV == "cuda":
                row.update(K5.kernel_config(band.f_max, same))
            out.append(row)
    return out


def phase_k5(torch, timer, test):
    from repro_torch.kernels import ttt_scan as K5
    rows, worst, worst_mirror = [], 0.0, 0.0
    for case, args, shared in k5_cases(torch, test):
        zq, zk, c, m, w0, b0, eta = args
        fn = K5.ttt_probe_scan if shared else K5.ttt_probe_batched
        got = fn(*args)
        n, _, f = zq.shape
        w0_rows = w0.expand(n, f) if shared else w0
        b0_rows = b0.expand(n) if shared else b0
        want = K5.ttt_probe_batched_plain(zq, zk, c, m, w0_rows, b0_rows,
                                          eta)
        # the kernel's own L-step form, at its L for this width
        L = K5.lookahead_steps(f, zq is zk)
        mirror = K5.ttt_probe_lookahead_plain(zq, zk, c, m, w0_rows,
                                              b0_rows, eta, L)
        sync(torch)
        err = {k: float((a - b).abs().max()) if a.numel() else 0.0
               for k, a, b in zip(("scores", "W_f", "b_f"), got, want)}
        mirror_err = max(float((a - b).abs().max()) if a.numel() else 0.0
                         for a, b in zip(got, mirror))
        if not all(torch.isfinite(t).all() for t in got):
            raise AssertionError(f"K5 {case}: non-finite output")
        # f32, another summation order than the plain version's; on these
        # inputs the plain version's own f32 vs f64 spread is below 1e-6
        if max(err.values()) > K5_TOL:
            raise AssertionError(f"K5 {case} off its plain version: {err}")
        if mirror_err > K5_TOL:
            raise AssertionError(f"K5 {case} off its L = {L} form: "
                                 f"{mirror_err}")
        worst = max(worst, *err.values())
        worst_mirror = max(worst_mirror, mirror_err)
        timed = case["N"] > 1 and case["T"] == 120 and case["c"] == "zero" \
            and case["w0"] == "shared"
        if timed:
            outs = got
            case["ms"] = timer(lambda: fn(*args))
            case["plain_ms"] = timer(lambda: K5.ttt_probe_batched_plain(
                zq, zk, c, m, w0_rows, b0_rows, eta))
            moved, ops = k5_bytes_ops(*args, outs)
            case["bound_ms"], case["bound_by"] = bound_ms(moved, ops)
            case["bytes"] = moved
            # what L costs in f32: the L-step form at every L, against the
            # plain version
            case["mirror_err_by_L"] = {
                Ls: max(float((a - b).abs().max()) for a, b in zip(
                    K5.ttt_probe_lookahead_plain(zq, zk, c, m, w0_rows,
                                                 b0_rows, eta, Ls), want))
                for Ls in (1, 2, 4, 8)}
        rows.append(dict(case, L=L, max_abs_err=err, mirror_err=mirror_err))
    # the kernel's refusals: a width above the widest config (the plain
    # version has no such limit), and grad
    wide = torch.zeros(1, 1, K5.MAX_F + 1, device=DEV)
    one = torch.ones(1, 1, device=DEV)
    try:
        K5.ttt_probe_batched(wide, wide, one, one,
                             torch.zeros(1, K5.MAX_F + 1, device=DEV),
                             torch.zeros(1, device=DEV),
                             torch.tensor(0.01, device=DEV))
    except ValueError:
        pass
    else:
        if DEV == "cuda":
            raise AssertionError(f"K5 accepted f = {K5.MAX_F + 1}")
    zq, zk, c, m, w0, b0, eta = args
    try:
        K5.ttt_probe_batched(zq, zk, c, m, w0.clone().requires_grad_(True),
                             b0, eta)
    except RuntimeError:
        pass
    else:
        raise AssertionError("K5 accepted a tensor that requires grad")
    served = next(r for r in rows if r.get("ms") is not None and
                  r["f"] == D_PHI)
    res = dict(phase="k5", cases=len(rows), max_abs_err=worst, tol=K5_TOL,
               max_mirror_err=worst_mirror,
               instances=k5_instances(K5),
               served=served, timed=[r for r in rows if "ms" in r],
               per_case=[(r["f"], r["N"], r["T"], r["c"], r["w0"], r["L"],
                          max(r["max_abs_err"].values()), r["mirror_err"])
                         for r in rows])
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phase k6: dense flash decode (B7)

# bf16 / f32 caches upcast exactly; f32 sums in another order (per-warp
# online softmax, then a cross-warp merge) than the plain one-shot
# softmax, and p rounded to the cache dtype against a running instead of
# the row's maximum: K2's tolerances, m to 1e-4, normalised output to 2e-3
# of max(1, max|v|), the scale of an attention output (a random-weight
# model's values are not unit-sized)
K6_M_TOL, K6_OUT_TOL = 1e-4, 2e-3


def v_scale(v) -> float:
    return max(1.0, float(v.float().abs().max()))
# (B, S, cache dtype, timed): the served dense shape (4 slots, 16 + 96
# positions), the harvest's (24 trajectories), a long cache, then S 16 and
# 113 (no multiple of the warps' 64-position stride) and f32 caches; long
# caches split over blocks past 256 positions: (24, 4096), (4, 1024) and
# f32 at 4096 (B > 2: a window band in row 1, an empty row 2)
K6_CASES = [(4, 112, "bf16", True), (24, 112, "bf16", True),
            (8, 4096, "bf16", True), (1, 16, "bf16", False),
            (1, 113, "f32", False), (4, 113, "bf16", False),
            (24, 16, "f32", False), (4, 112, "f32", False),
            (24, 4096, "bf16", True), (4, 1024, "bf16", True),
            (4, 4096, "f32", False)]


def dense_case(torch, gen, B, S, dtype, H=15, KV=5, d=64):
    """A dense cache with row 0 fully valid, ragged tails, and for B > 2 a
    sliding-window band (row 1) and a row with no valid position (row
    2)."""
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    q = torch.randn(B, H, d, generator=gen).to(dt).to(DEV)
    k = torch.randn(B, KV, S, d, generator=gen).to(dt).to(DEV)
    v = torch.randn(B, KV, S, d, generator=gen).to(dt).to(DEV)
    lens = torch.randint(1, S + 1, (B,), generator=gen)
    lens[0] = S
    pos = torch.arange(S)[None, :]
    valid = pos < lens[:, None]
    if B > 2:
        valid[1] = (pos[0] >= S // 4) & (pos[0] < S // 4 + max(S // 3, 1))
        valid[2] = False
    return q, k, v, valid.to(DEV)


def phase_k6(torch, timer):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as K6
    from repro_torch.kernels import split as SP
    gen = torch.Generator().manual_seed(SEED + 6)
    rows = []
    for B, S, dtype, timed in K6_CASES:
        q, k, v, valid = dense_case(torch, gen, B, S, dtype)
        o, l, m = K6.flash_decode(q, k, v, valid, return_partials=True)
        want = K6.flash_decode_plain(q, k, v, valid, return_partials=True)
        m_err, o_err = partial_errors((o, l, m), want, valid)
        empty = ~valid.any(1)
        if not (m_err <= K6_M_TOL and o_err <= K6_OUT_TOL * v_scale(v)):
            raise AssertionError(f"K6 {B}x{S} {dtype}: m err {m_err}, "
                                 f"output err {o_err}")
        if empty.any() and not (float(o[empty].abs().max()) == 0.0
                                and float(l[empty].abs().max()) == 0.0
                                and bool((m[empty] == -1e30).all())):
            raise AssertionError(f"K6 {B}x{S} {dtype}: an empty row is not "
                                 "(o, l, m) = (0, 0, -1e30)")
        # the normalised output as well (B7's function), in q's dtype
        out = K6.flash_decode(q, k, v, valid)
        pout = K6.flash_decode_plain(q, k, v, valid)
        live = valid.any(1)
        n_err = float((out.float() - pout.float())[live].abs().max())
        if n_err > (K6_OUT_TOL * v_scale(v)
                    + (2.0 ** -7 if dtype == "bf16" else 0.0)):
            raise AssertionError(f"K6 {B}x{S} {dtype}: normalised output "
                                 f"err {n_err}")
        H, KV, d = q.shape[1], k.shape[1], q.shape[2]
        n_split = SP.split_count(S, SP.DECODE_MAX_SPLITS)
        row = dict(B=B, S=S, cache=dtype, H=H, KV=KV, d=d,
                   valid_positions=int(valid.sum()),
                   empty_rows=int(empty.sum()), splits=n_split,
                   merge=n_split > 1, m_err=m_err, out_err=o_err,
                   normalised_err=n_err)
        if timed:
            row["ms"] = timer(lambda: K6.flash_decode(
                q, k, v, valid, return_partials=True))
            row["plain_ms"] = timer(lambda: K6.flash_decode_plain(
                q, k, v, valid, return_partials=True))
            # yardstick: SDPA over the same cache and mask, KV heads
            # repeated to the query heads (outside the timing)
            kr = k.repeat_interleave(H // KV, dim=1)
            vr = v.repeat_interleave(H // KV, dim=1)
            mask = valid[:, None, None, :]
            row["library_ms"] = timer(lambda: F.scaled_dot_product_attention(
                q[:, :, None, :], kr, vr, attn_mask=mask))
            # bytes this data needs: K and V of the valid positions, q,
            # valid, and the (o, l, m) written
            n_valid = row["valid_positions"]
            moved = (n_valid * KV * d * k.element_size() * 2
                     + nbytes(q, valid, o, l, m))
            row["bound_ms"], row["bound_by"] = bound_ms(
                moved, n_valid * H * (4 * d + 4))
            row["bytes"] = moved
            # the kernel's share of one decode step, 32 layers
            row["per_step_ms"] = 32 * row["ms"]
            if (B, S) == (8, 4096):
                from repro_torch.kernels import _build
                p = _build.ptr
                qg = q.reshape(B, KV, H // KV, d)
                split_sweep(torch, timer, "k6", lambda n, parts: (
                    _build.library().flash_decode_launch(
                        p(qg), p(k), p(v), p(valid), p(o), p(l), p(m),
                        *parts, B, KV, H // KV, d, S, n,
                        K6._DTYPE_CODE[k.dtype], float(1.0 / d ** 0.5),
                        _build.stream_of(q))), (o, l, m), S)
        emit(dict(phase="k6", **row))
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# phase k7: flash prefill attention (B8)

# f32: another summation order than the einsum (online softmax over 64-key
# tiles), 2e-5 of max(1, max|v|); bf16 inputs: the same f32 values, then
# the bf16 cast of the output, which may land one bf16 ulp (2^-7 of the
# value) apart
K7_F32_TOL = 2e-5
K7_BF16_RTOL = 2.0 ** -7
# (B, Sq, Sk, window, dtype, timed): the harvest's and an admission's
# prefill (16 tokens), the chunked fleets' 160-token prompts, a long
# prompt; f32 (phase model's float32 model); a window of 64, Sq < Sk, and
# a window past the keys (rows 23 on see no key)
K7_CASES = [(1, 16, 16, None, "bf16", True), (24, 16, 16, None, "bf16", True),
            (1, 160, 160, None, "bf16", True),
            (24, 160, 160, None, "bf16", True),
            (4, 2048, 2048, None, "bf16", True),
            (24, 16, 16, None, "f32", True),
            (24, 160, 160, None, "f32", True),
            (24, 160, 160, 64, "bf16", False),
            (4, 2048, 2048, 64, "f32", False),
            (4, 64, 160, None, "bf16", False),
            (1, 48, 16, 8, "f32", False)]


def visible_pairs(sq, sk, window):
    """(query, key) pairs the causal / window mask leaves, per head."""
    n = 0
    for i in range(sq):
        hi = min(i, sk - 1)
        lo = max(0, i - window + 1) if window else 0
        n += max(0, hi - lo + 1)
    return n


def k7_error(out, want, v):
    """Largest |kernel - plain|, and whether it is within K7's tolerance
    (f32: K7_F32_TOL of the value scale; bf16: that plus one ulp of the
    plain value)."""
    diff = (out.float() - want.float()).abs()
    lim = K7_F32_TOL * v_scale(v)
    if out.dtype.itemsize == 2:                     # bf16
        lim = K7_BF16_RTOL * want.float().abs() + lim
    return float(diff.max()), bool((diff <= lim).all())


def phase_k7(torch, timer):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as K7
    gen = torch.Generator().manual_seed(SEED + 7)
    H, KV, d = 15, 5, 64
    rows = []
    for B, sq, sk, window, dtype, timed in K7_CASES:
        dt = torch.bfloat16 if dtype == "bf16" else torch.float32
        q = torch.randn(B, sq, H, d, generator=gen).to(dt).to(DEV)
        k = torch.randn(B, sk, KV, d, generator=gen).to(dt).to(DEV)
        v = torch.randn(B, sk, KV, d, generator=gen).to(dt).to(DEV)
        out = K7.flash_attention(q, k, v, causal=True, window=window)
        want = K7.attn_prefill_einsum(q, k, v, causal=True, window=window)
        err, ok = k7_error(out, want, v)
        if not ok or not torch.isfinite(out.float()).all():
            raise AssertionError(f"K7 {B}x{sq}x{sk} window {window} "
                                 f"{dtype}: err {err}")
        row = dict(B=B, Sq=sq, Sk=sk, window=window, dtype=dtype, H=H,
                   KV=KV, d=d, max_abs_err=err)
        if timed:
            row["ms"] = timer(lambda: K7.flash_attention(
                q, k, v, causal=True, window=window))
            row["plain_ms"] = timer(lambda: K7.attn_prefill_einsum(
                q, k, v, causal=True, window=window))
            # yardstick: SDPA with is_causal on (B, H, S, d), KV heads
            # repeated (outside the timing)
            qt = q.transpose(1, 2).contiguous()
            kt = k.transpose(1, 2).repeat_interleave(H // KV, 1).contiguous()
            vt = v.transpose(1, 2).repeat_interleave(H // KV, 1).contiguous()
            row["library_ms"] = timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True))
            pairs = visible_pairs(sq, sk, window)
            moved = nbytes(q, k, v, out)
            row["bound_ms"], row["bound_by"] = bound_ms(
                moved, B * H * pairs * (4 * d + 4))
            row["bound_tc_ms"] = bound_tc_ms(moved, B * H * pairs * 4 * d,
                                             B * H * pairs * 4)
            row["bytes"] = moved
            row["visible_pairs_per_head"] = pairs
        emit(dict(phase="k7", **row))
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# phase model: full-width model, teacher-forced

def _positions_reversed(K2):
    """The plain paged attention with each row's positions in reverse
    order (its pages reversed, and the slots within each page): the same
    softmax over the same positions, summed in another order from the
    first step on, also while the prompt fits in one page."""
    def flip(t):
        return None if t is None else t.flip(2)

    def fn(q, k, v, tables, valid, ks=None, vs=None, *,
           return_partials=False):
        return K2.paged_decode_plain(q, flip(k), flip(v), tables.flip(1),
                                     valid.flip(1), flip(ks), flip(vs),
                                     return_partials=return_partials)
    return fn


class CheckedK2:
    """K2 on the inputs the model gives it, each call held against the
    plain version on the same inputs with phase k2's tolerances (m relative
    to max(1, |m|)): a dropped page or a wrong scale fails on the call that
    makes it."""

    def __init__(self, K2):
        self.K2 = K2
        self.calls, self.m_err, self.out_err = 0, 0.0, 0.0

    def __call__(self, q, k, v, tables, valid, ks=None, vs=None, *,
                 return_partials=False):
        assert return_partials, "the model folds in the current token"
        got = self.K2.paged_flash_decode(q, k, v, tables, valid, ks, vs,
                                         return_partials=True)
        want = self.K2.paged_decode_plain(q, k, v, tables, valid, ks, vs,
                                          return_partials=True)
        m_err, o_err = partial_errors(got, want, valid, m_relative=True)
        if not (m_err <= K2_M_TOL and o_err <= K2_OUT_TOL):
            raise AssertionError(f"K2 in the model, call {self.calls}: "
                                 f"relative m err {m_err}, output err "
                                 f"{o_err}")
        self.calls += 1
        self.m_err = max(self.m_err, m_err)
        self.out_err = max(self.out_err, o_err)
        return got


def teacher_forced(torch, model, params, prompt, feed, impls, bs=16):
    """Prefill, copy the prompt K/V into one page pool per paged attention
    implementation, then decode the same fed tokens through each (the
    model's ``paged_flash_decode`` swapped for it).  ``impls`` holds
    (paged decode, prefill attention) pairs; a prefill attention of None
    is the served one (K7 on the card), any other is swapped in for the
    prefill of its pool.  Returns the max |logit - logit of impls[0]| per
    step for each other pair, and the largest |logit|."""
    from repro_torch.models import attention as A
    cfg = model.cfg
    B, S = prompt.shape
    steps = feed.shape[0]
    nb = -(-(S + steps) // bs)
    served_prefill = A.flash_attention
    prefilled = {}
    try:
        for _, pre_impl in impls:
            if pre_impl not in prefilled:
                A.flash_attention = pre_impl or served_prefill
                prefilled[pre_impl], _, _ = model.prefill(
                    cfg, params, {"tokens": prompt}, nb * bs)
    finally:
        A.flash_attention = served_prefill
    table = (1 + torch.arange(B * nb)).reshape(B, nb).to(torch.int32).to(DEV)
    states = []
    for _, pre_impl in impls:
        pre = prefilled[pre_impl]
        st = model.init_paged_state(B, B * nb + 1, bs, nb, device=DEV)
        pages = {k: v for k, v in st.items() if k != "block_tables"}
        for i in range(B):
            A.prefill_to_pages(pages, {k: v[:, i:i + 1] for k, v in
                                       pre.items()}, table[i], -(-S // bs))
        st["block_tables"].copy_(table)
        states.append(st)
    diffs = [[] for _ in impls[1:]]
    scale = 0.0
    served = A.paged_flash_decode
    try:
        for t in range(steps):
            pos = torch.full((B,), S + t, dtype=torch.int32, device=DEV)
            logits = []
            for (impl, _), st in zip(impls, states):
                A.paged_flash_decode = impl
                lg, _, _ = model.decode_step(cfg, params, feed[t], st, pos)
                lg = lg[:, :cfg.vocab_size].float()
                if not torch.isfinite(lg).all():
                    raise AssertionError(f"non-finite logits at step {t}")
                logits.append(lg)
            scale = max(scale, float(logits[0].abs().max()))
            for d, lg in zip(diffs, logits[1:]):
                d.append(float((lg - logits[0]).abs().max()))
    finally:
        A.paged_flash_decode = served
    return diffs, scale


class CheckedK6:
    """K6 on the inputs the model gives it, each call held against the
    plain version on the same inputs with phase k6's tolerances (m relative
    to max(1, |m|), the model's scores reach tens)."""

    def __init__(self, K6):
        self.K6 = K6
        self.calls, self.m_err, self.out_err = 0, 0.0, 0.0

    def __call__(self, q, k, v, valid, *, return_partials=False):
        assert return_partials, "the model folds in the current token"
        got = self.K6.flash_decode(q, k, v, valid, return_partials=True)
        want = self.K6.flash_decode_plain(q, k, v, valid,
                                          return_partials=True)
        m_err, o_err = partial_errors(got, want, valid, m_relative=True)
        if not (m_err <= K6_M_TOL and o_err <= K6_OUT_TOL * v_scale(v)):
            raise AssertionError(f"K6 in the model, call {self.calls}: "
                                 f"relative m err {m_err}, output err "
                                 f"{o_err}")
        self.calls += 1
        self.m_err = max(self.m_err, m_err)
        self.out_err = max(self.out_err, o_err)
        return got


class CheckedK7:
    """K7 on the inputs the model gives it, each call held against the
    plain version on the same inputs with phase k7's tolerances."""

    def __init__(self, K7):
        self.K7 = K7
        self.calls, self.err = 0, 0.0

    def __call__(self, q, k, v, *, causal=True, window=None):
        got = self.K7.flash_attention(q, k, v, causal=causal, window=window)
        want = self.K7.attn_prefill_einsum(q, k, v, causal=causal,
                                             window=window)
        err, ok = k7_error(got, want, v)
        if not ok:
            raise AssertionError(f"K7 in the model, call {self.calls}: err "
                                 f"{err}")
        self.calls += 1
        self.err = max(self.err, err)
        return got


def dense_teacher_forced(torch, model, params, prompt, feed, impls):
    """Prefill the prompt into a dense cache and decode the same fed
    tokens, once per (decode, prefill) attention pair in ``impls`` (the
    model's ``flash_decode`` and ``flash_attention`` swapped for it).
    Returns each pair's logits per step."""
    from repro_torch.models import attention as A
    cfg = model.cfg
    B, S = prompt.shape
    served = A.flash_decode, A.flash_attention
    runs = []
    try:
        for dec, pre in impls:
            A.flash_decode, A.flash_attention = dec, pre
            cache, _, _ = model.prefill(cfg, params, {"tokens": prompt},
                                        S + feed.shape[0])
            logits = []
            for t in range(feed.shape[0]):
                pos = torch.full((B,), S + t, dtype=torch.int32, device=DEV)
                lg, _, _ = model.decode_step(cfg, params, feed[t], cache, pos)
                lg = lg[:, :cfg.vocab_size].float()
                if not torch.isfinite(lg).all():
                    raise AssertionError(f"dense: non-finite logits at step "
                                         f"{t}")
                logits.append(lg)
            runs.append(logits)
    finally:
        A.flash_decode, A.flash_attention = served
    return runs


def dense_path(torch, model, params, prompt, feed, exact_argmax):
    """The dense path of one model: K7's prefill and K6's decode steps,
    every call checked, against the plain versions.  With
    ``exact_argmax`` (f32) every step's argmax must equal the plain
    path's and the logits sit within 2^-10 of the largest."""
    from repro_torch.kernels import flash_attention as K7
    from repro_torch.kernels import flash_decode as K6
    k6, k7 = CheckedK6(K6), CheckedK7(K7)
    kern, plain = dense_teacher_forced(
        torch, model, params, prompt, feed,
        [(k6, k7), (K6.flash_decode_plain, K7.attn_prefill_einsum)])
    diffs = [float((a - b).abs().max()) for a, b in zip(kern, plain)]
    agree = [float((a.argmax(-1) == b.argmax(-1)).float().mean())
             for a, b in zip(kern, plain)]
    scale = max(float(b.abs().max()) for b in plain)
    res = dict(k6_calls=k6.calls, k6_m_rel_err=k6.m_err,
               k6_out_err=k6.out_err, k7_calls=k7.calls, k7_err=k7.err,
               max_logit_diff_per_step=diffs, argmax_agree_per_step=agree,
               max_abs_logit=scale)
    if exact_argmax:
        res["bound"] = scale * 2.0 ** -10
        if min(agree) < 1.0:
            raise AssertionError(f"dense f32: argmax differs from the plain "
                                 f"path at step {agree.index(min(agree))}")
        if max(diffs) > res["bound"]:
            raise AssertionError(f"dense f32: logits {max(diffs)} from the "
                                 f"plain path > {res['bound']}")
    return res


def phase_model(torch, reduced: bool = False):
    """Full-width smollm-360m, teacher-forced: K2 against the plain paged
    attention, in bf16 (as served) and with the same weights in float32.
    Every K2 call is also held against the plain version on its own
    inputs (``CheckedK2``).  Then the dense path: the prompt through K7,
    the fed tokens through K6 on a dense cache, every call checked, against
    the plain versions (``dense_path``)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as K7
    from repro_torch.kernels import paged_decode as K2
    from repro_torch.models import build
    cfg = get_config("smollm-360m")
    if reduced:
        cfg = cfg.reduced()
    model = build(cfg)
    gen = torch.Generator().manual_seed(SEED)
    params = model.init(gen, DEV)
    n_params = sum(t.numel() for t in _leaves(params))
    B, S, steps = 4, 16, 64
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           dtype=torch.int32).to(DEV)
    feed = torch.randint(0, cfg.vocab_size, (steps, B), generator=gen,
                         dtype=torch.int32).to(DEV)
    plain = K2.paged_decode_plain
    checked = CheckedK2(K2)
    (k2, rev, pre_spread), scale = teacher_forced(
        torch, model, params, prompt, feed,
        [(plain, None), (checked, None), (_positions_reversed(K2), None),
         (plain, K7.attn_prefill_einsum)])
    # bf16 logits: K2, the position-reversed plain version and the prompt
    # prefilled through the einsum in place of K7 all compute the same
    # functions with their f32 sums in another order.  The bf16 cast of each attention output turns such
    # a reordering into one-ulp flips, which a random-weight 32-layer stack
    # amplifies on the way to the logits.  The floor at step t is the
    # larger difference the two reference reorderings show there; the
    # logits of K2 are held to 8x the largest floor up to step t, plus one
    # bf16 ulp of the largest logit.  The prefill's reordering gives the
    # floor a value from step 0, where reversing the positions of a prompt
    # in one page can flip nothing.  The kernel itself is held per call by
    # CheckedK2 above.
    floor = [max(a, b) for a, b in zip(rev, pre_spread)]
    ulp = scale * 2.0 ** -8
    bound = [8 * max(floor[:t + 1]) + ulp for t in range(steps)]
    over = [t for t in range(steps) if k2[t] > bound[t]]
    if over:
        t = over[0]
        raise AssertionError(f"bf16 step {t}: K2 vs plain paged logits "
                             f"{k2[t]} > {bound[t]} (reordering spread "
                             f"{max(floor[:t + 1])})")
    # float32, the same weights: no bf16 cast between layers, so the two
    # orders differ by f32 rounding (~1e-7) times the same amplification
    # (~20x, from 2^-8 to ~8% in bf16); 2^-10 of the largest logit leaves
    # two orders of magnitude of room
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                kv_cache_dtype="float32")
    params32 = _tree(params, lambda t: t.float())
    checked32 = CheckedK2(K2)
    (k2_32,), scale32 = teacher_forced(torch, build(cfg32), params32,
                                       prompt, feed,
                                       [(plain, None), (checked32, None)])
    bound32 = scale32 * 2.0 ** -10
    if max(k2_32) > bound32:
        raise AssertionError(f"f32: K2 vs plain paged logits {max(k2_32)} "
                             f"> {bound32}")
    dense = dense_path(torch, model, params, prompt, feed, False)
    dense32 = dense_path(torch, build(cfg32), params32, prompt, feed, True)
    res = dict(phase="model", arch=cfg.name, layers=cfg.n_layers,
               d_model=cfg.d_model, heads=cfg.n_heads,
               kv_heads=cfg.n_kv_heads, d_head=cfg.d_head, d_ff=cfg.d_ff,
               vocab=cfg.vocab_size, params=n_params, dtype=cfg.dtype,
               batch=B, prompt=S, decode_steps=steps,
               bf16=dict(k2_calls=checked.calls,
                         k2_m_rel_err=checked.m_err,
                         k2_out_err=checked.out_err,
                         max_logit_diff_per_step=k2,
                         reversed_plain_diff_per_step=rev,
                         einsum_prefill_diff_per_step=pre_spread,
                         max_abs_logit=scale, bound_per_step=bound),
               f32=dict(k2_calls=checked32.calls,
                        k2_m_rel_err=checked32.m_err,
                        k2_out_err=checked32.out_err,
                        max_logit_diff_per_step=k2_32,
                        max_abs_logit=scale32, bound=bound32),
               dense=dict(bf16=dense, f32=dense32))
    emit(res)
    return res


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# phase model-chunked: full-width model, chunked and packed prefill

class CheckedK3:
    """One K3 entry point (B3 or B4) on the inputs the model gives it, each
    call held against its plain version on the same inputs with phase k3's
    tolerances (m relative to max(1, |m|), the model's scores reach tens).
    Returns the kernel's partials."""

    def __init__(self, kernel, plain):
        self.kernel, self.plain = kernel, plain
        self.calls, self.m_err, self.out_err = 0, 0.0, 0.0

    def __call__(self, *args):
        got = self.kernel(*args)
        m_err, o_err = chunk_partial_errors(got, self.plain(*args),
                                            m_relative=True)
        if not (m_err <= K3_M_TOL and o_err <= K3_OUT_TOL):
            raise AssertionError(f"K3 in the model, call {self.calls}: "
                                 f"relative m err {m_err}, output err "
                                 f"{o_err}")
        self.calls += 1
        self.m_err = max(self.m_err, m_err)
        self.out_err = max(self.out_err, o_err)
        return got


CHUNK, BS = 64, 16


def prefill_three(torch, model, params, prompts, impls):
    """Three requests into one page pool: A through ``Model.prefill_chunk``
    in 64-token chunks (B3); B's first 64 tokens through a one-segment
    ``prefill_packed`` chunk, then B's remaining tokens packed with all of
    C in one chunk (B4).  ``impls`` (B3, B4) replace the model's K3 entry
    points for the run; None prefills each request in one shot instead.
    Returns the state, with every row's block table set."""
    from repro_torch.models import attention as A
    cfg = model.cfg
    lens = [len(p) for p in prompts]
    nb = -(-(max(lens) + 1) // BS)
    table = (1 + torch.arange(3 * nb)).reshape(3, nb).to(torch.int32).to(DEV)
    st = model.init_paged_state(3, 3 * nb + 1, BS, nb, device=DEV)
    pages = {k: v for k, v in st.items() if k != "block_tables"}
    if impls is None:
        for i, p in enumerate(prompts):
            n = -(-len(p) // BS)
            pre, _, _ = model.prefill(cfg, params, {"tokens": p[None]}, n * BS)
            A.prefill_to_pages(pages, pre, table[i], n)
    else:
        served = A.paged_flash_prefill_chunk, A.paged_flash_packed_chunk
        A.paged_flash_prefill_chunk, A.paged_flash_packed_chunk = impls
        try:
            a, b, c = prompts
            zero = torch.zeros(1, dtype=torch.long, device=DEV)
            for start in range(0, len(a), CHUNK):
                n = min(CHUNK, len(a) - start)
                buf = torch.zeros(1, CHUNK, dtype=torch.int32, device=DEV)
                buf[0, :n] = a[start:start + n]
                model.prefill_chunk(cfg, params, buf, st, zero, start, n,
                                    block_rows=table[0:1])
            i32 = dict(dtype=torch.int32, device=DEV)
            slots = torch.tensor([1, 2], **i32)
            model.prefill_packed(cfg, params, b[:CHUNK], st,
                                 torch.zeros(CHUNK, **i32), slots,
                                 torch.tensor([0, 0], **i32),
                                 torch.tensor([CHUNK, 0], **i32),
                                 table[1:3])
            tail = len(b) - CHUNK
            assert tail + len(c) == CHUNK, "B's tail and C fill one chunk"
            model.prefill_packed(cfg, params, torch.cat([b[CHUNK:], c]), st,
                                 torch.tensor([0] * tail + [1] * len(c),
                                              **i32), slots,
                                 torch.tensor([CHUNK, 0], **i32),
                                 torch.tensor([tail, len(c)], **i32),
                                 table[1:3])
        finally:
            A.paged_flash_prefill_chunk, A.paged_flash_packed_chunk = served
    st["block_tables"].copy_(table)
    return st, table


def prompt_pages(torch, state, table, lens):
    """Each request's prompt K/V read back from the pool, concatenated:
    (L, KV, sum(lens), dh) f32 for "k" and "v"."""
    out = {}
    for key in ("k", "v"):
        parts = []
        for i, n in enumerate(lens):
            pg = state[key][:, table[i].long()]      # (L, nb, KV, bs, dh)
            L, nb, kv, bs, dh = pg.shape
            parts.append(pg.permute(0, 2, 1, 3, 4).reshape(
                L, kv, nb * bs, dh)[:, :, :n].float())
        out[key] = torch.cat(parts, dim=2)
    return out


def chunked_vs_one_shot(torch, model, params, prompts, feed):
    """Prefill the three requests one shot, chunked through K3 (every call
    checked) and chunked through K3's plain versions; then one decode step
    of the same fed token on each.  Returns the max page and next-step
    logit differences from one shot, of the K3 run and of the plain run,
    the scales, and the checked calls."""
    from repro_torch.kernels import paged_chunk as K3
    cfg = model.cfg
    lens = [len(p) for p in prompts]
    b3 = CheckedK3(K3.paged_flash_prefill_chunk, K3.paged_prefill_chunk_plain)
    b4 = CheckedK3(K3.paged_flash_packed_chunk, K3.paged_packed_chunk_plain)
    runs = {"one_shot": None, "k3": (b3, b4),
            "plain": (K3.paged_prefill_chunk_plain,
                      K3.paged_packed_chunk_plain)}
    pages, logits = {}, {}
    pos = torch.tensor(lens, dtype=torch.int32, device=DEV)
    for name, impls in runs.items():
        st, table = prefill_three(torch, model, params, prompts, impls)
        pages[name] = prompt_pages(torch, st, table, lens)
        lg, _, _ = model.decode_step(cfg, params, feed, st, pos)
        lg = lg[:, :cfg.vocab_size].float()
        if not torch.isfinite(lg).all():
            raise AssertionError(f"{name}: non-finite logits")
        logits[name] = lg
    res = {}
    for name in ("k3", "plain"):
        res[f"{name}_page_diff"] = max(
            float((pages[name][k] - pages["one_shot"][k]).abs().max())
            for k in ("k", "v"))
        res[f"{name}_logit_diff"] = float(
            (logits[name] - logits["one_shot"]).abs().max())
    res["page_scale"] = max(float(pages["one_shot"][k].abs().max())
                            for k in ("k", "v"))
    res["logit_scale"] = float(logits["one_shot"].abs().max())
    res.update(b3_calls=b3.calls, b4_calls=b4.calls,
               k3_m_rel_err=max(b3.m_err, b4.m_err),
               k3_out_err=max(b3.out_err, b4.out_err))
    return res


def phase_model_chunked(torch, reduced: bool = False):
    """Full-width smollm-360m: chunked and packed prefill through K3 held
    to one-shot prefill, in bf16 (as served) and with the same weights in
    float32."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build
    cfg = get_config("smollm-360m")
    if reduced:
        cfg = cfg.reduced()
    model = build(cfg)
    gen = torch.Generator().manual_seed(SEED + 4)
    params = model.init(gen, DEV)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen,
                             dtype=torch.int32).to(DEV)
               for n in (160, 100, 28)]
    feed = torch.randint(0, cfg.vocab_size, (3,), generator=gen,
                         dtype=torch.int32).to(DEV)
    bf16 = chunked_vs_one_shot(torch, model, params, prompts, feed)
    # bf16: chunked prefill and one shot sum the same attention in another
    # order (online softmax over pages, then the chunk's own keys, against
    # one softmax), and every layer's bf16 cast turns that into one-ulp
    # flips the random-weight stack amplifies; K3 and its plain version are
    # two such orders.  So K3's distance from one shot is held to 8x the
    # plain version's own distance plus one bf16 ulp of the largest value,
    # as phase model holds K2 (the kernel itself is held per call above)
    for what in ("page", "logit"):
        bound = 8 * bf16[f"plain_{what}_diff"] + bf16[f"{what}_scale"] * 2**-8
        bf16[f"{what}_bound"] = bound
        if bf16[f"k3_{what}_diff"] > bound:
            raise AssertionError(f"bf16 chunked vs one-shot {what}s: "
                                 f"{bf16[f'k3_{what}_diff']} > {bound}")
    # float32, the same weights: no bf16 cast between layers, so the orders
    # differ by f32 rounding times the same amplification; 2^-10 of the
    # largest value, phase model's f32 bound
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                kv_cache_dtype="float32")
    f32 = chunked_vs_one_shot(torch, build(cfg32), _tree(params, lambda t:
                                                         t.float()),
                              prompts, feed)
    for what in ("page", "logit"):
        bound = f32[f"{what}_scale"] * 2**-10
        f32[f"{what}_bound"] = bound
        for run in ("k3", "plain"):
            if f32[f"{run}_{what}_diff"] > bound:
                raise AssertionError(f"f32 chunked ({run}) vs one-shot "
                                     f"{what}s: {f32[f'{run}_{what}_diff']}"
                                     f" > {bound}")
    res = dict(phase="model-chunked", arch=cfg.name, layers=cfg.n_layers,
               prompts=[len(p) for p in prompts], chunk=CHUNK, bf16=bf16,
               f32=f32)
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phase model-spec: the verify pass against sequential decode

def verify_vs_decode(torch, model, params, prompt, feed, bs=16):
    """Prefill once into two page pools; feed the same k tokens per slot
    through k sequential ``decode_step``s (K2) on one and through one
    ``verify_packed`` chunk (4 slots x k tokens, K3 held per call against
    its plain version) on the other.  Returns the largest logit, hidden and
    page differences, the scales, and the share of equal argmaxes."""
    from repro_torch.kernels import paged_chunk as K3
    from repro_torch.models import attention as A
    cfg = model.cfg
    B, S = prompt.shape
    k = feed.shape[0]
    nb = -(-(S + k) // bs)
    pre, _, _ = model.prefill(cfg, params, {"tokens": prompt}, nb * bs)
    table = (1 + torch.arange(B * nb)).reshape(B, nb).to(torch.int32).to(DEV)
    states = []
    for _ in range(2):
        st = model.init_paged_state(B, B * nb + 1, bs, nb, device=DEV)
        pages = {key: v for key, v in st.items() if key != "block_tables"}
        for i in range(B):
            A.prefill_to_pages(pages, {key: v[:, i:i + 1]
                                       for key, v in pre.items()},
                               table[i], -(-S // bs))
        st["block_tables"].copy_(table)
        states.append(st)
    dec_l, dec_h = [], []
    for t in range(k):
        pos = torch.full((B,), S + t, dtype=torch.int32, device=DEV)
        lg, h, _ = model.decode_step(cfg, params, feed[t], states[0], pos)
        dec_l.append(lg[:, :cfg.vocab_size].float())
        dec_h.append(h.float())
    dec_l, dec_h = torch.stack(dec_l, 1), torch.stack(dec_h, 1)
    i32 = dict(dtype=torch.int32, device=DEV)
    checked = CheckedK3(K3.paged_flash_packed_chunk,
                        K3.paged_packed_chunk_plain)
    served = A.paged_flash_packed_chunk
    A.paged_flash_packed_chunk = checked
    try:
        lg, h, _ = model.verify_packed(
            cfg, params, feed.T.reshape(-1).contiguous(), states[1],
            torch.arange(B, **i32).repeat_interleave(k), torch.arange(B, **i32),
            torch.full((B,), S, **i32), torch.full((B,), k, **i32),
            states[1]["block_tables"])
    finally:
        A.paged_flash_packed_chunk = served
    ver_l = lg[:, :cfg.vocab_size].float().reshape(B, k, -1)
    ver_h = h.float().reshape(B, k, -1)
    if not (torch.isfinite(ver_l).all() and torch.isfinite(dec_l).all()):
        raise AssertionError("non-finite logits")
    page_diff = 0.0
    for key in ("k", "v"):
        a, b = (st[key][:, table.long()].float() for st in states)
        page_diff = max(page_diff, float((a - b).abs().max()))
    return dict(max_logit_diff=float((ver_l - dec_l).abs().max()),
                max_hidden_diff=float((ver_h - dec_h).abs().max()),
                max_page_diff=page_diff,
                max_abs_logit=float(dec_l.abs().max()),
                argmax_equal_share=float((ver_l.argmax(-1)
                                          == dec_l.argmax(-1)).float()
                                         .mean()),
                k3_calls=checked.calls, k3_m_rel_err=checked.m_err,
                k3_out_err=checked.out_err)


def phase_model_spec(torch, reduced: bool = False):
    """Full-width smollm-360m, teacher-forced: ``verify_packed_chunk`` on 4
    slots x k = 4 against 4 sequential ``decode_step``s on paged KV, in
    bf16 (as served) and with the same weights in float32."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build
    cfg = get_config("smollm-360m")
    if reduced:
        cfg = cfg.reduced()
    model = build(cfg)
    gen = torch.Generator().manual_seed(SEED + 6)
    params = model.init(gen, DEV)
    B, S, k = 4, 16, 4
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           dtype=torch.int32).to(DEV)
    feed = torch.randint(0, cfg.vocab_size, (k, B), generator=gen,
                         dtype=torch.int32).to(DEV)
    bf16 = verify_vs_decode(torch, model, params, prompt, feed)
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                kv_cache_dtype="float32")
    f32 = verify_vs_decode(torch, build(cfg32),
                           _tree(params, lambda t: t.float()), prompt, feed)
    # float32: the verify pass and decode sum the same attention in
    # another order (K3 over pages then the block's own keys, against K2
    # with the current token folded in); phase model's f32 bound, 2^-10 of
    # the largest logit, and every argmax equal
    f32["bound"] = f32["max_abs_logit"] * 2.0 ** -10
    if f32["max_logit_diff"] > f32["bound"] \
            or f32["argmax_equal_share"] != 1.0:
        raise AssertionError(f"f32 verify vs decode: {f32}")
    res = dict(phase="model-spec", arch=cfg.name, layers=cfg.n_layers,
               batch=B, prompt=S, k=k, bf16=bf16, f32=f32)
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phases serve and serve-chunked: the driver on the card; trace and
# trace-chunked: its profiled windows

def kernel_counters():
    """Every kernel wrapper of the port, by name: each counts its launches."""
    from repro_torch.kernels import flash_attention as K7
    from repro_torch.kernels import flash_decode as K6
    from repro_torch.kernels import paged_chunk as K3
    from repro_torch.kernels import paged_decode as K2
    from repro_torch.kernels import probe_step as K1
    from repro_torch.kernels import probe_spec as K4
    from repro_torch.kernels import rwkv6_scan as K8
    from repro_torch.kernels import ttt_scan as K5
    return {"serving_probe_step": K1.serving_probe_step,
            "serving_probe_spec_step": K4.serving_probe_spec_step,
            "paged_flash_decode": K2.paged_flash_decode,
            "paged_flash_prefill_chunk": K3.paged_flash_prefill_chunk,
            "paged_flash_packed_chunk": K3.paged_flash_packed_chunk,
            "ttt_probe_batched": K5.ttt_probe_batched,
            "flash_decode": K6.flash_decode,
            "flash_attention": K7.flash_attention,
            "wkv_scan": K8.wkv_scan}


def zero_launches() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in kernel_counters().items()}


def serve_fleet(torch, extra_argv=(), *, phase, requests, need, paged=True,
                arch="smollm-360m"):
    """The serving driver end to end, on a paged fleet or (``paged=False``)
    a dense one; every kernel in ``need`` must have launched during it
    (counts zeroed just before, read just after).  Returns the phase's
    record and the driver's ``ServeResult``."""
    from repro_torch.launch import serve
    argv = ["--arch", arch, *(["--paged"] if paged else []),
            "--requests", str(requests), "--slots", "4", "--max-new-tokens",
            "96", "--seed", str(SEED), *extra_argv]
    zero_launches()
    t0 = time.perf_counter()
    out = serve.serve(argv)
    sync(torch)
    wall = time.perf_counter() - t0
    launches = read_launches()
    states = [r.state.value for r in out.requests]
    if len(states) != requests or not set(states) <= {"stopped",
                                                      "finished"}:
        raise AssertionError(f"requests did not all end: {states}")
    pool = out.scheduler.pool
    if paged:
        pool.check()
        if pool.blocks_in_use:
            raise AssertionError(f"{pool.blocks_in_use} pages still in use")
    elif pool is not None:
        raise AssertionError("a dense fleet holds a page pool")
    missing = [k for k in need if launches[k] < 1]
    if missing:
        raise AssertionError(f"{missing} never ran on the main path: "
                             f"{launches}")
    fleet = out.fleet
    res = dict(phase=phase, argv=argv, lam=out.lam, states=states,
               stop_steps=[r.stop_step for r in out.requests],
               tokens=[len(r.tokens) for r in out.requests],
               engine_steps=fleet.engine_steps,
               requests_per_s=fleet.requests_per_s,
               tokens_per_s=fleet.tokens_per_s,
               serve_wall_s=fleet.wall_time_s, driver_wall_s=wall,
               prefill_chunks=fleet.prefill_chunks,
               packed_chunks=fleet.packed_chunks,
               peak_step_tokens=fleet.peak_step_tokens,
               stall_ms_p50=fleet.stall_ms_p50,
               stall_ms_p99=fleet.stall_ms_p99,
               ttft_ms_p50=fleet.ttft_ms_p50, ttft_ms_p99=fleet.ttft_ms_p99,
               launches=launches)
    if out.static is not None:
        # the assertion of benchmarks/serving_throughput.py: eviction does
        # not move a single stop decision
        if out.static.stop_step.tolist() != res["stop_steps"]:
            raise AssertionError(f"static-batch stops "
                                 f"{out.static.stop_step.tolist()} differ "
                                 f"from the fleet's {res['stop_steps']}")
        res["static_batch"] = dict(
            stop_steps=out.static.stop_step.tolist(),
            engine_steps=out.static.engine_steps,
            wall_s=out.static.wall_time_s,
            requests_per_s=requests / out.static.wall_time_s,
            slot_utilization=(out.static.active_slot_steps
                              / max(out.static.total_slot_steps, 1)))
    return res, out


# the harvest and every admission run K7 and K6 in every fleet
SERVE_NEED = ("serving_probe_step", "paged_flash_decode", "flash_decode",
              "flash_attention")


def phase_serve(torch, extra_argv=(), *, phase="serve", requests=8,
                need=SERVE_NEED):
    res, out = serve_fleet(torch, extra_argv, phase=phase, requests=requests,
                           need=need)
    emit(res)
    return res, out


def profiled_events(prof):
    """Every event of a finished torch.profiler window as (name, device
    type, start us, end us), from its raw kineto results."""
    out = []
    for e in prof.profiler.kineto_results.events():
        t0_us = e.start_ns() / 1e3
        out.append((e.name(), e.device_type(), t0_us,
                    t0_us + e.duration_ns() / 1e3))
    return out


def phase_trace(torch, sched, steps: int = 16, prompt_len: int = 16,
                phase: str = "trace"):
    """A profiler window over ``steps`` engine steps of the served fleet,
    refilled with fresh requests of ``prompt_len`` tokens: the card's busy
    share of the window's wall time and the kernels that take it, and the
    device kernels and busy share per step, split into steps that ran a
    prefill chunk and steps that did not.  A device kernel belongs to the
    step whose host span it starts in (every step ends in a sync)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.serving import make_request
    gen = torch.Generator().manual_seed(SEED + 2)
    vocab = sched.model.cfg.vocab_size
    prompts = torch.randint(0, vocab, (sched.n_slots, prompt_len),
                            generator=gen, dtype=torch.int32)
    sched.submit([make_request(t.numpy(), max_new_tokens=3 * steps)
                  for t in prompts])
    eng = sched.engine
    had_chunk = []
    served_step = eng.step

    def step(chunk=None, **spec):
        had_chunk.append(chunk is not None)
        return served_step(chunk, **spec)

    # admission, then warm steps; a chunked fleet's window starts after
    # one, so that it holds the prompts' chunk steps and the decode after
    for _ in range(4 if prompt_len <= CHUNK else 1):
        sched.step()
    sync(torch)
    eng.step = step
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                with record_function(f"engine_step_{i}"):
                    sched.step()
            sync(torch)
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        del eng.step
    while sched.step():
        pass
    # the window's events, read from the profiler's raw results (building
    # torch's FunctionEvents for prof.events() or key_averages() took most
    # of a trace phase's time on the card), each (name, device, start, end)
    # in us
    events = profiled_events(prof)
    # device-side events only (an operator's row on the host also carries
    # the device time of the kernels it launched), without the device-side
    # copies of the step annotations
    device = [e for e in events if e[1] == DeviceType.CUDA
              and not e[0].startswith("engine_step_")]
    # device time and calls by kernel name
    by_key = {}
    for name, _, t0_us, t1_us in device:
        acc = by_key.setdefault(name, [0.0, 0])
        acc[0] += t1_us - t0_us
        acc[1] += 1
    rows = sorted(((us, key, n) for key, (us, n) in by_key.items()),
                  reverse=True)
    busy_us = sum(r[0] for r in rows)
    # per-step split: host spans of the steps, device events by start
    spans = {int(name.rsplit("_", 1)[1]): (t0_us, t1_us)
             for name, dev, t0_us, t1_us in events
             if dev == DeviceType.CPU and name.startswith("engine_step_")}
    order = sorted(spans)
    starts = [spans[i][0] for i in order]
    per_step = {i: [0, 0.0] for i in order}
    unassigned = 0
    for _, _, t0_us, t1_us in device:
        j = bisect.bisect_right(starts, t0_us) - 1
        if j < 0:
            unassigned += 1
            continue
        per_step[order[j]][0] += 1
        per_step[order[j]][1] += t1_us - t0_us
    split = {}
    for label, flag in (("with_chunk", True), ("without_chunk", False)):
        ids = [i for i in order if had_chunk[i] == flag]
        if not ids:
            split[label] = None
            continue
        span_us = sum(spans[i][1] - spans[i][0] for i in ids)
        split[label] = dict(
            steps=len(ids),
            kernels_per_step=sum(per_step[i][0] for i in ids) / len(ids),
            device_busy_ms_per_step=sum(per_step[i][1] for i in ids)
            / len(ids) / 1e3,
            wall_ms_per_step=span_us / len(ids) / 1e3,
            device_busy_share=(sum(per_step[i][1] for i in ids) / span_us
                               if span_us else None))
    # the split-KV merge (K2, K3 and K6 past 256 positions), by its name
    merges = sum(r[2] for r in rows if "merge_splits" in r[1])
    res = dict(phase=phase, steps=steps, prompt_len=prompt_len,
               merge_kernels_per_step=merges / steps,
               wall_ms_per_step=wall_us / steps / 1e3,
               device_busy_ms_per_step=busy_us / steps / 1e3,
               device_busy_share=busy_us / wall_us if busy_us else None,
               kernels_per_step=sum(r[2] for r in rows) / steps,
               split=split, unassigned_device_events=unassigned,
               top=[dict(kernel=k[:90], ms_per_step=us / steps / 1e3,
                         calls_per_step=c / steps)
                    for us, k, c in rows[:8]])
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phase serve-spec: linear speculative decode through the driver

class CheckedK4:
    """K4 on the inputs the engine gives it; the first ``limit`` calls are
    each held against the plain version on copies of the same state (the
    integer and boolean state equal, floats within K4_TOL).  ``max_accept``
    is the longest accepted length among the checked calls."""

    def __init__(self, K4, limit: int):
        self.K4, self.limit = K4, limit
        self.calls, self.err, self.max_accept = 0, 0.0, 0

    def __call__(self, zq, zk, bnd, acc, *state, burn_in):
        check = self.calls < self.limit
        if check:
            plain = [t.clone() for t in state[:6]]
            want = self.K4.serving_probe_spec_step_plain(
                zq, zk, bnd, acc, *plain, *state[6:], burn_in=burn_in)
        got = self.K4.serving_probe_spec_step(zq, zk, bnd, acc, *state,
                                              burn_in=burn_in)
        if check:
            for name in ("n_seq", "n_scores", "stopped", "stop_step"):
                if not getattr(got, name).equal(getattr(want, name)):
                    raise AssertionError(f"K4 in the fleet, call "
                                         f"{self.calls}: {name} differs")
            err = max(float((getattr(got, n) - getattr(want, n)).abs().max())
                      for n in ("s", "smoothed_seq", "W", "b", "ring"))
            if err > K4_TOL:
                raise AssertionError(f"K4 in the fleet, call {self.calls}: "
                                     f"err {err}")
            self.err = max(self.err, err)
            self.max_accept = max(self.max_accept, int(acc.max()))
        self.calls += 1
        return got


def first_divergence(torch, model, params, req, ref,
                     names=("spec", "one_token")):
    """The first token where a request left the reference fleet's (by
    default the one-token fleet's) sequence, and the reference run's top-2
    logit margin there: the model consumed prompt + [0] + tokens[:j] (a
    slot starts decoding from token 0) before choosing tokens[j]."""
    from repro_torch.models import transformer
    j = next(i for i, (a, b) in enumerate(zip(req.tokens, ref.tokens))
             if a != b)
    seq = list(req.inputs["tokens"][0]) + [0] + ref.tokens[:j]
    toks = torch.tensor([seq], dtype=torch.int32, device=DEV)
    with torch.no_grad():
        _, h, _ = model.prefill(model.cfg, params, {"tokens": toks},
                                len(seq))
        lg = transformer.logits_from_hidden(model.cfg, params, h)
    top = lg[0, :model.cfg.vocab_size].float().topk(2).values
    return {"req_id": req.req_id, "token": j, names[0]: req.tokens[j],
            names[1]: ref.tokens[j], "logit_margin": float(top[0] - top[1])}


def phase_serve_spec(torch, base, extra_argv=(), *, phase="serve-spec"):
    """The driver with ``--spec-tokens 4`` on ``base``'s fleet: K4 must
    launch once per engine step (each is a verify step), the first 16 K4
    calls are held against the plain version, and each request is held
    against the one-token fleet ``base`` served (tokens and stops)."""
    from repro_torch.kernels import probe_spec as K4
    from repro_torch.serving import engine as E
    checked = CheckedK4(K4, limit=16)
    served = E.serving_probe_spec_step
    E.serving_probe_spec_step = checked
    try:
        res, out = serve_fleet(
            torch, ("--spec-tokens", "4", *extra_argv), phase=phase,
            requests=len(base.requests),
            need=("serving_probe_spec_step", "paged_flash_packed_chunk"))
    finally:
        E.serving_probe_spec_step = served
    fleet = out.fleet
    k4 = res["launches"]["serving_probe_spec_step"]
    if k4 != fleet.engine_steps:
        raise AssertionError(f"K4 launched {k4} times in "
                             f"{fleet.engine_steps} spec steps")
    agree = [r.tokens == b.tokens and r.stop_step == b.stop_step
             for r, b in zip(out.requests, base.requests)]
    bad = [(r, b) for r, b in zip(out.requests, base.requests)
           if r.tokens != b.tokens]
    res.update(
        step_ms=fleet.wall_time_s / fleet.engine_steps * 1e3,
        drafts_proposed=fleet.spec_tokens_proposed,
        drafts_accepted=fleet.spec_tokens_accepted,
        acceptance_rate=fleet.acceptance_rate,
        accepted_len_p50=fleet.accepted_len_p50,
        accepted_len_p99=fleet.accepted_len_p99,
        draft_cache_hits=fleet.draft_cache_hits,
        draft_cache_misses=fleet.draft_cache_misses,
        k4_checked_calls=min(checked.calls, checked.limit),
        k4_checked_err=checked.err,
        one_token=dict(engine_steps=base.fleet.engine_steps,
                       tokens_per_s=base.fleet.tokens_per_s,
                       step_ms=base.fleet.wall_time_s
                       / base.fleet.engine_steps * 1e3),
        agree_with_one_token=f"{sum(agree)}/{len(agree)}",
        first_divergence=(first_divergence(torch, out.scheduler.model,
                                           out.scheduler.params, *bad[0])
                          if bad else None))
    emit(res)
    return res, out


def choose_lambda(scores, burn_in):
    """A threshold between the served smoothed scores that stops some
    requests and not others, as far as it can get from every score the
    threshold test reads (those after the burn-in); splits that stop a
    quarter to three quarters of the requests first.  Returns (lambda*,
    its distance to the nearest such score)."""
    tested = sorted({s for sc in scores for s in sc[burn_in:]})
    n = len(scores)
    best = None
    for lo, hi in zip(tested, tested[1:]):
        lam = (lo + hi) / 2
        stops = sum(any(s >= lam for s in sc[burn_in:]) for sc in scores)
        if 0 < stops < n:
            key = (n / 4 <= stops <= 3 * n / 4 and hi - lo > 2e-3, hi - lo)
            if best is None or key > best[0]:
                best = (key, lam, (hi - lo) / 2)
    if best is None:
        raise AssertionError(f"no threshold splits the scores {scores}")
    return best[1], best[2]


def phase_spec_stops(torch, sched, requests: int = 8, prompt_len: int = 16):
    """The stop-invariance of ``benchmarks/serving_throughput.py`` and the
    JAX suite's ``test_spec_stops_match_one_token_matrix``, in float32 on
    the serve fleet: the driver's weights and calibrated probe, served
    through ``OrcaScheduler`` one token at a time with nothing stopping
    (every request's full score trajectory), then at a lambda* between
    those scores, one-token and with spec_tokens 4: every stop step, and
    every token up to it, equal.  With random weights the default draft
    cache proposes nothing the verifier accepts, so a second spec fleet
    gets a cache that has observed the free fleet's tokens: its drafts are
    the one-token continuations, several tokens land per step (``pos``
    advancing by gen > 1, K4 chaining accepted tokens, the collection
    truncating at a stop), and its first 16 K4 calls are held against the
    plain version, at least one of them with an accepted length above 1."""
    import dataclasses
    from repro_torch.kernels import probe_spec as K4
    from repro_torch.launch import serve
    from repro_torch.models import build
    from repro_torch.serving import (DraftCache, OrcaScheduler, ServeConfig,
                                     make_request)
    from repro_torch.serving import engine as E
    cfg32 = dataclasses.replace(sched.model.cfg, dtype="float32",
                                kv_cache_dtype="float32")
    model32 = build(cfg32)
    params32 = _tree(sched.params, lambda t: t.float())
    batch = serve.model_inputs(cfg32, torch.Generator().manual_seed(SEED + 1),
                               requests, prompt_len)
    base = dict(n_slots=4, paged=True, tokens_per_step=8, max_new_tokens=96,
                burn_in=2)

    def fleet(lam, spec, cache=None):
        t0 = time.perf_counter()
        done, fl = OrcaScheduler(model32, params32, sched.pc, sched.theta,
                                 ServeConfig(lam=lam, spec_tokens=spec,
                                             **base),
                                 draft_cache=cache).run(
            [make_request(t) for t in batch["tokens"]])
        sync(torch)
        return done, fl, time.perf_counter() - t0

    free, _, _ = fleet(2.0, None)
    lam, margin = choose_lambda([r.scores for r in free], base["burn_in"])
    # f32 scores of the two paths differ by about 1e-6
    if margin < 1e-4:
        raise AssertionError(f"every threshold lies within {margin} of a "
                             "score: the check would hang on a tie")
    one, one_fl, one_s = fleet(lam, None)
    spec, spec_fl, spec_s = fleet(lam, 4)
    primed = DraftCache()
    for r in free:
        primed.observe(r.inputs["tokens"][0].tolist(), r.tokens)
    checked = CheckedK4(K4, limit=16)
    served = E.serving_probe_spec_step
    E.serving_probe_spec_step = checked
    try:
        hit, hit_fl, hit_s = fleet(lam, 4, primed)
    finally:
        E.serving_probe_spec_step = served
    stops = [r.stop_step for r in one]
    for name, done in (("spec", spec), ("primed spec", hit)):
        if [r.stop_step for r in done] != stops:
            raise AssertionError(f"f32 {name} stops "
                                 f"{[r.stop_step for r in done]} differ "
                                 f"from one-token stops {stops}")
        if [r.tokens for r in done] != [r.tokens for r in one]:
            raise AssertionError(f"f32 {name} tokens differ from one-token "
                                 "tokens")
    longest = max(g for r in hit for g in r.accepted_lens)
    if hit_fl.spec_tokens_accepted < 1 or longest < 2:
        raise AssertionError(f"the primed cache's drafts were not accepted: "
                             f"{hit_fl.spec_tokens_accepted} accepted, "
                             f"longest block {longest}")
    if checked.max_accept < 2:
        raise AssertionError("no checked K4 call chained more than one "
                             "accepted token")

    def spec_res(fl, wall_s):
        return dict(engine_steps=fl.engine_steps, wall_s=wall_s,
                    tokens_per_s=fl.tokens_per_s,
                    drafts_accepted=fl.spec_tokens_accepted,
                    drafts_proposed=fl.spec_tokens_proposed,
                    accepted_len_p50=fl.accepted_len_p50,
                    draft_cache_hits=fl.draft_cache_hits,
                    draft_cache_misses=fl.draft_cache_misses)

    res = dict(phase="serve-spec-f32", lam=lam, lambda_margin=margin,
               stop_steps=stops, stopped=sum(s >= 0 for s in stops),
               one_token=dict(engine_steps=one_fl.engine_steps, wall_s=one_s,
                              tokens_per_s=one_fl.tokens_per_s),
               spec=spec_res(spec_fl, spec_s),
               spec_primed=dict(spec_res(hit_fl, hit_s),
                                longest_block=longest,
                                k4_checked_calls=min(checked.calls,
                                                     checked.limit),
                                k4_checked_max_accept=checked.max_accept,
                                k4_checked_err=checked.err))
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phases harvest, serve-dense, trace-dense and serve-dense-f32: the dense
# side of the path (K6 and K7)

class PlainDenseAttention:
    """Within the block, the model's dense attention runs the plain
    versions of K6 and K7 (what the port ran before them)."""

    def __enter__(self):
        from repro_torch.kernels import flash_attention as K7
        from repro_torch.kernels import flash_decode as K6
        from repro_torch.models import attention as A
        self.served = A.flash_decode, A.flash_attention
        A.flash_decode, A.flash_attention = (K6.flash_decode_plain,
                                             K7.attn_prefill_einsum)
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention as A
        A.flash_decode, A.flash_attention = self.served
        return False


def harvest_turns(torch, sched, plain, expect, n, prompt_len, max_new):
    """The driver's harvest (``trajectories_from_model``: one prefill of
    ``n`` prompts, then ``max_new`` decode steps) timed through the
    kernels and, inside the ``plain`` context, through their plain
    versions, in turns (plain, kernels, kernels, plain); each run through
    the kernels must launch them as ``expect`` says.  Returns the wall
    seconds of each turn and the harvested trajectories."""
    import numpy as np
    from repro_torch.launch import serve
    model, params = sched.model, sched.params

    def run():
        sync(torch)
        t0 = time.perf_counter()
        ts = serve.trajectories_from_model(model, params, n, prompt_len,
                                           max_new, 8, SEED)
        sync(torch)
        return time.perf_counter() - t0, ts

    walls = {"kernels": [], "plain": []}
    for turn in ("plain", "kernels", "kernels", "plain"):
        zero_launches()
        if turn == "plain":
            with plain():
                wall, _ = run()
        else:
            wall, ts = run()
            launches = read_launches()
            got = {k: launches[k] for k in expect}
            if got != expect:
                raise AssertionError(f"harvest launches {launches}, "
                                     f"expected {expect}")
        walls[turn].append(wall)
    if not np.isfinite(ts.phis).all():
        raise AssertionError("harvested step embeddings are not finite")
    return walls, ts


def phase_harvest(torch, sched, n: int = 24, prompt_len: int = 16,
                  max_new: int = 96):
    """The driver's harvest timed through K7 and K6, then through their
    plain versions, in turns: K7 launches once a layer, K6 once a layer a
    step."""
    layers = sched.model.cfg.n_layers
    walls, ts = harvest_turns(
        torch, sched, PlainDenseAttention,
        {"flash_attention": layers, "flash_decode": layers * max_new}, n,
        prompt_len, max_new)
    res = dict(phase="harvest", trajectories=n, prompt=prompt_len,
               decode_steps=max_new, wall_s=walls,
               k6_launches=layers * max_new, k7_launches=layers,
               phis_shape=list(ts.phis.shape))
    emit(res)
    return res


def phase_serve_dense(torch, paged, paged_out, requests: int = 8):
    """The driver without ``--paged``: a dense fleet of ``requests`` on 4
    slots.  K1 and K6 launch every engine step (K6 once a layer), K7 once
    a layer for the harvest and for each admission, K2 never; the fleet
    line beside the paged fleet's (``paged``, phase serve's record, and
    ``paged_out``, its driver result) and, in bf16, how far the two
    fleets' tokens agree (not asserted: the two attention kernels sum in
    other orders and bf16 flips near-ties)."""
    res, out = serve_fleet(
        torch, phase="serve-dense", requests=requests, paged=False,
        need=("serving_probe_step", "flash_decode", "flash_attention"))
    layers = out.scheduler.model.cfg.n_layers
    fleet = out.fleet
    lc = res["launches"]
    harvest_steps = 96
    want = dict(paged_flash_decode=0,
                flash_decode=layers * (harvest_steps + fleet.engine_steps),
                flash_attention=layers * (1 + requests))
    got = {k: lc[k] for k in want}
    if got != want:
        raise AssertionError(f"dense fleet launches {got}, expected {want} "
                             f"(K6 once a layer in each of the harvest's "
                             f"{harvest_steps} steps and the fleet's "
                             f"{fleet.engine_steps}; K7 once a layer for "
                             f"the harvest and each admission; K2 never)")
    ref = paged_out.requests
    bad = [(r, b) for r, b in zip(out.requests, ref) if r.tokens != b.tokens]
    res.update(
        step_ms=fleet.wall_time_s / fleet.engine_steps * 1e3,
        k6_launches_per_step=layers,
        paged_fleet=dict(engine_steps=paged["engine_steps"],
                         tokens_per_s=paged["tokens_per_s"],
                         step_ms=paged["serve_wall_s"]
                         / paged["engine_steps"] * 1e3,
                         stop_steps=paged["stop_steps"]),
        tokens_agree_with_paged=f"{len(ref) - len(bad)}/{len(ref)}",
        first_divergence=(first_divergence(
            torch, out.scheduler.model, out.scheduler.params, *bad[0],
            names=("dense", "paged")) if bad else None))
    emit(res)
    return res, out


def phase_dense_stops(torch, sched, requests: int = 8, prompt_len: int = 16):
    """The serve fleet in float32 through ``OrcaScheduler``, dense and
    paged, at a lambda* between its scores (phase serve-spec-f32's
    machinery): the dense fleet (K6 and K7) stops every request where the
    paged fleet (K2 and K7) does, with the same tokens."""
    import dataclasses
    from repro_torch.launch import serve
    from repro_torch.models import build
    from repro_torch.serving import OrcaScheduler, ServeConfig, make_request
    cfg32 = dataclasses.replace(sched.model.cfg, dtype="float32",
                                kv_cache_dtype="float32")
    model32 = build(cfg32)
    params32 = _tree(sched.params, lambda t: t.float())
    batch = serve.model_inputs(cfg32, torch.Generator().manual_seed(SEED + 1),
                               requests, prompt_len)
    base = dict(n_slots=4, tokens_per_step=8, max_new_tokens=96, burn_in=2)

    def fleet(lam, paged):
        zero_launches()
        t0 = time.perf_counter()
        done, fl = OrcaScheduler(model32, params32, sched.pc, sched.theta,
                                 ServeConfig(lam=lam, paged=paged, **base)
                                 ).run([make_request(t)
                                        for t in batch["tokens"]])
        sync(torch)
        return done, fl, time.perf_counter() - t0, read_launches()

    free, _, _, _ = fleet(2.0, True)
    lam, margin = choose_lambda([r.scores for r in free], base["burn_in"])
    if margin < 1e-4:
        raise AssertionError(f"every threshold lies within {margin} of a "
                             "score: the check would hang on a tie")
    paged, paged_fl, paged_s, paged_l = fleet(lam, True)
    dense, dense_fl, dense_s, dense_l = fleet(lam, False)
    stops = [r.stop_step for r in paged]
    if [r.stop_step for r in dense] != stops:
        raise AssertionError(f"f32 dense stops {[r.stop_step for r in dense]}"
                             f" differ from paged stops {stops}")
    if [r.tokens for r in dense] != [r.tokens for r in paged]:
        raise AssertionError("f32 dense tokens differ from paged tokens")
    if dense_l["paged_flash_decode"] or not (dense_l["flash_decode"]
                                             and dense_l["flash_attention"]):
        raise AssertionError(f"f32 dense fleet launches {dense_l}")
    res = dict(phase="serve-dense-f32", lam=lam, lambda_margin=margin,
               stop_steps=stops, stopped=sum(s >= 0 for s in stops),
               paged=dict(engine_steps=paged_fl.engine_steps, wall_s=paged_s,
                          tokens_per_s=paged_fl.tokens_per_s,
                          launches=paged_l),
               dense=dict(engine_steps=dense_fl.engine_steps, wall_s=dense_s,
                          tokens_per_s=dense_fl.tokens_per_s,
                          launches=dense_l))
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phase offline: the paper's procedure, fit -> evaluate

# benchmarks/common.py EPOCHS at the full corpus: not cut
EPOCHS = 35


def plain_scores(torch, probe, ts):
    """``TrainedProbe.scores`` with K5's plain version in place of K5, on
    the same CUDA tensors: the same features, mask and smoothing."""
    import numpy as np
    from repro_torch.core import probe as P
    from repro_torch.kernels import ttt_scan as K5
    pc, theta = probe.pc, probe.theta
    with torch.no_grad():
        phis = torch.as_tensor(ts.phis, device=DEV)
        zq, zk = P.features(pc, theta, phis)
        n, T, f = zq.shape
        raw, _, _ = K5.ttt_probe_batched_plain(
            zq, zk, torch.zeros(n, T, device=DEV),
            torch.as_tensor(ts.mask, device=DEV).float(),
            theta["W0"].expand(n, f), theta["b0"].expand(n),
            P.inner_lr(pc, theta))
        s = P.smooth_scores(raw, pc.smooth_window)
    return s.cpu().numpy() * np.asarray(ts.mask)


def phase_offline(torch, splits, epochs: int = EPOCHS):
    """Table 2's supervised half on the synthetic corpus at d_phi 960: fit
    the TTT probe (no-QK and QK d_h 128, with the paper's epoch selection)
    and the static probe, then ``orca.evaluate`` at every delta.  K5 must
    launch in fit (epoch selection scores the validation slice each epoch)
    and in evaluate; evaluate rerun on scores from K5's plain version must
    give the same lambda*, savings and error."""
    import numpy as np
    from repro_torch import api as orca
    from repro_torch.core.pipeline import evaluate_probe
    from repro_torch.core.probe import ProbeConfig
    train, cal, test = splits
    methods = [
        ("ttt-noqk", "ttt", dict(pc=ProbeConfig(d_phi=D_PHI), epochs=epochs,
                                 epoch_select=True, seed=SEED)),
        ("ttt-qk128", "ttt", dict(pc=ProbeConfig(d_phi=D_PHI, variant="qk",
                                                 d_h=128), epochs=epochs,
                                  epoch_select=True, seed=SEED)),
        ("static", "static", {}),
    ]
    out = {}
    for name, method, kw in methods:
        zero_launches()
        t0 = time.perf_counter()
        calib = orca.fit(train, mode="supervised", method=method,
                         device=DEV, **kw)
        sync(torch)
        fit_s = time.perf_counter() - t0
        fit_launches = read_launches()["ttt_probe_batched"]
        zero_launches()
        t0 = time.perf_counter()
        ev = orca.evaluate(calib, cal, test, deltas=orca.DELTAS)
        eval_s = time.perf_counter() - t0
        eval_launches = read_launches()["ttt_probe_batched"]
        # lam None: LTT certified no threshold at this delta (never stop)
        rows = [dict(delta=r.delta, lam=r.lam if math.isfinite(r.lam)
                     else None, savings=r.savings, error=r.error)
                for r in ev.results]
        rec = dict(fit_s=fit_s, evaluate_s=eval_s, k5_launches_fit=
                   fit_launches, k5_launches_evaluate=eval_launches,
                   rows=rows)
        if method == "ttt":
            if fit_launches < epochs or eval_launches != 2:
                raise AssertionError(f"{name}: K5 launched {fit_launches} "
                                     f"times in fit, {eval_launches} in "
                                     "evaluate")
            kern = [calib.scores(ts) for ts in (cal, test)]
            plain = [plain_scores(torch, calib.probe, ts)
                     for ts in (cal, test)]
            rec["scores_max_abs_err"] = max(float(np.abs(a - b).max())
                                            for a, b in zip(kern, plain))
            rec["val_savings_by_epoch"] = [h["val_savings"]
                                           for h in calib.probe.history]
            ref = evaluate_probe(plain[0], cal, plain[1], test, calib.mode,
                                 orca.DELTAS, method=method)
            for a, b in zip(ev.results, ref.results):
                if (a.lam, a.savings, a.error) != (b.lam, b.savings,
                                                   b.error):
                    raise AssertionError(
                        f"{name} at delta {a.delta}: K5 gives ({a.lam}, "
                        f"{a.savings}, {a.error}), its plain version "
                        f"({b.lam}, {b.savings}, {b.error})")
        for r in rows:
            if not all(math.isfinite(r[k]) for k in ("savings", "error")):
                raise AssertionError(f"{name}: non-finite metrics {r}")
        out[name] = rec
    res = dict(phase="offline", data="synthetic corpus_splits(500, 170, "
               "170, d_phi=960), not the paper's data", epochs=epochs,
               epochs_cut=epochs < EPOCHS, mode="supervised", methods=out)
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phase serve-static: the static-batch baseline and the static probe

def phase_static_fleet(torch, sched, requests: int = 4):
    """The static baseline deployed: PCA + logreg fitted through
    ``api.fit(method="static")`` on trajectories harvested from the served
    model, flattened into a frozen no-QK probe (eta = 0) and served through
    ``api.engine`` on the same fused step: K1 must launch, and every slot's
    W must still equal W0 after every step."""
    import numpy as np
    from repro_torch import api as orca
    from repro_torch.launch import serve
    from repro_torch.serving import ServeConfig, make_request
    model, params = sched.model, sched.params
    ts = serve.trajectories_from_model(model, params, 8, 16, 96, 8,
                                       SEED + 3)
    half = len(ts) // 2
    train = ts.subset(np.arange(half))
    cal = ts.subset(np.arange(half, len(ts)))
    scal = orca.fit(train, mode="consistent", method="static", device=DEV)
    lam = orca.calibrated_lambda(scal, cal, 0.2, fallback=0.99)
    cfg = ServeConfig(n_slots=4, paged=True, tokens_per_step=8,
                      max_new_tokens=96, burn_in=2, lam=lam)
    fleet_sched = orca.engine(model, params, scal, config=cfg)
    gen = torch.Generator().manual_seed(SEED + 4)
    prompts = torch.randint(0, model.cfg.vocab_size, (requests, 16),
                            generator=gen, dtype=torch.int32)
    zero_launches()
    fleet_sched.submit([make_request(p.numpy()) for p in prompts])
    w0 = fleet_sched.theta["W0"]
    steps = 0
    while fleet_sched.step():
        steps += 1
        W = fleet_sched.engine.st.W
        if not torch.equal(W, w0.expand_as(W)):
            raise AssertionError(f"static fleet step {steps}: K1 moved a "
                                 "slot's W with eta = 0")
    done, fleet = fleet_sched.drain()
    launches = read_launches()
    if launches["serving_probe_step"] < 1:
        raise AssertionError(f"K1 never ran in the static fleet: "
                             f"{launches}")
    states = [r.state.value for r in done]
    if len(states) != requests or not set(states) <= {"stopped",
                                                      "finished"}:
        raise AssertionError(f"static fleet requests did not all end: "
                             f"{states}")
    res = dict(phase="serve-static-probe", lam=lam, eta=fleet_sched.pc.eta,
               steps_checked=steps, engine_steps=fleet.engine_steps,
               stop_steps=[r.stop_step for r in done],
               requests_per_s=fleet.requests_per_s,
               tokens_per_s=fleet.tokens_per_s, launches=launches)
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phases k8, model-rwkv, serve-rwkv, trace-rwkv and serve-rwkv-f32: RWKV6
# served through K8 (the WKV scan), K1 at f 2048 and K5

# K8 against its plain version: f32, the same per-element state recurrence
# with another summation order for out's dot over the 64 key channels;
# each within this share of the plain version's largest |value|
K8_RTOL = 1e-5
# (B, T): the served decode step, an admission, the harvest's prefill and
# decode steps, T not a multiple of the Pallas chunk (64), a long prefill;
# the timed ones
K8_CASES = ((4, 1, True), (1, 16, True), (24, 16, True), (24, 1, False),
            (1, 100, False), (1, 2048, True), (1, 512, True))
# T one below, at and one above the staged chunk (kernels/rwkv6_scan.py
# CHUNK_STEPS), at 4 column blocks (B 1) and at 1 (B 4)
K8_CHUNK_CASES = ((1, 31), (1, 32), (1, 33), (4, 33))
# r, k and v in bf16 (the served dtype, widened on load), timed beside
# the f32 rows of the same shape
K8_BF16_CASES = ((4, 1), (1, 16))
RWKV_ARCH = "rwkv6-1.6b"
# model-rwkv's bf16 check against the same run through the plain scan: the
# logit gap to the one-shot prefill within this multiple of the plain
# run's (plus one bf16 ulp), the mean argmax agreement (over 64 steps x 4
# rows) within this share of the plain run's
RWKV_BF16_FLOOR_MULT = 2.0
RWKV_BF16_AGREE_SLACK = 0.1


def k8_inputs(torch, gen, B, T, H, d, decay, s0_zero, rkv_dtype=None):
    """r, k, v ~ N(0, 1) (in ``rkv_dtype``, f32 by default); u small; w =
    exp(-exp(x)) with x around 2 ("near 0", w ~ 6e-4), 0 ("mid", w ~ 0.37)
    or -6 ("near 1", w ~ 0.9975); s0 zero or ~ N(0, 1)."""
    mean = {"near 0": 2.0, "mid": 0.0, "near 1": -6.0}[decay]
    r, k, v = (torch.randn(B, T, H, d, generator=gen).to(DEV, rkv_dtype)
               for _ in range(3))
    w = torch.exp(-torch.exp(mean + 0.5 * torch.randn(
        B, T, H, d, generator=gen))).to(DEV)
    u = (0.5 * torch.randn(H, d, generator=gen)).to(DEV)
    s0 = (torch.zeros(B, H, d, d) if s0_zero
          else torch.randn(B, H, d, d, generator=gen)).to(DEV)
    return r, k, v, w, u, s0


def k8_errs(got, want):
    """(max |got - want| / max |want|, max |got - want|) over out and
    state."""
    diffs = [(float((a - b).abs().max()), float(b.abs().max()))
             for a, b in zip(got, want)]
    return (max(d / max(m, 1e-30) for d, m in diffs),
            max(d for d, _ in diffs))


def k8_bytes_ops(B, T, H, d, rkv_bytes=4):
    """Each input read once (r, k, v at ``rkv_bytes`` an element, w, u,
    s0), each output written once (out, state); 7 f32 operations per state
    element a step (k v, u kv, + S, r att and its sum, w S + kv)."""
    n = B * T * H * d
    moved = 3 * rkv_bytes * n + 4 * (n + H * d + 2 * B * H * d * d + n)
    return moved, 7 * B * T * H * d * d


def k8_schedule(K8, B, T, H, rkv_dtype):
    """The launch's column split and staged chunk, and the instance's
    registers and shared memory as the library reports them."""
    n_col, chunk = K8.col_split(B, H), K8.chunk_steps(T)
    row = dict(n_col=n_col, chunk=chunk)
    if DEV == "cuda":
        cfg = K8.kernel_config(rkv_dtype, n_col, chunk)
        row.update(registers=cfg["registers"], local_bytes=cfg["local_bytes"],
                   smem_bytes=cfg["ring_bytes"] if T > chunk
                   else cfg["ring_bytes"] // 2)
    return row


def plain_wkv(K8):
    """K8's plain version behind the wrapper's signature."""
    def fn(r, k, v, w, u, s0, *, state_out=None):
        out, S = K8.wkv_scan_plain(r, k, v, w, u, s0)
        return (out, S) if state_out is None else (out, state_out.copy_(S))
    return fn


class CheckedK8:
    """K8 on the inputs the model gives it, each call held against the
    plain version on the same inputs (K8_RTOL), the state compared before
    the kernel overwrites it in place."""

    def __init__(self, K8):
        self.K8 = K8
        self.calls, self.err, self.abs_err, self.max_T = 0, 0.0, 0.0, 0

    def __call__(self, r, k, v, w, u, s0, *, state_out=None):
        want = self.K8.wkv_scan_plain(r, k, v, w, u, s0)
        got = self.K8.wkv_scan(r, k, v, w, u, s0, state_out=state_out)
        err, abs_err = k8_errs(got, want)
        if not err <= K8_RTOL:
            raise AssertionError(f"K8 in the model, call {self.calls} (B, T "
                                 f"= {tuple(r.shape[:2])}): relative err "
                                 f"{err}")
        self.calls += 1
        self.err = max(self.err, err)
        self.abs_err = max(self.abs_err, abs_err)
        self.max_T = max(self.max_T, r.shape[1])
        return got


class SwapWKV:
    """Within the block, the RWKV6 model's WKV scan runs ``impl`` instead
    of K8: by default K8's plain version (what the model computes without
    the kernel)."""

    def __init__(self, impl=None):
        self.impl = impl

    def __enter__(self):
        from repro_torch.kernels import rwkv6_scan as K8
        from repro_torch.models import rwkv6 as R
        self.served = R.wkv_kernel
        R.wkv_kernel = self.impl or plain_wkv(K8)
        return self

    def __exit__(self, *exc):
        from repro_torch.models import rwkv6 as R
        R.wkv_kernel = self.served
        return False


def phase_k8(torch, timer):
    """K8 against its plain version at the path's shapes (H 32, d 64), with
    s0 zero and nonzero, w near 0, mid and near 1; T around the staged
    chunk; bf16 r, k and v; T = 100 split in two calls carrying the state,
    in place at 4 column blocks, and one call in place at 2; d = 32
    refused; timed beside the plain version with the byte/operation bound.
    Each row names its column split (n_col) and staged chunk."""
    from repro_torch.kernels import rwkv6_scan as K8
    gen = torch.Generator().manual_seed(SEED + 8)
    H, d = 32, 64
    rows, worst, worst_abs = [], 0.0, 0.0
    cases = ([(B, T, timed, torch.float32) for B, T, timed in K8_CASES]
             + [(B, T, False, torch.float32) for B, T in K8_CHUNK_CASES]
             + [(B, T, True, torch.bfloat16) for B, T in K8_BF16_CASES])
    for B, T, timed, dtype in cases:
        errs = {}
        for decay, s0_zero in (("mid", True), ("near 0", False),
                               ("near 1", False)):
            args = k8_inputs(torch, gen, B, T, H, d, decay, s0_zero, dtype)
            got = K8.wkv_scan(*args)
            want = K8.wkv_scan_plain(*args)
            sync(torch)
            if not all(torch.isfinite(t).all() for t in got):
                raise AssertionError(f"K8 ({B}, {T}) {decay}: not finite")
            rel, abs_err = k8_errs(got, want)
            errs[f"{decay}, s0 {'zero' if s0_zero else 'random'}"] = rel
            worst_abs = max(worst_abs, abs_err)
        row = dict(B=B, T=T, H=H, d=d, rkv=str(dtype).split(".")[-1],
                   **k8_schedule(K8, B, T, H, dtype), rel_err=errs,
                   tol=K8_RTOL)
        if max(errs.values()) > K8_RTOL:
            raise AssertionError(f"K8 ({B}, {T}) {row['rkv']} off its plain "
                                 f"version: {errs}")
        worst = max(worst, max(errs.values()))
        if timed:
            r, k, v, w, u, s0 = args
            row["ms"] = timer(lambda: K8.wkv_scan(r, k, v, w, u, s0))
            row["plain_ms"] = timer(lambda: K8.wkv_scan_plain(
                r, k, v, w, u, s0), reps=30 if T < 1000 else 3, warmup=1)
            moved, ops = k8_bytes_ops(B, T, H, d, r.element_size())
            row["bound_ms"], row["bound_by"] = bound_ms(moved, ops)
            row["bytes"], row["operations"] = moved, ops
            row["library_ms"] = None
        emit(dict(phase="k8", **row))
        rows.append(row)
    # the state carried across two calls equals one call's; and in place
    r, k, v, w, u, s0 = k8_inputs(torch, gen, 1, 100, H, d, "near 1", False)
    one = K8.wkv_scan(r, k, v, w, u, s0)
    cut = 37
    st = s0.clone()
    a, _ = K8.wkv_scan(r[:, :cut].contiguous(), k[:, :cut].contiguous(),
                       v[:, :cut].contiguous(), w[:, :cut].contiguous(), u,
                       st, state_out=st)
    b, _ = K8.wkv_scan(r[:, cut:].contiguous(), k[:, cut:].contiguous(),
                       v[:, cut:].contiguous(), w[:, cut:].contiguous(), u,
                       st, state_out=st)
    split = (torch.cat([a, b], dim=1), st)
    split_err, _ = k8_errs(split, one)
    if split_err > K8_RTOL:
        raise AssertionError(f"K8: two calls off one call by {split_err}")
    split_bitwise = all(torch.equal(x, y) for x, y in zip(split, one))
    # in place at 2 column blocks (B 2: 64 (row, head) pairs)
    r, k, v, w, u, s0 = k8_inputs(torch, gen, 2, 40, H, d, "mid", False)
    want = K8.wkv_scan_plain(r, k, v, w, u, s0)
    st = s0.clone()
    got = (K8.wkv_scan(r, k, v, w, u, st, state_out=st)[0], st)
    in_place_err, _ = k8_errs(got, want)
    if in_place_err > K8_RTOL:
        raise AssertionError(f"K8 in place at n_col {K8.col_split(2, H)}: "
                             f"{in_place_err}")
    try:
        K8.wkv_scan(*k8_inputs(torch, gen, 1, 2, 2, 32, "mid", False))
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("K8 took d = 32 on the card")
    res = dict(phase="k8-checks", split_at=cut, split_rel_err=split_err,
               split_bitwise=split_bitwise,
               split_n_col=K8.col_split(1, H),
               in_place_n_col=K8.col_split(2, H),
               in_place_rel_err=in_place_err, d32_refused=refused,
               max_rel_err=max(worst, split_err, in_place_err),
               max_abs_err=worst_abs)
    emit(res)
    return rows, res


def rwkv_teacher_forced(torch, model, params, prompt, feed, wkv):
    """Prefill the prompt, then decode the fed tokens one step at a time,
    with the model's WKV scan swapped for ``wkv``; then one prefill of
    prompt + feed, whose logits at the fed positions the decode steps
    must give.  Returns (decode logits per step, one-shot logits per
    step)."""
    cfg = model.cfg
    B, S = prompt.shape
    V = cfg.vocab_size
    with SwapWKV(wkv):
        state, _, _ = model.prefill(cfg, params, {"tokens": prompt}, 0)
        steps = []
        for t in range(feed.shape[0]):
            pos = torch.full((B,), S + t, dtype=torch.int32, device=DEV)
            lg, _, state = model.decode_step(cfg, params, feed[t], state, pos)
            steps.append(lg[:, :V].float())
        seq = torch.cat([prompt, feed.T], dim=1)
        _, _, h = model.prefill(cfg, params, {"tokens": seq}, 0)
        one = (h[:, S:] @ params["lm_head"].to(h.dtype))[..., :V].float()
    for t, lg in enumerate(steps):
        if not torch.isfinite(lg).all():
            raise AssertionError(f"rwkv: non-finite logits at step {t}")
    return steps, [one[:, t] for t in range(feed.shape[0])]


def phase_model_rwkv(torch, reduced: bool = False):
    """Full-width rwkv6-1.6b (bf16, random weights from a seed, then the
    same weights in f32): prefill 16 tokens, 64 teacher-forced decode
    steps through K8, every K8 call held against the plain version on its
    inputs; each step's logits against one prefill over the whole sequence
    (the JAX suite's ``test_model_consistency``).  In f32 every argmax is
    equal and the logits sit within 2^-10 of the largest.  In bf16 the
    same run through the plain scan gives the floor that K8's logit gap
    and argmax agreement are held to."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import rwkv6_scan as K8
    from repro_torch.models import build
    cfg = get_config(RWKV_ARCH)
    if reduced:
        cfg = cfg.reduced()
    model = build(cfg)
    gen = torch.Generator().manual_seed(SEED)
    params = model.init(gen, DEV)
    n_params = sum(t.numel() for t in _leaves(params))
    B, S, steps = 4, 16, 64
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           dtype=torch.int32).to(DEV)
    feed = torch.randint(0, cfg.vocab_size, (steps, B), generator=gen,
                         dtype=torch.int32).to(DEV)
    out = {}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    for name, mdl, prm in (("bf16", model, params),
                           ("f32", build(cfg32),
                            _tree(params, lambda t: t.float()))):
        checked = CheckedK8(K8)
        t0 = time.perf_counter()
        dec, one = rwkv_teacher_forced(torch, mdl, prm, prompt, feed,
                                          checked)
        sync(torch)
        diffs = [float((a - b).abs().max()) for a, b in zip(dec, one)]
        agree = [float((a.argmax(-1) == b.argmax(-1)).float().mean())
                 for a, b in zip(dec, one)]
        scale = max(float(b.abs().max()) for b in one)
        out[name] = dict(k8_calls=checked.calls, k8_rel_err=checked.err,
                         k8_abs_err=checked.abs_err,
                         k8_max_T=checked.max_T,
                         max_logit_diff_per_step=diffs,
                         argmax_agree_per_step=agree, max_abs_logit=scale,
                         wall_s=time.perf_counter() - t0)
    # bf16: decode (M = 4) and the one-shot prefill (M = 320) round their
    # matrix products to bf16 at other places, which a random-weight
    # 24-layer stack amplifies to a logit gap of ~0.2 from step 0 whatever
    # the scan.  The floor is that gap with both runs through the plain
    # scan; K8's gap at step t is held to RWKV_BF16_FLOOR_MULT x the
    # largest floor up to step t plus one bf16 ulp of the largest logit,
    # and its mean argmax agreement to the plain run's less
    # RWKV_BF16_AGREE_SLACK.  K8 itself is held per call by CheckedK8.
    dec, one = rwkv_teacher_forced(torch, model, params, prompt, feed,
                                   plain_wkv(K8))
    bf16 = out["bf16"]
    floor = [float((a - b).abs().max()) for a, b in zip(dec, one)]
    plain_agree = [float((a.argmax(-1) == b.argmax(-1)).float().mean())
                   for a, b in zip(dec, one)]
    ulp = bf16["max_abs_logit"] * 2.0 ** -8
    bound = [RWKV_BF16_FLOOR_MULT * max(floor[:t + 1]) + ulp
             for t in range(steps)]
    bf16.update(plain_logit_diff_per_step=floor,
                plain_argmax_agree_per_step=plain_agree, bound_per_step=bound)
    over = [t for t in range(steps)
            if bf16["max_logit_diff_per_step"][t] > bound[t]]
    if over:
        t = over[0]
        raise AssertionError(f"rwkv bf16 step {t}: K8's logits "
                             f"{bf16['max_logit_diff_per_step'][t]} from "
                             f"the one-shot prefill > {bound[t]} (plain "
                             f"scan's gap {max(floor[:t + 1])})")
    k8_mean = sum(bf16["argmax_agree_per_step"]) / steps
    plain_mean = sum(plain_agree) / steps
    if k8_mean < plain_mean - RWKV_BF16_AGREE_SLACK:
        raise AssertionError(f"rwkv bf16: K8's argmax agreement {k8_mean} "
                             f"< the plain scan's {plain_mean} less "
                             f"{RWKV_BF16_AGREE_SLACK}")
    # f32: the decode steps and the one-shot prefill run the same
    # recurrence with other matrix shapes (M = 4 against M = 320), so they
    # differ by f32 rounding amplified through 24 random-weight layers;
    # 2^-10 of the largest logit leaves orders of magnitude of room
    f32 = out["f32"]
    f32["bound"] = f32["max_abs_logit"] * 2.0 ** -10
    if min(f32["argmax_agree_per_step"]) < 1.0:
        raise AssertionError("rwkv f32: a decode step's argmax differs from "
                             "the one-shot prefill's")
    if max(f32["max_logit_diff_per_step"]) > f32["bound"]:
        raise AssertionError(f"rwkv f32: logits "
                             f"{max(f32['max_logit_diff_per_step'])} from "
                             f"the one-shot prefill > {f32['bound']}")
    calls = cfg.n_layers * (2 + steps)
    for name in out:
        if out[name]["k8_calls"] != calls:
            raise AssertionError(f"rwkv {name}: {out[name]['k8_calls']} K8 "
                                 f"calls, expected {calls}")
    res = dict(phase="model-rwkv", arch=cfg.name, layers=cfg.n_layers,
               d_model=cfg.d_model, heads=cfg.n_heads,
               head_dim=cfg.ssm.head_dim, d_ff=cfg.d_ff,
               vocab=cfg.vocab_size, params=n_params, batch=B, prompt=S,
               decode_steps=steps, **out)
    emit(res)
    return res


RWKV_NEED = ("serving_probe_step", "wkv_scan", "ttt_probe_batched")
RWKV_NEVER = ("paged_flash_decode", "paged_flash_prefill_chunk",
              "paged_flash_packed_chunk", "serving_probe_spec_step",
              "flash_decode", "flash_attention")


def phase_serve_rwkv(torch, requests: int = 8, harvest: int = 24,
                     harvest_steps: int = 96):
    """``launch.serve --arch rwkv6-1.6b``: the serve fleet (8 requests on
    4 slots, 16-token prompts, 96 new tokens, 24 harvested trajectories) on
    the recurrent state.  K1, K8 and K5 launch; K8 once a layer for the
    harvest's prefill, each of its decode steps, each admission and each
    engine step; no attention kernel and no K4."""
    res, out = serve_fleet(torch, phase="serve-rwkv", requests=requests,
                           need=RWKV_NEED, paged=False, arch=RWKV_ARCH)
    layers = out.scheduler.model.cfg.n_layers
    fleet = out.fleet
    lc = res["launches"]
    want = layers * (1 + harvest_steps + requests + fleet.engine_steps)
    if lc["wkv_scan"] != want:
        raise AssertionError(f"K8 launched {lc['wkv_scan']} times, expected "
                             f"{want} = {layers} x (1 harvest prefill + "
                             f"{harvest_steps} harvest steps + {requests} "
                             f"admissions + {fleet.engine_steps} engine "
                             f"steps)")
    ran = [k for k in RWKV_NEVER if lc[k]]
    if ran:
        raise AssertionError(f"{ran} launched in the RWKV fleet: {lc}")
    res.update(step_ms=fleet.wall_time_s / fleet.engine_steps * 1e3,
               k8_launches_expected=want, k8_launches_per_step=layers,
               params=sum(t.numel() for t in _leaves(out.scheduler.params)))
    emit(res)
    return res, out


def phase_harvest_rwkv(torch, sched, n: int = 24, prompt_len: int = 16,
                       max_new: int = 96):
    """The RWKV driver's harvest timed through K8 and through the plain
    scan, in turns: K8 once a layer for the prefill and once a layer a
    decode step."""
    layers = sched.model.cfg.n_layers
    walls, ts = harvest_turns(torch, sched, SwapWKV,
                              {"wkv_scan": layers * (1 + max_new)}, n,
                              prompt_len, max_new)
    res = dict(phase="harvest-rwkv", trajectories=n, prompt=prompt_len,
               decode_steps=max_new, wall_s=walls,
               k8_launches=layers * (1 + max_new),
               phis_shape=list(ts.phis.shape))
    emit(res)
    return res


def phase_rwkv_stops(torch, sched, requests: int = 8, prompt_len: int = 16):
    """The RWKV fleet in float32 through ``OrcaScheduler`` at a lambda*
    between its scores (phase serve-spec-f32's machinery), served once
    through K8 and once with the WKV scan on its plain version: every stop
    step and every token equal."""
    import dataclasses
    from repro_torch.launch import serve
    from repro_torch.models import build
    from repro_torch.serving import OrcaScheduler, ServeConfig, make_request
    cfg32 = dataclasses.replace(sched.model.cfg, dtype="float32")
    model32 = build(cfg32)
    params32 = _tree(sched.params, lambda t: t.float())
    batch = serve.model_inputs(cfg32, torch.Generator().manual_seed(SEED + 1),
                               requests, prompt_len)
    base = dict(n_slots=4, tokens_per_step=8, max_new_tokens=96, burn_in=2)

    def fleet(lam):
        zero_launches()
        t0 = time.perf_counter()
        done, fl = OrcaScheduler(model32, params32, sched.pc, sched.theta,
                                 ServeConfig(lam=lam, **base)).run(
            [make_request(t) for t in batch["tokens"]])
        sync(torch)
        return done, fl, time.perf_counter() - t0, read_launches()

    free, _, _, _ = fleet(2.0)
    lam, margin = choose_lambda([r.scores for r in free], base["burn_in"])
    if margin < 1e-4:
        raise AssertionError(f"every threshold lies within {margin} of a "
                             "score: the check would hang on a tie")
    kern, kern_fl, kern_s, kern_l = fleet(lam)
    with SwapWKV():
        plain, plain_fl, plain_s, plain_l = fleet(lam)
    stops = [r.stop_step for r in kern]
    if [r.stop_step for r in plain] != stops:
        raise AssertionError(f"f32 RWKV stops through the plain scan "
                             f"{[r.stop_step for r in plain]} differ from "
                             f"K8's {stops}")
    if [r.tokens for r in plain] != [r.tokens for r in kern]:
        raise AssertionError("f32 RWKV tokens through the plain scan differ "
                             "from K8's")
    if not kern_l["wkv_scan"] or plain_l["wkv_scan"]:
        raise AssertionError(f"K8 launches: {kern_l['wkv_scan']} through "
                             f"the kernel, {plain_l['wkv_scan']} plain")
    res = dict(phase="serve-rwkv-f32", lam=lam, lambda_margin=margin,
               stop_steps=stops, stopped=sum(s >= 0 for s in stops),
               kernel=dict(engine_steps=kern_fl.engine_steps, wall_s=kern_s,
                           tokens_per_s=kern_fl.tokens_per_s,
                           k8_launches=kern_l["wkv_scan"]),
               plain=dict(engine_steps=plain_fl.engine_steps,
                          wall_s=plain_s,
                          tokens_per_s=plain_fl.tokens_per_s))
    emit(res)
    return res


# ---------------------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build      # needs the repo's src/
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    lib = _build.build()
    build_s = time.perf_counter() - t0
    log = (lib.parent / "build.log").read_text()
    emit(dict(phase="build", seconds=build_s, library=os.path.relpath(
        lib, ROOT), ptxas=[ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln
                           or "Compiling entry" in ln]))
    _build.library()
    timer = Timer(torch)
    k1 = phase_k1(torch, timer)
    k2 = phase_k2(torch, timer)
    k3 = phase_k3(torch, timer)
    k4 = phase_k4(torch, timer)
    splits = corpus()
    k5 = phase_k5(torch, timer, splits[2])
    k6 = phase_k6(torch, timer)
    k7 = phase_k7(torch, timer)
    model = phase_model(torch)
    zero_launches()
    chunked = phase_model_chunked(torch)
    b3_launches = read_launches()["paged_flash_prefill_chunk"]
    if b3_launches < 1:
        raise AssertionError("K3-B3 never ran in the chunked model phase")
    phase_model_spec(torch)
    served, out = phase_serve(torch)
    phase_trace(torch, out.scheduler)
    phase_harvest(torch, out.scheduler)
    served_d, out_d = phase_serve_dense(torch, served, out)
    phase_trace(torch, out_d.scheduler, phase="trace-dense")
    with PlainDenseAttention():
        phase_trace(torch, out_d.scheduler, phase="trace-dense-plain")
    phase_dense_stops(torch, out_d.scheduler)
    served_c, out_c = phase_serve(
        torch, ("--chunk-tokens", str(CHUNK), "--prompt-len", "160"),
        phase="serve-chunked", need=SERVE_NEED + ("paged_flash_packed_chunk",))
    if served_c["packed_chunks"] < 1:
        raise AssertionError("the chunked fleet packed no chunk")
    phase_trace(torch, out_c.scheduler, steps=24, prompt_len=160,
                phase="trace-chunked")
    spec, out_s = phase_serve_spec(torch, out)
    phase_trace(torch, out_s.scheduler, phase="trace-spec")
    phase_serve_spec(torch, out_c, ("--chunk-tokens", str(CHUNK),
                                    "--prompt-len", "160"),
                     phase="serve-spec-chunked")
    spec_f32 = phase_spec_stops(torch, out_s.scheduler)
    offline = phase_offline(torch, splits)
    _, out_st = phase_serve(
        torch, ("--static-baseline",), phase="serve-static", requests=4,
        need=SERVE_NEED + ("ttt_probe_batched",))
    phase_static_fleet(torch, out_st.scheduler)
    k8, k8_checks = phase_k8(torch, timer)
    rwkv_model = phase_model_rwkv(torch)
    served_r, out_r = phase_serve_rwkv(torch)
    phase_trace(torch, out_r.scheduler, phase="trace-rwkv")
    phase_harvest_rwkv(torch, out_r.scheduler)
    phase_rwkv_stops(torch, out_r.scheduler)
    k2_main = k2[0]
    # absolute errors: phase k2's m and outputs, the model's outputs
    k2_err = max([max(r["m_err"], r["out_err"]) for r in k2]
                 + [model[p]["k2_out_err"] for p in ("bf16", "f32")])
    b3_rows = [r for r in k3 if r["fn"] == "B3"]
    b4_rows = [r for r in k3 if r["fn"] == "B4"]
    k3_model_err = max(chunked[p]["k3_out_err"] for p in ("bf16", "f32"))
    b3_err = max([max(r["m_err"], r["out_err"]) for r in b3_rows]
                 + [k3_model_err])
    b4_err = max([max(r["m_err"], r["out_err"], r["merged_err"])
                  for r in b4_rows] + [k3_model_err])

    k6_main = k6[0]
    k6_err = max([max(r["m_err"], r["out_err"], r["normalised_err"])
                  for r in k6]
                 + [model["dense"][p]["k6_out_err"] for p in ("bf16", "f32")])
    k7_main = k7[0]
    k7_err = max([r["max_abs_err"] for r in k7]
                 + [model["dense"][p]["k7_err"] for p in ("bf16", "f32")])

    def k3_entry(name, line, launches, err, row):
        return dict(name=name, route="cuda",
                    source="src/repro_torch/csrc/paged_chunk.cu",
                    replaces=f"src/repro/kernels/decode_attention.py:{line}",
                    launches=launches, max_abs_err=err, ms=row["ms"],
                    plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                    bound_by=row["bound_by"], library_ms=row["library_ms"])

    emit({"kernels": [
        dict(name="serving_probe_step", route="cuda",
             source="src/repro_torch/csrc/probe_spec.cu",
             replaces="src/repro/kernels/ttt_probe.py:368",
             launches=served["launches"]["serving_probe_step"],
             max_abs_err=max(k1["max_abs_err"].values()), ms=k1["ms"],
             plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None,
             served_ms=k1["served_ms"],
             served_plain_ms=k1["served_plain_ms"],
             served_bound_ms=k1["served_bound_ms"]),
        dict(name="paged_flash_decode", route="cuda",
             source="src/repro_torch/csrc/paged_decode.cu",
             replaces="src/repro/kernels/decode_attention.py:231",
             launches=served["launches"]["paged_flash_decode"],
             max_abs_err=k2_err, ms=k2_main["ms"],
             plain_ms=k2_main["plain_ms"], bound_ms=k2_main["bound_ms"],
             bound_by=k2_main["bound_by"],
             library_ms=k2_main["library_ms"]),
        k3_entry("paged_flash_prefill_chunk", 265, b3_launches, b3_err,
                 b3_rows[0]),
        k3_entry("paged_flash_packed_chunk", 298,
                 served_c["launches"]["paged_flash_packed_chunk"], b4_err,
                 b4_rows[0]),
        dict(name="ttt_probe_batched", route="cuda",
             source="src/repro_torch/csrc/ttt_scan.cu",
             replaces="src/repro/kernels/ttt_probe.py:80",
             launches=sum(m["k5_launches_fit"] + m["k5_launches_evaluate"]
                          for m in offline["methods"].values()),
             max_abs_err=max([k5["max_abs_err"]] + [
                 m["scores_max_abs_err"] for m in offline["methods"].values()
                 if "scores_max_abs_err" in m]),
             ms=k5["served"]["ms"], plain_ms=k5["served"]["plain_ms"],
             bound_ms=k5["served"]["bound_ms"],
             bound_by=k5["served"]["bound_by"], library_ms=None),
        dict(name="serving_probe_spec_step", route="cuda",
             source="src/repro_torch/csrc/probe_spec.cu",
             replaces="src/repro/kernels/ttt_probe.py:304",
             launches=spec["launches"]["serving_probe_spec_step"],
             max_abs_err=max(k4["max_abs_err"], spec["k4_checked_err"],
                             spec_f32["spec_primed"]["k4_checked_err"]),
             ms=k4["ms"], plain_ms=k4["plain_ms"], bound_ms=k4["bound_ms"],
             bound_by=k4["bound_by"], library_ms=None,
             served_ms=k4["served_ms"],
             served_plain_ms=k4["served_plain_ms"],
             served_bound_ms=k4["served_bound_ms"]),
        dict(name="flash_decode", route="cuda",
             source="src/repro_torch/csrc/flash_decode.cu",
             replaces="src/repro/kernels/decode_attention.py:78",
             launches=served_d["launches"]["flash_decode"],
             max_abs_err=k6_err, ms=k6_main["ms"],
             plain_ms=k6_main["plain_ms"], bound_ms=k6_main["bound_ms"],
             bound_by=k6_main["bound_by"],
             library_ms=k6_main["library_ms"]),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:64",
             launches=served["launches"]["flash_attention"],
             max_abs_err=k7_err, ms=k7_main["ms"],
             plain_ms=k7_main["plain_ms"], bound_ms=k7_main["bound_ms"],
             bound_by=k7_main["bound_by"],
             library_ms=k7_main["library_ms"]),
        dict(name="wkv_scan", route="cuda",
             source="src/repro_torch/csrc/rwkv6_scan.cu",
             replaces="src/repro/kernels/rwkv6_scan.py:53",
             launches=served_r["launches"]["wkv_scan"],
             max_abs_err=max([k8_checks["max_abs_err"]]
                             + [rwkv_model[p]["k8_abs_err"]
                                for p in ("bf16", "f32")]),
             ms=k8[0]["ms"], plain_ms=k8[0]["plain_ms"],
             bound_ms=k8[0]["bound_ms"], bound_by=k8[0]["bound_by"],
             library_ms=None),
    ]})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
