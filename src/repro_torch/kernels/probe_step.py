"""K1: the fused serving probe step — hand-written CUDA kernel + its plain
PyTorch version.

``serving_probe_step`` runs one decode step's probe work for ALL engine
slots: score-then-update of the per-slot fast weights at reasoning-step
boundaries, the rolling-window smoothing and the calibrated threshold test
(the complete per-token deployed procedure of Algorithm 2).  It replaces
the TPU kernel ``repro/kernels/ttt_probe.py:368 serving_probe_step`` (body
``_serving_kernel`` :175); the plain version follows
``repro/kernels/ref.py:44 serving_probe_step_ref`` and the kernel body
line by line.

The probe state (W, b, ring, n_scores, stopped, stop_step) is updated IN
PLACE — the buffers the JAX engine donates to its jitted step — and the
returned ``ProbeStepOut`` holds those same tensors plus the fresh
per-slot raw score ``s`` and smoothed score.

Dispatch is by the input's device: CPU tensors take the plain version,
CUDA tensors the kernel (``csrc/probe_step.cu``); anything else raises.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import probe as P
from repro_torch.kernels import _build


class ProbeStepOut(NamedTuple):
    """One fused serving step's per-slot observations + state."""
    s: torch.Tensor           # (B,) raw probe score this token
    W: torch.Tensor           # (B, f) fast weights after the step
    b: torch.Tensor           # (B,)
    ring: torch.Tensor        # (B, window) rolling raw-score window
    n_scores: torch.Tensor    # (B,) int32 scores emitted since admission
    smoothed: torch.Tensor    # (B,) rolling-mean score
    stopped: torch.Tensor     # (B,) bool — calibrated threshold crossed
    stop_step: torch.Tensor   # (B,) int32 reasoning step at stop (-1 active)


def serving_probe_step_plain(zq, zk, boundary, W, b, ring, n_scores, stopped,
                             stop_step, eta: float, lam: float, *,
                             burn_in: int) -> ProbeStepOut:
    """Plain PyTorch version of the kernel (same in-place contract)."""
    dev = zq.device
    eta_t = torch.tensor(eta, dtype=torch.float32, device=dev)
    lam_t = torch.tensor(lam, dtype=torch.float32, device=dev)
    # a stopped slot is frozen compute: no boundary, no update, no scores
    bnd = boundary & ~stopped
    s, W_upd, b_upd = P.score_then_update(W, b, zq, zk, 0.0, bnd.float(),
                                          eta_t)
    ring_new = torch.where(bnd[:, None],
                           torch.cat([ring[:, 1:], s[:, None]], dim=1), ring)
    n = n_scores + bnd.to(torch.int32)
    win = ring.shape[1]
    denom = torch.clamp(n, max=win).float()
    smoothed = torch.where(n > 0,
                           ring_new.sum(1) / torch.clamp(denom, min=1.0),
                           torch.zeros_like(denom))
    # threshold test (Algorithm 2 line 11), after the burn-in
    stop_now = bnd & (smoothed >= lam_t) & (n > burn_in)
    step_new = torch.where(stop_now & (stop_step < 0), n, stop_step)
    # the stopping step leaves the fast weights untouched
    W.copy_(torch.where(stop_now[:, None], W, W_upd))
    b.copy_(torch.where(stop_now, b, b_upd))
    ring.copy_(ring_new)
    n_scores.copy_(n)
    stopped.copy_(stopped | stop_now)
    stop_step.copy_(step_new)
    return ProbeStepOut(s, W, b, ring, n_scores, smoothed, stopped, stop_step)


def _check(zq, zk, boundary, W, b, ring, n_scores, stopped, stop_step):
    B, f = zq.shape
    win = ring.shape[-1]
    want = {"zq": (zq, torch.float32, (B, f)), "zk": (zk, torch.float32, (B, f)),
            "boundary": (boundary, torch.bool, (B,)),
            "W": (W, torch.float32, (B, f)), "b": (b, torch.float32, (B,)),
            "ring": (ring, torch.float32, (B, win)),
            "n_scores": (n_scores, torch.int32, (B,)),
            "stopped": (stopped, torch.bool, (B,)),
            "stop_step": (stop_step, torch.int32, (B,))}
    for name, (t, dt, shape) in want.items():
        if t.device != zq.device:
            raise ValueError(f"serving_probe_step: {name} on {t.device}, "
                             f"zq on {zq.device}")
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"serving_probe_step: {name} is {t.dtype} "
                             f"{tuple(t.shape)}, expected {dt} {shape}")
        if not t.is_contiguous():
            raise ValueError(f"serving_probe_step: {name} not contiguous")
    if win < 1:
        raise ValueError("serving_probe_step: smoothing window must be >= 1")


def serving_probe_step(zq, zk, boundary, W, b, ring, n_scores, stopped,
                       stop_step, eta: float, lam: float, *,
                       burn_in: int) -> ProbeStepOut:
    """One fused serving step for ALL engine slots (vector per-slot state).

    zq/zk (B, f) f32 feature views of the running step embedding; boundary
    (B,) bool marks slots finishing a reasoning step this token; (W (B, f),
    b (B,), ring (B, win) f32, n_scores (B,) i32, stopped (B,) bool,
    stop_step (B,) i32) is the per-slot state, updated in place; eta and
    lam are Python floats (used as f32)."""
    if zq.device.type == "cpu":
        return serving_probe_step_plain(zq, zk, boundary, W, b, ring,
                                        n_scores, stopped, stop_step, eta,
                                        lam, burn_in=burn_in)
    if zq.device.type != "cuda":
        raise RuntimeError(f"serving_probe_step: no kernel for device "
                           f"{zq.device}")
    _check(zq, zk, boundary, W, b, ring, n_scores, stopped, stop_step)
    B, f = zq.shape
    s = torch.empty((B,), dtype=torch.float32, device=zq.device)
    smoothed = torch.empty((B,), dtype=torch.float32, device=zq.device)
    p = _build.ptr
    err = _build.library().probe_step_launch(
        p(zq), p(zk), p(boundary), p(W), p(b), p(ring), p(n_scores),
        p(stopped), p(stop_step), p(s), p(smoothed), float(eta), float(lam),
        int(burn_in), B, f, ring.shape[1], _build.stream_of(zq))
    _build.check(err, "serving_probe_step launch")
    serving_probe_step.launches += 1
    return ProbeStepOut(s, W, b, ring, n_scores, smoothed, stopped, stop_step)


serving_probe_step.launches = 0
