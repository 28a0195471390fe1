"""K4: the masked multi-token serving probe step of speculative decode —
hand-written CUDA kernel + its plain PyTorch version.

``serving_probe_spec_step`` runs the verify step's probe work for ALL
engine slots: T chained one-token probe steps per slot (K1's
score-then-update, rolling smoothing and threshold test), where token t of
slot i takes part only if ``t < accept[i]`` — the verifier's accepted
prefix — and its boundary flag is set.  A stop firing mid-chain freezes the
slot for the rest of the chain.  It replaces the TPU kernel
``repro/kernels/ttt_probe.py:304 serving_probe_spec_step`` (body
``_spec_kernel`` :236); the plain version chains K1's plain version
``serving_probe_step_plain`` T times, as ``repro/kernels/ref.py:80
serving_probe_spec_step_ref`` chains its one-token oracle, so the
spec-decode invariant (``accept[i] = a`` equals ``a`` sequential one-token
steps) holds by construction.

The probe state (W, b, ring, n_scores, stopped, stop_step) is updated IN
PLACE, as K1's; the returned ``SpecProbeOut`` holds those tensors plus
fresh per-token sequences of the raw score, the smoothed score and the
score count, from which the scheduler replays the chain on the host.

Dispatch is by the input's device: CPU tensors take the plain version,
CUDA tensors the kernel (``csrc/probe_spec.cu``); anything else raises.
The kernel's instance for a width is K1's (``probe_step.instance``): K1
launches this kernel at T = 1.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.probe_step import (MAX_F, MAX_WINDOW, instance,
                                            serving_probe_step_plain,
                                            shared_view, vector_rows)


class SpecProbeOut(NamedTuple):
    """A masked multi-token probe step's per-token sequences + state.

    Token t of slot i emitted a score iff ``n_seq[i, t]`` exceeds the count
    before it, and ``smoothed_seq[i, t]`` is that score's rolling mean."""
    s: torch.Tensor             # (B, T) raw probe score per verify token
    smoothed_seq: torch.Tensor  # (B, T) rolling mean AFTER each token
    n_seq: torch.Tensor         # (B, T) int32 scores emitted AFTER each token
    W: torch.Tensor             # (B, f) final fast weights
    b: torch.Tensor             # (B,)
    ring: torch.Tensor          # (B, window)
    n_scores: torch.Tensor      # (B,) int32
    smoothed: torch.Tensor      # (B,)
    stopped: torch.Tensor       # (B,) bool
    stop_step: torch.Tensor     # (B,) int32


def serving_probe_spec_step_plain(zq, zk, boundary, accept, W, b, ring,
                                  n_scores, stopped, stop_step, eta: float,
                                  lam: float, *, burn_in: int) -> SpecProbeOut:
    """Plain PyTorch version of the kernel: K1's plain version, T times,
    with boundary ``boundary[:, t] & (t < accept)`` (same in-place
    contract)."""
    ss, sms, ns = [], [], []
    for t in range(zq.shape[1]):
        out = serving_probe_step_plain(
            zq[:, t], zk[:, t], boundary[:, t] & (t < accept), W, b, ring,
            n_scores, stopped, stop_step, eta, lam, burn_in=burn_in)
        ss.append(out.s)
        sms.append(out.smoothed)
        ns.append(n_scores.clone())
    sm_seq = torch.stack(sms, dim=1)
    return SpecProbeOut(torch.stack(ss, dim=1), sm_seq,
                        torch.stack(ns, dim=1), W, b, ring, n_scores,
                        sm_seq[:, -1], stopped, stop_step)


def _check(zq, zk, boundary, accept, W, b, ring, n_scores, stopped,
           stop_step):
    B, T, f = zq.shape
    win = ring.shape[-1]
    want = {"zq": (zq, torch.float32, (B, T, f)),
            "zk": (zk, torch.float32, (B, T, f)),
            "boundary": (boundary, torch.bool, (B, T)),
            "accept": (accept, torch.int32, (B,)),
            "W": (W, torch.float32, (B, f)), "b": (b, torch.float32, (B,)),
            "ring": (ring, torch.float32, (B, win)),
            "n_scores": (n_scores, torch.int32, (B,)),
            "stopped": (stopped, torch.bool, (B,)),
            "stop_step": (stop_step, torch.int32, (B,))}
    for name, (t, dt, shape) in want.items():
        if t.device != zq.device:
            raise ValueError(f"serving_probe_spec_step: {name} on "
                             f"{t.device}, zq on {zq.device}")
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"serving_probe_spec_step: {name} is {t.dtype} "
                             f"{tuple(t.shape)}, expected {dt} {shape}")
        if not t.is_contiguous():
            raise ValueError(f"serving_probe_spec_step: {name} not "
                             "contiguous")
    if not 1 <= win <= MAX_WINDOW:
        raise ValueError(f"serving_probe_spec_step: smoothing window {win} "
                         f"outside 1 .. {MAX_WINDOW}, the window the "
                         "kernel's shared memory holds")
    if f > MAX_F:
        raise ValueError(f"serving_probe_spec_step: f={f} exceeds {MAX_F}, "
                         "the widest d_model of the repo's configs, for "
                         "which the kernel has an instance")


def serving_probe_spec_step(zq, zk, boundary, accept, W, b, ring, n_scores,
                            stopped, stop_step, eta: float, lam: float, *,
                            burn_in: int) -> SpecProbeOut:
    """T chained serving probe steps for ALL engine slots in one call.

    zq/zk (B, T, f) f32 per-token feature views (token t's already reflect
    the hidden-state pooling up to t); boundary (B, T) bool the raw
    reasoning-step flags; accept (B,) int32, slot i processes only its
    first ``accept[i]`` tokens; (W, b, ring, n_scores, stopped, stop_step)
    the per-slot state of K1, updated in place; eta and lam Python floats
    (used as f32).  Any T >= 1; f up to ``MAX_F`` on the card."""
    if zq.dim() != 3 or zq.shape[1] < 1:
        raise ValueError(f"serving_probe_spec_step: zq is "
                         f"{tuple(zq.shape)}, expected (B, T >= 1, f)")
    if zq.device.type == "cpu":
        return serving_probe_spec_step_plain(
            zq, zk, boundary, accept, W, b, ring, n_scores, stopped,
            stop_step, eta, lam, burn_in=burn_in)
    if zq.device.type != "cuda":
        raise RuntimeError(f"serving_probe_spec_step: no kernel for device "
                           f"{zq.device}")
    _check(zq, zk, boundary, accept, W, b, ring, n_scores, stopped,
           stop_step)
    B, T, f = zq.shape
    dev = zq.device
    s = torch.empty((B, T), dtype=torch.float32, device=dev)
    sm_seq = torch.empty((B, T), dtype=torch.float32, device=dev)
    n_seq = torch.empty((B, T), dtype=torch.int32, device=dev)
    p = _build.ptr
    err = _build.library().probe_spec_launch(
        p(zq), p(zk), p(boundary), p(accept), p(W), p(b), p(ring),
        p(n_scores), p(stopped), p(stop_step), p(s), p(sm_seq), p(n_seq),
        float(eta), float(lam), int(burn_in), B, T, f, ring.shape[1],
        *instance(f, shared_view(zq, zk), ring.shape[1]),
        vector_rows(f, zq, zk, W),
        _build.stream_of(zq))
    _build.check(err, "serving_probe_spec_step launch")
    serving_probe_spec_step.launches += 1
    return SpecProbeOut(s, sm_seq, n_seq, W, b, ring, n_scores,
                        sm_seq[:, -1], stopped, stop_step)


serving_probe_spec_step.launches = 0
