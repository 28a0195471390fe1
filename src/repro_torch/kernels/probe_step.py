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
CUDA tensors the kernel (``csrc/probe_step.cu``, K4's chain at T = 1);
anything else raises.  ``BANDS`` and ``instance`` choose the kernel's
instance for a width and a smoothing window, for K1 and K4 alike, and
``shared_view`` tells it that zq is zk (the served no-QK view: one row
read, one dot taken).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from repro_torch.core import probe as P
from repro_torch.kernels import _build
# the widest d_model of the repo's configs: the widest band keeps W_i in
# registers, 28 features a thread of 256
from repro_torch.kernels.ttt_scan import MAX_F

# the widest smoothing window the kernel's registers hold (probe_math.cuh
# kMaxWindow; the repo's configs use 4 and 10); a wider one lies in shared
# memory
REGISTER_WINDOW = 16
# shared memory a block may take on the H100 (227 KB), less the warps'
# static sums
SMEM_BLOCK = 227 * 1024 - 256


class Band(NamedTuple):
    """One width band of the probe chain's instances (csrc/probe_spec.cu)."""
    f_max: int      # widest f it takes
    threads: int
    fpt: int        # features a thread, in 16-byte groups of 4


# The chain's policy: which compiled instance a width takes, for K1 and K4
# alike (K1 is K4 at T = 1), so both run one reduction tree at every width.
# Threads times features a thread cover the band.  Every load is issued at
# entry; the rows of two tokens are in flight in a cp.async ring in shared
# memory.  One warp at f <= 128 needs no barrier; 256 threads at every
# wider band.  On an NVIDIA H100 80GB HBM3 at 700 W, one warp at f 128
# was faster than 256 threads in K1 and K4 in both views, 128, 64 and 32
# threads at f 960 and 512 at f 2048 and 5120 were slower, as were rings
# of registers and deeper rings (PERF.md, tools/probe_phases.py).
# csrc/probe_spec.cu builds exactly the instances these name
# (tests/test_torch_probe_chain.py holds the two lists equal) and launches
# the one the wrapper names.
BANDS = (Band(128, 32, 4), Band(1024, 256, 4), Band(2048, 256, 8),
         Band(4096, 256, 16), Band(5120, 256, 20), Band(7168, 256, 28))


def instance(f: int, same: bool, win: int) -> Tuple[int, int, int, int]:
    """The figures of the instance width f and window win take, as the
    launchers read them: (threads, features a thread, zq is zk, the window
    in shared memory); ``same``: zq and zk are one tensor."""
    for band in BANDS:
        if f <= band.f_max:
            return (band.threads, band.fpt, int(same),
                    int(win > REGISTER_WINDOW))
    raise ValueError(f"serving probe chain: f={f} exceeds {MAX_F}")


def smem_bytes(fig, win: int) -> int:
    """The dynamic shared memory of instance ``fig`` at window win: the
    rows of two tokens (two rows a token unless zq is zk) and, where it
    lies there, the window."""
    threads, fpt, same, smem_ring = fig
    return 2 * (1 if same else 2) * threads * fpt * 4 + 4 * win * smem_ring


# the widest window every width takes: what shared memory holds beside the
# widest band's rows
MAX_WINDOW = (SMEM_BLOCK - smem_bytes(instance(MAX_F, False, 0), 0)) // 4


def shared_view(zq, zk) -> bool:
    """True iff zq and zk are one view of one tensor: the same data
    pointer, shape, strides, dtype and device.  A clone, an offset view or
    another stride is not (equal values in two tensors read as two)."""
    return (zq.data_ptr() == zk.data_ptr() and zq.shape == zk.shape
            and zq.stride() == zk.stride() and zq.dtype == zk.dtype
            and zq.device == zk.device)


def vector_rows(f: int, *tensors) -> int:
    """1 where the kernel may move rows as float4: f a multiple of 4 and
    every tensor starting on 16 bytes (the bits do not depend on it)."""
    return int(f % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def kernel_config(f: int, same: bool, win: int) -> dict:
    """The instance width f and window win take on the card: its figures
    (``instance``) and, from the library itself, its registers, static
    shared bytes (the warps' sums), spill bytes a thread and the rows'
    shared ring bytes."""
    fig = instance(f, same, win)
    out = (ctypes.c_int * 4)()
    _build.check(_build.library().probe_chain_config(*fig, out),
                 "probe_chain_config")
    keys = ("threads", "features_per_thread", "same", "smem_window",
            "registers", "static_smem", "local_bytes", "ring_smem")
    return dict(zip(keys, (*fig, *out)))


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
    if not 1 <= win <= MAX_WINDOW:
        raise ValueError(f"serving_probe_step: smoothing window {win} "
                         f"outside 1 .. {MAX_WINDOW}, the window the "
                         "kernel's shared memory holds")
    if f > MAX_F:
        raise ValueError(f"serving_probe_step: f={f} exceeds {MAX_F}, the "
                         "widest d_model of the repo's configs, for which "
                         "the kernel has an instance")


def serving_probe_step(zq, zk, boundary, W, b, ring, n_scores, stopped,
                       stop_step, eta: float, lam: float, *,
                       burn_in: int) -> ProbeStepOut:
    """One fused serving step for ALL engine slots (vector per-slot state).

    zq/zk (B, f) f32 feature views of the running step embedding; boundary
    (B,) bool marks slots finishing a reasoning step this token; (W (B, f),
    b (B,), ring (B, win) f32, n_scores (B,) i32, stopped (B,) bool,
    stop_step (B,) i32) is the per-slot state, updated in place; eta and
    lam are Python floats (used as f32)."""
    _build.forward_only("serving_probe_step", zq, zk, W, b, ring)
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
        int(burn_in), B, f, ring.shape[1],
        *instance(f, shared_view(zq, zk), ring.shape[1]),
        vector_rows(f, zq, zk, W),
        _build.stream_of(zq))
    _build.check(err, "serving_probe_step launch")
    _build.count_launch(serving_probe_step)
    return ProbeStepOut(s, W, b, ring, n_scores, smoothed, stopped, stop_step)


serving_probe_step.launches = 0
