"""K5: the offline TTT scan — hand-written CUDA kernel + its plain PyTorch
version.

``ttt_probe_batched`` runs the probe's inner loop over N whole
trajectories: per trajectory, T sequential score-then-update steps from
its own fast weights (W_i, b_i), with inner labels ``c`` and an update
mask ``m``.  It returns the raw scores and the final fast weights.  It
replaces the TPU kernel ``repro/kernels/ttt_probe.py:80
ttt_probe_batched`` (body ``_kernel`` :47); ``ttt_probe_scan`` (:132,
one shared (W0, b0)) and ``make_unroll_kernel`` (:148, the
``core.ttt.inner_unroll(kernel=)`` adapter) are its wrappers, as there.
The plain version follows ``repro/kernels/ref.py:37
ttt_probe_batched_ref`` with the port's ``core.probe.score_then_update``.

Dispatch is by the input's device: CPU tensors take the plain version,
CUDA tensors the kernel (``csrc/ttt_scan.cu``); anything else raises.  The
Pallas knobs ``t_chunk`` and ``interpret`` have no counterpart.  The
kernel is forward only: a tensor that requires grad is refused on every
device (differentiate ``core.ttt``'s autograd loop instead).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import probe as P
from repro_torch.kernels import _build

# the widest d_model among the repo's configs (llava-next-34b); the
# kernel keeps W in shared memory, 4 bytes a feature
MAX_F = 7168

Out = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def ttt_probe_batched_plain(zq, zk, c, m, w0, b0, eta) -> Out:
    """Plain PyTorch version: a loop over T on the (N, f) state."""
    n, T, _ = zq.shape
    W, b = w0, b0
    scores = []
    for t in range(T):
        s, W, b = P.score_then_update(W, b, zq[:, t], zk[:, t], c[:, t],
                                      m[:, t], eta)
        scores.append(s)
    s = (torch.stack(scores, dim=1) if scores
         else zq.new_zeros((n, 0)))
    return s, W, b


def _check(zq, zk, c, m, w0, b0, eta, shared: bool) -> None:
    n, T, f = zq.shape
    want = {"zq": (zq, (n, T, f)), "zk": (zk, (n, T, f)), "c": (c, (n, T)),
            "m": (m, (n, T)), "w0": (w0, (f,) if shared else (n, f)),
            "b0": (b0, () if shared else (n,)), "eta": (eta, ())}
    for name, (t, shape) in want.items():
        if t.device != zq.device:
            raise ValueError(f"ttt_probe_batched: {name} on {t.device}, "
                             f"zq on {zq.device}")
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"ttt_probe_batched: {name} is {t.dtype} "
                             f"{tuple(t.shape)}, expected float32 {shape}")
        if not t.is_contiguous():
            raise ValueError(f"ttt_probe_batched: {name} not contiguous")
    if f > MAX_F:
        raise ValueError(f"ttt_probe_batched: f={f} exceeds {MAX_F}, the "
                         "widest d_model of the repo's configs, which the "
                         "kernel keeps in shared memory")


def _scan(zq, zk, c, m, w0, b0, eta, *, shared: bool) -> Out:
    """The one dispatcher behind both entry points."""
    if any(isinstance(t, torch.Tensor) and t.requires_grad
           for t in (zq, zk, c, m, w0, b0, eta)):
        raise RuntimeError(
            "ttt_probe_batched is forward only: an input requires grad; "
            "differentiate core.ttt's autograd loop (outer_loss) instead")
    if zq.device.type == "cpu":
        if shared:
            n, f = zq.shape[0], zq.shape[-1]
            w0, b0 = w0.expand(n, f), b0.expand(n)
        return ttt_probe_batched_plain(zq, zk, c, m, w0, b0, eta)
    if zq.device.type != "cuda":
        raise RuntimeError(f"ttt_probe_batched: no kernel for device "
                           f"{zq.device}")
    _check(zq, zk, c, m, w0, b0, eta, shared)
    n, T, f = zq.shape
    dev = zq.device
    scores = torch.empty((n, T), dtype=torch.float32, device=dev)
    w_f = torch.empty((n, f), dtype=torch.float32, device=dev)
    b_f = torch.empty((n,), dtype=torch.float32, device=dev)
    p = _build.ptr
    err = _build.library().ttt_scan_launch(
        p(zq), p(zk), p(c), p(m), p(w0), p(b0), p(eta), p(scores), p(w_f),
        p(b_f), n, T, f, 0 if shared else f, 0 if shared else 1,
        _build.stream_of(zq))
    _build.check(err, "ttt_probe_batched launch")
    if n:
        ttt_probe_batched.launches += 1
    return scores, w_f, b_f


def ttt_probe_batched(zq, zk, c, m, w0, b0, eta) -> Out:
    """Offline scan with a VECTOR initial state: zq/zk (N, T, f) f32, c/m
    (N, T) f32, w0 (N, f), b0 (N,), eta a 0-d tensor on the same device.
    Returns (scores (N, T), w_final (N, f), b_final (N,))."""
    return _scan(zq, zk, c, m, w0, b0, eta, shared=False)


ttt_probe_batched.launches = 0


def ttt_probe_scan(zq, zk, c, m, w0, b0, eta) -> Out:
    """Offline scan from the SHARED meta-learned init: w0 (f,), b0 and eta
    0-d tensors; otherwise as ``ttt_probe_batched``, whose launch count it
    adds to (one kernel serves both)."""
    return _scan(zq, zk, c, m, w0, b0, eta, shared=True)


def make_unroll_kernel():
    """Adapter with the signature ``core.ttt.inner_unroll(kernel=)`` takes:
    (zq, zk, c, m, W0, b0, eta) -> (scores, W_f, b_f) for ONE trajectory
    (zq/zk (T, f), c/m (T,))."""
    def kern(zq, zk, c, m, w0, b0, eta):
        s, wf, bf = ttt_probe_scan(zq[None], zk[None], c[None], m[None],
                                   w0, b0, eta)
        return s[0], wf[0], bf[0]
    return kern
