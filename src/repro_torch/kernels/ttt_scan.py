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
Pallas knobs ``t_chunk`` and ``interpret`` have no counterpart.  ``BANDS``
chooses the kernel's instance for a width (``instance``); it scores
``lookahead_steps(f, same)`` steps per block reduction, the L-step form
that ``ttt_probe_lookahead_plain`` mirrors.  The kernel is forward only:
a tensor that requires grad is refused on every device (differentiate
``core.ttt``'s autograd loop instead).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from repro_torch.core import probe as P
from repro_torch.kernels import _build

# the widest d_model among the repo's configs (llava-next-34b); the
# kernel's widest instance (BANDS) keeps W in registers, 7 features a
# thread of 1024
MAX_F = 7168


class Band(NamedTuple):
    """One width band of csrc/ttt_scan.cu's instances."""
    f_max: int        # widest f it takes
    threads: int
    fpt: int          # features a thread (threads * fpt >= f_max)
    l_same: int       # L where zq is zk (the no-QK view)
    l_distinct: int   # L where it is not
    min_blocks: int   # blocks an SM must hold (the register budget)
    in_flight: int    # L-blocks of rows loaded ahead


# The kernel's policy: which compiled instance a width takes.  L steps
# share one block reduction; L is the widest in {1, 2, 4, 8} whose rows in
# flight and sums fit the band's register budget: two blocks of 256
# threads an SM at the served widths (960, and 2048 for rwkv6-1.6b; N 170
# > 132 SMs, so every trajectory's block is resident at once; on an H100
# one block of 512 an SM made the 2048 band 1.3x slower, PERF.md), 64
# registers a thread at 1024 threads.  The narrow band runs four warps of
# one feature a thread with two L-blocks in flight: its chain, not its
# bytes, sets its time.  csrc/ttt_scan.cu builds exactly the instances
# these name (tests/test_torch_scan_blocked.py holds the two lists equal)
# and launches the one the wrapper names.
BANDS = (Band(128, 128, 1, 8, 8, 1, 2), Band(1024, 256, 4, 8, 4, 2, 1),
         Band(2048, 256, 8, 4, 2, 2, 1), Band(4096, 512, 8, 2, 1, 1, 1),
         Band(5120, 512, 10, 2, 1, 1, 1), Band(7168, 1024, 7, 2, 1, 1, 1))

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


def instance(f: int, same: bool) -> Tuple[int, ...]:
    """The figures of the instance width f takes, as the launcher reads
    them: (threads, features a thread, L, zq is zk, blocks an SM must hold,
    L-blocks in flight); ``same``: zq and zk are one tensor, the no-QK
    view."""
    for band in BANDS:
        if f <= band.f_max:
            return (band.threads, band.fpt,
                    band.l_same if same else band.l_distinct, int(same),
                    band.min_blocks, band.in_flight)
    raise ValueError(f"ttt_probe_batched: f={f} exceeds {MAX_F}")


def lookahead_steps(f: int, same: bool) -> int:
    """L, the steps one block reduction of the kernel serves at width f."""
    return instance(f, same)[2]


def ttt_probe_lookahead_plain(zq, zk, c, m, w0, b0, eta, L: int) -> Out:
    """The kernel's L-step form in plain PyTorch (the tests and chip_smoke's
    phase k5 use it; no path serves through it).  The update is rank one,
    W_{t+1} = W_t - a_t zk_t with a_t = eta m_t g_t, so from W = W_{t0}
    the dots of steps t0 .. t0 + L - 1 follow from dots with W and among
    the block's rows:

        zk_{t0+i} . W_{t0+i} = zk_{t0+i} . W - sum_{j<i} a_j zk_{t0+i} . zk_{t0+j}

    (likewise for zq); then W -= sum_i a_i zk_{t0+i} once.  w0 (N, f), b0
    (N,); the last block is short when L does not divide T.  Equals
    ``ttt_probe_batched_plain`` up to f32 rounding."""
    n, T, _ = zq.shape
    W, b = w0, b0
    scores = []
    for t0 in range(0, T, L):
        q, k = zq[:, t0:t0 + L], zk[:, t0:t0 + L]
        dq = torch.einsum("nlf,nf->nl", q, W)
        dk = torch.einsum("nlf,nf->nl", k, W)
        gq = torch.einsum("nif,njf->nij", q, k)
        gk = torch.einsum("nif,njf->nij", k, k)
        coef = []
        for i in range(q.shape[1]):
            t = t0 + i
            s_q = torch.sigmoid(dq[:, i] + b)
            s_k = torch.sigmoid(dk[:, i] + b)
            g = 2.0 * (s_k - c[:, t]) * s_k * (1.0 - s_k)
            a = (eta * m[:, t]) * g
            b = b - a
            scores.append(s_q)
            coef.append(a)
            # the later steps' dots, corrected for this step's update
            dq = dq - a[:, None] * gq[:, :, i]
            dk = dk - a[:, None] * gk[:, :, i]
        W = W - torch.einsum("nl,nlf->nf", torch.stack(coef, dim=1), k)
    s = (torch.stack(scores, dim=1) if scores
         else zq.new_zeros((n, 0)))
    return s, W, b


def kernel_config(f: int, same: bool) -> dict:
    """The instance width f takes on the card: its figures (``instance``)
    and, from the library itself, its registers, shared bytes (the warp and
    block sums) and spill bytes a thread."""
    fig = instance(f, same)
    out = (ctypes.c_int * 3)()
    _build.check(_build.library().ttt_scan_config(*fig, out),
                 "ttt_scan_config")
    keys = ("threads", "features_per_thread", "L", "same", "min_blocks",
            "blocks_in_flight", "registers", "static_smem", "local_bytes")
    return dict(zip(keys, (*fig, *out)))


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
                         "widest d_model of the repo's configs, for which "
                         "the kernel has an instance")


def _scan(zq, zk, c, m, w0, b0, eta, *, shared: bool) -> Out:
    """The one dispatcher behind both entry points."""
    _build.forward_only("ttt_probe_batched", zq, zk, c, m, w0, b0, eta,
                        hint="differentiate core.ttt's autograd loop "
                        "(outer_loss) instead")
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
    fig = instance(f, zq.data_ptr() == zk.data_ptr())
    scores = torch.empty((n, T), dtype=torch.float32, device=dev)
    w_f = torch.empty((n, f), dtype=torch.float32, device=dev)
    b_f = torch.empty((n,), dtype=torch.float32, device=dev)
    p = _build.ptr
    err = _build.library().ttt_scan_launch(
        p(zq), p(zk), p(c), p(m), p(w0), p(b0), p(eta), p(scores), p(w_f),
        p(b_f), n, T, f, 0 if shared else f, 0 if shared else 1, *fig,
        _build.stream_of(zq))
    _build.check(err, "ttt_probe_batched launch")
    if n:
        _build.count_launch(ttt_probe_batched)
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
