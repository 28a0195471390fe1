"""K8: the RWKV6 WKV recurrence — hand-written CUDA kernel + its plain
PyTorch version.

Per (batch row, head), over T steps:

    out_t = r_t . (diag(u) k_t v_t^T + S_{t-1})
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T

r, k, v, w (B, T, H, d) f32, u (H, d), s0 (B, H, d, d) -> out (B, T, H, d)
and the final state.  It replaces the TPU kernel
``repro/kernels/rwkv6_scan.py:53 wkv_scan`` (body ``_kernel`` :23); the
plain version is the JAX model's own loop (``repro/models/rwkv6.py:90``,
the oracle ``repro/kernels/ref.py:232``).  The Pallas knobs ``ct`` and
``interpret`` have no counterpart: the kernel walks T inside the block.

Dispatch is by the input's device: CPU tensors take the plain version,
CUDA tensors the kernel (``csrc/rwkv6_scan.cu``); anything else raises.
The kernel is forward only: a tensor that requires grad is refused on every
device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

# the one head dim the kernel is built for: rwkv6-1.6b's ssm.head_dim
KERNEL_HEAD_DIM = 64


def wkv_scan_plain(r, k, v, w, u, s0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: a loop over T on the (B, H, d, d) state, every input
    cast to f32.  Returns (out (B, T, H, d), state_T)."""
    r, k, v, w, u = (t.float() for t in (r, k, v, w, u))
    S = s0.float()
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]        # (B,H,dk,dv)
        att = u[None, :, :, None] * kv + S
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], att))
        S = w[:, t, :, :, None] * S + kv
    out = torch.stack(outs, dim=1) if outs else torch.zeros_like(r)
    return out, S


def _check(r, k, v, w, u, s0, state_out) -> None:
    b, T, h, d = r.shape
    if d != KERNEL_HEAD_DIM:
        raise ValueError(f"wkv_scan: kernel built for d={KERNEL_HEAD_DIM} "
                         f"(rwkv6-1.6b's ssm.head_dim), got d={d}; other "
                         "head dims need their own instance")
    want = [("r", r, (b, T, h, d)), ("k", k, (b, T, h, d)),
            ("v", v, (b, T, h, d)), ("w", w, (b, T, h, d)),
            ("u", u, (h, d)), ("s0", s0, (b, h, d, d)),
            ("state_out", state_out, (b, h, d, d))]
    for name, t, shape in want:
        if t.device != r.device:
            raise ValueError(f"wkv_scan: {name} on {t.device}, r on "
                             f"{r.device}")
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"wkv_scan: {name} is {t.dtype} "
                             f"{tuple(t.shape)}, expected float32 {shape}")
        if not t.is_contiguous():
            raise ValueError(f"wkv_scan: {name} not contiguous")


def wkv_scan(r, k, v, w, u, s0, *,
             state_out: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The WKV recurrence.  r, k, v, w (B, T, H, d), u (H, d), s0
    (B, H, d, d), all f32 and contiguous on the card.  The final state is
    written into ``state_out`` when given (it may be ``s0`` itself: the
    state is then updated in place) and returned.  Returns (out, state)."""
    if any(t.requires_grad for t in (r, k, v, w, u, s0)):
        raise RuntimeError("wkv_scan is forward only: an input requires "
                           "grad")
    if r.device.type == "cpu":
        out, S = wkv_scan_plain(r, k, v, w, u, s0)
        if state_out is None:
            return out, S
        return out, state_out.copy_(S)
    if r.device.type != "cuda":
        raise RuntimeError(f"wkv_scan: no kernel for device {r.device}")
    if state_out is None:
        state_out = torch.empty_like(s0)
    _check(r, k, v, w, u, s0, state_out)
    b, T, h, d = r.shape
    out = torch.empty_like(r)
    p = _build.ptr
    err = _build.library().wkv_scan_launch(
        p(r), p(k), p(v), p(w), p(u), p(s0), p(out), p(state_out), b, T, h,
        d, _build.stream_of(r))
    _build.check(err, "wkv_scan launch")
    wkv_scan.launches += 1
    return out, state_out


wkv_scan.launches = 0
