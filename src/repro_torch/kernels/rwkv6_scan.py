"""K8: the RWKV6 WKV recurrence — hand-written CUDA kernel + its plain
PyTorch version.

Per (batch row, head), over T steps:

    out_t = r_t . (diag(u) k_t v_t^T + S_{t-1})
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T

r, k, v (B, T, H, d) f32 or bf16, w (B, T, H, d) f32, u (H, d), s0 (B, H,
d, d) -> out (B, T, H, d) f32 and the final state.  It replaces the TPU
kernel ``repro/kernels/rwkv6_scan.py:53 wkv_scan`` (body ``_kernel`` :23);
the plain version is the JAX model's own loop (``repro/models/rwkv6.py:90``,
the oracle ``repro/kernels/ref.py:232``).  The Pallas knobs ``ct`` and
``interpret`` have no counterpart: the kernel walks T inside the block,
``chunk_steps(T)`` steps staged at a time, over a grid of (B H,
``col_split(B, H)``) blocks; ``wkv_scan_blocked_plain`` mirrors that
schedule for the tests.

Dispatch is by the input's device: CPU tensors take the plain version,
CUDA tensors the kernel (``csrc/rwkv6_scan.cu``); anything else raises.
The kernel is forward only: a tensor that requires grad is refused on every
device.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

# the one head dim the kernel is built for: rwkv6-1.6b's ssm.head_dim
KERNEL_HEAD_DIM = 64
# the kernel's threads a block; with n_col column slices each thread holds
# 16 / n_col rows of one column
KERNEL_THREADS = 256
# steps staged into shared memory at a time (the ring of two stages, f32
# at n_col 1: 128 KB)
CHUNK_STEPS = 32
# blocks that fill the card (132 SMs): below this many (row, head) pairs
# the value columns are split over 2 or 4 blocks
FILL_BLOCKS = 128
# dtypes the kernel reads r, k and v in (widened to f32 on load)
INPUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def col_split(B: int, H: int) -> int:
    """Blocks that share one (row, head)'s value columns: 1 where B H
    already fills the card, else 2 or 4, so that a (1, T) prompt of 32
    heads runs 128 blocks."""
    bh = B * H
    if bh >= FILL_BLOCKS:
        return 1
    return 2 if 2 * bh >= FILL_BLOCKS else 4


def chunk_steps(T: int) -> int:
    """Steps the kernel stages at a time (at least 1, at most T)."""
    return max(1, min(T, CHUNK_STEPS))


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


def wkv_scan_blocked_plain(r, k, v, w, u, s0, *, n_col: int, chunk: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's schedule in plain PyTorch: the value columns cut into
    ``n_col`` slices, each with its own state slice; within a slice each of
    KERNEL_THREADS "threads" holds d / (KERNEL_THREADS / (d / n_col)) rows
    of one column and writes its partial of out_t[j] every step; after
    every ``chunk`` steps the partials are summed over the row groups, in
    group order.  Equals ``wkv_scan_plain`` up to f32 summation order."""
    r, k, v, w, u = (t.float() for t in (r, k, v, w, u))
    B, T, H, d = r.shape
    nc = d // n_col                       # columns a block
    ng = KERNEL_THREADS // nc             # row groups
    rows = d // ng                        # rows a thread
    out = torch.zeros_like(r)
    state = s0.float().clone()
    for cb in range(n_col):
        cols = slice(cb * nc, (cb + 1) * nc)
        S = state[..., cols]
        for t0 in range(0, T, chunk):
            steps = min(chunk, T - t0)
            part = r.new_empty((steps, B, H, ng, nc))
            for tl in range(steps):
                t = t0 + tl
                kv = k[:, t, :, :, None] * v[:, t, :, None, cols]
                att = u[None, :, :, None] * kv + S
                part[tl] = (r[:, t, :, :, None] * att).reshape(
                    B, H, ng, rows, nc).sum(3)
                S = w[:, t, :, :, None] * S + kv
            acc = part[:, :, :, 0]
            for g in range(1, ng):
                acc = acc + part[:, :, :, g]
            out[:, t0:t0 + steps, :, cols] = acc.permute(1, 0, 2, 3)
        state[..., cols] = S
    return out, state


def kernel_config(rkv_dtype, n_col: int, chunk: int) -> dict:
    """The instance a launch takes on the card, from the library itself:
    registers, spill bytes, and the dynamic shared bytes of its ring of
    ``chunk``-step stages (two; one when T fits one chunk)."""
    out = (ctypes.c_int * 4)()
    _build.check(_build.library().wkv_scan_config(
        INPUT_DTYPES[rkv_dtype], n_col, chunk, out), "wkv_scan_config")
    return dict(registers=out[0], local_bytes=out[2], ring_bytes=out[3])


def _check(r, k, v, w, u, s0, state_out) -> None:
    b, T, h, d = r.shape
    if d != KERNEL_HEAD_DIM:
        raise ValueError(f"wkv_scan: kernel built for d={KERNEL_HEAD_DIM} "
                         f"(rwkv6-1.6b's ssm.head_dim), got d={d}; other "
                         "head dims need their own instance")
    if r.dtype not in INPUT_DTYPES:
        raise ValueError(f"wkv_scan: r is {r.dtype}, expected one of "
                         f"{sorted(map(str, INPUT_DTYPES))}")
    want = [("r", r, (b, T, h, d), r.dtype), ("k", k, (b, T, h, d), r.dtype),
            ("v", v, (b, T, h, d), r.dtype),
            ("w", w, (b, T, h, d), torch.float32),
            ("u", u, (h, d), torch.float32),
            ("s0", s0, (b, h, d, d), torch.float32),
            ("state_out", state_out, (b, h, d, d), torch.float32)]
    for name, t, shape, dtype in want:
        if t.device != r.device:
            raise ValueError(f"wkv_scan: {name} on {t.device}, r on "
                             f"{r.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"wkv_scan: {name} is {t.dtype} "
                             f"{tuple(t.shape)}, expected {dtype} {shape}")
        if not t.is_contiguous():
            raise ValueError(f"wkv_scan: {name} not contiguous")
        # the kernel stages its inputs 16 bytes at a time
        if name in ("r", "k", "v", "w") and t.data_ptr() % 16:
            raise ValueError(f"wkv_scan: {name} not 16-byte aligned")


def wkv_scan(r, k, v, w, u, s0, *,
             state_out: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The WKV recurrence.  r, k, v (B, T, H, d) f32 or bf16 (one dtype),
    w (B, T, H, d), u (H, d), s0 (B, H, d, d) f32, all contiguous on the
    card.  The final state is written into ``state_out`` when given (it may
    be ``s0`` itself: the state is then updated in place) and returned.
    Returns (out f32, state)."""
    _build.forward_only("wkv_scan", r, k, v, w, u, s0)
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
    out = torch.empty_like(w)
    p = _build.ptr
    err = _build.library().wkv_scan_launch(
        p(r), p(k), p(v), p(w), p(u), p(s0), p(out), p(state_out), b, T, h,
        d, INPUT_DTYPES[r.dtype], col_split(b, h), chunk_steps(T),
        _build.stream_of(r))
    _build.check(err, "wkv_scan launch")
    _build.count_launch(wkv_scan)
    return out, state_out


wkv_scan.launches = 0
