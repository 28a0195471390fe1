"""Shared model building blocks (PyTorch, plain functions on tensors).

Parameters are declared once as ``Param`` leaves (shape + initializer) in a
nested dict with the JAX package's names and layouts — stacked layer leaves
keep their leading ``L`` axis — and ``init_params`` instantiates them from a
``torch.Generator``.  The JAX package keeps every leaf in float32 and casts
it at use.  Most leaves are cast to the compute dtype (``cfg.dtype``)
there, so the port stores them in it, rounded once to the values the casts
give.  A few are read through a float32 cast instead (RWKV6's ``u``,
``w0``, its group-norm and LayerNorm scales and biases): rounding those to
bf16 would change the model, so their ``Param`` says ``dtype="float32"``
and they stay float32 whatever the compute dtype.  The trainer keeps
float32 masters instead, as JAX trains: ``init_params`` (and
``Model.init``) take ``dtype=torch.float32`` for every leaf, and the
forward casts each at use, as JAX does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int8": torch.int8,
           "float64": torch.float64}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def cdtype(cfg) -> torch.dtype:
    return torch_dtype(cfg.dtype)


# ---------------------------------------------------------------------------
# Param declarations


@dataclasses.dataclass(frozen=True)
class Param:
    shape: Tuple[int, ...]
    init: str = "normal"                  # normal | zeros | ones | embed | small
    scale: float = 1.0
    # None: stored in the compute dtype; "float32": kept float32
    dtype: Optional[str] = None


def stack_decls(decls, n: int):
    """Add a leading stacked-layer dim to every declaration."""
    if isinstance(decls, Param):
        return dataclasses.replace(decls, shape=(n,) + decls.shape)
    return {k: stack_decls(v, n) for k, v in decls.items()}


def _leaf_std(p: Param) -> float:
    """The standard deviation of a random leaf's normal draw."""
    if p.init == "normal":
        # the JAX package's fan-in rule, read from the leaf's FIRST axis
        # (the stacked-layer axis for per-layer matrices)
        fan_in = p.shape[0] if len(p.shape) >= 2 else max(p.shape[-1], 1)
        return p.scale / math.sqrt(fan_in)
    if p.init in ("embed", "small"):
        return 0.02 * p.scale
    raise ValueError(p.init)


def _leaf_init(p: Param, gen: Optional[torch.Generator]) -> torch.Tensor:
    """A leaf on the CPU, drawn in float32."""
    if p.init == "zeros":
        return torch.zeros(p.shape)
    if p.init == "ones":
        return torch.ones(p.shape)
    x = torch.randn(p.shape, generator=gen, dtype=torch.float32)
    return x * _leaf_std(p)


def _leaf_on_device(p: Param, gen: torch.Generator, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """A leaf drawn where it lives, in its stored dtype: ``normal_`` writes
    the tensor in place, so no float32 copy of it exists anywhere (at
    qwen1.5-32b's width the float32 leaves would take 140 GB)."""
    out = torch.empty(p.shape, dtype=dtype, device=device)
    if p.init == "zeros":
        return out.zero_()
    if p.init == "ones":
        return out.fill_(1.0)
    return out.normal_(0.0, _leaf_std(p), generator=gen)


def _device_generator(gen: Optional[torch.Generator],
                      device: torch.device) -> torch.Generator:
    """``gen`` itself if it lives on ``device``, else a generator there
    seeded by one draw from ``gen``."""
    if gen is not None and gen.device == device:
        return gen
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
    return torch.Generator(device=device).manual_seed(seed)


def init_params(decls, generator: Optional[torch.Generator] = None,
                dtype: torch.dtype = torch.float32, device="cpu"):
    """Instantiate a decl tree: same distributions as the JAX package's
    ``init_params``, drawn from ``generator`` (so not the same numbers), in
    ``dtype`` except for the leaves declared float32.  On the CPU every
    leaf is drawn in float32 and cast; on another device each leaf is
    drawn there, in its stored dtype, from a generator on that device
    seeded by one draw from ``generator``."""
    device = torch.device(device)
    if device.type != "cpu":
        gen = _device_generator(generator, device)
        return _map_decls(decls, lambda p: _leaf_on_device(
            p, gen, torch_dtype(p.dtype) if p.dtype else dtype, device))
    return _map_decls(decls, lambda p: _leaf_init(p, generator).to(
        dtype=torch_dtype(p.dtype) if p.dtype else dtype))


def _map_decls(decls, fn):
    if isinstance(decls, Param):
        return fn(decls)
    return {k: _map_decls(v, fn) for k, v in decls.items()}


def param_shapes(decls, dtype: torch.dtype = torch.float32):
    """The parameter tree as shapes and dtypes, no storage: a tensor on
    the ``meta`` device per leaf, in ``dtype`` except the leaves declared
    float32 (JAX's ``param_shapes`` gives ShapeDtypeStructs)."""
    return _map_decls(decls, lambda p: torch.empty(
        p.shape, dtype=torch_dtype(p.dtype) if p.dtype else dtype,
        device="meta"))


# ---------------------------------------------------------------------------
# Numerics helpers

def rmsnorm(x, weight, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight.float()).to(dt)


def layernorm(x, weight, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = torch.square(x - mu).mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(dt)


def norm_decls(cfg) -> Dict[str, Param]:
    if cfg.norm == "rmsnorm":
        return {"scale": Param((cfg.d_model,), "ones")}
    return {"scale": Param((cfg.d_model,), "ones"),
            "bias": Param((cfg.d_model,), "zeros")}


def apply_norm(cfg, p, x):
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


# ---------------------------------------------------------------------------
# Rotary position embeddings (supports partial rotary)

def rope_frequencies(d_rot: int, theta: float, device="cpu") -> torch.Tensor:
    exps = torch.arange(0, d_rot, 2, dtype=torch.float32, device=device) / d_rot
    return 1.0 / (theta ** exps)


def rope_tables(positions: torch.Tensor, d_head: int, theta: float,
                rotary_pct: float = 1.0):
    """The rotation of ``positions`` (..., seq): (cos, sin) of
    (..., seq, 1, d_rot/2) and d_rot, or None where nothing rotates.
    Computed once, they serve every layer of a step
    (``apply_rope_tables``)."""
    d_rot = int(d_head * rotary_pct)
    d_rot -= d_rot % 2
    if d_rot == 0:
        return None
    freqs = rope_frequencies(d_rot, theta, positions.device)    # (d_rot/2,)
    angles = positions[..., None].float() * freqs               # (..., seq, d_rot/2)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :], \
        d_rot


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rotary_pct: float = 1.0) -> torch.Tensor:
    """x: (..., seq, n_heads, d_head); positions: (..., seq)."""
    return apply_rope_tables(x, rope_tables(positions, x.shape[-1], theta,
                                            rotary_pct))


def apply_rope_tables(x: torch.Tensor, tables) -> torch.Tensor:
    """x: (..., seq, n_heads, d_head) rotated by ``rope_tables``' tables
    of its positions."""
    if tables is None:
        return x
    cos, sin, d_rot = tables
    xr, xp = x[..., :d_rot], x[..., d_rot:]
    x1, x2 = xr[..., : d_rot // 2], xr[..., d_rot // 2:]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2, xp], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Activations

def gelu(x):
    """The tanh approximation, as the JAX package's
    ``jax.nn.gelu(x, approximate=True)``."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def swiglu(gate, up):
    return torch.nn.functional.silu(gate.float()).to(gate.dtype) * up


def relu_sq(x):
    r = torch.relu(x)
    return r * r


# ---------------------------------------------------------------------------
# Cross-entropy

def softmax_xent(logits: torch.Tensor, targets: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (B, S, V), targets (B, S) int; the mean over tokens of
    logsumexp minus the gold logit, in float32 (JAX's ``softmax_xent``),
    or with ``mask`` (B, S) the masked mean."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    loss = lse - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(loss * mask) / torch.clamp(mask.sum(), min=1.0)
    return loss.mean()
