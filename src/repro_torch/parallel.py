"""Parallel context: logical-axis sharding rules threaded through model code.

The JAX package's ``repro/parallel.py`` on ``torch.distributed``.  Model
code names the logical axes of its tensors ("batch", "vocab", ...); the
launcher installs a ``ParallelContext`` that maps logical names to the axes
of a ``DeviceMesh`` with named dimensions.  Outside a context every
annotation is a no-op and every collective below is the identity, so model
code is mesh-agnostic, as in JAX.

There is no ``shard_map``: under a context each rank holds its local
shards (``launch.shardings``), and the two shard-map paths of the JAX
package (``attention._flash_decode_sharded`` and ``moe.moe_ep``) call the
collectives below on ``mesh.get_group(axis)`` themselves.  The layout the
collectives keep is JAX's: activations carry the batch on the data axes
and are replicated over ``model``; ``constrain`` states it.

Two kinds of operation need their own backward (Megatron's ``f`` and
``g``): ``reduce_from`` sums a tensor over mesh axes and passes the
gradient through (its output is replicated: each rank's backward already
holds the whole gradient); ``copy_to`` is the identity and sums the
gradient over the axes (a replicated input that feeds a computation
sharded over them).  ``gather`` assembles a tensor sharded along a dim:
over an axis the computation is replicated on, its backward is the rank's
own slice; over an axis whose ranks see different rows (the data axes),
the slice of the gradient summed over the axis.

Every collective is counted with its bytes by (axis, op) in
``COLLECTIVES`` (``collective_stats``, ``reset_collectives``).  gloo takes
CUDA tensors for every collective used here (all_reduce, all_gather with a
list of outputs, broadcast), bf16 included; it copies them through host
memory itself.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import time
from typing import Mapping, Optional, Sequence, Tuple, Union

import torch

Axes = Union[None, str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    mesh: object                          # a DeviceMesh with named dims
    rules: Mapping[str, Axes]             # logical axis -> mesh axes
    data_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    ep_moe: bool = False                  # expert-parallel MoE path
    flash_decode: bool = False            # seq-sharded decode attention
    attn_impl: str = "einsum"             # einsum | blockwise
    remat: bool = False

    def spec(self, logical: Sequence[Optional[str]]) -> Tuple[Axes, ...]:
        """The mesh axes of each dim, the entries of JAX's
        ``PartitionSpec``."""
        return tuple(None if name is None else self.rules.get(name)
                     for name in logical)

    def axis_size(self, axis: str) -> int:
        return mesh_shape(self.mesh)[axis]

    def axis_rank(self, axis: str) -> int:
        return self.mesh.get_local_rank(axis)

    def group(self, axis: str):
        return self.mesh.get_group(axis)


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a mesh."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def axis_names(entry: Axes) -> Tuple[str, ...]:
    """A spec entry (None, an axis or a tuple of axes) as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


_CTX: contextvars.ContextVar[Optional[ParallelContext]] = \
    contextvars.ContextVar("repro_torch_parallel_ctx", default=None)


def current_ctx() -> Optional[ParallelContext]:
    return _CTX.get()


@contextlib.contextmanager
def use_parallel(ctx: ParallelContext):
    token = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(token)


def constrain(x, *logical: Optional[str]):
    """State the layout of ``x`` under the active rules (JAX's sharding
    constraint).  The port keeps the layout its collectives give: the
    batch on the data axes, everything else replicated over ``model``; the
    annotation checks that it names every dim and returns ``x``."""
    if current_ctx() is not None:
        assert len(logical) == x.dim(), (tuple(x.shape), logical)
    return x


def attn_impl() -> str:
    ctx = current_ctx()
    return "einsum" if ctx is None else ctx.attn_impl


def remat_enabled() -> bool:
    ctx = current_ctx()
    return bool(ctx and ctx.remat)


# ---------------------------------------------------------------------------
# Collectives

# (axis, op) -> [calls, bytes, seconds]
COLLECTIVES: "collections.defaultdict" = collections.defaultdict(
    lambda: [0, 0, 0.0])


def reset_collectives() -> None:
    COLLECTIVES.clear()


def collective_stats() -> dict:
    """{"axis/op": {"calls", "bytes", "seconds"}} since the last reset."""
    return {f"{a}/{op}": {"calls": c, "bytes": b, "seconds": s}
            for (a, op), (c, b, s) in sorted(COLLECTIVES.items())}


def _live(ctx: ParallelContext, axes) -> Tuple[str, ...]:
    return tuple(a for a in axis_names(axes) if ctx.axis_size(a) > 1)


def _run(ctx, axis, op, t, fn):
    """``fn(tensor, group)`` on ``t`` over ``axis``, counted with its
    bytes and host seconds."""
    t0 = time.perf_counter()
    out = fn(t, ctx.group(axis))
    out = t if out is None else out
    rec = COLLECTIVES[(axis, op)]
    rec[0] += 1
    rec[1] += t.numel() * t.element_size()
    rec[2] += time.perf_counter() - t0
    return out


def all_reduce_(t: torch.Tensor, axes, op: str = "sum",
                ctx: Optional[ParallelContext] = None) -> torch.Tensor:
    """In-place sum or max of ``t`` over the mesh axes ``axes`` (no
    autograd)."""
    import torch.distributed as dist
    ctx = ctx or current_ctx()
    if ctx is None:
        return t
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    for a in _live(ctx, axes):
        t = _run(ctx, a, f"all_reduce_{op}", t,
                 lambda x, g: dist.all_reduce(x, op=rop, group=g))
    return t


def all_gather(t: torch.Tensor, axis: str, dim: int,
               ctx: Optional[ParallelContext] = None) -> torch.Tensor:
    """The shards of ``t`` over ``axis`` concatenated along ``dim`` in
    rank order (no autograd)."""
    import torch.distributed as dist
    ctx = ctx or current_ctx()
    n = ctx.axis_size(axis)
    if n == 1:
        return t

    def gather(x, g):
        outs = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(outs, x.contiguous(), group=g)
        return torch.cat(outs, dim)
    return _run(ctx, axis, "all_gather", t, gather)


def own_slice(t: torch.Tensor, axes, dim: int,
              ctx: Optional[ParallelContext] = None) -> torch.Tensor:
    """This rank's shard of ``t`` along ``dim`` over the axes ``axes``
    (the first axis major, as JAX lays out a tuple of axes)."""
    ctx = ctx or current_ctx()
    idx, n = 0, 1
    for a in axis_names(axes):
        idx = idx * ctx.axis_size(a) + ctx.axis_rank(a)
        n *= ctx.axis_size(a)
    if n == 1:
        return t
    assert t.shape[dim] % n == 0, (tuple(t.shape), dim, axes)
    size = t.shape[dim] // n
    return t.narrow(dim, idx * size, size)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, axes, ctx):
        return all_reduce_(x.clone(), axes, "sum", ctx)

    @staticmethod
    def backward(fctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, axes, ctx):
        fctx.axes, fctx.ctx = axes, ctx
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return all_reduce_(g.clone(), fctx.axes, "sum", fctx.ctx), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, axes, dim, summed, ctx):
        fctx.axes, fctx.dim, fctx.summed, fctx.ctx = axes, dim, summed, ctx
        # the last axis of a tuple is minor: gather it first
        for a in reversed(axis_names(axes)):
            x = all_gather(x, a, dim, ctx)
        return x

    @staticmethod
    def backward(fctx, g):
        if fctx.summed:
            g = all_reduce_(g.contiguous().clone(), fctx.axes, "sum",
                            fctx.ctx)
        return (own_slice(g, fctx.axes, fctx.dim, fctx.ctx).contiguous(),
                None, None, None, None)


def reduce_from(x: torch.Tensor, axes) -> torch.Tensor:
    """Sum over the mesh axes ``axes``; the gradient passes through."""
    ctx = current_ctx()
    if ctx is None or not _live(ctx, axes):
        return x
    return _ReduceFrom.apply(x, axes, ctx)


def copy_to(x: torch.Tensor, axes) -> torch.Tensor:
    """The identity; the gradient is summed over the mesh axes ``axes``."""
    ctx = current_ctx()
    if ctx is None or not _live(ctx, axes) or not x.requires_grad:
        return x
    return _CopyTo.apply(x, axes, ctx)


def gather(x: torch.Tensor, axes, dim: int, *,
           summed: bool) -> torch.Tensor:
    """``x`` sharded along ``dim`` over the mesh axes ``axes``, whole.
    ``summed``: the ranks of those axes compute on different rows, so the
    backward sums the gradient over them before taking the rank's slice."""
    ctx = current_ctx()
    if ctx is None or not _live(ctx, axes):
        return x
    return _Gather.apply(x, axes, dim, summed, ctx)


def axes_size(axes: Axes) -> int:
    """The number of shards over the mesh axes ``axes`` (1 outside a
    context)."""
    ctx = current_ctx()
    n = 1
    for a in axis_names(axes) if ctx is not None else ():
        n *= ctx.axis_size(a)
    return n


def axis_offset(axis: Axes, local: int) -> int:
    """The first global index of this rank's shard of ``local`` entries
    along a dim sharded over ``axis`` (0 outside a context)."""
    ctx = current_ctx()
    if ctx is None:
        return 0
    idx = 0
    for a in axis_names(axis):
        idx = idx * ctx.axis_size(a) + ctx.axis_rank(a)
    return idx * local
