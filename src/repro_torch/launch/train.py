"""Training driver, on one card by default.

    python -m repro_torch.launch.train --arch smollm-360m \
        [--steps 100 --batch 8 --seq 128 --lr 3e-4 --warmup 20] \
        [--ckpt-dir DIR --ckpt-every 100] [--log-every 10] [--seed 0] \
        [--mesh none|single|multi]
    python -m repro_torch.launch.train --arch smollm-360m --reduced \
        --device cpu --steps 20
    torchrun --nproc-per-node 256 ... -m repro_torch.launch.train \
        --arch smollm-360m --mesh single

The JAX package's ``repro/launch/train.py``: float32 master weights drawn
from ``--seed``, the synthetic token pipeline, Adam with global-norm
clipping at 1.0 under the cosine schedule, autograd of ``Model.loss`` (the
forward in the config's dtype, through no kernel).  With ``--ckpt-dir`` it
resumes the parameters from the latest ``step_<N>`` there, as JAX does
(the optimizer state, the schedule and the pipeline start afresh), saves
every ``--ckpt-every`` steps and at the end.  Exits 0 only when the last
loss is below the first.

``--mesh single`` (16 x 16, data x model) or ``multi`` (2 x 16 x 16) runs
every rank of a ``torchrun`` job (NCCL, one card a rank) under
``make_context``'s train context: each rank keeps its shards of the
parameters and of Adam's moments (``launch.shardings``) and its data
rows; the step (``make_train_step``) is the same function the one-device
run takes.  A checkpoint under a mesh holds the whole arrays (JAX's
layout), written by rank 0; a restore shards them again.  Too few ranks
for the mesh raise, as in JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import List, NamedTuple

import numpy as np
import torch

from repro_torch import parallel, resolve_device
from repro_torch.checkpoint import latest_step, restore, save_pytree
from repro_torch.configs import InputShape, get_config
from repro_torch.data import TokenPipeline, TokenPipelineConfig, device_batch
from repro_torch.launch import shardings as SH
from repro_torch.launch.mesh import init_distributed, make_production_mesh
from repro_torch.models import build
from repro_torch.models.common import cdtype
from repro_torch.optim import Adam, cosine_schedule
from repro_torch.optim.adam import tree_leaves, tree_map


def loss_and_grads(model, params, batch):
    """(loss, metrics, grads) of ``model.loss`` at ``params`` (grads in
    the tree's structure, zeros where a leaf is unused).  Under a
    ``ParallelContext`` ``params`` are this rank's shards under
    ``model.specs`` of the context's rules and ``batch`` its rows: the
    forward reads ``shardings.compute_params`` of the shards and the
    gradients, the shards', are summed over the batch axes
    (``shardings.reduce_grads``).  The loss is the whole batch's on every
    rank."""
    ctx = parallel.current_ctx()
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    fwd = params
    if ctx is not None:
        fwd = SH.compute_params(model.decls, params, ctx)
    loss, metrics = model.loss(fwd, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for p in leaves:
        p.requires_grad_(False)
    it = iter(g if g is not None else torch.zeros_like(p)
              for p, g in zip(leaves, grads))
    grads = tree_map(lambda _: next(it), params)
    if ctx is not None:
        grads = SH.reduce_grads(grads, model.specs(ctx.rules), ctx)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def make_train_step(model, opt):
    """(params, opt_state, batch) -> (params, opt_state, loss, metrics):
    autograd of ``model.loss`` over the float32 masters
    (``loss_and_grads``), Adam's updates added to them in place (JAX's
    ``params + updates``).  Under a ``ParallelContext`` (read at each
    call) params, the optimizer state and the batch are this rank's
    shards and rows, and the clip's norm is the whole gradient's."""
    def train_step(params, opt_state, batch):
        loss, metrics, grads = loss_and_grads(model, params, batch)
        opt_state = apply_update(model, opt, params, grads, opt_state)
        return params, opt_state, loss, metrics

    return train_step


def apply_update(model, opt, params, grads, opt_state):
    """Adam's update of ``grads`` added to ``params`` in place; returns the
    optimizer state.  Under a ``ParallelContext`` the three are this
    rank's shards and the clip's norm is the whole gradient's."""
    ctx = parallel.current_ctx()
    specs = None if ctx is None else model.specs(ctx.rules)
    updates, opt_state = opt.update(grads, opt_state, params, specs)
    with torch.no_grad():
        for p, u in zip(tree_leaves(params), tree_leaves(updates)):
            p.add_(u)
    return opt_state


class TrainResult(NamedTuple):
    losses: List[float]
    step_s: List[float]          # wall seconds of each step, synced
    params: dict
    start: int                   # the step resumed from (0: fresh)
    tokens_per_step: int


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--mesh", choices=["none", "single", "multi"],
                    default="none")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cpu", "cuda"], default=None,
                    help="default cuda; cpu runs the plain PyTorch port")
    return ap.parse_args(argv)


def mesh_context(cfg, shape: InputShape, mesh_kind: str):
    """The train context of ``--mesh single|multi``: the production mesh
    over the ranks of a ``torchrun`` job (started here when its variables
    are set), ``make_context``'s rules.  Raises, as JAX does, when the job
    has too few ranks."""
    import torch.distributed as dist
    if "RANK" in os.environ and not dist.is_initialized():
        init_distributed()
    multi = mesh_kind == "multi"
    mesh = make_production_mesh(multi_pod=multi)
    return SH.make_context(cfg, mesh, shape, multi_pod=multi)


def save_sharded(params, specs, ctx, directory: str, step: int) -> None:
    """A checkpoint of the whole arrays (JAX's layout) from this rank's
    shards, written by rank 0 (every rank calls)."""
    import torch.distributed as dist
    full = SH.gathered(params, specs, ctx.mesh)
    if dist.get_rank() == 0:
        save_pytree(full, directory, step=step)
    dist.barrier()


def restore_sharded(template, specs, ctx, path: str):
    """This rank's shards of the whole-array checkpoint at ``path``;
    ``template`` holds whole-shaped leaves (meta tensors allowed) and
    ``ctx`` names the device through the mesh."""
    full = restore(template, path, device=ctx.mesh.device_type)
    return SH.with_shardings(full, specs, ctx.mesh)


def train(args) -> TrainResult:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build(cfg)
    shape = InputShape("cli", args.seq, args.batch, "train")
    ctx = specs = None
    if args.mesh != "none":
        ctx = mesh_context(cfg, shape, args.mesh)
        specs = model.specs(ctx.rules)
    dev = resolve_device(args.device)
    opt = Adam(lr=cosine_schedule(args.lr, args.warmup, args.steps),
               clip_norm=1.0)
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=model.text_len(shape),
        global_batch=args.batch, seed=args.seed))
    params = model.init(torch.Generator().manual_seed(args.seed), dev,
                        dtype="float32")
    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        start = latest_step(args.ckpt_dir)
        params = restore(params, f"{args.ckpt_dir}/step_{start}")
        print(f"[train] resumed from step {start}")
    if ctx is not None:
        params = SH.with_shardings(params, specs, ctx.mesh)
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"[train] {cfg.name}: {n_params/1e6:.1f}M params, "
          f"{args.steps} steps @ batch {args.batch} x seq {args.seq}")
    extra = {}
    if cfg.arch_type == "vlm":
        extra["patch_embeds"] = torch.zeros(
            (args.batch, cfg.frontend.n_tokens, cfg.frontend.embed_dim),
            dtype=cdtype(cfg), device=dev)
    if cfg.arch_type == "audio":
        extra["frames"] = torch.zeros(
            (args.batch, cfg.frontend.n_tokens, cfg.d_model),
            dtype=cdtype(cfg), device=dev)
    losses: List[float] = []
    step_s: List[float] = []
    t0 = time.time()
    for i, batch in enumerate(pipe):
        step = start + i
        if step >= args.steps:
            break
        tb = time.perf_counter()
        jb = {**device_batch(batch, dev), **extra}
        if ctx is not None:
            jb = SH.with_shardings(jb, SH.batch_spec_tree(jb, ctx.rules),
                                   ctx.mesh)
        with _parallel(ctx):
            params, opt_state, loss, _ = step_fn(params, opt_state, jb)
        losses.append(float(loss))        # waits for the step
        step_s.append(time.perf_counter() - tb)
        if (step + 1) % args.log_every == 0:
            dt = time.time() - t0
            print(f"[train] step {step+1:5d} loss "
                  f"{np.mean(losses[-args.log_every:]):.4f} "
                  f"({dt / (i + 1):.2f}s/step)")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            _save(params, specs, ctx, args.ckpt_dir, step + 1)
    if args.ckpt_dir:
        _save(params, specs, ctx, args.ckpt_dir, start + len(losses))
    if losses:
        print(f"[train] done: loss {losses[0]:.4f} -> "
              f"{np.mean(losses[-5:]):.4f}")
    return TrainResult(losses, step_s, params, start,
                       args.batch * args.seq)


def _parallel(ctx):
    return contextlib.nullcontext() if ctx is None \
        else parallel.use_parallel(ctx)


def _save(params, specs, ctx, directory: str, step: int) -> None:
    if ctx is None:
        save_pytree(params, directory, step=step)
    else:
        save_sharded(params, specs, ctx, directory, step)


def exit_code(losses) -> int:
    """0 when the last loss is below the first (JAX's rule), else 1."""
    return 0 if losses and losses[-1] < losses[0] else 1


def main(argv=None) -> int:
    return exit_code(train(parse(argv)).losses)


if __name__ == "__main__":
    raise SystemExit(main())
