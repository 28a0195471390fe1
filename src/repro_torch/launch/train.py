"""Training driver, on one card by default.

    python -m repro_torch.launch.train --arch smollm-360m \
        [--steps 100 --batch 8 --seq 128 --lr 3e-4 --warmup 20] \
        [--ckpt-dir DIR --ckpt-every 100] [--log-every 10] [--seed 0]
    python -m repro_torch.launch.train --arch smollm-360m --reduced \
        --device cpu --steps 20

The JAX package's ``repro/launch/train.py`` on one device (its ``--mesh``
is the multi-device port's): float32 master weights drawn from ``--seed``,
the synthetic token pipeline, Adam with global-norm clipping at 1.0 under
the cosine schedule, autograd of ``Model.loss`` (the forward in the
config's dtype, through no kernel).  With ``--ckpt-dir`` it resumes the
parameters from the latest ``step_<N>`` there, as JAX does (the optimizer
state, the schedule and the pipeline start afresh), saves every
``--ckpt-every`` steps and at the end.  Exits 0 only when the last loss
is below the first.
"""
from __future__ import annotations

import argparse
import time
from typing import List, NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import latest_step, restore, save_pytree
from repro_torch.configs import InputShape, get_config
from repro_torch.data import TokenPipeline, TokenPipelineConfig, device_batch
from repro_torch.models import build
from repro_torch.models.common import cdtype
from repro_torch.optim import Adam, cosine_schedule
from repro_torch.optim.adam import tree_leaves, tree_map


def make_train_step(model, opt):
    """(params, opt_state, batch) -> (params, opt_state, loss, metrics):
    autograd of ``model.loss`` over the float32 masters, Adam's updates
    added to them in place (JAX's ``params + updates``)."""
    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, metrics = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter(g if g is not None else torch.zeros_like(p)
                  for p, g in zip(leaves, grads))
        grads = tree_map(lambda _: next(it), params)
        updates, opt_state = opt.update(grads, opt_state, params)
        with torch.no_grad():
            for p, u in zip(leaves, tree_leaves(updates)):
                p.add_(u)
                p.requires_grad_(False)
        return (params, opt_state, loss.detach(),
                {k: v.detach() for k, v in metrics.items()})

    return train_step


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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cpu", "cuda"], default=None,
                    help="default cuda; cpu runs the plain PyTorch port")
    return ap.parse_args(argv)


def train(args) -> TrainResult:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build(cfg)
    dev = resolve_device(args.device)
    shape = InputShape("cli", args.seq, args.batch, "train")
    opt = Adam(lr=cosine_schedule(args.lr, args.warmup, args.steps),
               clip_norm=1.0)
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=model.text_len(shape),
        global_batch=args.batch, seed=args.seed))
    params = model.init(torch.Generator().manual_seed(args.seed), dev,
                        dtype="float32")
    opt_state = opt.init(params)
    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        start = latest_step(args.ckpt_dir)
        params = restore(params, f"{args.ckpt_dir}/step_{start}")
        print(f"[train] resumed from step {start}")
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
        params, opt_state, loss, _ = step_fn(params, opt_state, jb)
        losses.append(float(loss))        # waits for the step
        step_s.append(time.perf_counter() - tb)
        if (step + 1) % args.log_every == 0:
            dt = time.time() - t0
            print(f"[train] step {step+1:5d} loss "
                  f"{np.mean(losses[-args.log_every:]):.4f} "
                  f"({dt / (i + 1):.2f}s/step)")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save_pytree(params, args.ckpt_dir, step=step + 1)
    if args.ckpt_dir:
        save_pytree(params, args.ckpt_dir, step=start + len(losses))
    if losses:
        print(f"[train] done: loss {losses[0]:.4f} -> "
              f"{np.mean(losses[-5:]):.4f}")
    return TrainResult(losses, step_s, params, start,
                       args.batch * args.seq)


def exit_code(losses) -> int:
    """0 when the last loss is below the first (JAX's rule), else 1."""
    return 0 if losses and losses[-1] < losses[0] else 1


def main(argv=None) -> int:
    return exit_code(train(parse(argv)).losses)


if __name__ == "__main__":
    raise SystemExit(main())
