"""Sharding policies: logical axes -> mesh axes, per workload.

The JAX package's ``repro/launch/shardings.py`` rule for rule.  The logical
axis names are those of the model zoo's ``Param`` declarations and
activation annotations:

    batch             activations' leading batch dim
    vocab             embedding / lm-head vocab dim (padded to 256)
    embed / embed2    d_model dims of weight matrices
    qkv / kv_qkv      flattened (n_heads*d_head) / (n_kv*d_head) dims
    mlp               d_ff
    experts           MoE expert dim
    inner / inner2    mamba d_inner / 2*d_inner
    heads             per-head parameter tables (rwkv u) — kept replicated
    layers            stacked-layer dim — never sharded

Policies:
    train "fsdp_tp"   batch -> (pod,)data; weights 2D-sharded
                      (embed -> data, ffn/heads/vocab/experts -> model)
    train "dp_tp"     weights replicated over data, TP over model
    serve "tp"        weights TP over model only; batch -> data; KV cache
                      sequence-sharded over model for flash-decode

A spec is a tuple with one entry a dim: None, a mesh axis or a tuple of
mesh axes (the entries of JAX's ``PartitionSpec``).  ``with_shardings``
turns a tree of whole tensors into this rank's local shards under a spec
tree, each of the shape JAX's sharding gives on the same mesh;
``gathered`` is the inverse, which tests and checkpoints take.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch import parallel
from repro_torch.configs import InputShape, ModelConfig
from repro_torch.parallel import ParallelContext


def data_axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def train_rules(multi_pod: bool, fsdp: bool) -> Dict[str, Any]:
    rules: Dict[str, Any] = {
        "batch": data_axes(multi_pod),
        "vocab": "model",
        "mlp": "model",
        "qkv": "model",
        "kv_qkv": "model",
        "experts": "model",
        "inner": "model",
        "inner2": "model",
        "heads": None,
        "embed2": None,
        "layers": None,
    }
    # second weight dim -> ZeRO-3 style under FSDP
    rules["embed"] = "data" if fsdp else None
    return rules


def serve_rules(multi_pod: bool) -> Dict[str, Any]:
    rules = train_rules(multi_pod, fsdp=False)
    rules["batch"] = data_axes(multi_pod)
    # kv cache sequence dim for flash-decode partial-softmax sharding
    rules["kv_seq"] = "model"
    return rules


def use_fsdp(cfg: ModelConfig) -> bool:
    """FSDP pays off above a few B params (weight memory dominates)."""
    return cfg.param_count() > 4e9


# ---------------------------------------------------------------------------
# batch / state specs

def _batch_leading(rank: int, b) -> tuple:
    return (b,) + (None,) * (rank - 1) if rank else ()


def _map_named(fn, tree, name=None):
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "shape"):
        fields = getattr(tree, "_fields", None)
        out = [_map_named(fn, v, fields[i] if fields else name)
               for i, v in enumerate(tree)]
        return type(tree)(*out) if fields else type(tree)(out)
    return fn(name, tree)


def batch_spec_tree(batch_tree, rules) -> Any:
    """Specs for a train/prefill/decode input batch: the batch dim on the
    data axes, "pos" replicated."""
    b = rules["batch"]
    return _map_named(lambda name, leaf: () if name == "pos"
                      else _batch_leading(len(leaf.shape), b), batch_tree)


def decode_state_specs(cfg: ModelConfig, state_tree, rules,
                       flash_decode: bool) -> Any:
    """Specs for the decode state tree, by arch family."""
    b = rules["batch"]
    seq_ax = rules.get("kv_seq") if flash_decode else None

    def one(name, leaf):
        shape = leaf.shape
        if name in ("k", "v", "k_scale", "v_scale"):
            # (L, B, KV, S, d) — sequence-shard for flash decode
            return (None, b, None, seq_ax, None)[:len(shape)]
        if name in ("cross_k", "cross_v"):
            return (None, b, None, None, None)
        if name == "wkv":                       # (L,B,H,dk,dv)
            return (None, b, "model", None, None)
        if name in ("tm_x", "cm_x"):            # (L,B,d)
            return (None, b, None)
        if name == "conv":                      # (L,B,w-1,di)
            return (None, b, None, "model")
        if name == "ssm":                       # (L,B,di,ds)
            return (None, b, "model", None)
        # probe state etc: batch-leading
        return _batch_leading(len(shape), b)

    return _map_named(one, state_tree)


def probe_state_specs(state_tree, rules) -> Any:
    b = rules["batch"]
    return _map_named(lambda _, leaf: _batch_leading(len(leaf.shape), b),
                      state_tree)


# ---------------------------------------------------------------------------
# local shards

def _zip(fn, tree, spec_tree):
    if isinstance(tree, dict):
        return {k: _zip(fn, v, spec_tree[k]) for k, v in tree.items()}
    fields = getattr(tree, "_fields", None)
    if fields is not None:
        return type(tree)(*(_zip(fn, v, s) for v, s in zip(tree, spec_tree)))
    return fn(tree, spec_tree)


def local_shard(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's shard of the whole tensor ``x`` under ``spec``."""
    ctx = ParallelContext(mesh=mesh, rules={})
    for dim, entry in enumerate(spec):
        if parallel.axis_names(entry):
            x = parallel.own_slice(x, entry, dim, ctx)
    return x.contiguous()


def gather_shard(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor from this rank's shard ``x`` under ``spec`` (a
    collective: every rank of the mesh calls it)."""
    ctx = ParallelContext(mesh=mesh, rules={})
    for dim, entry in enumerate(spec):
        for a in reversed(parallel.axis_names(entry)):
            x = parallel.all_gather(x, a, dim, ctx)
    return x


def with_shardings(tree, spec_tree, mesh):
    """Each rank's local shards of a tree of whole tensors."""
    return _zip(lambda x, s: local_shard(x, s, mesh), tree, spec_tree)


def gathered(tree, spec_tree, mesh):
    """The whole tensors of a tree of local shards (every rank calls)."""
    return _zip(lambda x, s: gather_shard(x, s, mesh), tree, spec_tree)


def replicated(tree, mesh):
    """A tree every rank holds whole (spec () on every leaf)."""
    return _zip(lambda x, _: x, tree, _map_named(lambda *_: (), tree))


def compute_params(decls, params, ctx: ParallelContext):
    """The parameter tree the training forward reads under ``ctx``, from
    this rank's shards: each leaf gathered over the mesh axes its dims
    are sharded on (autograd: the gradient of a dim gathered over the
    batch axes is summed over them, that of one gathered over an axis the
    computation is replicated on is the rank's slice), except the vocab
    dims (the embedding, logits and loss are vocab-parallel) and, with
    ``ep_moe``, the expert dim (``moe.moe_ep`` runs the local experts)."""
    batch = set(parallel.axis_names(ctx.rules.get("batch")))
    keep = {"vocab"} | ({"experts"} if ctx.ep_moe else set())

    def one(p, x):
        for dim, name in enumerate(p.axes):
            entry = ctx.rules.get(name) if name is not None else None
            if name in keep or not parallel.axis_names(entry):
                continue
            summed = bool(batch & set(parallel.axis_names(entry)))
            x = parallel.gather(x, entry, dim, summed=summed)
        return x

    return _zip_decls(one, decls, params)


def _zip_decls(fn, decls, tree):
    if isinstance(tree, dict):
        return {k: _zip_decls(fn, decls[k], v) for k, v in tree.items()}
    return fn(decls, tree)


def reduce_grads(grads, spec_tree, ctx: ParallelContext):
    """Sum each gradient over the batch axes, in place, where its leaf is
    not sharded over them (a leaf sharded over them had its gradient
    summed by the gather's backward)."""
    batch = parallel.axis_names(ctx.rules.get("batch"))

    def one(g, spec):
        on = {a for e in spec for a in parallel.axis_names(e)}
        if batch and not on & set(batch):
            parallel.all_reduce_(g, batch, "sum", ctx)
        return g

    return _zip(one, grads, spec_tree)


def make_context(cfg: ModelConfig, mesh, shape: InputShape, *,
                 multi_pod: bool) -> ParallelContext:
    """The ParallelContext the launchers install (JAX's ``make_context``:
    ``mesh`` needs only named dims and their sizes)."""
    is_train = shape.kind == "train"
    is_decode = shape.kind == "decode"
    fsdp = use_fsdp(cfg) and is_train
    rules = train_rules(multi_pod, fsdp) if is_train else serve_rules(multi_pod)
    if cfg.moe is not None:
        # expert weights are (E, d, f): experts already claim the model axis
        rules = dict(rules)
        rules["mlp"] = None
        if is_train and cfg.param_count() < 4e9:
            # small fine-grained MoE: spend the model axis on experts only;
            # attention runs data-parallel and the now-replicated weights
            # are FSDP-sharded over data (vocab stays on model)
            rules["qkv"] = rules["kv_qkv"] = None
            rules["embed"] = "data"
    # batch must divide the data axes (a global batch of 1 leaves the data
    # axis idle)
    sizes = parallel.mesh_shape(mesh)
    n_data = 1
    for a in data_axes(multi_pod):
        n_data *= sizes[a]
    if shape.global_batch % n_data:
        rules = dict(rules)
        rules["batch"] = None
    # flash-decode needs a sequence dim in the cache (not rwkv)
    flash = is_decode and cfg.arch_type != "ssm"
    return ParallelContext(
        mesh=mesh, rules=rules, data_axes=data_axes(multi_pod),
        model_axis="model",
        ep_moe=cfg.moe is not None,
        flash_decode=flash,
        attn_impl="blockwise",
        remat=is_train,
    )
