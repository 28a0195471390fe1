"""Carry parameters from the JAX package into the port.

The JAX package's parameter pytree is nested dicts; the caller turns each
leaf into a numpy array (``np.asarray``), so the port never sees a JAX
array.  Names and layouts map one to one:

    embed                     (V_pad, d)
    final_norm.scale          (d,)
    final_norm.bias           (d,)          LayerNorm configs (stablelm-3b)
    layers.ln1.scale          (L, d)        stacked: leading L axis kept
    layers.ln2.scale          (L, d)
    layers.ln1.bias / ln2.bias  (L, d)      LayerNorm configs
    layers.attn.wq            (L, d, H*dh)  x @ wq
    layers.attn.wk / wv       (L, d, KV*dh)
    layers.attn.bq            (L, H*dh)     qkv_bias configs (qwen1.5-32b,
    layers.attn.bk / bv       (L, KV*dh)    stablelm-3b)
    layers.attn.wo            (L, H*dh, d)
    layers.mlp.w_gate / w_up  (L, d, d_ff)
    layers.mlp.w_down         (L, d_ff, d)
    lm_head                   (d, V_pad)    untied embeddings only

The VLM (``arch_type == "vlm"``) adds its patch projector:

    projector.w1              (embed_dim, d)  patches @ w1
    projector.b1              (d,)
    projector.w2              (d, d)
    projector.b2              (d,)

MoE configs (``models/moe.py``) in place of the three mlp leaves; (f32)
marks a leaf read through a float32 cast, as for RWKV6 below:

    layers.mlp.router         (L, d, E)     (f32)
    layers.mlp.w_gate / w_up  (L, E, d, d_ff)
    layers.mlp.w_down         (L, E, d_ff, d)

RWKV6 (``models/rwkv6.py``), the same way; (f32) marks the leaves the
model reads through a float32 cast, which stay float32 when the rest is
converted to bf16 (the model's ``decls`` declare them so):

    embed (V_pad, d); lm_head (d, V_pad)
    ln0.scale / .bias, final_norm.scale / .bias        (d,)      (f32)
    layers.ln1 / ln2 .scale / .bias                    (L, d)    (f32)
    layers.tm.mu              (L, 5, d)     r, k, v, w, g token-shift mixes
    layers.tm.w0              (L, d)        (f32) decay offset
    layers.tm.wA / wB         (L, d, 64) / (L, 64, d)  decay LoRA
    layers.tm.u               (L, H, dh)    (f32) current-token bonus
    layers.tm.Wr / Wk / Wv / Wg / Wo        (L, d, d)  x @ W
    layers.tm.gn_scale / gn_bias            (L, d)     (f32) group norm
    layers.cm.mu_k / mu_r     (L, d)
    layers.cm.Wk (L, d, d_ff); cm.Wv (L, d_ff, d); cm.Wr (L, d, d)

hymba (``models/hymba.py``): the dense leaves above (no biases, untied
lm_head) and, with di = expand * d, ds = state_dim, r = dt_rank:

    meta_tokens               (n_meta, d)   put in front of the prompt
    layers.mamba.w_in         (L, d, 2 di)  x @ w_in -> [x_in | z]
    layers.mamba.conv_w       (L, conv_dim, di); conv_b (L, di)
    layers.mamba.w_x_dt       (L, di, r); w_dt (L, r, di)
    layers.mamba.b_dt         (L, di)
    layers.mamba.w_B / w_C    (L, di, ds)
    layers.mamba.A_log        (L, di, ds)   (f32)
    layers.mamba.D            (L, di)       (f32)
    layers.mamba.w_out        (L, di, d)
    layers.norm_attn.scale / norm_ssm.scale  (L, d)
    layers.beta               (L, 2)        (f32) branch weights

A_log, D and beta are read through a float32 cast in JAX, so they stay
float32 (A_log's small random values would round in bf16); b_dt is cast
to the activation dtype there, so it is stored in it like the weights,
which gives the values JAX's cast gives.

whisper (``models/whisper.py``), tied embeddings (no lm_head), LayerNorm
scales and biases throughout:

    pos_embed                 (32768, d)    decoder learned positions
    enc_layers.ln1 / ln2 .scale / .bias     (Le, d)
    enc_layers.attn.wq / wk / wv / wo       (Le, d, H*dh) / (Le, H*dh, d)
    enc_layers.attn.bq / bk / bv            (Le, H*dh)
    enc_layers.mlp.w_in (Le, d, d_ff); b_in (Le, d_ff)
    enc_layers.mlp.w_out (Le, d_ff, d); b_out (Le, d)
    enc_norm.scale / .bias    (d,)
    dec_layers.ln1 / ln2 / ln3 .scale / .bias  (L, d)
    dec_layers.self_attn.*, dec_layers.cross_attn.*  as enc_layers.attn.*
    dec_layers.mlp.*          as enc_layers.mlp.*

The probe's slow weights (``repro.core.probe.init_outer``'s dict: W0 (f,),
b0 (), theta_q/theta_k (d_phi, d_h), ...) map the same way.

``from_jax_params(..., dtype="float32")`` keeps every leaf float32, the
trainer's float32 masters (JAX's own storage); ``to_numpy`` is the way
back, a port tree as numpy arrays (bf16 widened to float32, exactly),
which the checkpoints write.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.common import Param, cdtype, torch_dtype


def _convert(tree, dtype, device, decls=None):
    if isinstance(tree, dict):
        return {k: _convert(v, dtype, device,
                            None if decls is None else decls[k])
                for k, v in tree.items()}
    arr = np.asarray(tree)
    t = torch.from_numpy(np.array(arr, dtype=np.float32, copy=True))
    if isinstance(decls, Param) and decls.dtype is not None:
        dtype = torch_dtype(decls.dtype)
    return t.to(device=device, dtype=dtype)


def from_jax_params(tree: Dict[str, Any], model, *, device=None,
                    dtype=None) -> Dict[str, Any]:
    """JAX model parameters (nested dicts of numpy arrays) -> the port's
    parameter dict for ``model`` (a ``Model`` from ``models.build``), same
    names and layouts, on ``device``: with ``dtype`` None each leaf in
    ``model.cfg.dtype``, except the leaves ``model.decls`` declares
    float32, which stay float32 as ``Model.init`` keeps them; with
    ``dtype="float32"`` every leaf float32 (the trainer's masters)."""
    if dtype is None:
        return _convert(tree, cdtype(model.cfg), resolve_device(device),
                        model.decls)
    return _convert(tree, torch_dtype(dtype), resolve_device(device))


def to_numpy(tree):
    """A port tree (nested dicts, lists or tuples of tensors) -> the same
    structure of numpy arrays on the host, bf16 and f16 leaves widened to
    float32 (exact; numpy has no bf16); a leaf that is no tensor goes
    through ``np.asarray``."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if not isinstance(tree, torch.Tensor):
        return np.asarray(tree)
    t = tree.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy()


def from_jax_theta(theta: Dict[str, Any], device=None
                   ) -> Dict[str, torch.Tensor]:
    """JAX probe slow weights (dict of numpy arrays) -> float32 tensors."""
    return _convert(theta, torch.float32, resolve_device(device))
