"""Carry parameters from the JAX package into the port.

The JAX package's parameter pytree is nested dicts; the caller turns each
leaf into a numpy array (``np.asarray``), so the port never sees a JAX
array.  Names and layouts map one to one:

    embed                     (V_pad, d)
    final_norm.scale          (d,)
    layers.ln1.scale          (L, d)        stacked: leading L axis kept
    layers.ln2.scale          (L, d)
    layers.attn.wq            (L, d, H*dh)  x @ wq
    layers.attn.wk / wv       (L, d, KV*dh)
    layers.attn.wo            (L, H*dh, d)
    layers.mlp.w_gate / w_up  (L, d, d_ff)
    layers.mlp.w_down         (L, d_ff, d)
    lm_head                   (d, V_pad)    untied embeddings only

The probe's slow weights (``repro.core.probe.init_outer``'s dict: W0 (f,),
b0 (), theta_q/theta_k (d_phi, d_h), ...) map the same way.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device


def _convert(tree, dtype, device):
    if isinstance(tree, dict):
        return {k: _convert(v, dtype, device) for k, v in tree.items()}
    arr = np.asarray(tree)
    t = torch.from_numpy(np.array(arr, dtype=np.float32, copy=True))
    return t.to(device=device, dtype=dtype)


def from_jax_params(tree: Dict[str, Any], *,
                    dtype: Optional[torch.dtype] = torch.float32,
                    device=None) -> Dict[str, Any]:
    """JAX model parameters (nested dicts of numpy arrays) -> the port's
    parameter dict, same names and layouts, as ``dtype`` tensors on
    ``device`` (pass the model's compute dtype)."""
    return _convert(tree, dtype, resolve_device(device))


def from_jax_theta(theta: Dict[str, Any], device=None
                   ) -> Dict[str, torch.Tensor]:
    """JAX probe slow weights (dict of numpy arrays) -> float32 tensors."""
    return _convert(theta, torch.float32, resolve_device(device))
