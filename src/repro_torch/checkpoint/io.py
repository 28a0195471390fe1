"""Pytree checkpointing: flattened-key npz + json metadata, atomic writes
(the JAX package's ``repro/checkpoint/io.py`` layout, so a checkpoint
written by either package restores in the other).

Layout: <dir>/step_<N>/arrays.npz + meta.json, each leaf under its key
path joined by ``//`` (``layers//attn//wq``).  numpy has no bf16: the
port widens bf16 leaves to float32 on save (exact), and reads the raw
two-byte records a JAX bf16 leaf leaves in the npz back as bf16
(``models.convert.to_numpy`` makes the host copy).
Restoration matches by key path against a template tree (shapes checked)
and casts each leaf to the template's dtype.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.models.convert import to_numpy

_SEP = "//"


def _flatten(tree, prefix=()) -> Dict[str, Any]:
    """Nested dicts (and lists or tuples, as ``[i]``) -> {key path: leaf}."""
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return {_SEP.join(prefix): tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, prefix + (k,)))
    return out


def save_pytree(tree, directory: str, step: Optional[int] = None,
                meta: Optional[Dict[str, Any]] = None) -> str:
    """Write ``tree`` to <directory>/step_<step> (or ``final``) through a
    temporary directory beside it, published by one rename."""
    sub = f"step_{step}" if step is not None else "final"
    target = os.path.join(directory, sub)
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=directory, prefix=".ckpt_tmp_")
    try:
        flat = _flatten(to_numpy(tree))
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, **(meta or {})}, f)
        if os.path.isdir(target):
            shutil.rmtree(target)
        os.replace(tmp, target)           # atomic publish
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return target


def load_pytree(path: str) -> Dict[str, np.ndarray]:
    """The flat {key path: array} of a checkpoint (a JAX bf16 leaf comes
    back as two-byte records, dtype ``|V2``)."""
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


def _tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        # the bits of a bf16 leaf saved by the JAX package
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def restore(template, path: str, device=None):
    """The checkpoint at ``path`` in the structure of ``template`` (nested
    dicts of tensors, meta tensors allowed): each leaf of the template's
    shape (else ValueError) cast to its dtype, on ``device`` (None: the
    template leaf's device, the CPU for a meta leaf).  A missing key is a
    KeyError."""
    flat = load_pytree(path)

    def one(key, leaf):
        if key not in flat:
            raise KeyError(f"checkpoint missing {key}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {arr.shape} != template "
                             f"{tuple(leaf.shape)}")
        dev = device if device is not None else (
            "cpu" if leaf.device.type == "meta" else leaf.device)
        return _tensor(arr).to(device=dev, dtype=leaf.dtype)

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, prefix + (str(k),)) for k, v in tree.items()}
        return one(_SEP.join(prefix), tree)

    return walk(template, ())


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m:
            steps.append(int(m.group(1)))
    return max(steps) if steps else None
