"""Production and test meshes on ``torch.distributed``.

Functions, never module-level constants, as in the JAX package's
``repro/launch/mesh.py``: importing this module touches no process group.

Topology (the JAX package's): a single pod is 16 x 16 = 256 devices
(data x model); multi-pod is 2 pods x 256 = 512 with the "pod" axis
outermost.  A mesh covers the first ``prod(shape)`` ranks of the default
process group, which the caller starts (``init_distributed`` under
``torchrun``, or ``init_process_group`` with its backend, store and
timeout named).
"""
from __future__ import annotations

import datetime
import math
import os
from typing import Tuple


def _world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device_type: str):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = _world_size()
    if have < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}, have {have} — start one "
            "process a device under torchrun (launch.mesh.init_distributed)")
    return _mesh(shape, axes, device_type)


def make_test_mesh(shape: Tuple[int, ...] = (2, 2),
                   axes: Tuple[str, ...] = ("data", "model"),
                   device_type: str = "cuda"):
    """Small mesh for multi-process tests (4 to 8 ranks)."""
    n = math.prod(shape)
    have = _world_size()
    if have < n:
        raise RuntimeError(f"need {n} ranks, have {have}")
    return _mesh(shape, axes, device_type)


def init_distributed(timeout_s: float = 600.0):
    """Start the default process group of a ``torchrun`` rank: NCCL on
    ``cuda:LOCAL_RANK`` from the ``RANK``, ``WORLD_SIZE`` and
    ``LOCAL_RANK`` variables, the store at torchrun's ``MASTER_ADDR`` and
    ``MASTER_PORT``.
    Returns the rank's device.  Nothing here picks another backend or the
    CPU: without CUDA it raises."""
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        raise RuntimeError("init_distributed: NCCL needs CUDA and there is "
                           "no CUDA device")
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        if var not in os.environ:
            raise RuntimeError(f"init_distributed: {var} is not set (start "
                               "the ranks with torchrun)")
    device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    torch.cuda.set_device(device)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(os.environ["MASTER_ADDR"],
                          int(os.environ["MASTER_PORT"]), world, rank == 0,
                          timeout=timeout)
    dist.init_process_group("nccl", store=store, rank=rank, world_size=world,
                            device_id=device, timeout=timeout)
    return device


def _to_host(tree):
    """The tensors of a result tree (dicts, lists, tuples) as numpy arrays,
    bf16 widened to float32 (exactly); other leaves as they are."""
    import torch
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [_to_host(v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else type(tree)(vals)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().to("cpu")
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree


def _rank_main(fn, rank, world, args, backend, store_path, timeout_s,
               threads, device, out):
    import traceback

    import torch
    import torch.distributed as dist

    try:
        # this process's own environment: gloo on the loopback device
        os.environ["GLOO_SOCKET_IFNAME"] = "lo"
        torch.set_num_threads(threads)
        kw = {}
        if backend == "nccl":
            kw["device_id"] = torch.device(device)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s),
            **kw)
        try:
            out.put((rank, True, _to_host(fn(rank, world, *args))))
        finally:
            dist.destroy_process_group()
    except BaseException:
        out.put((rank, False, traceback.format_exc()))


def spawn_ranks(fn, world: int, args=(), *, backend: str, device: str,
                timeout_s: float, threads: int = 1):
    """``fn(rank, world, *args)`` in ``world`` fresh processes (the spawn
    start method) that share a default process group of ``backend``
    through a ``FileStore`` in a temporary directory, each with
    ``threads`` intra-op threads and the collectives' timeout
    ``timeout_s``.  Returns the ranks' results in rank order, tensors as
    numpy arrays.  A rank's exception, a rank that dies, or the deadline
    (``timeout_s`` from the start) raises with every traceback received;
    what is still running then is killed."""
    import multiprocessing as mp
    import queue
    import tempfile
    import time
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    results, errors = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world, args, backend,
                                   os.path.join(tmp, "store"), timeout_s,
                                   threads, device, out))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while len(results) < world and not errors:
                left = deadline - time.monotonic()
                if left <= 0:
                    errors.append(f"deadline of {timeout_s} s: ranks "
                                  f"{sorted(set(range(world)) - set(results))}"
                                  " did not finish")
                    break
                try:
                    rank, ok, payload = out.get(timeout=min(left, 1.0))
                except queue.Empty:
                    for r, p in enumerate(procs):
                        if r not in results and p.exitcode not in (None, 0):
                            errors.append(f"rank {r} died, exit code "
                                          f"{p.exitcode}")
                    continue
                if ok:
                    results[rank] = payload
                else:
                    errors.append(f"rank {rank}:\n{payload}")
        finally:
            for p in procs:
                p.join(timeout=0 if errors else 10)
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        raise RuntimeError("spawn_ranks: " + "\n".join(errors))
    return [results[r] for r in range(world)]
