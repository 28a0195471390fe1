"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into one shared library with a
plain C interface, loaded with ``ctypes``.  No PyTorch header is included,
so a build takes seconds.  The build happens at first use, one ``nvcc``
per source started together, and is keyed by a hash of the sources and
flags: the library lands in ``build/repro_torch/<hash>/`` at the repo root
(listed in ``.gitignore``), next to ``build.log`` with ptxas's register and
spill report for each kernel.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_c = ctypes
_P = _c.c_void_p
# C signatures of the launchers (each returns cudaGetLastError() as int)
SIGNATURES = {
    "probe_step_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _c.c_float, _c.c_float, _c.c_int, _c.c_int,
                          _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int,
                          _c.c_int, _c.c_int, _P],
    "paged_decode_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _P, _P, _c.c_int, _c.c_int, _c.c_int, _c.c_int,
                            _c.c_int, _c.c_int, _c.c_int, _c.c_int,
                            _c.c_float, _P],
    "paged_chunk_launch": [_P, _P, _c.c_int, _P, _P, _P, _P, _P, _P, _P, _P,
                           _P, _P, _P, _P, _c.c_int, _c.c_int, _c.c_int,
                           _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int,
                           _c.c_int, _c.c_float, _P],
    "ttt_scan_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _c.c_int,
                        _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int,
                        _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int,
                        _P],
    "probe_spec_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _c.c_float, _c.c_float, _c.c_int, _c.c_int,
                          _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int,
                          _c.c_int, _c.c_int, _c.c_int, _P],
    "probe_chain_config": [_c.c_int, _c.c_int, _c.c_int, _c.c_int, _P],
    "flash_decode_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _c.c_int, _c.c_int, _c.c_int, _c.c_int,
                            _c.c_int, _c.c_int, _c.c_int, _c.c_float, _P],
    "flash_attention_launch": [_P, _P, _P, _P, _c.c_int, _c.c_int, _c.c_int,
                               _c.c_int, _c.c_int, _c.c_int, _c.c_int,
                               _c.c_int, _c.c_int, _c.c_float, _P],
    "wkv_scan_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _c.c_int, _c.c_int,
                        _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int,
                        _P],
    "wkv_scan_config": [_c.c_int, _c.c_int, _c.c_int, _P],
    "ttt_scan_config": [_c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int,
                        _c.c_int, _P],
    "cuda_error_string": [_c.c_int],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (PATH or /usr/local/cuda)")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless this source hash is already built;
    returns the library path.  Concurrent builders each compile into a
    private temp dir and publish with an atomic rename."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / "librepro_torch_kernels.so"
    if lib.exists():
        return lib
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        tmp = Path(tmp)
        procs = []
        for src in _sources():
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name} (rc={proc.returncode})\n{out}")
        if any(p.returncode for _, _, p in procs):
            raise RuntimeError("nvcc failed:\n" + "\n".join(log))
        tmp_lib = tmp / lib.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib)]
            + [str(o) for _, o, _ in procs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        log.append(f"build seconds: {time.perf_counter() - t0:.3f}")
        (tmp / "build.log").write_text("\n".join(log))
        try:
            tmp.rename(out_dir)
        except OSError:
            if not lib.exists():          # lost a race to nothing: retry
                raise
        # TemporaryDirectory cleans up whatever was not renamed
        tmp.mkdir(exist_ok=True)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = _c.c_int if name != "cuda_error_string" else _c.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err:
        msg = library().cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def ptr(t) -> int:
    return t.data_ptr()


def opt_ptr(t):
    """A tensor's pointer, or None (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
