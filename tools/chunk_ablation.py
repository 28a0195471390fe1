#!/usr/bin/env python3
"""Ablations of K3's tensor-core kernel (``csrc/paged_chunk.cu``) on one
CUDA card.

    python3 tools/chunk_ablation.py

Builds four variants of ``src/repro_torch/csrc/paged_chunk.cu`` side by
side (one ``nvcc`` each) and times them through their launcher on
``chip_smoke.py``'s packed-chunk inputs, in turns (a, b, c, d, d, c,
b, a, twice), with ``chip_smoke.Timer``:

* ``tree``:      the sources as they are;
* ``q-shared``:  d 64 keeps its three q terms in shared memory, read
  through ldmatrix, as d 128 does (``ChunkQ<64>`` = ``QShared<64>``);
* ``one-warp``:  a block at G 1 is the head's one warp, which stages every
  K/V tile alone (``chunk_warps``: G warps);
* ``smem-pad``:  every block asks for 64 KB more dynamic shared memory
  than it uses: what the size of a block's shared memory costs alone.

Prints one line per case with each variant's median and its runs, then
the card's name and power limit.  Exits non-zero without a card or when a
substitution no longer matches the sources.
"""
import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

PC = "paged_chunk.cu"
VARIANTS = {
    "tree": [],
    "q-shared": [(PC, "  static constexpr bool kShared = D > 80;",
                  "  static constexpr bool kShared = D != 80;")],
    "one-warp": [(PC, "return G == 1 ? 4 : G;", "return G;")],
    "smem-pad": [(PC, "  s.total = off;\n",
                  "  s.total = off + 64 * 1024;\n")],
}
# (label, segments as (tokens, cached positions), pages, shape): the served
# chunk of each config (a prompt's third chunk packed with the next one's
# head), and four segments at qwen1.5-32b's G 1
CASES = [("smollm served", [(32, 128), (32, 0)], "bf16", "SMOLLM"),
         ("llama served", [(32, 128), (32, 0)], "bf16", "LLAMA"),
         ("qwen served", [(32, 128), (32, 0)], "int8", "QWEN"),
         ("qwen four segments", [(16, 200), (16, 0), (16, 37), (8, 255)],
          "int8", "QWEN")]


def build(tmp, name, subs):
    from repro_torch.kernels import _build
    src = os.path.join(tmp, name)
    shutil.copytree(_build.CSRC, src)
    for fname, old, new in subs:
        path = os.path.join(src, fname)
        text = open(path).read()
        if old not in text:
            raise SystemExit(f"chunk_ablation: {name}: {fname} no longer "
                             f"holds {old!r}")
        open(path, "w").write(text.replace(old, new))
    lib = os.path.join(tmp, f"lib_{name}.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", src, "-shared", "-o",
           lib, os.path.join(src, PC)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def packed_inputs(torch, cs, gen, segs, dtype, shape, C=64, R=4, nb=16):
    """One packed chunk as phase k3's ``k3_b4_case`` builds it."""
    H, KV, d, _ = shape
    k, v, ks, vs, tables = cs.chunk_pool(torch, gen, R, nb, dtype, KV, d)
    seg = torch.full((C,), len(segs) - 1, dtype=torch.int32)
    starts = torch.zeros(R, dtype=torch.int32)
    off = 0
    for i, (t, cached) in enumerate(segs):
        seg[off:off + t] = i
        starts[i] = cached
        off += t
    valid = torch.arange(nb * 16)[None, :] < starts[:, None]
    q = torch.randn(C, H, d, generator=gen)
    return [t.to("cuda") for t in (q, seg, tables, valid)] + [k, v, ks, vs]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chunk_ablation: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_chunk as K3
    with tempfile.TemporaryDirectory() as tmp:
        procs = {n: build(tmp, n, s) for n, s in VARIANTS.items()}
        libs = {}
        for name, (path, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode:
                print(out, file=sys.stderr)
                return 1
            lib = ctypes.CDLL(path)
            lib.paged_chunk_launch.argtypes = \
                _build.SIGNATURES["paged_chunk_launch"]
            libs[name] = lib
        timer = cs.Timer(torch)
        p, opt = _build.ptr, _build.opt_ptr

        def launcher(lib, args):
            """The variant's launch on ``args`` and the (o, l, m) it
            writes."""
            q, seg, tables, valid, k, v, ks, vs = args
            n, h, d = q.shape
            n_kv = k.shape[1]
            g = h // n_kv
            o = torch.empty(n, n_kv, g, d, device="cuda")
            l = torch.empty(n, n_kv, g, device="cuda")
            m = torch.empty_like(l)
            return (lambda: lib.paged_chunk_launch(
                p(q), p(seg), 0, p(k), p(v), opt(ks), opt(vs), p(tables),
                p(valid), p(o), p(l), p(m), None, None, None, n,
                tables.shape[0], n_kv, g, d, k.shape[2], tables.shape[1], 1,
                K3._DTYPE_CODE[k.dtype], 1.0 / d ** 0.5,
                _build.stream_of(q))), (o, l, m)

        gen = torch.Generator().manual_seed(cs.SEED + 24)
        names = list(VARIANTS)
        order = (names + names[::-1]) * 2
        for label, segs, dtype, shape in CASES:
            args = packed_inputs(torch, cs, gen, segs, dtype,
                                 getattr(cs, shape))
            q, seg, tables, valid, k, v, ks, vs = args
            want = K3.paged_packed_chunk_plain(q, k, v, seg, tables, valid,
                                               ks, vs)
            # every variant computes the partials of the plain version
            for name in names:
                call, out = launcher(libs[name], args)
                _build.check(call(), f"{name} {label}")
                m_err, o_err = cs.chunk_partial_errors(out, want)
                if not (m_err <= cs.K3_M_TOL and o_err <= cs.K3_OUT_TOL):
                    raise SystemExit(f"chunk_ablation: {name} {label}: m "
                                     f"err {m_err}, output err {o_err}")
            runs = {}
            for name in order:
                runs.setdefault(name, []).append(
                    timer(launcher(libs[name], args)[0]))
            print(label, {n: dict(median=sorted(r)[len(r) // 2], runs=r)
                          for n, r in runs.items()}, flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
