#!/usr/bin/env python3
"""Ablations of K2's and K6's decode body on one CUDA card.

    python3 tools/decode_ablation.py

Builds three variants of ``src/repro_torch/csrc/{paged_decode,
flash_decode}.cu`` side by side (one ``nvcc`` each) and times them through
their launchers on ``chip_smoke.py``'s inputs, in turns (a, b, c, c, b, a,
twice), with ``chip_smoke.Timer``:

* ``tree``: the sources as they are;
* ``div``:  K2's page index by integer division instead of a shift
  (``PagedRows.bs_shift = -1``);
* ``expf``: the softmax in base e with a correction every group, instead
  of base 2 with the correction skipped while the running max stays.

Prints one line per case with each variant's median and its runs, then the
card's name and power limit.  Exits non-zero without a card or when a
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

DM = "decode_math.cuh"
VARIANTS = {
    "tree": [],
    "div": [("paged_decode.cu",
             "const int bs_shift = (bs & (bs - 1)) == 0 ? __ffs(bs) - 1 : -1;",
             "const int bs_shift = -1;")],
    "expf": [(DM, "const float qscale = scale * kLog2e;",
              "const float qscale = scale;"),
             (DM, "const float corr = moved ? exp2f(m_run[r] - m_new) : 1.f;",
              "const float corr = expf(m_run[r] - m_new);"),
             (DM, "exp2f(sc[r][u] - m_new)", "expf(sc[r][u] - m_new)"),
             (DM, "      if (moved) {", "      {"),
             (DM, "exp2f(s_m[w][r] - m_tot)", "expf(s_m[w][r] - m_tot)"),
             (DM, "m_tot == kNegInf ? kNegInf : m_tot * kLn2", "m_tot")],
}


def build(tmp, name, subs):
    from repro_torch.kernels import _build
    src = os.path.join(tmp, name)
    shutil.copytree(_build.CSRC, src)
    for fname, old, new in subs:
        path = os.path.join(src, fname)
        text = open(path).read()
        if old not in text:
            raise SystemExit(f"decode_ablation: {name}: {fname} no longer "
                             f"holds {old!r}")
        open(path, "w").write(text.replace(old, new))
    lib = os.path.join(tmp, f"lib_{name}.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", src, "-shared", "-o",
           lib, os.path.join(src, "paged_decode.cu"),
           os.path.join(src, "flash_decode.cu")]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("decode_ablation: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_decode as K6
    from repro_torch.kernels import paged_decode as K2
    from repro_torch.kernels import split as SP
    with tempfile.TemporaryDirectory() as tmp:
        procs = {n: build(tmp, n, s) for n, s in VARIANTS.items()}
        libs = {}
        for name, (path, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode:
                print(out, file=sys.stderr)
                return 1
            lib = ctypes.CDLL(path)
            for fn in ("paged_decode_launch", "flash_decode_launch"):
                getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            libs[name] = lib
        timer = cs.Timer(torch)
        p, opt = _build.ptr, _build.opt_ptr

        def launcher(lib, case):
            q, k, v = case[:3]
            b, h, d = q.shape
            n_kv = k.shape[1]
            o = torch.empty(b, n_kv, h // n_kv, d, device="cuda")
            l = torch.empty(b, n_kv, h // n_kv, device="cuda")
            m = torch.empty_like(l)
            if len(case) == 7:                     # K2's paged case
                tables, valid, ks, vs = case[3:]
                n_split = SP.split_count(valid.shape[1],
                                         SP.DECODE_MAX_SPLITS)
                parts = [opt(t) for t in SP.split_scratch(n_split, o, l, m)]
                return lambda: lib.paged_decode_launch(
                    p(q), p(k), p(v), opt(ks), opt(vs), p(tables), p(valid),
                    p(o), p(l), p(m), *parts, b, n_kv, h // n_kv, d,
                    k.shape[2], tables.shape[1], n_split,
                    K2._DTYPE_CODE[k.dtype], 1.0 / d ** 0.5,
                    _build.stream_of(q))
            valid = case[3]
            n_split = SP.split_count(k.shape[2], SP.DECODE_MAX_SPLITS)
            parts = [opt(t) for t in SP.split_scratch(n_split, o, l, m)]
            return lambda: lib.flash_decode_launch(
                p(q), p(k), p(v), p(valid), p(o), p(l), p(m), *parts, b,
                n_kv, h // n_kv, d, k.shape[2], n_split,
                K6._DTYPE_CODE[k.dtype], 1.0 / d ** 0.5, _build.stream_of(q))

        gen = torch.Generator().manual_seed(cs.SEED + 21)
        cases = [(f"K2 ({B}, nb {nb}) {dt}", cs.paged_case(torch, gen, B, nb,
                                                           dt), True)
                 for B, nb, dt in ((4, 7, "bf16"), (8, 64, "bf16"),
                                   (8, 256, "bf16"), (8, 256, "int8"))]
        cases += [(f"K6 ({B}, {S}) {dt}", cs.dense_case(torch, gen, B, S,
                                                        dt), False)
                  for B, S, dt in ((4, 112, "bf16"), (8, 4096, "bf16"),
                                   (24, 4096, "bf16"))]
        names = list(VARIANTS)
        order = (names + names[::-1]) * 2
        for label, case, paged in cases:
            runs = {}
            for name in order:
                if name == "div" and not paged:
                    continue
                runs.setdefault(name, []).append(
                    timer(launcher(libs[name], case)))
            print(label, {n: dict(median=sorted(r)[len(r) // 2], runs=r)
                          for n, r in runs.items()}, flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
