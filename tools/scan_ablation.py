#!/usr/bin/env python3
"""Ablations of K8 (the RWKV6 WKV scan) and K5 (the offline TTT scan) on
one CUDA card.

    python3 tools/scan_ablation.py

Builds variants of ``src/repro_torch/csrc/rwkv6_scan.cu`` and
``ttt_scan.cu`` side by side (one ``nvcc`` each), holds every variant to
the plain versions on ``chip_smoke.py``'s phase k8 and k5 inputs (K8_RTOL,
K5_TOL), and times them through their launchers in turns (a, b, ..., b,
a, twice) with ``chip_smoke.Timer``:

* ``tree``:    the sources as they are (K8 also at every column split,
  ``tree/n_col``);
* ``nt512``:   K8 with 512 threads a block (half the rows a thread);
* ``u4``:      K8's steps unrolled half as far (1 at 16 rows a thread, 4
  at fewer);
* ``fast``:    K5's scalar steps with the fast exponential and reciprocal
  (``__expf``, ``__frcp_rn``) instead of ``expf`` and a division;
* ``nochain``: K5's sigmoid replaced by a line, a cheap stand-in for the
  scalar steps' cost;
* ``noload``:  K5 without the loads of the rows ahead (stale rows: the
  time of everything but the loads).

``nochain`` and ``noload`` compute wrong values; their errors are printed
and not held to K5_TOL.

Prints one line per case with each variant's median, runs and largest
error, then the card's name and power limit.  Exits non-zero without a
card, when a variant does not build, or when a substitution no longer
matches the sources.
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

K8_SRC, K5_SRC = "rwkv6_scan.cu", "ttt_scan.cu"
VARIANTS = {
    "tree": [],
    "nt512": [(K8_SRC, "constexpr int kThreads = 256;",
               "constexpr int kThreads = 512;")],
    "u4": [(K8_SRC, "constexpr int kUnroll = R >= 16 ? 2 : 8;",
            "constexpr int kUnroll = R >= 16 ? 1 : 4;")],
    "fast": [(K5_SRC, "return 1.0f / (1.0f + expf(-x));",
              "return __frcp_rn(1.0f + __expf(-x));")],
    "nochain": [(K5_SRC, "return 1.0f / (1.0f + expf(-x));",
                 "return 0.5f + 0.125f * x;")],
    "noload": [(K5_SRC, "    if (t0 + PD * L < T)\n      load_rows",
                "    if (false)\n      load_rows")],
}
# the K8 cases (B, T, r/k/v dtype) and the K5 widths timed
K8_TIMED = ((4, 1, "f32"), (1, 16, "f32"), (24, 16, "f32"), (1, 512, "f32"),
            (1, 2048, "f32"), (4, 1, "bf16"), (1, 16, "bf16"))


def build(tmp, name, subs):
    from repro_torch.kernels import _build
    src = os.path.join(tmp, name)
    shutil.copytree(_build.CSRC, src)
    for fname, old, new in subs:
        path = os.path.join(src, fname)
        text = open(path).read()
        if old not in text:
            raise SystemExit(f"scan_ablation: {name}: {fname} no longer "
                             f"holds {old!r}")
        open(path, "w").write(text.replace(old, new))
    lib = os.path.join(tmp, f"lib_{name}.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", src, "-shared", "-o",
           lib, os.path.join(src, K8_SRC), os.path.join(src, K5_SRC)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("scan_ablation: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import rwkv6_scan as K8
    from repro_torch.kernels import ttt_scan as K5
    with tempfile.TemporaryDirectory() as tmp:
        procs = {n: build(tmp, n, s) for n, s in VARIANTS.items()}
        libs = {}
        for name, (path, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode:
                print(out, file=sys.stderr)
                return 1
            regs = [ln.strip() for ln in out.splitlines()
                    if "registers" in ln or "spill" in ln]
            print(name, "ptxas", regs, flush=True)
            lib = ctypes.CDLL(path)
            for fn in ("wkv_scan_launch", "ttt_scan_launch"):
                getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            libs[name] = lib
        timer = cs.Timer(torch)
        p = _build.ptr

        def k8_launch(lib, args, n_col=None):
            r, k, v, w, u, s0 = args
            B, T, H, d = r.shape
            out = torch.empty_like(w)
            st = torch.empty_like(s0)

            def go():
                _build.check(lib.wkv_scan_launch(
                    p(r), p(k), p(v), p(w), p(u), p(s0), p(out), p(st), B,
                    T, H, d, K8.INPUT_DTYPES[r.dtype],
                    n_col or K8.col_split(B, H),
                    K8.chunk_steps(T), _build.stream_of(r)), "wkv")
                return out, st
            return go

        def k5_launch(lib, args, shared):
            zq, zk, c, m, w0, b0, eta = args
            n, T, f = zq.shape
            s = torch.empty(n, T, device="cuda")
            wf = torch.empty(n, f, device="cuda")
            bf = torch.empty(n, device="cuda")
            fig = K5.instance(f, zq.data_ptr() == zk.data_ptr())

            def go():
                _build.check(lib.ttt_scan_launch(
                    p(zq), p(zk), p(c), p(m), p(w0), p(b0), p(eta), p(s),
                    p(wf), p(bf), n, T, f, 0 if shared else f,
                    0 if shared else 1, *fig, _build.stream_of(zq)), "ttt")
                return s, wf, bf
            return go

        names = list(VARIANTS)
        order = (names + names[::-1]) * 2
        gen = torch.Generator().manual_seed(cs.SEED + 22)
        for B, T, dt in K8_TIMED:
            dtype = torch.bfloat16 if dt == "bf16" else torch.float32
            errs = {}
            for decay, z in (("mid", True), ("near 0", False),
                             ("near 1", False)):
                args = cs.k8_inputs(torch, gen, B, T, 32, 64, decay, z,
                                    dtype)
                want = K8.wkv_scan_plain(*args)
                for name in names:
                    got = k8_launch(libs[name], args)()
                    torch.cuda.synchronize()
                    errs[name] = max(errs.get(name, 0.0),
                                     cs.k8_errs(got, want)[0])
            runs = {}
            for name in order:
                runs.setdefault(name, []).append(
                    timer(k8_launch(libs[name], args)))
            for n_col in (1, 2, 4):
                if n_col != K8.col_split(B, 32):
                    runs[f"tree/{n_col}"] = [timer(k8_launch(
                        libs["tree"], args, n_col)) for _ in range(2)]
                    errs[f"tree/{n_col}"] = cs.k8_errs(
                        k8_launch(libs["tree"], args, n_col)(), want)[0]
            print(f"K8 ({B}, {T}) {dt}",
                  {n: dict(median=sorted(r)[len(r) // 2], runs=r,
                           rel_err=errs[n], ok=errs[n] <= cs.K8_RTOL)
                   for n, r in runs.items()}, flush=True)
        test = cs.corpus()[2]
        errs = {}
        timed = []
        for case, args, shared in cs.k5_cases(torch, test):
            zq, zk, c, m, w0, b0, eta = args
            n, _, f = zq.shape
            want = K5.ttt_probe_batched_plain(
                zq, zk, c, m, w0.expand(n, f) if shared else w0,
                b0.expand(n) if shared else b0, eta)
            for name in names:
                got = k5_launch(libs[name], args, shared)()
                torch.cuda.synchronize()
                e = max(float((a - b).abs().max()) if a.numel() else 0.0
                        for a, b in zip(got, want))
                errs[name] = max(errs.get(name, 0.0), e)
            if case["N"] > 1 and case["T"] == 120 and case["c"] == "zero" \
                    and case["w0"] == "shared":
                timed.append((case, args, shared))
        wrong = ("nochain", "noload")
        print("K5 largest error over phase k5's cases",
              {n: dict(err=e, ok=None if n in wrong else e <= cs.K5_TOL)
               for n, e in errs.items()}, flush=True)
        for case, args, shared in timed:
            runs = {}
            for name in order:
                runs.setdefault(name, []).append(
                    timer(k5_launch(libs[name], args, shared)))
            print(f"K5 (N {case['N']}, T {case['T']}, f {case['f']})",
                  {n: dict(median=sorted(r)[len(r) // 2], runs=r)
                   for n, r in runs.items()}, flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
