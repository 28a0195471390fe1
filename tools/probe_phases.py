#!/usr/bin/env python3
"""Phases k1 and k4 of ``chip_smoke.py`` alone, on one CUDA card, and an
ablation of the probe chain's design.

    python3 tools/probe_phases.py            # phases, then the ablation
    python3 tools/probe_phases.py --check    # phases untimed, no ablation
    python3 tools/probe_phases.py --against DIR   # two trees in turns

Builds the kernels, then runs ``chip_smoke.phase_k1`` (the serving probe
step, K1) and ``chip_smoke.phase_k4`` (the masked multi-token probe step,
K4) with ``chip_smoke.Timer``: every case held to its plain version and
K4 to chained K1 launches bit for bit, the Timer's floor, the timed rows
with their bounds and instances (registers, threads).  ``--check`` times
nothing (every ms prints 0): a first call after a change to the kernel.
``--against DIR`` times phases k1 and k4 of the tree in DIR (a ``git
archive`` of another commit, unpacked in the repo's ``build/``) and of
this one in turns (DIR, this, this, DIR), each in a process of its own
from its root, one ``probe-against`` line each, and nothing else.

The ablation builds variants of ``src/repro_torch/csrc/probe_spec.cu``
side by side (one ``nvcc`` each, a copy of the sources with text
substituted), holds each to the plain version and to the sources as
they are, bit for bit, and times them through the wrappers in turns (a,
b, c, d, d, c, b, a, twice; medians) with ``chip_smoke.Timer``:

* ``tree``:  the sources as they are, and the swept instances the policy
  does not name (``INSTANCE_SWEEP``) added to the copy's list;
* ``late``:  each token's rows loaded when its step starts, none in
  flight ahead (rows not preloaded);
* ``bar2``:  a second barrier a token, after its writes, as the earlier
  design had;
* ``ieee``:  the sigmoid's reciprocal and the smoothed score's division
  as the compiler's division (``/``, with its branch to a slow path)
  instead of ``rcp_rn`` and ``div_rn``: the same values, bit for bit;
* ``line``:  the sigmoid replaced by a line, a cheap stand-in for the
  scalar logic's longest piece;
* ``noshfl``: no warp shuffles (each warp's sum is its lane's);
* ``nobar``: no barrier (the fold reads whatever the buffer holds);

``line``, ``noshfl`` and ``nobar`` give wrong values: each is the time of
everything but a piece, its error printed, not held;

the tree at (4, T, 960), T 1, 2, 4 and 8, in both views, timed after
the Timer's flush (1 GiB zeroed: the L2 full of dirty lines), after a
read of the same GiB (the L2 full of clean lines) and after a wait on the
card alone (``torch.cuda._sleep``: the rows still in the L2 from the
last call), with each view's slope over T; the tree with zk the same
tensor as zq (one row read) against zk a clone of zq (two rows); and the
tree at other instances (threads and features a thread;
``INSTANCE_SWEEP``, among them one warp against 256 threads at f 128)
with the policy pointed at each in turn.
Prints one line per case, then the card's name and power limit.  Exits
non-zero without a card, when a variant does not build or when a check
fails.
"""
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

# (kernel, B, T, f, view): the instances timed against the policy's (the
# first of each list); figures (threads, features a thread, zq is zk) as
# kernels/probe_step.py instance gives them, the window in registers
INSTANCE_SWEEP = {
    ("K4", 4, 4, 128, "same"): ((32, 4, 1), (256, 4, 1)),
    ("K4", 4, 4, 128, "distinct"): ((32, 4, 0), (256, 4, 0)),
    ("K4", 4, 8, 128, "same"): ((32, 4, 1), (256, 4, 1)),
    ("K4", 4, 8, 128, "distinct"): ((32, 4, 0), (256, 4, 0)),
    ("K1", 4, 1, 128, "same"): ((32, 4, 1), (256, 4, 1)),
    ("K1", 4, 1, 128, "distinct"): ((32, 4, 0), (256, 4, 0)),
    ("K4", 4, 4, 960, "same"): ((256, 4, 1), (128, 8, 1), (64, 16, 1),
                                (32, 32, 1)),
    ("K4", 4, 8, 960, "same"): ((256, 4, 1), (128, 8, 1), (64, 16, 1),
                                (32, 32, 1)),
    ("K4", 4, 4, 960, "distinct"): ((256, 4, 0), (128, 8, 0)),
    ("K1", 4, 1, 960, "same"): ((256, 4, 1), (128, 8, 1), (64, 16, 1),
                                (32, 32, 1)),
    ("K1", 4, 1, 2048, "same"): ((256, 8, 1), (128, 16, 1), (512, 4, 1)),
    ("K4", 8, 8, 5120, "distinct"): ((256, 20, 0), (512, 16, 0),
                                     (256, 28, 0)),
    ("K4", 8, 8, 5120, "same"): ((256, 20, 1), (512, 16, 1)),
    ("K4", 8, 8, 4096, "distinct"): ((256, 16, 0), (512, 8, 0)),
}

def _extra():
    """The swept instances the policy does not name (the tree's copy of
    the sources adds those)."""
    from repro_torch.kernels import probe_step as K1
    built = {K1.instance(b.f_max, s, 1)[:3] for b in K1.BANDS
             for s in (0, 1)}
    return sorted({fig for figs in INSTANCE_SWEEP.values() for fig in figs}
                  - built)


def _tree_subs():
    """The tree's substitution: the swept instances' lines before the end
    of the list of csrc/probe_spec.cu."""
    lines = "".join(f"  PROBE_INSTANCE({', '.join(map(str, fig))})\n"
                    for fig in _extra())
    return (("probe_spec.cu", "#undef PROBE_INSTANCE",
             lines + "#undef PROBE_INSTANCE"),)


# name: substitutions (file, old, new) in a copy of the sources
SIGMOID = "return rcp_rn(1.0f + expf(-x));"
DIVISION = "div_rn(tree_sum(r), pre.d, pre.rd)"
WAIT = "cp_async_wait<R - 1>();"
VARIANTS = {"tree": _tree_subs,
            "late": (("probe_spec.cu",
                      "#pragma unroll\n  for (int a = 0; a < R; ++a) "
                      "load(a, a);\n", ""),
                     ("probe_spec.cu", WAIT,
                      "load(a, t);\n      cp_async_wait<0>();"),
                     ("probe_spec.cu", "      load(a, t + R);", "")),
            "bar2": (("probe_spec.cu",
                      "g.n_out[first + t] = st.n;\n      }\n",
                      "g.n_out[first + t] = st.n;\n      }\n"
                      "      __syncthreads();\n"),),
            "line": (("probe_math.cuh", SIGMOID,
                      "return 0.5f + 0.125f * x;"),),
            "ieee": (("probe_math.cuh", SIGMOID,
                      "return 1.0f / (1.0f + expf(-x));"),
                     ("probe_math.cuh", DIVISION,
                      "tree_sum(r) / pre.d")),
            "noshfl": (("probe_math.cuh",
                        "v += __shfl_xor_sync(0xffffffffu, v, o);",
                        "v += 0.0f;"),
                       ("probe_spec.cu",
                        "__shfl_xor_sync(0xffffffffu, hi ? ak : aq, 16);",
                        "0.0f;"),
                       ("probe_spec.cu",
                        "v += __shfl_xor_sync(0xffffffffu, v, o);",
                        "v += 0.0f;")),
            "nobar": (("probe_spec.cu",
                       "        __syncthreads();\n        dk = fold",
                       "        dk = fold"),)}
# variants whose values are not held
WRONG = ("line", "noshfl", "nobar")
# (kernel, B, T, f, view): K4 at the served shape in both views, a longer
# chain, the wide shape; K1 at the served shape and RWKV's width
CASES = (("K4", 4, 4, 960, "same"), ("K4", 4, 4, 960, "distinct"),
         ("K4", 4, 8, 960, "same"), ("K4", 8, 8, 5120, "distinct"),
         ("K1", 4, 1, 960, "same"), ("K1", 4, 1, 2048, "same"))
# the shared view against a clone: (kernel, B, T, f)
VIEW_CASES = (("K4", 4, 4, 960), ("K4", 4, 8, 960), ("K4", 8, 8, 5120),
              ("K1", 4, 1, 960), ("K1", 4, 1, 2048))


def build_variants(tmp):
    from repro_torch.kernels import _build
    procs = {}
    for name, subs in VARIANTS.items():
        src = os.path.join(tmp, name)
        shutil.copytree(_build.CSRC, src)
        for fname, old, new in (subs() if callable(subs) else subs):
            path = os.path.join(src, fname)
            text = open(path).read()
            if text.count(old) != 1:
                raise SystemExit(f"probe_phases: {name}: {fname} holds "
                                 f"{old!r} {text.count(old)} times, not "
                                 "once")
            open(path, "w").write(text.replace(old, new))
        lib = os.path.join(tmp, f"lib_{name}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", src,
               "-shared", "-o", lib, os.path.join(src, "probe_spec.cu"),
               os.path.join(src, "probe_step.cu")]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"probe_phases: {name} did not build:\n{out}")
        lib = ctypes.CDLL(path)
        for fn in ("probe_step_launch", "probe_spec_launch",
                   "probe_chain_config", "cuda_error_string"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = (ctypes.c_char_p
                                        if fn == "cuda_error_string"
                                        else ctypes.c_int)
        libs[name] = lib
    return libs


class Policy:
    """Point K1's and K4's instance policy at one instance."""

    def __init__(self, fig):
        self.fig = tuple(fig)

    def __enter__(self):
        from repro_torch.kernels import probe_spec as K4
        from repro_torch.kernels import probe_step as K1
        self.saved = K1.instance
        K1.instance = K4.instance = lambda f, same, win: (
            *self.fig, int(win > K1.REGISTER_WINDOW))

    def __exit__(self, *exc):
        from repro_torch.kernels import probe_spec as K4
        from repro_torch.kernels import probe_step as K1
        K1.instance = K4.instance = self.saved


class Using:
    """Route the wrappers' launches through one variant's library."""

    def __init__(self, lib):
        self.lib = lib

    def __enter__(self):
        from repro_torch.kernels import _build
        self.saved = _build.library
        _build.library = lambda: self.lib

    def __exit__(self, *exc):
        from repro_torch.kernels import _build
        _build.library = self.saved


def inputs(torch, cs, gen, kern, B, T, f, view):
    """Timed inputs as phase k4's (every token accepted, at a boundary,
    lambda* out of reach) and a call of K1 or K4 on a fresh copy of the
    state; view "clone": zk a clone of zq."""
    zq = (torch.randn(B, T, f, generator=gen) / f ** 0.5).to("cuda")
    zk = {"same": zq, "clone": zq.clone(),
          "distinct": (torch.randn(B, T, f, generator=gen)
                       / f ** 0.5).to("cuda")}[view]
    bnd = torch.ones(B, T, dtype=torch.bool, device="cuda")
    acc = torch.full((B,), T, dtype=torch.int32, device="cuda")
    st = cs.k4_state(torch, gen, B, f, 4, 2, False)
    if kern == "K1":
        zq, zk, bnd = zq[:, 0], zk[:, 0], bnd[:, 0]
        zk = zq if view == "same" else zk.contiguous()
    return zq, zk, bnd, acc, st


def call(kern, args, st, plain=False):
    from repro_torch.kernels import probe_spec as K4
    from repro_torch.kernels import probe_step as K1
    zq, zk, bnd, acc, _ = args
    if kern == "K1":
        fn = K1.serving_probe_step_plain if plain else K1.serving_probe_step
        return fn(zq, zk, bnd, *st, 0.05, 1.5, burn_in=2)
    fn = (K4.serving_probe_spec_step_plain if plain
          else K4.serving_probe_spec_step)
    return fn(zq, zk, bnd, acc, *st, 0.05, 1.5, burn_in=2)


def outputs(out):
    return [t.clone() for t in out]


class ReadTimer:
    """chip_smoke.Timer with the 1 GiB buffer read (summed) before each
    call instead of zeroed: the L2 holds clean lines, none to write back;
    or, with ``sleep``, the card spinning for about 0.5 ms instead: the
    L2 holds what the last call read."""

    def __init__(self, torch, flush, sleep=False):
        self.torch, self.flush, self.sleep = torch, flush, sleep

    def __call__(self, fn, reps=200, warmup=3):
        torch = self.torch
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(reps):
            if self.sleep:
                torch.cuda._sleep(1_000_000)
            else:
                self.flush.sum(dtype=torch.int32)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / reps


def l2_rows(torch, cs, timer):
    """The served chain's slope with the L2 dirty, clean and warm."""
    timers = {"dirty": timer, "clean": ReadTimer(torch, timer.flush),
              "warm": ReadTimer(torch, timer.flush, sleep=True)}
    gen = torch.Generator().manual_seed(cs.SEED + 11)
    for view in ("same", "distinct"):
        rows = {k: [] for k in timers}
        for T in (1, 2, 4, 8):
            args = inputs(torch, cs, gen, "K4", 4, T, 960, view)
            st = [t.clone() for t in args[4]]
            for name in list(timers) + list(timers)[::-1]:
                rows[name].append(dict(T=T, ms=timers[name](
                    lambda: call("K4", args, st), reps=200)))
        # two readings of each T in turns: the mean of the pair
        ms = {k: [(r[2 * i]["ms"] + r[2 * i + 1]["ms"]) / 2
                  for i in range(4)] for k, r in
              ((k, sorted(v, key=lambda x: x["T"])) for k, v in rows.items())}
        cs.emit(dict(phase="probe-l2", kernel="K4", B=4, f=960, view=view,
                     T=[1, 2, 4, 8], ms=ms,
                     slope_ms_per_token={k: cs.slope(
                         [dict(T=T, ms=m) for T, m in zip((1, 2, 4, 8), v)])
                         for k, v in ms.items()}))


def ablation(torch, cs, timer, libs):
    gen = torch.Generator().manual_seed(cs.SEED + 9)
    names = list(VARIANTS)
    order = names + names[::-1]
    for kern, B, T, f, view in CASES:
        args = inputs(torch, cs, gen, kern, B, T, f, view)
        st0 = args[4]
        plain = outputs(call(kern, args, [t.clone() for t in st0],
                             plain=True))
        ref, err = None, {}
        for name in names:
            with Using(libs[name]):
                got = outputs(call(kern, args, [t.clone() for t in st0]))
            torch.cuda.synchronize()
            err[name] = max(float((a.float() - b.float()).abs().max())
                            for a, b in zip(got, plain))
            if name in WRONG:
                continue
            if err[name] > cs.K4_TOL:
                raise AssertionError(f"{name} {kern} off its plain version: "
                                     f"{err[name]}")
            if ref is None:
                ref = got
            elif not all(torch.equal(a, b) for a, b in zip(got, ref)):
                raise AssertionError(f"{name} {kern} not bit-equal to tree")
        runs = {n: [] for n in names}
        st = [t.clone() for t in st0]
        for _ in range(2):
            for name in order:
                with Using(libs[name]):
                    runs[name].append(timer(lambda: call(kern, args, st),
                                            reps=200))
        cs.emit(dict(phase="probe-ablation", kernel=kern, B=B, T=T, f=f,
                     view=view, median_ms={n: statistics.median(r)
                                           for n, r in runs.items()},
                     runs_ms=runs, max_abs_err=err))
    for kern, B, T, f in VIEW_CASES:
        got, runs = {}, {"same": [], "clone": []}
        for view in ("same", "clone", "clone", "same", "same", "clone",
                     "clone", "same"):
            args = inputs(torch, cs, torch.Generator().manual_seed(
                cs.SEED + 10), kern, B, T, f, view)
            st = [t.clone() for t in args[4]]
            if view not in got:
                got[view] = outputs(call(kern, args,
                                         [t.clone() for t in st]))
            runs[view].append(timer(lambda: call(kern, args, st), reps=200))
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b)
                      for a, b in zip(got["same"], got["clone"]))
        if not bitwise:
            raise AssertionError(f"{kern} ({B}, {T}, {f}): zk is zq and zk "
                                 "a clone differ")
        cs.emit(dict(phase="probe-view", kernel=kern, B=B, T=T, f=f,
                     median_ms={v: statistics.median(r)
                                for v, r in runs.items()},
                     runs_ms=runs, bitwise=bitwise))
    tree = libs["tree"]
    for (kern, B, T, f, view), figs in INSTANCE_SWEEP.items():
        args = inputs(torch, cs, gen, kern, B, T, f, view)
        st0 = args[4]
        plain = outputs(call(kern, args, [t.clone() for t in st0],
                             plain=True))
        regs, err = {}, {}
        with Using(tree):
            for fig in figs:
                out = (ctypes.c_int * 4)()
                from repro_torch.kernels import _build
                _build.check(tree.probe_chain_config(*fig, 0, out),
                             str(fig))
                regs[str(fig)] = list(out)
                with Policy(fig):
                    got = outputs(call(kern, args, [t.clone() for t in st0]))
                torch.cuda.synchronize()
                err[str(fig)] = max(float((a.float() - b.float()).abs().max())
                                    for a, b in zip(got, plain))
                if err[str(fig)] > cs.K4_TOL:
                    raise AssertionError(f"{fig} {kern} off its plain "
                                         f"version: {err[str(fig)]}")
            runs = {str(fig): [] for fig in figs}
            st = [t.clone() for t in st0]
            for _ in range(2):
                for fig in list(figs) + list(figs)[::-1]:
                    with Policy(fig):
                        runs[str(fig)].append(timer(
                            lambda: call(kern, args, st), reps=200))
        cs.emit(dict(phase="probe-instances", kernel=kern, B=B, T=T, f=f,
                     view=view, median_ms={k: statistics.median(r)
                                           for k, r in runs.items()},
                     runs_ms=runs, regs_smem_local_ring=regs,
                     max_abs_err=err))


# phases k1 and k4 of one tree, timed, summed up in one line; run from the
# tree's root
SUMMARY = """
import json, sys, torch
sys.path[:0] = ["src", "."]
import chip_smoke as cs
cs.emit = lambda obj: None
timer = cs.Timer(torch)
k1, k4 = cs.phase_k1(torch, timer), cs.phase_k4(torch, timer)
print(json.dumps(dict(
    floor_ms=k1["floor_ms"], k1_served=k1["served"]["ms"],
    k1_distinct=k1["distinct"]["ms"], k1_rwkv=k1["rwkv_width"]["ms"],
    k4_timed=[r["ms"] for r in k4["timed"]],
    slope_ms_per_token=k4["slope_ms_per_token"],
    bitwise=k4["chained_k1_bitwise"], cases=k4["cases"])))
"""


def against(other):
    """Phases k1 and k4 of the tree in ``other`` and of this one, timed in
    turns: other, this, this, other."""
    for tree in (other, ROOT, ROOT, other):
        out = subprocess.run([sys.executable, "-c", SUMMARY], cwd=tree,
                             capture_output=True, text=True)
        if out.returncode:
            raise SystemExit(f"probe_phases: phases of {tree} failed:\n"
                             f"{out.stdout[-2000:]}{out.stderr[-2000:]}")
        row = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(dict(phase="probe-against",
                              tree=os.path.relpath(tree, ROOT), **row)),
              flush=True)


def phases(torch, check):
    """Build, phases k1 and k4, and unless ``check``, the L2 rows and the
    ablation."""
    import chip_smoke as cs
    from repro_torch.kernels import _build
    lib = _build.build()
    log = (lib.parent / "build.log").read_text()
    keep, ptxas = False, []
    for ln in log.splitlines():
        if "Compiling entry" in ln:
            keep = "probe_chain" in ln
        if keep:
            ptxas.append(ln.strip())
    cs.emit(dict(phase="build", ptxas=ptxas))
    if check:
        def timer(fn, reps=30, warmup=3):
            fn()
            return 0.0
    else:
        timer = cs.Timer(torch)
    cs.phase_k1(torch, timer)
    cs.phase_k4(torch, timer)
    if not check:
        l2_rows(torch, cs, timer)
        with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT) as tmp:
            ablation(torch, cs, timer, build_variants(tmp))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_phases: no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    if "--against" in args:
        against(os.path.abspath(args[args.index("--against") + 1]))
    else:
        phases(torch, "--check" in args)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
