#!/usr/bin/env python3
"""Run kernel phases of ``chip_smoke.py`` on the card in the tree this is
started from, each JSON line prefixed with a tag: one side of a
parent-against-change comparison made in a single chip call.

    python3 tools/phase_times.py TAG k2 k6

imports ``chip_smoke.py`` and ``src/`` from the current directory, so the
same script times an unpacked parent as well (``git archive <parent> |
tar -x -C build/parent``, then ``cd build/parent && python3
../../tools/phase_times.py parent k2 k6``).  Run the two trees in turns,
parent, change, change, parent, in one call: two calls may land on two
cards.  Each tree builds its own kernels first (not timed).  Phases:
k2, k3, k6, k7 (every case of the tree's lists, timed as chip_smoke.py
times them).
"""
import json
import os
import sys

PHASES = {"k2": "phase_k2", "k3": "phase_k3", "k6": "phase_k6",
          "k7": "phase_k7"}


def main(argv) -> int:
    if len(argv) < 2 or any(p not in PHASES for p in argv[1:]):
        print(__doc__, file=sys.stderr)
        return 2
    root = os.getcwd()
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch
    if not torch.cuda.is_available():
        print("phase_times: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    tag = argv[0]
    cs.emit = lambda obj: print(tag, json.dumps(obj), flush=True)
    timer = cs.Timer(torch)
    for p in argv[1:]:
        getattr(cs, PHASES[p])(torch, timer)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
