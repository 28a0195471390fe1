#!/usr/bin/env python3
"""Which side of a float32 training-gradient gap float64 takes.

    python3 tools/train_f64_witness.py [--arch rwkv6-1.6b [...]]

Runs chip_smoke's train-check for each ``--arch`` (one of its
``TRAIN_CHECK_ARCHS``, drawn from the same seed as there): full width in
float32 at 2 layers, one step's loss and every gradient leaf on the card
against the port on the CPU, the card's own 1e-7 spread and the TF32
control, and besides the port on the CPU in float64 throughout (the
parameters widened, every float32 cast of the model's contract taken to
float64).  Its line gives, for each leaf, the card-to-CPU gap
(``rel_errs``), the spread (``spread_rels``) and each float32 side's
distance from float64 (``f64_card_rel``, ``f64_cpu_rel``), each over the
leaf's largest magnitude.  A gap where both sides sit as far from float64
as from each other is float32 rounding; one where the card sits far from
float64 and the CPU on it is the card's fault.  The last line gives the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("train_f64_witness: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=["rwkv6-1.6b"],
                    choices=cs.TRAIN_CHECK_ARCHS)
    args = ap.parse_args()
    cs.DEV = "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_train_check(torch, archs=tuple(args.arch), f64=tuple(args.arch))
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
