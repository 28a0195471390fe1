#!/usr/bin/env python3
"""Phases k5 and k8 of ``chip_smoke.py`` alone, on one CUDA card.

    python3 tools/scan_phases.py

Builds the kernels, then runs ``chip_smoke.phase_k5`` (the offline TTT
scan, K5, on the synthetic corpus's test split) and ``chip_smoke.phase_k8``
(the RWKV6 WKV scan, K8) with ``chip_smoke.Timer``: every case held to its
plain version, the timed rows with their bounds, each instance's L or
column split, registers and shared memory.  Prints the phases' JSON lines,
then the card's name and power limit.  Exits non-zero without a card or
when a check fails.
"""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("scan_phases: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build
    lib = _build.build()
    log = (lib.parent / "build.log").read_text()
    keep = False
    ptxas = []
    for ln in log.splitlines():
        if "Compiling entry" in ln:
            keep = "wkv_scan" in ln or "ttt_scan" in ln
        if keep:
            ptxas.append(ln.strip())
    cs.emit(dict(phase="build", ptxas=ptxas))
    timer = cs.Timer(torch)
    cs.phase_k5(torch, timer, cs.corpus()[2])
    cs.phase_k8(torch, timer)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
