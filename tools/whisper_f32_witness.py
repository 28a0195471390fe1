#!/usr/bin/env python3
"""Which side of a float32 whisper-tiny token split float64 takes.

    python3 tools/whisper_f32_witness.py [--layers 4 [2 ...]]

Runs chip_smoke's serve-whisper (the driver at full width and depth,
random weights from seed 0: the harvest of 24 and the fit) for its probe,
then serve-whisper-f32's float32 fleet at each ``--layers`` depth of
encoder and decoder layers (the first layers of that draw) through the
kernels and through the plain versions of K6 and K7
(``chip_smoke.f32_fleets``), and prints each request's stop and the first
token where the two runs part.

Each request the two runs part on is replayed alone (batch 1, the fleet's
96-position cache), fed the tokens both runs share up to the split,
through the kernels, the plain versions and the model in float64 (the
same weights cast up; attention, layer norms and every product in
float64).  One JSON line a request: at every step each float32 path's
largest |logit - float64 logit| and its argmax; float64's gap between its
two largest logits; at the split step the float64 logits of the token
each run chose and of float64's own pick; and every K6 and K7 call of the
kernel replay held against float64 on its inputs, the kernel's distance
beside the plain version's.  A split where float64 puts the two chosen
tokens closer together than the float32 paths sit from float64 is a
near-tie that float32 cannot settle; one where the kernels' token lies
well below float64's pick while the plain path's is on it is the kernels'
fault.  The last lines give the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def decode_exact(q, k, v, valid):
    """K6's function in float64: (B, KV, G, d) attention of q over the
    valid cache positions, NaN on rows with none."""
    import torch
    b, n_kv, g, d = q.shape
    s = torch.einsum("bkgd,bksd->bkgs", q.double(), k.double()) / d ** 0.5
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    return torch.einsum("bkgs,bksd->bkgd", torch.softmax(s, -1), v.double())


class Held:
    """K6 and K7 on the model's inputs, each call's output held against
    its float64 function beside the plain version's: the largest distance
    of each over the calls."""

    def __init__(self):
        from repro_torch.kernels import flash_attention as K7
        from repro_torch.kernels import flash_decode as K6
        self.K6, self.K7 = K6, K7
        self.k6 = dict(calls=0, kernel=0.0, plain=0.0)
        self.k7 = dict(calls=0, kernel=0.0, plain=0.0)

    def decode(self, q, k, v, valid, *, return_partials=False):
        got = self.K6.flash_decode(q, k, v, valid, return_partials=True)
        want = self.K6.flash_decode_plain(q, k, v, valid,
                                          return_partials=True)
        b, h, d = q.shape
        qg = q.reshape(b, k.shape[1], h // k.shape[1], d).to(k.dtype)
        ex = decode_exact(qg, k, v, valid)
        rows = valid.any(1)
        if rows.any():
            for name, (o, l, _) in (("kernel", got), ("plain", want)):
                out = o.double() / l.double()[..., None]
                err = float((out - ex)[rows].abs().max())
                self.k6[name] = max(self.k6[name], err)
        self.k6["calls"] += 1
        return got

    def prefill(self, q, k, v, *, causal=True, window=None):
        import chip_smoke as cs
        got = self.K7.flash_attention(q, k, v, causal=causal, window=window)
        want = self.K7.attn_prefill_einsum(q, k, v, causal=causal,
                                           window=window)
        ex = cs.prefill_exact(q, k, v, causal, window)
        for name, out in (("kernel", got), ("plain", want)):
            self.k7[name] = max(self.k7[name],
                                float((out.double() - ex).abs().max()))
        self.k7["calls"] += 1
        return got


class Float64:
    """Within the block the model's attention, its decode merge and its
    layer norms run in float64 (float32 is what they keep otherwise)."""

    def __enter__(self):
        import torch
        import chip_smoke as cs
        from repro_torch.models import attention as A
        from repro_torch.models import common

        def attn_decode(q, cache_l, valid, dtype, extra_kv=None):
            b, h, d = q.shape
            k, v = cache_l["k"], cache_l["v"]
            if extra_kv is not None:
                k = torch.cat([k, extra_kv[0][:, :, None]], 2)
                v = torch.cat([v, extra_kv[1][:, :, None]], 2)
                valid = torch.cat([valid, valid.new_ones((b, 1))], 1)
            qg = q.reshape(b, k.shape[1], h // k.shape[1], d)
            return decode_exact(qg, k, v, valid).reshape(b, h, d).to(dtype)

        def layernorm(x, weight, bias, eps: float = 1e-5):
            mu = x.mean(-1, keepdim=True)
            var = torch.square(x - mu).mean(-1, keepdim=True)
            return (x - mu) * torch.rsqrt(var + eps) * weight.to(x.dtype) \
                + bias.to(x.dtype)

        self.kept = (A.attn_decode, A.flash_attention, common.layernorm,
                     dict(common._DTYPES))
        A.attn_decode, common.layernorm = attn_decode, layernorm
        A.flash_attention = cs.prefill_exact
        common._DTYPES["float64"] = torch.float64
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention as A
        from repro_torch.models import common
        (A.attn_decode, A.flash_attention, common.layernorm,
         dtypes) = self.kept
        common._DTYPES.clear()
        common._DTYPES.update(dtypes)
        return False


def replay(torch, model, params, batch, feed, cache_len, dec=None, pre=None):
    """Prefill one request and decode ``feed`` from position 0, with the
    model's ``flash_decode`` and ``flash_attention`` swapped for ``dec``
    and ``pre`` where given: the logits of every step, in the model's
    dtype."""
    from repro_torch.models import attention as A
    cfg = model.cfg
    dev = batch["frames"].device
    served = A.flash_decode, A.flash_attention
    try:
        A.flash_decode = dec or A.flash_decode
        A.flash_attention = pre or A.flash_attention
        state, _, _ = model.prefill(cfg, params, batch, cache_len)
        logits = []
        for t, tok in enumerate(feed):
            lg, _, state = model.decode_step(
                cfg, params, torch.tensor([tok], device=dev), state,
                torch.tensor([t], dtype=torch.int32, device=dev))
            logits.append(lg[0, :cfg.vocab_size])
        return logits
    finally:
        A.flash_decode, A.flash_attention = served


def splits(torch, sched, layers):
    """serve-whisper-f32's fleet at ``layers`` layers through the kernels
    and the plain versions, and the float64 replay of every request the
    two runs part on: one JSON line for the fleet, one a split."""
    import dataclasses
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as K7
    from repro_torch.kernels import flash_decode as K6
    from repro_torch.launch import serve
    from repro_torch.models import build
    n, new = cs.WHISPER_REQUESTS, cs.WHISPER_NEW
    model32, params32 = cs.f32_cut(sched, layers)
    lam, margin, _, kern_run, plain_run = cs.f32_fleets(
        torch, "witness", model32, params32, sched.pc, sched.theta,
        cs.PlainDenseAttention(), requests=n, prompt_len=16,
        max_new_tokens=new)
    kern, plain = kern_run[0], plain_run[0]
    apart = [next((j for j, (x, y) in enumerate(zip(a.tokens, b.tokens))
                   if x != y), None) for a, b in zip(kern, plain)]
    print(json.dumps(dict(
        fleet=True, layers=model32.cfg.n_layers,
        encoder_layers=model32.cfg.n_encoder_layers, lam=lam,
        lambda_margin=margin, kernel_stops=[r.stop_step for r in kern],
        plain_stops=[r.stop_step for r in plain], first_token_apart=apart)),
        flush=True)

    cfg64 = dataclasses.replace(model32.cfg, dtype="float64")
    params64 = cs._tree(params32, lambda t: t.double())
    model64 = build(cfg64)
    batch = serve.model_inputs(model32.cfg,
                               torch.Generator().manual_seed(cs.SEED + 1),
                               n, 16)
    for i, j in enumerate(apart):
        if j is None:
            continue
        one = {k: torch.as_tensor(v[i:i + 1]).to("cuda")
               for k, v in batch.items()}
        feed = [0] + kern[i].tokens[:j]
        held = Held()
        lk = replay(torch, model32, params32, one, feed, new, held.decode,
                    held.prefill)
        lp = replay(torch, model32, params32, one, feed, new,
                    K6.flash_decode_plain, K7.attn_prefill_einsum)
        with Float64():
            lx = replay(torch, model64, params64,
                        {k: v.double() if v.is_floating_point() else v
                         for k, v in one.items()}, feed, new)
        torch.cuda.synchronize()
        steps = []
        for a, b, x in zip(lk, lp, lx):
            top = x.topk(2).values
            steps.append(dict(
                kernel_err=float((a.double() - x).abs().max()),
                plain_err=float((b.double() - x).abs().max()),
                kernel_argmax=int(a.argmax()), plain_argmax=int(b.argmax()),
                f64_argmax=int(x.argmax()),
                f64_top2_gap=float(top[0] - top[1])))
        x = lx[j]
        kt, pt = kern[i].tokens[j], plain[i].tokens[j]
        split = dict(kernel_token=kt, plain_token=pt,
                     f64_logit_kernel_token=float(x[kt]),
                     f64_logit_plain_token=float(x[pt]),
                     f64_gap_plain_minus_kernel=float(x[pt] - x[kt]),
                     f64_argmax=int(x.argmax()), f64_max=float(x.max()),
                     kernel_err=steps[j]["kernel_err"],
                     plain_err=steps[j]["plain_err"],
                     replay_kernel_argmax=steps[j]["kernel_argmax"],
                     replay_plain_argmax=steps[j]["plain_argmax"])
        gap = abs(split["f64_gap_plain_minus_kernel"])
        split["near_tie"] = gap < max(split["kernel_err"],
                                      split["plain_err"])
        print(json.dumps(dict(request=i, split_step=j, split=split,
                              k6_vs_f64=held.k6, k7_vs_f64=held.k7,
                              steps=steps)), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("whisper_f32_witness: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", default=[4])
    args = ap.parse_args()
    cs.DEV = "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, out = cs.phase_serve_family(
        torch, cs.WHISPER_ARCH, "serve-whisper",
        ("--train-trajectories", str(cs.WHISPER_HARVEST)),
        cs.WHISPER_REQUESTS, cs.WHISPER_NEW, cs.WHISPER[3],
        2 * cs.WHISPER[3])
    for layers in args.layers:
        splits(torch, out.scheduler, layers)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
