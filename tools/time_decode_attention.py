#!/usr/bin/env python3
"""Time the int8 decode attention kernel (K5) of one source tree, two ways.

    python3 tools/time_decode_attention.py [--tree DIR] [--rows 1 5 8]

``DIR`` is the root of a checkout that holds ``emdr2_tpu_torch`` (default:
the one this file lies in); its wrapper ``decode_cross_attention_int8(q, k8,
kscale, v8, vscale, kv_bias)`` is imported, its kernels are built there, and
the call is timed at the decode shape [8, R, 12, 25,600, 64] with CUDA
events:

- ``one_call_ms``: one call between two events, median of 20. It holds the
  wrapper's host work where that is longer than the kernel.
- ``queued_ms``: ten calls queued back to back between two events, a tenth
  of the median of 10: the kernels' own time.

To compare two commits, unpack the other one with ``git archive`` into a
directory, and run this script once a tree, one after the other on one card,
in the order parent, change, change, parent: a process imports one tree only.
Needs a CUDA device. Prints the card's name and power limit, then one JSON
object.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

SEED = 1234


def time_ms(fn, reps, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=here)
    ap.add_argument("--rows", type=int, nargs="+", default=[1, 5, 8])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_decode_attention: needs a CUDA device")
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from emdr2_tpu_torch.ops import decode_attention as da

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    B, nh, Lk, hd = 8, 12, 25_600, 64
    kf = torch.randn(B, nh, Lk, hd, device=dev, generator=gen)
    vf = torch.randn(B, nh, Lk, hd, device=dev, generator=gen)
    real = torch.randint(Lk // 2, Lk - 50, (B,), device=dev, generator=gen)
    pad = torch.arange(Lk, device=dev)[None, :] >= real[:, None]
    kf.masked_fill_(pad[:, None, :, None], 0.0)
    vf.masked_fill_(pad[:, None, :, None], 0.0)
    k8, ks = da.quantize_kv_rows(kf)
    v8, vs = da.quantize_kv_rows(vf)
    bias = torch.where(pad, -1e9, 0.0).float()
    del kf, vf
    rows = []
    for R in args.rows:
        q = torch.randn(B, R, nh, hd, device=dev, generator=gen
                        ).to(torch.bfloat16)

        def call():
            return da.decode_cross_attention_int8(q, k8, ks, v8, vs, bias)

        def ten_calls():
            for _ in range(10):
                call()
        got = call()
        want = da.decode_cross_attention_int8_plain(q, k8, ks, v8, vs, bias)
        err = (got.float() - want.float()).abs().max().item()
        if not err <= 2e-2 * want.float().abs().max().item():
            sys.exit(f"time_decode_attention: R={R} disagrees with the "
                     f"plain version by {err}")
        rows.append({"R": R, "one_call_ms": time_ms(call, reps=20),
                     "queued_ms": time_ms(ten_calls, reps=10) / 10,
                     "max_abs_err": err})
    print(json.dumps({"tree": tree, "card": card, "shape": [B, "R", nh, Lk, hd],
                      "rows": rows}))


if __name__ == "__main__":
    main()
