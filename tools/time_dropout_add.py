#!/usr/bin/env python3
"""Time the dropout-add kernel against the plain path it replaces.

    python3 tools/time_dropout_add.py [--shapes 400x512x768 400x256x768]

For each shape, in bf16 at rate 0.1, with and without the residual: the
kernel's forward (``ops.dropout_add.dropout_add``), the plain forward
(``r + packed_dropout(y)``, the model's sites before the kernel), and each
one's backward: the kernel's as its autograd Function launches it
(``dropout_add_backward``, which hashes the mask again; through the
autograd engine the host's time a call would exceed the kernel's), the
plain path's as ``torch.autograd.grad`` of its output on a kept graph (it
reads its saved mask).
CUDA events around ten calls queued back to back, a tenth of the median
of 20 such runs after 3 warm-up calls: the device's time a call, not the
wrapper's host time before its launch. Beside each, the bound:
the bytes the pass must move (forward 3 x 2 bytes an element with the
residual, 2 x 2 without; backward 2 x 2) over 3.35 TB/s, and the kernel's
share of it. Every output and gradient is checked ``torch.equal`` to the
plain path's first. Needs a CUDA device. Prints the card's name and power
limit, then one JSON object a line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

HBM_BYTES_PER_S = 3.35e12
RATE, SEED = 0.1, 2 ** 31 + 11


def time_ms(fn, reps=20, warmup=3, queued=10):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(queued):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / queued)
    return statistics.median(times)


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+",
                    default=["400x512x768", "400x256x768"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_dropout_add: needs a CUDA device")
    sys.path.insert(0, here)
    from emdr2_tpu_torch.ops.dropout_add import (_site, dropout_add,
                                                  dropout_add_backward)
    from emdr2_tpu_torch.ops.hashing import packed_dropout

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)

    def plain(y, r):
        d = packed_dropout(y, RATE, SEED)
        return d if r is None else r + d

    def kernel(y, r):
        return dropout_add(y, r, RATE, SEED)

    for text in args.shapes:
        shape = tuple(int(v) for v in text.split("x"))
        n = 1
        for v in shape:
            n *= v
        y = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
        r0 = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
        g = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
        y.requires_grad_()
        for residual in (True, False):
            r = r0 if residual else None
            row = {"shape": list(shape), "residual": residual}
            outs = {}
            for name, fn in (("kernel", kernel), ("plain", plain)):
                out = fn(y, r)
                (dy,) = torch.autograd.grad(out, y, g, retain_graph=True)
                outs[name] = (out.detach(), dy)
                with torch.no_grad():
                    row[f"{name}_fwd_ms"] = time_ms(lambda: fn(y, r))
                row[f"{name}_bwd_ms"] = time_ms(
                    (lambda: dropout_add_backward(
                        g, _site(RATE, SEED, 0, 0, g.dtype)))
                    if name == "kernel" else
                    (lambda: torch.autograd.grad(out, y, g,
                                                 retain_graph=True)))
                del out
            row["equal"] = all(torch.equal(a, b) for a, b in
                               zip(outs["kernel"], outs["plain"]))
            fwd_bytes = (3 if residual else 2) * 2 * n
            row["fwd_bound_ms"] = 1e3 * fwd_bytes / HBM_BYTES_PER_S
            row["bwd_bound_ms"] = 1e3 * 2 * 2 * n / HBM_BYTES_PER_S
            row["fwd_share"] = row["fwd_bound_ms"] / row["kernel_fwd_ms"]
            row["bwd_share"] = row["bwd_bound_ms"] / row["kernel_bwd_ms"]
            print(json.dumps(row), flush=True)
            del outs
        del y, r0, g
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
