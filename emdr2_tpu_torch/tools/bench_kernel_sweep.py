"""Time the attention kernels' forward and backward at the flagship shapes
across key chunks (port of ``emdr2_tpu/tools/bench_kernel_sweep.py``).

- The general flash kernel (K4, ``ops.fid_attention.fid_cross_attention``)
  on the decoder's cross shape: 32 queries over K x 512 keys (25,600 at
  K=50), 12 heads of 64, bf16, in each key chunk of ``--chunks`` that
  divides the keys. A chunk the kernel's checks refuse is a row with
  ``error``, not a dropped row.
- The fused self-attention slab kernel (K1, ``flash_self_attention``) on
  the encoder's [B*K, 512, 2304] slab, as a canary.

Each row is the mean host ms of forward + backward (the gradients of the
output's sum) over ``--iters`` calls between synchronizes. Prints one JSON
line per configuration. Runs on the card unless ``--device cpu``:

    python -m emdr2_tpu_torch.tools.bench_kernel_sweep [--iters 20] [--batch 4]
"""

from __future__ import annotations

import argparse
import json

import torch

from emdr2_tpu_torch.tools import flagship


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--topk", type=int, default=50)
    p.add_argument("--chunks", type=int, nargs="*",
                   default=[256, 512, 1024, 1600, 3200])
    p.add_argument("--device", default="cuda",
                   help="where to run (default the card; 'cpu' to run the "
                        "plain versions without one)")
    args = p.parse_args(argv)

    from emdr2_tpu_torch.ops.fid_attention import (fid_cross_attention,
                                                   flash_self_attention)
    from emdr2_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    B, K = args.batch, args.topk
    L, nh, hd = 512, 12, 64
    H = nh * hd
    Lq, Lk = 32, K * L
    dt = torch.bfloat16
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    def tensor(*shape):
        return torch.randn(*shape, generator=gen, device=device,
                           dtype=dt).requires_grad_(True)

    # ---- cross-attention kv-slab shape (decoder over K*512 keys) ----------
    q, k, v = tensor(B, Lq, nh, hd), tensor(B, Lk, nh, hd), \
        tensor(B, Lk, nh, hd)
    bias = torch.zeros((B, Lk), dtype=torch.float32, device=device)

    def cross_fwd_bwd(chunk):
        out = fid_cross_attention(q, k, v, bias, None, chunk, 0.0)
        return torch.autograd.grad(out.float().sum(), (q, k, v))

    results = []
    for chunk in args.chunks:
        if Lk % chunk:
            continue
        try:
            dt_s = flagship.seconds_per_call(lambda: cross_fwd_bwd(chunk),
                                             args.iters, device)
        except (ValueError, RuntimeError) as e:   # a chunk the checks refuse
            results.append({"kernel": "cross", "key_chunk": chunk,
                            "error": str(e)[:120]})
            print(json.dumps(results[-1]), flush=True)
            continue
        results.append({"kernel": "cross", "key_chunk": chunk,
                        "fwd_bwd_ms": round(dt_s * 1e3, 3)})
        print(json.dumps(results[-1]), flush=True)
    del q, k, v, bias

    # ---- self-attention slab at the encoder shape --------------------------
    qkv = tensor(B * K, L, 3 * H)
    sbias = torch.zeros((B * K, L), dtype=torch.float32, device=device)

    def self_fwd_bwd():
        out = flash_self_attention(qkv, sbias, nh, None, 0.0)
        return torch.autograd.grad(out.float().sum(), qkv)

    dt_s = flagship.seconds_per_call(self_fwd_bwd, max(2, args.iters // 4),
                                     device)
    results.append({"kernel": "self_slab", "shape": f"{B * K}x{L}x{nh}h",
                    "fwd_bwd_ms": round(dt_s * 1e3, 3)})
    print(json.dumps(results[-1]), flush=True)
    return results


if __name__ == "__main__":
    main()
