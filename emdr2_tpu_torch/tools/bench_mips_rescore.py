"""Recall and queries/s of the int8 search's re-rank window selection (port
of ``emdr2_tpu/tools/bench_mips_rescore.py``).

An int8 ``mips_topk`` re-scores the top-M approximate winners of the
candidate scan exactly (M = 48 for k <= 20, else max(128, 2k)); above
about 8,192 candidate columns the window is selected by the two-stage
``mips._blocked_window_topk``. This tool holds that selection against an
exact top-M (``torch.topk``) over one card's shard (``flagship.SHARD_ROWS``
x 768 int8 rows, random bf16 rows quantized in groups of 128, queries
N(0, 1) in fp32), at k in {20, 51}:

- recall of the whole search against an exact search over the stored
  (dequantized) rows, summed in float64, row-chunked;
- queries/s of each variant (host clock over ``--iters`` searches between
  synchronizes).

Prints one JSON line per (k, variant). Runs on the card unless ``--device
cpu``:

    python -m emdr2_tpu_torch.tools.bench_mips_rescore [--iters 20] [--nq 512]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from emdr2_tpu_torch.tools import flagship

KS = (20, 51)
SEED = 0


def make_inputs(n: int, d: int, nq: int, group: int, device,
                seed: int = SEED):
    """(queries [nq, d] fp32, int8 rows [n, d], scales [n / group]): rows
    N(0, 1) in bf16 quantized in blocks (no fp32 copy of the whole index),
    from one generator on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    from emdr2_tpu_torch.ops.mips import quantize_int8
    q8 = torch.empty((n, d), dtype=torch.int8, device=device)
    scales = torch.empty(n // group, dtype=torch.float32, device=device)
    step = 512 * group
    for s in range(0, n, step):
        e = torch.randn(min(step, n - s), d, generator=gen, device=device,
                        dtype=torch.bfloat16)
        q8[s:s + e.shape[0]], scales[s // group:(s + e.shape[0]) // group] \
            = quantize_int8(e, group)
    q = torch.randn(nq, d, generator=gen, device=device)
    return q, q8, scales


def exact_reference_ids(q, q8, scales, k: int, chunks: int = 16
                        ) -> np.ndarray:
    """Exact top-k rows [nq, k] over the stored rows (int8 x group scale),
    the products summed in float64, in ``chunks`` row blocks so the
    [nq, N] score matrix never exists whole."""
    n = q8.shape[0]
    group = n // scales.shape[0]
    step = -(-n // chunks // group) * group
    qd = q.double()
    best_v = best_i = None
    for s in range(0, n, step):
        rows = q8[s:s + step].double() * scales[
            s // group:(s + step) // group].double().repeat_interleave(
                group)[:, None]
        v, i = torch.topk(qd @ rows.T, min(k, rows.shape[0]), dim=1)
        i = i + s
        if best_v is not None:
            v, i = torch.cat([best_v, v], 1), torch.cat([best_i, i], 1)
            v, pos = torch.topk(v, k, dim=1)
            i = torch.gather(i, 1, pos)
        best_v, best_i = v, i
    return best_i.cpu().numpy()


def recall(ids: np.ndarray, ref: np.ndarray) -> float:
    """Mean over queries of |ids & ref| / k."""
    k = ref.shape[1]
    return float(np.mean([len(set(a) & set(b)) / k
                          for a, b in zip(ids.tolist(), ref.tolist())]))


def _exact_window(cand_vals, m, **_):
    return torch.topk(cand_vals, m, dim=1).indices


def run(nq: int, iters: int, device) -> list:
    """The rows, each with the search's ids (``"ids"``, not printed) and
    the inputs they came from (``inputs``: queries, rows, scales)."""
    from emdr2_tpu_torch.ops import mips
    cfg = flagship.base_config().index
    n, d, group = flagship.SHARD_ROWS, cfg.embed_dim, cfg.group_size
    q, q8, scales = make_inputs(n, d, nq, group, device)
    refs = {k: exact_reference_ids(q, q8, scales, k) for k in KS}
    variants = {"blocked": mips._blocked_window_topk,
                "exact_topk": _exact_window}
    blocked_impl = mips._blocked_window_topk
    rows = []
    try:
        for k in KS:
            for name, impl in variants.items():
                mips._blocked_window_topk = impl

                def search():
                    return mips.mips_topk(
                        q, q8, k, chunk_rows=cfg.chunk_rows,
                        group_size=group,
                        cands_per_group=cfg.cands_per_group,
                        shard_scales=scales)
                ids = search()[1].cpu().numpy()
                dt = flagship.seconds_per_call(search, iters, device,
                                               warmup=0)
                row = {"k": k, "window_select": name,
                       "recall_vs_exact_fp32_over_stored":
                           round(recall(ids, refs[k]), 6),
                       "qps_per_chip": round(nq / dt, 1),
                       "n_rows": n}
                print(json.dumps(row), flush=True)
                rows.append(dict(row=row, ids=ids, ref=refs[k]))
    finally:
        mips._blocked_window_topk = blocked_impl
    return [dict(r, inputs=(q, q8, scales)) for r in rows]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--nq", type=int, default=512)
    p.add_argument("--device", default="cuda",
                   help="where to search (default the card; 'cpu' to run "
                        "without one)")
    args = p.parse_args(argv)
    from emdr2_tpu_torch.utils.device import resolve_device
    return run(args.nq, args.iters, resolve_device(args.device))


if __name__ == "__main__":
    main()
