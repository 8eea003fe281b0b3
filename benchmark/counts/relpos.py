"""The work of K1's relative-position-bias calls (the T5 v1.1 encoders'
flash self-attention): (FLOPs, bytes) of one call, and the least time of
a step's calls from the program's counters.

A call over ``rows`` sequences of L tokens, ``nh`` heads of ``hd``:
forward two products (q k^T, P v), q, k, v read, the output written, the
fp32 key bias and the offsets' vector read and, when a backward follows,
the two fp32 statistics a row and head written; backward five products
(q k^T and do v^T again, dq, dk, dv), q, k, v, out and dout read, dq, dk
and dv written, the bias, the statistics and delta, the vector read and
its gradient written. The per-block partials the kernel sums its gradient
in are its scratch, not bytes the call needs, and are not counted. The
program counts the same
(``ops/fid_attention.py:_rel_counts``)."""

from __future__ import annotations

import sys
from typing import Optional, Tuple

from benchmark.counts.flops import bound


def rel_self_attention_fwd(rows, L, nh, hd, stats: bool
                           ) -> Tuple[float, float]:
    act = rows * L * nh * hd * 2
    width = nh * (2 * L - 1) * 4
    return (4.0 * rows * L * L * nh * hd,
            4 * act + rows * L * 4 + (rows * nh * L * 8 if stats else 0)
            + width)


def rel_self_attention_bwd(rows, L, nh, hd) -> Tuple[float, float]:
    act = rows * L * nh * hd * 2
    width = nh * (2 * L - 1) * 4
    return (10.0 * rows * L * L * nh * hd,
            8 * act + rows * L * 4 + rows * nh * L * 12 + 2 * width)


def least_seconds_per_step(record) -> Optional[float]:
    """A step's least time of the relative-bias calls, forward and
    backward each bound by the larger of its bytes and its FLOPs, from the
    program's counters over the run's steps (set-up's check steps, the
    window and the stage steps); None without them."""
    module = sys.modules.get("emdr2_tpu_torch.ops.fid_attention")
    traffic = record.get("traffic") or {}
    steps = (record.get("units", 0) + int(traffic.get("check_steps", 0))
             + int(traffic.get("stage_steps", 0)))
    peak = record.get("peak")
    total = 0.0
    for name in ("flash_self_attention", "flash_self_attention_backward"):
        fn = getattr(module, name, None)
        flops = getattr(fn, "rel_flops", None)
        nbytes = getattr(fn, "rel_bytes", None)
        if not flops or nbytes is None or not steps or not peak:
            return None
        total += bound(nbytes / steps, flops / steps, peak)[0]
    return total
