"""The dropout-add kernel's counters (``emdr2_tpu_torch.ops.dropout_add``:
``.launches`` and ``.bytes`` on ``dropout_add`` for the forward, the
remat recompute's included, and on ``dropout_add_backward``), per train
step. They cover every step of the run made by the time a reader runs:
the set-up's ``check_steps``, the window's and the ``stage_steps`` after
it; every step has the same shapes, so the mean is each step's count. A
program without the kernel gives nothing to read."""

from __future__ import annotations

import sys


def per_step(record, fn_name: str, counter: str):
    """``fn_name.counter`` over the steps made so far, or None."""
    module = sys.modules.get("emdr2_tpu_torch.ops.dropout_add")
    value = getattr(getattr(module, fn_name, None), counter, None)
    traffic = record.get("traffic") or {}
    steps = (record.get("units", 0) + int(traffic.get("check_steps", 0))
             + int(traffic.get("stage_steps", 0)))
    if value is None or not steps:
        return None
    return value / steps
