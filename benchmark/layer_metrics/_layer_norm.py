"""The layer-norm kernels' counters (``emdr2_tpu_torch.ops.layer_norm``:
``.launches`` and ``.bytes`` on ``layer_norm`` for the forward, the remat
recompute's included, and on ``layer_norm_backward``), per unit of work.
They cover every unit the run made by the time a reader runs: in a
training cell the set-up's ``check_steps``, the window's steps and the
``stage_steps`` after it; in the embedder's cell the set-up's two warm-up
batches and the window's passages. Every unit has the same shapes, so the
mean is each unit's count. A program without the kernels gives nothing to
read."""

from __future__ import annotations

import sys

MODULE = "emdr2_tpu_torch.ops.layer_norm"


def _units(record) -> int:
    """The units of work the counters cover."""
    traffic = record.get("traffic") or {}
    units = record.get("units", 0)
    if traffic.get("driver") == "evidence_embed":
        return units + 2 * int(record["config"]["embed_batch"])
    return (units + int(traffic.get("check_steps", 0))
            + int(traffic.get("stage_steps", 0)))


def per_unit(record, fn_name: str, counter: str):
    """``fn_name.counter`` over the units made so far, or None."""
    module = sys.modules.get(MODULE)
    value = getattr(getattr(module, fn_name, None), counter, None)
    units = _units(record)
    if value is None or not units:
        return None
    return value / units


def roofline(record):
    """The bytes the kernels' launches in the window must move (forward and
    backward, as the wrapper counts them) over the card's memory rate,
    against the device time of the kernels whose name holds
    ``layer_norm``, in %."""
    fwd = per_unit(record, "layer_norm", "bytes")
    bwd = per_unit(record, "layer_norm_backward", "bytes")
    spent = sum(s for k, s in record.get("kernel_s", {}).items()
                if "layer_norm" in k)
    if fwd is None or bwd is None or not spent or not record.get("peak"):
        return None
    least = (fwd + bwd) * record["units"] / record["peak"]["hbm_bytes_per_s"]
    return 100.0 * least / spent
