"""K1's relative-position-bias kernels' share of their roofline: the
least time of the window's calls, max(bytes / 3.35 TB/s, FLOPs / 989
TFLOP/s) a direction, from the program's counters (``.rel_flops`` and
``.rel_bytes`` on ``flash_self_attention`` and on
``flash_self_attention_backward``: every call of the run, recompute
included, per step), over the device time of the kernels whose names
hold ``RelBias`` (the walks' relative-bias variant). A program without the
bias gives nothing to read."""
from benchmark.counts.relpos import least_seconds_per_step


def read(record):
    least = least_seconds_per_step(record)
    spent = sum(s for k, s in record.get("kernel_s", {}).items()
                if "RelBias" in k)
    if least is None or not spent:
        return None
    return 100.0 * least * record["units"] / spent
