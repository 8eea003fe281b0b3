"""The dropout-add kernel's share of its roofline: the bytes its launches
in the window must move (counted by the wrapper, forward and backward:
each input read once, the output written once) over 3.35 TB/s, against
the device time of the kernels whose name holds ``dropout_add``."""
from benchmark.layer_metrics._dropout_add import per_step


def read(record):
    fwd = per_step(record, "dropout_add", "bytes")
    bwd = per_step(record, "dropout_add_backward", "bytes")
    spent = sum(s for k, s in record.get("kernel_s", {}).items()
                if "dropout_add" in k)
    if fwd is None or bwd is None or not spent or not record.get("peak"):
        return None
    least = (fwd + bwd) * record["units"] / record["peak"]["hbm_bytes_per_s"]
    return 100.0 * least / spent
