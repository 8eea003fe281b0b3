"""The flash attention kernels' share of their roofline: the least time
of the attention work the cell's shapes need, counted once, over the
device time of the kernels counts/attn_roofline.embed.json names."""
from benchmark.layer_metrics._common import roofline


def read(record):
    return roofline(record, "attn_roofline.embed")
