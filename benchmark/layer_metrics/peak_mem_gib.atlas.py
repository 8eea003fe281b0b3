"""The allocator's peak over the window (torch.cuda.max_memory_allocated,
reset at the window's start)."""
from benchmark.layer_metrics._common import peak_gib


def read(record):
    return peak_gib(record)
