"""Command-line tools: evidence prep, the offline index build, checkpoint
and retrieval tools, and the measurement tools (``bench_*``)."""
