"""Command-line tools: evidence prep and the offline index build."""
