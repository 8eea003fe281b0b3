"""The program's counts of token positions against slots, read off the
function that formatted the rows, where the program keeps them
(``emdr2_tpu_torch.utils.timing.count``): ``tokens`` and ``slots``, a
number, or a dict by kind of row. They cover every step of the run that
formatted rows (set-up, the window and after it), so the share is that of
the run's traffic. A program without these counts gives nothing to read."""

from __future__ import annotations

import sys


def pad_share(module: str, function: str, key=None):
    """The share of the slots that hold padding, in %, or None."""
    fn = getattr(sys.modules.get(module), function, None)
    tokens, slots = getattr(fn, "tokens", None), getattr(fn, "slots", None)
    if key is not None:
        tokens = tokens.get(key) if isinstance(tokens, dict) else None
        slots = slots.get(key) if isinstance(slots, dict) else None
    if tokens is None or not slots:
        return None
    return 100.0 * (1.0 - tokens / slots)
