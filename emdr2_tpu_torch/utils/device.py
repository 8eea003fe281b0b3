"""Where the port's entry points put their tensors.

The port is written for the card: ``EMDR2Model``, ``E2EQATask`` and
``ShardedEvidenceIndex`` default to ``"cuda"``. The CPU is used only when
the caller names it (the CPU tests do); asking for a card that is not there
raises, it never becomes a quiet run on the CPU.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``torch.device(device)``; raises when it names a CUDA device and none
    is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for, but no CUDA device is "
            f"available (torch.cuda.is_available() is False). The port "
            f"runs on the card by default; pass device=\"cpu\" to run on "
            f"the CPU")
    return dev
