"""Does a train step repeat bit for bit? Run it twice from one state and
name the first tensor that differs.

``snapshot(state)`` copies a ``training.step.TrainState`` (parameters,
AdamW moments and counts); ``restore(state, snap)`` writes the copy back in
place. ``StepRecorder(model)`` fingerprints, in execution order, every
submodule's forward output, the gradient that reaches each of those
outputs, and every parameter's gradient just before the optimizer reads it
(``record_grads``). ``first_difference(a, b)`` compares two recordings.

A fingerprint is exact: the tensor's bits as integers, summed plainly and
weighted by position (int64 on the tensor's device), so two tensors of
equal shape get equal fingerprints when their bits are equal, and a single
flipped bit changes both sums. ``recorded_step(task, batch)`` records one
``train_step`` of an ``E2EQATask`` or a ``DPRTask``; ``repeat_step(task,
batch)`` runs it twice from one state and compares.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

import torch

_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
         torch.float16: torch.int16, torch.float64: torch.int64}
_CHUNK = 1 << 24


def fingerprint(t: torch.Tensor) -> Tuple[Tuple[int, ...], int, int]:
    """(shape, plain sum of the bits, position-weighted sum of the bits)."""
    t = t.detach()
    flat = t.contiguous().reshape(-1)
    if t.dtype in _BITS:
        flat = flat.view(_BITS[t.dtype])
    plain = torch.zeros((), dtype=torch.int64, device=flat.device)
    weighted = torch.zeros((), dtype=torch.int64, device=flat.device)
    for start in range(0, flat.numel(), _CHUNK):    # bounded temporaries
        part = flat[start:start + _CHUNK].to(torch.int64)
        weight = (torch.arange(start, start + part.numel(),
                               device=flat.device, dtype=torch.int64)
                  % 1_000_003 + 1)
        plain += part.sum()
        weighted += (part * weight).sum()
    return tuple(t.shape), int(plain), int(weighted)


def snapshot(state) -> Dict:
    """A copy of ``state``'s parameters, optimizer moments and counts."""
    return {"params": {k: v.detach().clone()
                       for k, v in state.model.state_dict().items()},
            "adamw": copy.deepcopy(state.optimizer.adamw.state_dict()),
            "count": state.optimizer.count, "step": state.step}


@torch.no_grad()
def restore(state, snap: Dict) -> None:
    """Write ``snap`` back into ``state`` in place."""
    for k, v in state.model.state_dict().items():
        v.copy_(snap["params"][k])
    state.optimizer.adamw.load_state_dict(copy.deepcopy(snap["adamw"]))
    state.optimizer.count = snap["count"]
    state.step = snap["step"]
    state.optimizer.zero_grad()


class StepRecorder:
    """Forward outputs and incoming gradients of every submodule, and the
    parameter gradients, as ``(name, kind, fingerprint)`` in the order they
    happen (a checkpointed stack's recompute records its outputs again)."""

    def __init__(self, model: torch.nn.Module):
        self.model = model
        self.entries: List[Tuple[str, str, Tuple]] = []
        self._handles = []

    def _forward_hook(self, name):
        def hook(module, args, out):
            outs = out if isinstance(out, (tuple, list)) else (out,)
            for i, o in enumerate(outs):
                if not isinstance(o, torch.Tensor):
                    continue
                self.entries.append((f"{name}[{i}]", "out", fingerprint(o)))
                if o.requires_grad:
                    o.register_hook(self._grad_hook(f"{name}[{i}]"))
        return hook

    def _grad_hook(self, name):
        def hook(g):
            self.entries.append((name, "grad", fingerprint(g)))
        return hook

    def record_grads(self) -> None:
        for name, p in self.model.named_parameters():
            if p.grad is not None:
                self.entries.append((name, "param_grad", fingerprint(p.grad)))

    def __enter__(self):
        for name, module in self.model.named_modules():
            self._handles.append(module.register_forward_hook(
                self._forward_hook(name or "<model>")))
        return self

    def __exit__(self, *exc):
        for h in self._handles:
            h.remove()
        self._handles.clear()
        return False


def first_difference(a: List, b: List) -> Optional[Tuple[int, Tuple, Tuple]]:
    """(position, entry of ``a``, entry of ``b``) of the first entry that
    differs, or None when the recordings are equal."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i, x, y
    if len(a) != len(b):
        n = min(len(a), len(b))
        return n, a[n] if n < len(a) else None, b[n] if n < len(b) else None
    return None


def recorded_step(task, batch) -> Tuple[Dict[str, torch.Tensor], List]:
    """``task.train_step(batch)`` under a ``StepRecorder`` -> (metrics,
    entries): the recording ends with the metrics and the updated
    parameters."""
    state = task.state
    opt = state.optimizer
    rec = StepRecorder(state.model)
    step = opt.step

    def recording_step():
        rec.record_grads()
        return step()

    opt.step = recording_step
    try:
        with rec:
            metrics = task.train_step(batch)
    finally:
        del opt.step                     # the bound method again
    metrics = {k: v.detach().clone() for k, v in metrics.items()}
    rec.entries.append(("<metrics>", "out", tuple(
        (k, fingerprint(v)) for k, v in sorted(metrics.items()))))
    for name, p in state.model.named_parameters():
        rec.entries.append((name, "param_after", fingerprint(p)))
    return metrics, rec.entries


def repeat_step(task, batch) -> Dict:
    """Run ``task.train_step(batch)`` twice from the task's current state
    (restoring it in between, and leaving it after the second run).
    Returns {"metrics": (first, second), "equal": bool, "entries": n,
    "first_difference": None or (position, first, second), "differing":
    the count of entries that differ}."""
    snap = snapshot(task.state)
    m0, e0 = recorded_step(task, batch)
    restore(task.state, snap)
    m1, e1 = recorded_step(task, batch)
    diff = first_difference(e0, e1)
    return {"metrics": (m0, m1), "equal": diff is None, "entries": len(e0),
            "first_difference": diff,
            "differing": sum(x != y for x, y in zip(e0, e1))
            + abs(len(e0) - len(e1))}
