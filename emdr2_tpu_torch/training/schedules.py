"""Learning-rate schedules (port of ``emdr2_tpu/training/schedules.py``).

The reference's ``AnnealingLR``: linear warmup over ``warmup_iter`` steps,
then linear / cosine / exponential / constant decay measured over
``total_iters``, floored at ``min_lr``. The reference's quirk is kept: decay
progress is ``(step - warmup) / total``, not ``/ (total - warmup)``. The
arithmetic is fp32, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from emdr2_tpu_torch.config import OptimizerConfig

_F = np.float32


def annealing_lr(start_lr: float, warmup_iter: int, total_iters: int,
                 decay_style: str = "linear", min_lr: float = 0.0
                 ) -> Callable[[int], float]:
    """-> schedule(step) -> lr."""
    if decay_style not in ("linear", "cosine", "exponential", "constant"):
        raise ValueError(f"unknown decay style {decay_style}")
    lr0 = _F(start_lr)

    def schedule(step: int) -> float:
        step_f = _F(step)
        w = _F(warmup_iter)
        total = _F(total_iters)
        capped = min(step_f, _F(total - w))
        warmup_lr = _F(lr0 * capped) / max(w, _F(1.0))
        progress = _F(capped - w)
        if decay_style == "linear":
            lr = _F(lr0 * _F(total - progress)) / total
        elif decay_style == "cosine":
            lr = _F(lr0 / _F(2.0)) * _F(
                np.cos(_F(_F(np.pi) * progress) / total) + _F(1.0))
        elif decay_style == "exponential":
            lr = lr0 * np.exp(_F(_F(-0.693) * progress) / total)
        else:
            lr = lr0
        lr = max(_F(lr), _F(min_lr))
        if warmup_iter > 0 and step_f <= w:
            return float(warmup_lr)
        return float(lr)

    return schedule


def schedule_from_config(cfg: OptimizerConfig, total_iters: int):
    warmup_iter = int(cfg.warmup * total_iters)
    return annealing_lr(cfg.lr, warmup_iter, total_iters,
                        decay_style=cfg.lr_decay_style, min_lr=cfg.min_lr)
