"""Carry JAX (flax) parameters over to the port.

``params_from_jax(tree)`` takes the flax params of ``EMDR2Model`` as a
nested dict of numpy arrays (unboxed from ``LogicallyPartitioned``, no jax
types) and returns the ``state_dict`` of the port's ``EMDR2Model``. The
port's modules carry the flax names, so keys are flax paths joined by dots;
the layout changes are:

- ``FusedDense`` kernels [D, n, H] -> [D, n*H] (``x @ W`` is the
  [q | k | v] slab) and their biases [n, H] -> [n*H];
- ``LayerNorm`` ``scale`` -> ``weight``;
- ``Dense`` kernels keep the flax [in, out] layout (the port computes
  ``x @ W``, no transpose); embedding tables and the LM bias are copied.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = ""):
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            yield from _flatten(value, path + ".")
        else:
            yield path, value


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (flax params) -> port ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(tree):
        a = np.asarray(value)
        module, _, leaf = path.rpartition(".")
        if leaf == "kernel" and a.ndim == 3:       # FusedDense [D, n, H]
            a = a.reshape(a.shape[0], -1)
        elif leaf == "bias" and a.ndim == 2:       # FusedDense bias [n, H]
            a = a.reshape(-1)
        elif leaf == "scale":                      # LayerNorm
            path = f"{module}.weight"
        out[path] = torch.tensor(a)
    return out
