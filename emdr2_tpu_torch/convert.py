"""Carry JAX (flax) parameters and Adam state over to the port.

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

``load_adam_from_jax`` puts the JAX optimizer's Adam moments (trees shaped
like the params, so the same layout changes apply) and its update count
into the port's ``Optimizer``, so a port run can go on from the middle of a
JAX run.

Tensor parallelism: ``shard_params(full, tp_rank, tp)`` cuts a whole
``state_dict`` into the part that tp rank ``tp_rank`` of ``tp`` holds, as
the JAX ``param_shardings`` place the same parameters on that index of a
mesh's ``tp`` axis (``parallel.tensor.split_of``: ``FusedDense`` by heads
within each of its n blocks, ``query`` / ``wi`` and their biases by
columns, ``out`` / ``wo`` by rows, the word embeddings and the LM bias by
the vocabulary); ``gather_params(local, tp)`` joins the ``tp`` ranks'
parts again.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from emdr2_tpu_torch.parallel.tensor import shard_state, split_of


def _flatten(tree: Mapping, prefix: str = ""):
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            yield from _flatten(value, path + ".")
        else:
            yield path, value


def port_key(path: str) -> str:
    """A flax parameter path (joined by dots) -> the port's state_dict key."""
    module, _, leaf = path.rpartition(".")
    return f"{module}.weight" if leaf == "scale" else path   # LayerNorm


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (flax params) -> port ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(tree):
        a = np.asarray(value)
        leaf = path.rpartition(".")[2]
        if leaf == "kernel" and a.ndim == 3:       # FusedDense [D, n, H]
            a = a.reshape(a.shape[0], -1)
        elif leaf == "bias" and a.ndim == 2:       # FusedDense bias [n, H]
            a = a.reshape(-1)
        out[port_key(path)] = torch.tensor(a)
    return out


def leaves_by_port_key(tree: Mapping) -> Dict[str, object]:
    """Any pytree shaped like the flax params (e.g. the JAX package's
    ``decay_mask``) -> {port state_dict key: leaf}, leaves unchanged."""
    return {port_key(path): leaf for path, leaf in _flatten(tree)}


def load_adam_from_jax(optimizer, model: torch.nn.Module, mu: Mapping,
                       nu: Mapping, count: int) -> None:
    """Load Adam's first and second moments (``mu``, ``nu``: nested dicts of
    numpy arrays shaped like the flax params) and the number of updates
    taken into ``optimizer`` (a ``training.step.Optimizer`` over
    ``model``). The schedule is read at ``count`` from then on."""
    first, second = params_from_jax(mu), params_from_jax(nu)
    named = dict(model.named_parameters())
    if set(first) != set(named) or set(second) != set(named):
        raise ValueError("the moments do not cover the model's parameters: "
                         f"{sorted(set(first) ^ set(named))[:5]} ...")
    for name, p in named.items():
        if first[name].shape != p.shape or second[name].shape != p.shape:
            raise ValueError(f"moment of {name} has shape "
                             f"{tuple(first[name].shape)}, the parameter "
                             f"{tuple(p.shape)}")
        optimizer.adamw.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": first[name].to(p.device, p.dtype),
            "exp_avg_sq": second[name].to(p.device, p.dtype),
        }
    optimizer.count = int(count)


def shard_params(full: Mapping[str, torch.Tensor], tp_rank: int, tp: int
                 ) -> Dict[str, torch.Tensor]:
    """The part of the whole ``state_dict`` ``full`` that tp rank
    ``tp_rank`` of ``tp`` holds (module docstring)."""
    if not 0 <= tp_rank < tp:
        raise ValueError(f"tp rank {tp_rank} of {tp}")
    return shard_state(full, tp_rank, tp)


def gather_params(local: Sequence[Mapping[str, torch.Tensor]], tp: int
                  ) -> Dict[str, torch.Tensor]:
    """The whole ``state_dict`` of the ``tp`` ranks' parts ``local`` (in
    tp rank order): ``gather_params([shard_params(full, t, tp) for t in
    range(tp)], tp)`` is ``full``."""
    if len(local) != tp:
        raise ValueError(f"{len(local)} parts for tp {tp}")
    out: Dict[str, torch.Tensor] = {}
    for name, first in local[0].items():
        split = split_of(name)
        out[name] = (first if split is None or tp == 1
                     else split.join([part[name] for part in local]))
    return out
