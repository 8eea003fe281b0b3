"""Tensor parallelism over a tp ``Group`` (the counterpart of the
reference's ``mpu/mappings.py``, which the JAX package expresses as the
``LOGICAL_RULES`` of ``emdr2_tpu/parallel/mesh.py``: ``mlp``, ``heads``
and ``vocab`` over ``tp``).

Megatron's scheme, one process per rank: a column-parallel layer takes
the replicated activations through ``copy_to_tp`` (identity forward,
all-reduce backward) and produces this rank's columns; a row-parallel
layer multiplies them by its rows and sums the partial products with
``reduce_from_tp`` (all-reduce forward, identity backward), after which
the activations are replicated again. ``gather_from_tp`` concatenates the
ranks' last axes (the generation step's logits). On a one-rank group each
is the identity and issues no call.

Which parameters split, and how, is a function of the parameter's name
(``split_of``), the JAX logical axes of the same parameter:

- ``qkv`` / ``key_value`` (``FusedDense``, flat [D, n*H] here, [D, n, H]
  in JAX with H over tp): each of the n blocks splits by heads, so a rank
  holds a whole [q_h | k_h | v_h] slab for its heads;
- ``query`` and ``wi`` are column-parallel (their last axis), their biases
  too; ``out`` and ``wo`` row-parallel (their first axis), their biases
  whole (added after the all-reduce);
- ``word_embeddings`` and ``lm_bias`` split over the vocabulary;
- everything else (LayerNorm, position and tokentype tables, the BERT
  heads' dense layers) is whole on every rank.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Mapping, Optional, Sequence

import torch

from emdr2_tpu_torch.parallel.mesh import Group


def is_split(tp: Optional[Group]) -> bool:
    """True when ``tp`` spans more than one rank."""
    return tp is not None and tp.world_size > 1


class _CopyToTP(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.tp.all_reduce_sum_(grad.contiguous().clone()), None


class _ReduceFromTP(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce_sum_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromTP(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        ctx.cols = x.shape[-1]
        parts = tp.all_gather(x)                       # [tp, ..., cols]
        return torch.cat(list(parts.unbind(0)), dim=-1)

    @staticmethod
    def backward(ctx, grad):
        r, c = ctx.tp.rank, ctx.cols
        return grad[..., r * c:(r + 1) * c].contiguous(), None


def copy_to_tp(x: torch.Tensor, tp: Optional[Group]) -> torch.Tensor:
    """The input of a column-parallel layer: ``x`` forward, its gradient
    summed over the tp ranks backward."""
    return _CopyToTP.apply(x, tp) if is_split(tp) else x


def reduce_from_tp(x: torch.Tensor, tp: Optional[Group]) -> torch.Tensor:
    """The output of a row-parallel layer: the sum of the ranks' partial
    ``x`` (in ``x``'s dtype) forward, the gradient as it is backward."""
    return _ReduceFromTP.apply(x, tp) if is_split(tp) else x


def gather_from_tp(x: torch.Tensor, tp: Optional[Group]) -> torch.Tensor:
    """The ranks' ``x`` concatenated on the last axis, in rank order;
    backward keeps this rank's columns."""
    return _GatherFromTP.apply(x, tp) if is_split(tp) else x


# ------------------------------------------------------- the parameters' split

@dataclasses.dataclass(frozen=True)
class Split:
    """A parameter split over tp along ``axis``, which holds ``n_fused``
    equal blocks (3 for a qkv slab, 2 for key/value, else 1); each block is
    cut in ``tp`` contiguous parts and rank t takes part t of every
    block."""

    axis: int
    n_fused: int = 1

    def _blocked(self, shape, parts: int):
        a = self.axis
        size = shape[a]
        if size % (self.n_fused * parts):
            raise ValueError(f"axis {a} of {tuple(shape)} does not divide "
                             f"into {self.n_fused} blocks of {parts} parts")
        return (tuple(shape[:a]) + (self.n_fused, size // self.n_fused)
                + tuple(shape[a + 1:]))

    def local_shape(self, shape, tp: int):
        shape = list(shape)
        shape[self.axis] //= tp
        return tuple(shape)

    def take(self, full: torch.Tensor, t: int, tp: int) -> torch.Tensor:
        """Rank ``t``'s part of ``full`` (a copy, contiguous)."""
        view = full.reshape(self._blocked(full.shape, tp))
        part = view.shape[self.axis + 1] // tp
        piece = view.narrow(self.axis + 1, t * part, part)
        return piece.reshape(self.local_shape(full.shape, tp)).clone()

    def join(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The whole parameter of the ranks' ``parts``, in rank order."""
        views = [p.reshape(self._blocked(p.shape, 1)) for p in parts]
        whole = torch.cat(views, dim=self.axis + 1)
        shape = list(parts[0].shape)
        shape[self.axis] *= len(parts)
        return whole.reshape(shape)


_SPLITS = {
    ("qkv", "kernel"): Split(1, 3), ("qkv", "bias"): Split(0, 3),
    ("key_value", "kernel"): Split(1, 2), ("key_value", "bias"): Split(0, 2),
    ("query", "kernel"): Split(1), ("query", "bias"): Split(0),
    ("wi", "kernel"): Split(1), ("wi", "bias"): Split(0),
    ("out", "kernel"): Split(0), ("wo", "kernel"): Split(0),
}
_VOCAB = ("word_embeddings", "lm_bias")
COLUMN, ROW = Split(1), Split(0)


def split_of(name: str) -> Optional[Split]:
    """How the parameter named ``name`` (a ``state_dict`` key) splits over
    tp, or None when every rank holds it whole (module docstring)."""
    parts = name.split(".")
    if parts[-1] in _VOCAB:
        return ROW
    if len(parts) < 2:
        return None
    return _SPLITS.get((parts[-2], parts[-1]))


def all_gather_params(local: Mapping[str, torch.Tensor],
                      tp: Optional[Group]) -> Dict[str, torch.Tensor]:
    """This rank's tensors keyed by parameter name -> the whole ones: one
    all-gather over ``tp`` for each split tensor, in the order of
    ``local`` (the same on every rank); whole tensors pass as they are."""
    if not is_split(tp):
        return dict(local)
    out = {}
    for name, t in local.items():
        split = split_of(name)
        out[name] = (t if split is None else
                     split.join(list(tp.all_gather(t).unbind(0))))
    return out


def shard_state(full: Mapping[str, torch.Tensor], t: int, tp: int
                ) -> Dict[str, torch.Tensor]:
    """Rank ``t``'s part of every split tensor of ``full``; whole ones
    pass as they are."""
    if tp == 1:
        return dict(full)
    out = {}
    for name, v in full.items():
        split = split_of(name)
        out[name] = v if split is None else split.take(v, t, tp)
    return out


def shard_for(full: Mapping[str, torch.Tensor], tp: Optional[Group]
              ) -> Dict[str, torch.Tensor]:
    """``full`` (whole tensors by parameter name) cut for this rank of
    ``tp``; as it is without tensor parallelism."""
    if not is_split(tp):
        return dict(full)
    return shard_state(full, tp.rank, tp.world_size)


def module_tp(module: torch.nn.Module) -> Optional[Group]:
    """The tp group of the first submodule that holds one (None)."""
    for m in module.modules():
        tp = getattr(m, "tp", None)
        if isinstance(tp, Group):
            return tp
    return None


@torch.no_grad()
def unsharded_copy(module: torch.nn.Module) -> torch.nn.Module:
    """A one-rank copy of a tp-split ``module`` with the whole parameters
    (one all-gather over its tp group for each split parameter, on every
    tp rank alike). The copy computes what the split module computes, with
    no collective: an embedder that runs beside the trainers embeds with
    it."""
    tp = module_tp(module)
    whole = all_gather_params(
        {n: p.detach() for n, p in module.named_parameters()}, tp)
    twin = copy.deepcopy(module)
    for m in twin.modules():
        if isinstance(getattr(m, "tp", None), Group):
            m.tp = Group.local()
    for n, p in list(twin.named_parameters()):
        if split_of(n) is None or not is_split(tp):
            continue
        owner, _, leaf = n.rpartition(".")
        setattr(twin.get_submodule(owner), leaf,
                torch.nn.Parameter(whole[n].clone(),
                                   requires_grad=p.requires_grad))
    return twin
