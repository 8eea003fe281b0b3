"""Hidden dropout and its residual add in one pass (the ``PackedDropout``
sites of ``emdr2_tpu/models/layers.py``: the embeddings, each residual
branch, the materialized attention probabilities).

``dropout_add(y, r, rate, seed, row_offset, head_offset)`` is
``r + packed_dropout(y, rate, seed, row_offset, head_offset)``, or the
dropout alone when ``r`` is None; with ``seed=None`` or rate 0
(evaluation) it is ``r + y``, or ``y``. On a CUDA tensor it launches the
hand-written kernel (``csrc/dropout_add.cu``), forward and backward, or
raises: it takes bf16 and fp32 tensors of rank 1 to 4, ``r`` of ``y``'s
shape, dtype and device. Its output and its gradients are the plain
path's bits. On a CPU tensor it runs the plain path (``packed_dropout``,
then the add).

The autograd Function saves no tensor, only the site's scalars: its
backward hashes the mask again from the seed and the coordinates
(``dropout_add_backward``: the same kernel over the incoming gradient,
without a residual), and the residual's gradient is the incoming one. A
recompute under activation checkpointing reruns the kernel like any other.

Counters (``utils.timing.count``): ``.launches``, ``.elements`` and
``.bytes`` (what each launch must read and write) on ``dropout_add`` for
the forward and on ``dropout_add_backward`` for the backward.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from emdr2_tpu_torch.ops import build
from emdr2_tpu_torch.ops.hashing import packed_dropout
from emdr2_tpu_torch.utils.timing import count

_M32 = 0xFFFFFFFF
_ENTRIES = {torch.bfloat16: "emdr2_dropout_add_bf16",
            torch.float32: "emdr2_dropout_add_f32"}
_MAX_AXIS = 2 ** 31


def _threshold(rate: float) -> int:
    """``round(rate * 2^32)``, the keep threshold of ``packed_dropout``."""
    t = round(rate * 4294967296.0)
    if t <= 0 or t >= 2 ** 32:
        raise ValueError(f"dropout rate {rate} is outside (0, 1)")
    return t


@functools.lru_cache(maxsize=None)
def _scale(t: int, dtype: torch.dtype) -> float:
    """2^32 / (2^32 - t) rounded to ``dtype``, as ``packed_dropout``
    rounds it."""
    return float(torch.tensor(4294967296.0 / (4294967296 - t), dtype=dtype))


def _site(rate: float, seed: int, row_offset: int, head_offset: int,
          dtype: torch.dtype) -> tuple:
    """The scalars the kernel hashes and scales by: (seed, threshold,
    scale, row offset, head offset), as uint32 where they are bits."""
    t = _threshold(rate)
    return (seed & _M32, t, _scale(t, dtype), row_offset & _M32,
            head_offset & _M32)


def _check(y: torch.Tensor, r: Optional[torch.Tensor]) -> None:
    if not 1 <= y.dim() <= 4:
        raise ValueError(f"dropout_add takes tensors of rank 1 to 4, got "
                         f"{tuple(y.shape)}")
    if r is None:
        return
    if r.shape != y.shape:
        raise ValueError(f"dropout_add: the residual {tuple(r.shape)} is "
                         f"not of y's shape {tuple(y.shape)}")
    if r.device != y.device:
        raise ValueError(f"dropout_add: y on {y.device}, the residual on "
                         f"{r.device}")


def _check_cuda(y: torch.Tensor, r: Optional[torch.Tensor]) -> None:
    if y.dtype not in _ENTRIES or (r is not None and r.dtype != y.dtype):
        raise TypeError(f"the dropout-add kernel takes bf16 or fp32, one "
                        f"dtype for y and the residual; got {y.dtype}"
                        + ("" if r is None else f" and {r.dtype}"))
    if max(y.shape, default=0) >= _MAX_AXIS:
        raise ValueError(f"the dropout-add kernel takes axes below 2^31, "
                         f"got {tuple(y.shape)}")


def dropout_add(y: torch.Tensor, r: Optional[torch.Tensor], rate: float,
                seed: Optional[int], row_offset: int = 0,
                head_offset: int = 0) -> torch.Tensor:
    """``r + packed_dropout(y, rate, seed, row_offset, head_offset)`` (the
    dropout alone when ``r`` is None), differentiable in ``y`` and ``r``;
    ``r + y`` (``y``) when ``seed`` is None or ``rate`` is 0."""
    if seed is None or rate == 0.0:
        return y if r is None else r + y
    _check(y, r)
    if y.device.type != "cuda":
        d = packed_dropout(y, rate, seed, row_offset, head_offset)
        return d if r is None else r + d
    _check_cuda(y, r)
    return _DropoutAdd.apply(
        y, r, _site(rate, seed, row_offset, head_offset, y.dtype))


def dropout_add_backward(grad: torch.Tensor, site: tuple) -> torch.Tensor:
    """The gradient of ``dropout_add`` with respect to ``y`` on the card, as
    the autograd Function's backward takes it: the kernel over ``grad``
    without a residual (``grad`` scaled where the mask keeps, 0 elsewhere),
    for the site's scalars (``_site``)."""
    return _launch(grad, None, site, dropout_add_backward)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(y: torch.Tensor, r: Optional[torch.Tensor], site: tuple,
            counted) -> torch.Tensor:
    """One launch of the kernel over contiguous copies of ``y`` (and
    ``r``), counted on ``counted``."""
    seed, t, scale, row_offset, head_offset = site
    y = y.contiguous()
    r = None if r is None else r.contiguous()
    out = torch.empty_like(y, memory_format=torch.contiguous_format)
    n = y.numel()
    if n == 0:
        return out
    shape, rank = y.shape, y.dim()
    build.launch(
        _ENTRIES[y.dtype], counted.__name__, y.device, y.data_ptr(),
        None if r is None else r.data_ptr(), out.data_ptr(), n, rank,
        shape[-3] if rank >= 3 else 1, shape[-2] if rank >= 2 else 1,
        shape[-1], row_offset, head_offset, seed, t, scale, _stream(y))
    count(counted, "launches")
    count(counted, "elements", n=n)
    count(counted, "bytes", n=(2 if r is None else 3) * n * y.element_size())
    return out


class _DropoutAdd(torch.autograd.Function):

    @staticmethod
    def forward(ctx, y, r, site):
        ctx.site, ctx.residual = site, r is not None
        return _launch(y, r, site, dropout_add)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        dy = (dropout_add_backward(grad, ctx.site)
              if ctx.needs_input_grad[0] else None)
        dr = grad if ctx.residual and ctx.needs_input_grad[1] else None
        return dy, dr, None


# launches, elements and bytes since the last reset, forward and backward
dropout_add.launches = dropout_add.elements = dropout_add.bytes = 0
dropout_add_backward.launches = 0
dropout_add_backward.elements = dropout_add_backward.bytes = 0
