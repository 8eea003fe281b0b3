"""LayerNorm over the last axis in fp32 statistics, whatever the
activations' dtype (the Megatron block's norm, ``models/layers.py``).

``layer_norm(x, weight, bias, eps)`` normalises each row of ``x`` (bf16
or fp32, any rank, last axis H a multiple of 8) with its mean and variance
in fp32, scales by ``weight`` and shifts by ``bias`` (fp32 [H]), and
returns x's dtype. On a CUDA tensor it launches the hand-written kernels
(``csrc/layer_norm.cu``), forward and backward, or raises; on a CPU tensor
it runs ``layer_norm_reference``, the formula the model ran before the
kernels, which stays the CPU route and the oracle.

The autograd Function saves x alone: the backward kernel recomputes the
row's statistics from it. The gradients of the weight and the bias are
summed without atomics in a fixed order (per-block fp32 partials over a
grid fixed by the shape and the card, then summed over the grid in index
order), so a step repeats bit for bit. A recompute under activation
checkpointing reruns the forward kernel like any other.

Counters (``utils.timing.count``): ``.launches`` and ``.bytes`` (what each
launch must read and write: x, the output and the weight and bias once
forward; x, dy, dx, the weight, the per-block partials written and read
back, and the two gradients backward) on ``layer_norm`` for the forward
and its recompute, and on ``layer_norm_backward`` for the backward (a
launch: the row kernel and the sum of its partials).
"""

from __future__ import annotations

import functools

import torch
from torch.autograd.function import once_differentiable

from emdr2_tpu_torch.ops import build
from emdr2_tpu_torch.utils.timing import count

_ENTRIES = {torch.bfloat16: "emdr2_layer_norm_bf16",
            torch.float32: "emdr2_layer_norm_f32"}
_BWD_ENTRIES = {torch.bfloat16: "emdr2_layer_norm_bwd_bf16",
                torch.float32: "emdr2_layer_norm_bwd_f32"}
_WARP_MAX_H = 1024          # a warp walks a row up to here, a block beyond
_MAX_H = 8192               # the block walk's most: 256 threads x 32 values
_ROWS_PER_BLOCK = 8         # the warp walk: 8 warps a block
# blocks a multiprocessor (the kernels' __launch_bounds__ minimums)
_FWD_BLOCKS_PER_SM, _BWD_BLOCKS_PER_SM = 4, 2


def layer_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, eps: float) -> torch.Tensor:
    """The plain formula: statistics and affine in fp32, the result in
    x's dtype."""
    orig = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    return (y * weight + bias).to(orig)


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> None:
    if x.dtype not in _ENTRIES:
        raise TypeError(f"layer_norm takes bf16 or fp32 activations, got "
                        f"{x.dtype}")
    if x.dim() == 0 or x.shape[-1] % 8:
        raise ValueError(f"layer_norm takes a last axis that is a multiple "
                         f"of 8, got {tuple(x.shape)}")
    h = x.shape[-1]
    for name, p in (("weight", weight), ("bias", bias)):
        if p.dtype != torch.float32:
            raise TypeError(f"layer_norm: the {name} is {p.dtype}, not fp32")
        if tuple(p.shape) != (h,):
            raise ValueError(f"layer_norm: the {name} {tuple(p.shape)} is "
                             f"not [{h}]")
        if p.device != x.device:
            raise ValueError(f"layer_norm: x on {x.device}, the {name} on "
                             f"{p.device}")


def _check_cuda(x: torch.Tensor) -> None:
    if x.shape[-1] > _MAX_H:
        raise ValueError(f"the layer-norm kernel takes a last axis up to "
                         f"{_MAX_H}, got {x.shape[-1]}")
    if x.numel() // x.shape[-1] >= 2 ** 31:
        raise ValueError(f"the layer-norm kernel takes fewer than 2^31 "
                         f"rows, got {tuple(x.shape)}")


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm of ``x`` over its last axis, differentiable in ``x``,
    ``weight`` and ``bias``: the kernels on the card, the formula on the
    CPU."""
    _check(x, weight, bias)
    if x.device.type != "cuda":
        return layer_norm_reference(x, weight, bias, eps)
    _check_cuda(x)
    return _LayerNorm.apply(x, weight, bias, float(eps))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _grid(rows: int, h: int, device: torch.device, blocks_per_sm: int) -> int:
    """The blocks that walk ``rows`` rows of ``h``: enough for the rows (8
    a block in the warp walk, 1 in the block walk), at most
    ``blocks_per_sm`` a multiprocessor of the card. The backward's number
    of partials, so fixed by the shape and the card."""
    per_block = _ROWS_PER_BLOCK if h <= _WARP_MAX_H else 1
    return min(-(-rows // per_block), blocks_per_sm * _sm_count(device))


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and on 16 bytes (the kernels' vector accesses)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def forward_bytes(rows: int, h: int, element_size: int) -> int:
    """x read and the output written once, the weight and bias read once."""
    return 2 * rows * h * element_size + 2 * h * 4


def backward_bytes(rows: int, h: int, element_size: int, groups: int) -> int:
    """x and dy read and dx written once, the weight read once, the fp32
    partials [2, groups, h] written and read back, dw and db written."""
    return 3 * rows * h * element_size + h * 4 + 2 * 2 * groups * h * 4 \
        + 2 * h * 4


def _forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             eps: float) -> torch.Tensor:
    out = torch.empty_like(x)
    h = x.shape[-1]
    rows = x.numel() // h
    if rows == 0:
        return out
    build.launch(_ENTRIES[x.dtype], "layer_norm", x.device, x.data_ptr(),
                 weight.data_ptr(), bias.data_ptr(), out.data_ptr(), rows, h,
                 eps, _grid(rows, h, x.device, _FWD_BLOCKS_PER_SM),
                 _stream(x))
    count(layer_norm, "launches")
    count(layer_norm, "bytes", n=forward_bytes(rows, h, x.element_size()))
    return out


def layer_norm_backward(x: torch.Tensor, dy: torch.Tensor,
                        weight: torch.Tensor, eps: float):
    """(dx, dweight, dbias) of ``layer_norm`` at ``x`` for the incoming
    gradient ``dy``, on the card: the row kernel (dx, and the per-block
    partials of the weight's and bias's gradients) and the sum of the
    partials in index order."""
    x, dy = _rows(x), _rows(dy)
    h = x.shape[-1]
    rows = x.numel() // h
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, weight.new_zeros(h), weight.new_zeros(h)
    dw, db = torch.empty_like(weight), torch.empty_like(weight)
    groups = _grid(rows, h, x.device, _BWD_BLOCKS_PER_SM)
    partial = torch.empty(2, groups, h, dtype=torch.float32, device=x.device)
    build.launch(_BWD_ENTRIES[x.dtype], "layer_norm_backward", x.device,
                 x.data_ptr(), dy.data_ptr(), weight.data_ptr(),
                 dx.data_ptr(), partial.data_ptr(), dw.data_ptr(),
                 db.data_ptr(), rows, h, eps, groups, _stream(x))
    count(layer_norm_backward, "launches")
    count(layer_norm_backward, "bytes",
          n=backward_bytes(rows, h, x.element_size(), groups))
    return dx, dw, db


class _LayerNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        x = _rows(x)
        ctx.eps = eps
        ctx.save_for_backward(x, weight)
        return _forward(x, _rows(weight), _rows(bias), eps)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw, db = layer_norm_backward(x, dy, _rows(weight), ctx.eps)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dw if need[1] else None,
                db if need[2] else None, None)


# launches and bytes since the last reset, forward and backward
layer_norm.launches = layer_norm.bytes = 0
layer_norm_backward.launches = layer_norm_backward.bytes = 0
