"""Flash attention on projection slabs (port of
``emdr2_tpu/ops/fid_attention.py``: ``flash_self_attention`` and
``flash_cross_attention`` and ``fid_cross_attention``, forward and
backward).

- ``flash_self_attention`` (K1) is padding-masked self-attention for every
  encoder: it consumes the fused projection as a flat [B, L, 3H] slab
  (features [q | k | v], heads sliced inside the kernel) and the key-side
  bias [B, L] (0 / -1e9), returns [B, L, H], and its backward emits the
  combined dqkv slab [B, L, 3H].
- ``flash_cross_attention`` (K2) is FiD cross-attention of the decoder
  queries q [B, Lq, H] over the fused key/value slab kv [B, Lk, 2H] in
  chunks of ``key_chunk`` keys with an online softmax; it saves the per-head
  lse [B, Lq, nh] and its backward emits dq and dkv [B, Lk, 2H] (the TPU
  kernel's dkv comes out transposed; this one does not).

- ``fid_cross_attention`` (K4) is the general per-head form on unfused
  q [B, Lq, nh, hd] and k, v [B, Lk, nh, hd] (strided views of a slab are
  taken as they are), chunked like K2: the route of self-attention longer
  than ``flash_key_chunk``. It saves the lse [B*nh, Lq, 1] and its backward
  emits dq, dk and dv in the inputs' shapes (``csrc/fid_attention.cu``).
  ``fid_self_attention`` is the same attention on the [B, L, 3H] slab
  itself: its backward writes dq, dk and dv into the column slices of one
  [B, L, 3H] gradient, so autograd has nothing to concatenate.

Attention dropout runs inside the kernels from a uint32 ``seed`` and a
``rate``: the keep mask is ``ops.hashing.keep_mask``, bit for bit the TPU
kernels' ``_keep_mask``, regenerated in the backward. All three functions are
``torch.autograd.Function``s. On a CUDA tensor every direction launches its
hand-written kernel (``csrc/flash_self_attention.cu``,
``csrc/flash_cross_attention.cu``, ``csrc/fid_attention.cu``) or raises; on a CPU tensor it runs the
plain PyTorch version beside it, which rounds where the TPU kernel rounds
and, backward, follows the TPU kernel's formula. Each kernel's wrapper
counts its launches in ``.launches``.

Every kernel is built on ``csrc/attention_mma.cuh`` (mma.sync and wgmma
products with the scores in registers, cp.async rings, one online-softmax
step). K1 and K4 share the walks of ``csrc/attention_flash.cuh``, one
forward and one backward pair over tensors given by strides: self-attention
on the slab is their one-chunk case, saving (rowmax, 1/l) where K4 saves
lse. K2, forward and backward, splits the keys over blocks in runs of whole
chunks and sums fp32 partials in run order
(``flash_cross_attention_split_reference`` and
``flash_cross_attention_bwd_split_reference`` are that arithmetic in plain
PyTorch).

K1 and K2 take the scores' ``scale`` (``None``: hd^-0.5; T5's attention
has none, 1.0). K1 also takes T5's relative-position bias as a per-head
fp32 vector over the key-query offsets, ``rel_bias`` [nh, 2L-1]
(``rel_bias[h, j - i + L - 1]`` is added to the scaled score of query i
and key j; ``rel_offsets`` gives that index and the model maps its bucket
table onto the vector), and returns its gradient: the sums of dS along each
diagonal over the rows, which the backward kernel reduces per block into
[B * L/64, nh, 2L-1] partials and the wrapper sums (no [B, nh, L, L]
tensor). Without a bias and at the default scale both kernels run the code
they ran before. The relative-bias calls count ``.rel_launches``,
``.rel_flops`` and ``.rel_bytes`` on ``flash_self_attention`` (forward,
remat recompute included) and on ``flash_self_attention_backward`` (the
partials' write and the sum's read included).

What the kernels take is stated once, in ``kernel_limits``: a
configuration outside it is refused on the card, at construction and at
every call, never routed to a plain version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from emdr2_tpu_torch.ops import build
from emdr2_tpu_torch.ops.hashing import attention_threshold, keep_mask
from emdr2_tpu_torch.utils.timing import count


# ------------------------------------------------------------------ helpers

def _dropout_args(seed: Optional[int], rate: float) -> tuple:
    """(seed, threshold, on, 1 - rate, 1 / (1 - rate)) for the kernels."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    if rate == 0.0:
        return 0, 0, 0, 1.0, 1.0
    if seed is None:
        raise ValueError("attention dropout needs a seed")
    return (seed & 0xFFFFFFFF, attention_threshold(rate), 1, 1.0 - rate,
            1.0 / (1.0 - rate))


def _bh(B: int, nh: int, device) -> torch.Tensor:
    """[B, nh] batch*head indices of the keep mask."""
    return torch.arange(B * nh, device=device).view(B, nh)


KERNEL_DTYPE = torch.bfloat16
KERNEL_HEAD_DIM = 64
KERNEL_MAX_DECODER_LEN = 64


def kernel_limits(dtype: torch.dtype, head_dim: int,
                  decoder_len: Optional[int] = None,
                  flash: bool = True) -> Optional[str]:
    """Why the hand-written attention kernels cannot run a configuration on
    the card, or ``None`` when they can: they are built for bf16
    activations and a head dim of 64 (one 128-byte swizzle row a head), and
    the cross-attention kernel (K2) holds all the decoder positions of a
    row in one 64-query tile. ``decoder_len`` is ``None`` where no decoder
    attends (the towers, self-attention); with ``flash`` off no attention
    kernel is on the path and nothing is refused. On the CPU the plain
    versions run and none of this applies."""
    if not flash:
        return None
    if dtype != KERNEL_DTYPE:
        return (f"the attention kernels take bf16 activations, got {dtype} "
                f"(set dtype=torch.bfloat16, or turn fid_flash_attention off)")
    if head_dim != KERNEL_HEAD_DIM:
        return (f"the attention kernels are built for head_dim "
                f"{KERNEL_HEAD_DIM}, got {head_dim} (hidden_size / num_heads)")
    if decoder_len is not None and decoder_len > KERNEL_MAX_DECODER_LEN:
        return (f"the cross-attention kernel takes at most "
                f"{KERNEL_MAX_DECODER_LEN} decoder positions (queries) a "
                f"row, got {decoder_len}")
    return None


def check_kernel_limits(what: str, dtype: torch.dtype, head_dim: int,
                        decoder_len: Optional[int] = None,
                        flash: bool = True) -> None:
    """Raise with ``kernel_limits``' reason (TypeError for the dtype,
    ValueError otherwise)."""
    reason = kernel_limits(dtype, head_dim, decoder_len, flash)
    if reason is not None:
        raise (TypeError if dtype != KERNEL_DTYPE else ValueError)(
            f"{what}: {reason}")


def _check_cuda(what: str, tensors, bf16, fp32,
                head_dim: int = KERNEL_HEAD_DIM,
                decoder_len: Optional[int] = None) -> None:
    for t in tensors:
        if t.device.type != "cuda" or t.device != tensors[0].device:
            raise ValueError(f"{what}: unsupported devices "
                             f"{[str(x.device) for x in tensors]}")
    for t in bf16:
        check_kernel_limits(what, t.dtype, head_dim, decoder_len)
    for t in fp32:
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: the kernel takes fp32 biases and "
                            f"softmax statistics, got {t.dtype}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what}: needs contiguous inputs")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: inputs must be 16-byte aligned")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _scale(scale: Optional[float], hd: int) -> float:
    """The scores' scale: ``scale``, or hd^-0.5 when None."""
    return hd ** -0.5 if scale is None else float(scale)


def rel_offsets(Lq: int, Lk: int, device=None) -> torch.Tensor:
    """[Lq, Lk] int64: ``j - i + Lq - 1``, the column of a relative-position
    vector [nh, Lq + Lk - 1] that query i and key j read."""
    i = torch.arange(Lq, device=device)[:, None]
    j = torch.arange(Lk, device=device)[None, :]
    return j - i + (Lq - 1)


def rel_bias_full(rel_bias: torch.Tensor, Lq: int, Lk: int) -> torch.Tensor:
    """The [nh, Lq, Lk] fp32 bias of a relative-position vector
    [nh, Lq + Lk - 1] (materialized: the plain versions and the tests)."""
    return rel_bias.float()[:, rel_offsets(Lq, Lk, rel_bias.device)]


def rel_bias_grad(ds: torch.Tensor) -> torch.Tensor:
    """The relative-position vector's gradient [nh, Lq + Lk - 1] from dS
    [B, nh, Lq, Lk]: the sums along each diagonal over the rows."""
    _, nh, Lq, Lk = ds.shape
    idx = rel_offsets(Lq, Lk, ds.device).reshape(-1)
    return torch.zeros((nh, Lq + Lk - 1), dtype=torch.float32,
                       device=ds.device).index_add_(
        1, idx, ds.float().sum(dim=0).reshape(nh, Lq * Lk))


def _check_rel(rel_bias, nh: int, L: int) -> None:
    if rel_bias is not None and (rel_bias.shape != (nh, 2 * L - 1)
                                 or rel_bias.dtype != torch.float32):
        raise ValueError(f"rel_bias must be fp32 {(nh, 2 * L - 1)}, got "
                         f"{rel_bias.dtype} {tuple(rel_bias.shape)}")


def _rel_counts(B: int, L: int, nh: int, hd: int, stats: bool,
                backward: bool):
    """(FLOPs, bytes) of one relative-bias K1 call over B rows of L tokens:
    the products (two forward, five backward, 2 L^2 hd each a row and
    head), each bf16 input read once and each output written once, the
    fp32 key bias, statistics and offset vector; backward also delta and
    the gradient written. The diagonal sums' per-block partials are the
    kernel's scratch, not bytes the call needs, and are not counted."""
    act = B * L * nh * hd * 2
    width = nh * (2 * L - 1) * 4
    if not backward:
        return (4.0 * B * L * L * nh * hd,
                4 * act + B * L * 4 + (B * nh * L * 8 if stats else 0)
                + width)
    return (10.0 * B * L * L * nh * hd,
            8 * act + B * L * 4 + B * nh * L * 12 + 2 * width)


# ------------------------------------------------- K1: self-attention slab

def flash_self_attention_reference(qkv: torch.Tensor, kv_bias: torch.Tensor,
                                   nh: int, seed: Optional[int] = None,
                                   rate: float = 0.0,
                                   scale: Optional[float] = None,
                                   rel_bias: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
    """Plain PyTorch forward, rounding where the TPU kernel rounds: fp32
    scores ``s*scale (+ rel) + bias``, ``p = exp(s - max)``, ``l = sum(p)`` in fp32
    over undropped ``p``, dropped ``p`` zeroed and cast to the input dtype
    before the fp32-accumulated P.V product, then ``/ (l*(1-rate))``
    (guarded ``> 0``) and a cast to the input dtype.

    The products run on fp32 copies; bf16 inputs are exact in fp32 (and in
    TF32), so TF32 settings cannot change the scores."""
    B, L, H3 = qkv.shape
    H = H3 // 3
    hd = H // nh
    heads = qkv.view(B, L, 3, nh, hd).permute(2, 0, 3, 1, 4)  # [3,B,nh,L,hd]
    q, k, v = heads[0].float(), heads[1].float(), heads[2]
    s = torch.matmul(q, k.transpose(-1, -2)) * _scale(scale, hd)
    if rel_bias is not None:
        s = s + rel_bias_full(rel_bias, L, L)
    s = s + kv_bias.float()[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    del s
    l = p.sum(dim=-1, keepdim=True)
    if rate:
        keep = keep_mask(seed, _bh(B, nh, qkv.device), rate, L, L)
        p = torch.where(keep, p, torch.zeros((), device=p.device))
        del keep
        l = l * (1.0 - rate)
    safe = torch.where(l > 0, l, torch.ones_like(l))
    o = torch.matmul(p.to(qkv.dtype).float(), v.float()) / safe
    return o.to(qkv.dtype).permute(0, 2, 1, 3).reshape(B, L, H)


def flash_self_attention_stats_reference(qkv: torch.Tensor,
                                         kv_bias: torch.Tensor,
                                         nh: int) -> torch.Tensor:
    """Plain PyTorch row statistics of the forward, [B, nh, 2, L] fp32: the
    softmax's ``(rowmax, 1/l)`` with ``l = sum(exp(s - rowmax))`` over every
    key, dropped or not (guarded ``> 0``). What the forward kernel saves
    and the backward kernels rebuild ``P = exp(s - rowmax) * (1/l)`` from;
    exact on a fully padded row (rowmax about -1e9, ``1/l = 1/L``)."""
    B, L, H3 = qkv.shape
    hd = H3 // 3 // nh
    heads = qkv.view(B, L, 3, nh, hd).permute(2, 0, 3, 1, 4)
    s = torch.matmul(heads[0].float(), heads[1].float().transpose(-1, -2))
    s = s * (hd ** -0.5) + kv_bias.float()[:, None, None, :]
    m = s.amax(dim=-1)
    l = torch.exp(s - m[..., None]).sum(dim=-1)
    return torch.stack([m, 1.0 / torch.where(l > 0, l, torch.ones_like(l))],
                       dim=2)


def flash_self_attention_bwd_reference(qkv, kv_bias, out, dout, nh: int,
                                       seed: Optional[int] = None,
                                       rate: float = 0.0,
                                       scale: Optional[float] = None,
                                       rel_bias: Optional[torch.Tensor] = None):
    """Plain PyTorch backward of the TPU kernel (``_self_bwd_kernel``):
    recompute ``P = exp(s - max) / l``; ``delta = rowsum(do * out)``;
    ``dP = do v^T`` (dropped and scaled by 1/(1-rate)); ``dS = P (dP -
    delta)``; dq = dS k * scale, dk = dS^T q * scale, dv = P_d^T do, all in
    fp32 and cast to qkv's dtype. Returns dqkv [B, L, 3H]; with
    ``rel_bias``, (dqkv, its gradient [nh, 2L-1] fp32: dS summed along each
    diagonal)."""
    B, L, H3 = qkv.shape
    H = H3 // 3
    hd = H // nh
    scale = _scale(scale, hd)
    heads = qkv.view(B, L, 3, nh, hd).permute(2, 0, 3, 1, 4)
    q, k, v = heads[0].float(), heads[1].float(), heads[2].float()
    do = dout.view(B, L, nh, hd).permute(0, 2, 1, 3).float()
    o = out.view(B, L, nh, hd).permute(0, 2, 1, 3).float()
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if rel_bias is not None:
        s = s + rel_bias_full(rel_bias, L, L)
    s = s + kv_bias.float()[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    P = torch.exp(s - m)
    del s
    l = P.sum(dim=-1, keepdim=True)
    P.mul_(1.0 / torch.where(l > 0, l, torch.ones_like(l)))
    delta = (do * o).sum(dim=-1, keepdim=True)
    dp = torch.matmul(do, v.transpose(-1, -2))
    if rate:
        keep = keep_mask(seed, _bh(B, nh, qkv.device), rate, L, L)
        inv_keep = 1.0 / (1.0 - rate)
        zero = torch.zeros((), device=P.device)
        dp = torch.where(keep, dp, zero).mul_(inv_keep)
        Pd = torch.where(keep, P, zero).mul_(inv_keep)
        del keep
    else:
        Pd = P
    ds = dp.sub_(delta).mul_(P)
    del P
    drel = rel_bias_grad(ds) if rel_bias is not None else None
    dq = (torch.matmul(ds, k) * scale).to(qkv.dtype)
    dk = (torch.matmul(ds.transpose(-1, -2), q) * scale).to(qkv.dtype)
    del ds
    dv = torch.matmul(Pd.transpose(-1, -2), do).to(qkv.dtype)
    d = torch.stack([dq, dk, dv], dim=0)                     # [3,B,nh,L,hd]
    dqkv = d.permute(1, 3, 0, 2, 4).reshape(B, L, H3)
    return dqkv if drel is None else (dqkv, drel)


def flash_self_attention_forward(qkv, kv_bias, nh: int,
                                 seed: Optional[int] = None,
                                 rate: float = 0.0, with_stats: bool = True,
                                 scale: Optional[float] = None,
                                 rel_bias: Optional[torch.Tensor] = None):
    """-> (out, row statistics or None); the kernel on CUDA, the plain
    version on CPU (which keeps no statistics: its backward recomputes
    them). Not differentiable (see ``flash_self_attention``).

    The statistics [B, nh, 2, L] are (rowmax, 1/l) of the softmax: the
    backward's P = exp(s - rowmax) / l, as the TPU backward recomputes it
    (an lse would lose log(l) in fp32 on a fully padded row, whose rowmax
    is ~-1e9)."""
    B, L, H3 = qkv.shape
    H = H3 // 3
    _check_rel(rel_bias, nh, L)
    if qkv.device.type == "cpu":
        return flash_self_attention_reference(qkv, kv_bias, nh, seed, rate,
                                              scale, rel_bias), None
    tensors = (qkv, kv_bias) + ((rel_bias,) if rel_bias is not None else ())
    _check_cuda("flash_self_attention", tensors, (qkv,), tensors[1:],
                H // nh)
    out = torch.empty((B, L, H), dtype=qkv.dtype, device=qkv.device)
    stats = (torch.empty((B, nh, 2, L), dtype=torch.float32,
                         device=qkv.device) if with_stats else None)
    build.launch(
        "emdr2_flash_self_attention_bf16", "flash_self_attention",
        qkv.device, qkv.data_ptr(), kv_bias.data_ptr(), out.data_ptr(),
        stats.data_ptr() if stats is not None else None, B, L, nh, 64,
        *_dropout_args(seed, rate), _scale(scale, H // nh),
        rel_bias.data_ptr() if rel_bias is not None else None, _stream(qkv))
    count(flash_self_attention, "launches")
    count(flash_self_attention, "launches_by_shape",
          (str(qkv.device), B, L))
    if rel_bias is not None:
        flops, nbytes = _rel_counts(B, L, nh, H // nh, with_stats, False)
        count(flash_self_attention, "rel_launches")
        count(flash_self_attention, "rel_flops", n=flops)
        count(flash_self_attention, "rel_bytes", n=nbytes)
    return out, stats


def flash_self_attention_backward(qkv, kv_bias, out, dout, nh: int,
                                  seed: Optional[int] = None,
                                  rate: float = 0.0,
                                  stats: Optional[torch.Tensor] = None,
                                  scale: Optional[float] = None,
                                  rel_bias: Optional[torch.Tensor] = None):
    """dqkv [B, L, 3H] of ``flash_self_attention`` (with ``rel_bias``,
    (dqkv, the bias's gradient [nh, 2L-1] fp32)). On CUDA it launches the
    backward kernels, which need the forward's row ``stats`` [B, nh, 2, L];
    on CPU it runs the plain version."""
    _dropout_args(seed, rate)
    B, L, H3 = qkv.shape
    H = H3 // 3
    _check_rel(rel_bias, nh, L)
    if qkv.device.type == "cpu":
        return flash_self_attention_bwd_reference(qkv, kv_bias, out, dout,
                                                  nh, seed, rate, scale,
                                                  rel_bias)
    if stats is None:
        raise ValueError("the backward kernel needs the forward's stats")
    dout = dout.contiguous()
    rel = (rel_bias,) if rel_bias is not None else ()
    _check_cuda("flash_self_attention_backward",
                (qkv, kv_bias, out, dout, stats) + rel, (qkv, out, dout),
                (kv_bias, stats) + rel, H // nh)
    if out.shape != (B, L, H) or dout.shape != (B, L, H) \
            or stats.shape != (B, nh, 2, L):
        raise ValueError(f"bad shapes for the backward kernel: qkv "
                         f"{tuple(qkv.shape)}, out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)}, stats {tuple(stats.shape)}")
    delta = torch.empty((B, nh, L), dtype=torch.float32, device=qkv.device)
    dqkv = torch.empty_like(qkv)
    parts = (torch.empty((B * (-(-L // 64)), nh, 2 * L - 1),
                         dtype=torch.float32, device=qkv.device)
             if rel_bias is not None else None)
    build.launch(
        "emdr2_flash_self_attention_bwd_bf16",
        "flash_self_attention_backward",
        qkv.device, qkv.data_ptr(), kv_bias.data_ptr(), out.data_ptr(),
        dout.data_ptr(), stats.data_ptr(), delta.data_ptr(),
        dqkv.data_ptr(), B, L, nh, 64,
        *_dropout_args(seed, rate), _scale(scale, H // nh),
        rel_bias.data_ptr() if rel_bias is not None else None,
        parts.data_ptr() if parts is not None else None, _stream(qkv))
    count(flash_self_attention_backward, "launches")
    if parts is None:
        return dqkv
    flops, nbytes = _rel_counts(B, L, nh, H // nh, True, True)
    count(flash_self_attention_backward, "rel_launches")
    count(flash_self_attention_backward, "rel_flops", n=flops)
    count(flash_self_attention_backward, "rel_bytes", n=nbytes)
    return dqkv, parts.sum(dim=0)


class _FlashSelfAttention(torch.autograd.Function):
    """Differentiable w.r.t. qkv and, when there is one, the relative-
    position bias vector."""

    @staticmethod
    def forward(ctx, qkv, kv_bias, rel_bias, nh, seed, rate, scale):
        out, stats = flash_self_attention_forward(qkv, kv_bias, nh, seed,
                                                  rate, scale=scale,
                                                  rel_bias=rel_bias)
        ctx.save_for_backward(qkv, kv_bias, rel_bias, out, stats)
        ctx.nh, ctx.seed, ctx.rate, ctx.scale = nh, seed, rate, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, kv_bias, rel_bias, out, stats = ctx.saved_tensors
        d = flash_self_attention_backward(qkv, kv_bias, out, dout, ctx.nh,
                                          ctx.seed, ctx.rate, stats,
                                          ctx.scale, rel_bias)
        dqkv, drel = d if rel_bias is not None else (d, None)
        return dqkv, None, drel, None, None, None, None


def flash_self_attention(qkv: torch.Tensor, kv_bias: torch.Tensor, nh: int,
                         seed: Optional[int] = None,
                         rate: float = 0.0, scale: Optional[float] = None,
                         rel_bias: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """qkv [B, L, 3H], kv_bias [B, L] fp32 -> [B, L, H] in qkv's dtype,
    differentiable w.r.t. qkv (and ``rel_bias``). ``seed`` (uint32) and
    ``rate`` set the in-kernel attention dropout; ``scale`` the scores'
    scale (None: hd^-0.5); ``rel_bias`` [nh, 2L-1] fp32 a relative-position
    bias by offset (``rel_offsets``)."""
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * nh):
        raise ValueError(f"qkv must be [B, L, 3H] with H % nh == 0, "
                         f"got {tuple(qkv.shape)} and nh={nh}")
    B, L, _ = qkv.shape
    if kv_bias.shape != (B, L):
        raise ValueError(f"kv_bias must be {(B, L)}, got {tuple(kv_bias.shape)}")
    if qkv.device.type not in ("cpu", "cuda") or kv_bias.device != qkv.device:
        raise ValueError(f"flash_self_attention: unsupported devices "
                         f"{qkv.device} / {kv_bias.device}")
    _dropout_args(seed, rate)
    _check_rel(rel_bias, nh, L)
    if torch.is_grad_enabled() and (
            qkv.requires_grad
            or (rel_bias is not None and rel_bias.requires_grad)):
        return _FlashSelfAttention.apply(qkv, kv_bias, rel_bias, nh, seed,
                                         rate, scale)
    return flash_self_attention_forward(qkv, kv_bias, nh, seed, rate,
                                        with_stats=False, scale=scale,
                                        rel_bias=rel_bias)[0]


# ------------------------------------------------ K2: cross-attention slab

def _cross_heads(q, kv, nh):
    B, Lq, H = q.shape
    Lk = kv.shape[1]
    hd = H // nh
    qh = q.view(B, Lq, nh, hd).permute(0, 2, 1, 3)
    kvh = kv.view(B, Lk, 2, nh, hd).permute(2, 0, 3, 1, 4)   # [2,B,nh,Lk,hd]
    return qh, kvh[0], kvh[1], hd


def _cross_walk(q, kv, kv_bias, nh: int, key_chunk: int, chunks, seed,
                rate: float, scale: Optional[float] = None):
    """The TPU kernel's online softmax over the key chunks ``chunks`` (a
    range): per chunk, ``p = exp(s - m_new)`` against the running max, ``l``
    over undropped ``p``, dropped ``p`` cast to kv's dtype before the
    fp32-accumulated P.V. Returns the running (m, l, acc), heads first:
    [B, nh, Lq, 1], [B, nh, Lq, 1], [B, nh, Lq, hd]."""
    B, Lq, _ = q.shape
    qh, kh, vh, hd = _cross_heads(q, kv, nh)
    qf = qh.float()
    bias = kv_bias.float()
    bh = _bh(B, nh, q.device)
    m = torch.full((B, nh, Lq, 1), -1e30, device=q.device)
    l = torch.zeros((B, nh, Lq, 1), device=q.device)
    acc = torch.zeros((B, nh, Lq, hd), device=q.device)
    for j in chunks:
        sl = slice(j * key_chunk, (j + 1) * key_chunk)
        s = torch.matmul(qf, kh[:, :, sl].float().transpose(-1, -2))
        s = s * _scale(scale, hd) + bias[:, None, None, sl]
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        if rate:
            keep = keep_mask(seed, bh, rate, Lq, key_chunk, j)
            p = torch.where(keep, p, torch.zeros((), device=p.device))
        acc = acc * corr + torch.matmul(p.to(kv.dtype).float(),
                                        vh[:, :, sl].float())
        m = m_new
    return m, l, acc


def _cross_finish(q, m, l, acc, rate: float):
    """(out [B, Lq, H] in q's dtype, lse [B, Lq, nh] fp32) from a walk's
    (m, l, acc): ``acc / (l*(1-rate))`` and ``m + log l``, both guarded."""
    l_eff = l * (1.0 - rate) if rate else l
    safe = torch.where(l_eff > 0, l_eff, torch.ones_like(l_eff))
    out = (acc / safe).to(q.dtype).permute(0, 2, 1, 3).reshape(q.shape)
    lse = m + torch.log(torch.where(l > 0, l, torch.ones_like(l)))
    return out, lse[..., 0].permute(0, 2, 1).contiguous()


def flash_cross_attention_reference(q, kv, kv_bias, nh: int, key_chunk: int,
                                    seed: Optional[int] = None,
                                    rate: float = 0.0,
                                    scale: Optional[float] = None
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch forward with the TPU kernel's chunked online softmax
    and rounding (``_cross_walk`` over every chunk in order). Returns (out
    [B, Lq, H] in q's dtype, lse [B, Lq, nh] fp32)."""
    chunks = range(kv.shape[1] // key_chunk)
    return _cross_finish(q, *_cross_walk(q, kv, kv_bias, nh, key_chunk,
                                         chunks, seed, rate, scale), rate)


def _cross_bwd_chunks(q, kv, kv_bias, lse, out, dout, nh: int,
                      key_chunk: int, seed, rate: float,
                      scale: Optional[float] = None):
    """The TPU kernel's backward (``_xslab_bwd_kernel``), chunk by chunk in
    order: ``P = exp(s - lse)``, ``dP = do v^T`` (dropped, rescaled), ``dS =
    P (dP - delta)``. Yields (the chunk's key slice, its fp32 dq term dS k *
    scale [B, nh, Lq, hd], dk = dS^T q * scale and dv = P_d^T do [B, nh, C,
    hd] in kv's dtype)."""
    B, Lq, H = q.shape
    Lk = kv.shape[1]
    qh, kh, vh, hd = _cross_heads(q, kv, nh)
    scale = _scale(scale, hd)
    qf = qh.float()
    do = dout.view(B, Lq, nh, hd).permute(0, 2, 1, 3).float()
    o = out.view(B, Lq, nh, hd).permute(0, 2, 1, 3).float()
    lse_h = lse.permute(0, 2, 1)[..., None].float()          # [B, nh, Lq, 1]
    delta = (do * o).sum(dim=-1, keepdim=True)
    bias = kv_bias.float()
    bh = _bh(B, nh, q.device)
    for j in range(Lk // key_chunk):
        sl = slice(j * key_chunk, (j + 1) * key_chunk)
        kf = kh[:, :, sl].float()
        s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
        s = s + bias[:, None, None, sl]
        p = torch.exp(s - lse_h)
        dp = torch.matmul(do, vh[:, :, sl].float().transpose(-1, -2))
        if rate:
            keep = keep_mask(seed, bh, rate, Lq, key_chunk, j)
            inv_keep = 1.0 / (1.0 - rate)
            zero = torch.zeros((), device=p.device)
            dp = torch.where(keep, dp, zero) * inv_keep
            pd = torch.where(keep, p, zero) * inv_keep
        else:
            pd = p
        ds = p * (dp - delta)
        yield (sl, torch.matmul(ds, kf) * scale,
               (torch.matmul(ds.transpose(-1, -2), qf) * scale).to(kv.dtype),
               torch.matmul(pd.transpose(-1, -2), do).to(kv.dtype))


def _cross_bwd_sum(q, kv, nh: int, terms, ends) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    """(dq [B, Lq, H] in q's dtype, dkv [B, Lk, 2H]) from the chunks' terms
    (``_cross_bwd_chunks``): dk and dv placed at their keys; the dq terms
    summed in chunk order into a run's fp32 partial, which is added to dq
    after each chunk index in ``ends``."""
    B, Lq, H = q.shape
    Lk = kv.shape[1]
    hd = H // nh
    dq = torch.zeros((B, nh, Lq, hd), device=q.device)
    run = torch.zeros_like(dq)
    dk = torch.empty((B, nh, Lk, hd), dtype=kv.dtype, device=q.device)
    dv = torch.empty_like(dk)
    for j, (sl, dq_j, dk_j, dv_j) in enumerate(terms):
        run = run + dq_j
        if j in ends:
            dq = dq + run
            run = torch.zeros_like(dq)
        dk[:, :, sl] = dk_j
        dv[:, :, sl] = dv_j
    dq = dq.to(q.dtype).permute(0, 2, 1, 3).reshape(B, Lq, H)
    dkv = torch.stack([dk, dv], dim=0).permute(1, 3, 0, 2, 4)
    return dq, dkv.reshape(B, Lk, 2 * H)


def flash_cross_attention_bwd_reference(q, kv, kv_bias, lse, out, dout,
                                        nh: int, key_chunk: int,
                                        seed: Optional[int] = None,
                                        rate: float = 0.0,
                                        scale: Optional[float] = None
                                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch backward of the TPU kernel (``_xslab_bwd_kernel``): per
    chunk, ``P = exp(s - lse)``, ``dP = do v^T`` (dropped, rescaled),
    ``dS = P (dP - delta)``; dk = dS^T q * scale and dv = P_d^T do per key,
    dq = sum over chunks of dS k * scale (fp32). Returns (dq [B, Lq, H],
    dkv [B, Lk, 2H]) in the inputs' dtypes."""
    terms = _cross_bwd_chunks(q, kv, kv_bias, lse, out, dout, nh, key_chunk,
                              seed, rate, scale)
    return _cross_bwd_sum(q, kv, nh, terms, {kv.shape[1] // key_chunk - 1})


def flash_cross_attention_bwd_split_reference(q, kv, kv_bias, lse, out, dout,
                                              nh: int, key_chunk: int,
                                              n_splits: int,
                                              seed: Optional[int] = None,
                                              rate: float = 0.0,
                                              scale: Optional[float] = None
                                              ) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    """The arithmetic of the backward kernel's key split, in plain PyTorch:
    the chunks are dealt to ``n_splits`` runs of whole chunks as
    ``flash_cross_attention_split_reference`` deals them, each run's dq
    terms summed into an fp32 partial, and the partials summed in run order;
    dk and dv are the unsplit backward's. Equals
    ``flash_cross_attention_bwd_reference`` up to rounding. Nothing on the
    card's path calls it: the CPU tests hold the run sums with it, and the
    ``gpu`` tests hold the kernel's forced runs to it."""
    n_chunks = kv.shape[1] // key_chunk
    per_run = _split_chunks(n_chunks, n_splits)[1]
    ends = {min(n_chunks, j0 + per_run) - 1
            for j0 in range(0, n_chunks, per_run)}
    terms = _cross_bwd_chunks(q, kv, kv_bias, lse, out, dout, nh, key_chunk,
                              seed, rate, scale)
    return _cross_bwd_sum(q, kv, nh, terms, ends)


def _check_cross(q, kv, kv_bias, nh, key_chunk):
    if q.dim() != 3 or q.shape[-1] % nh:
        raise ValueError(f"q must be [B, Lq, H] with H % nh == 0, got "
                         f"{tuple(q.shape)} and nh={nh}")
    B, Lq, H = q.shape
    if kv.dim() != 3 or kv.shape[0] != B or kv.shape[2] != 2 * H:
        raise ValueError(f"kv must be [{B}, Lk, {2 * H}], got "
                         f"{tuple(kv.shape)}")
    Lk = kv.shape[1]
    if kv_bias.shape != (B, Lk):
        raise ValueError(f"kv_bias must be {(B, Lk)}, got "
                         f"{tuple(kv_bias.shape)}")
    if key_chunk <= 0 or Lk % key_chunk:
        raise ValueError(f"Lk={Lk} must be a multiple of key_chunk="
                         f"{key_chunk} (pad the keys at -1e9 bias)")
    if q.device.type not in ("cpu", "cuda") or not (
            kv.device == kv_bias.device == q.device):
        raise ValueError(f"flash_cross_attention: unsupported devices "
                         f"{q.device} / {kv.device} / {kv_bias.device}")


def flash_cross_attention_split_reference(q, kv, kv_bias, nh: int,
                                          key_chunk: int, n_splits: int,
                                          seed: Optional[int] = None,
                                          rate: float = 0.0,
                                          scale: Optional[float] = None
                                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The arithmetic of the kernel's key split, in plain PyTorch: the
    chunks are dealt to ``n_splits`` runs of whole chunks, each run walked
    on its own into a partial (m, l, acc), and the partials combined in
    split order: M = max m_i, l = sum l_i exp(m_i - M), acc likewise, then
    out and lse as in the unsplit walk, which this equals up to rounding.
    Nothing on the card's path calls it: the CPU tests hold the combine rule
    with it, and the ``gpu`` tests hold the kernel's forced splits to it."""
    n_chunks = kv.shape[1] // key_chunk
    per_split = _split_chunks(n_chunks, n_splits)[1]
    parts = [_cross_walk(q, kv, kv_bias, nh, key_chunk,
                         range(j0, min(n_chunks, j0 + per_split)), seed, rate,
                         scale)
             for j0 in range(0, n_chunks, per_split)]
    m = torch.stack([part[0] for part in parts]).amax(dim=0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    for m_i, l_i, acc_i in parts:
        w = torch.exp(m_i - m)
        l = l + l_i * w
        acc = acc + acc_i * w
    return _cross_finish(q, m, l, acc, rate)


# blocks the forward wants in flight before it stops splitting the keys, per
# multiprocessor (four fit at once; more, smaller ones even out the tail)
_CROSS_BLOCKS_PER_SM = 8
# and the backward (fewer fit at once; at the reader shape 17 runs of 3
# chunks beat 10 of 5 and 50 of 1: tools/time_kernels.py's K2-bwd runs)
_CROSS_BWD_BLOCKS_PER_SM = 16


def _split_chunks(n_chunks: int, n_splits: int) -> Tuple[int, int]:
    """(splits, chunks per split) when ``n_chunks`` whole chunks are dealt
    to at most ``n_splits`` runs of equal length, none empty (the last may
    be shorter)."""
    if n_splits < 1:
        raise ValueError(f"n_splits must be >= 1, got {n_splits}")
    per_split = -(-n_chunks // min(n_splits, n_chunks))
    return -(-n_chunks // per_split), per_split


def _cross_splits(B: int, nh: int, n_chunks: int, device,
                  per_sm: int = _CROSS_BLOCKS_PER_SM) -> int:
    """Key splits (runs) of the kernels: enough that B*nh*splits blocks
    fill the card, ``per_sm`` a multiprocessor (the reader shape has 96
    (head, row) pairs for 132 multiprocessors), one when the rows alone do
    (the teacher shape)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = -(-per_sm * sms // (B * nh))
    return _split_chunks(n_chunks, want)[0]


def flash_cross_attention_forward(q, kv, kv_bias, nh: int, key_chunk: int,
                                  seed: Optional[int] = None,
                                  rate: float = 0.0,
                                  n_splits: Optional[int] = None,
                                  scale: Optional[float] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, Lq, H], lse [B, Lq, nh] fp32): the kernel on CUDA, the
    plain version on CPU. Not differentiable (see ``flash_cross_attention``).

    The kernel deals the key chunks to ``n_splits`` blocks per (head, row)
    and combines their fp32 partials in split order (one count in
    ``.launches`` either way); ``None`` picks the number from the shape and
    the card, a given number is reduced until no split is empty."""
    _check_cross(q, kv, kv_bias, nh, key_chunk)
    _dropout_args(seed, rate)
    if q.device.type == "cpu":
        return flash_cross_attention_reference(q, kv, kv_bias, nh, key_chunk,
                                               seed, rate, scale)
    B, Lq, H = q.shape
    Lk = kv.shape[1]
    _check_cuda("flash_cross_attention", (q, kv, kv_bias), (q, kv),
                (kv_bias,), H // nh, Lq)
    n_chunks = Lk // key_chunk
    if n_splits is None:
        n_splits = _cross_splits(B, nh, n_chunks, q.device)
    else:
        n_splits = _split_chunks(n_chunks, n_splits)[0]
    out = torch.empty((B, Lq, H), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Lq, nh), dtype=torch.float32, device=q.device)
    part_acc = part_ml = None
    if n_splits > 1:
        part_acc = torch.empty((n_splits, B, nh, Lq, 64),
                               dtype=torch.float32, device=q.device)
        part_ml = torch.empty((n_splits, B, nh, Lq, 2), dtype=torch.float32,
                              device=q.device)
    build.launch(
        "emdr2_flash_cross_attention_bf16", "flash_cross_attention",
        q.device, q.data_ptr(), kv.data_ptr(), kv_bias.data_ptr(),
        out.data_ptr(), lse.data_ptr(),
        part_acc.data_ptr() if n_splits > 1 else None,
        part_ml.data_ptr() if n_splits > 1 else None, B, Lq, Lk, nh, 64,
        key_chunk, n_splits, *_dropout_args(seed, rate),
        _scale(scale, H // nh), _stream(q))
    count(flash_cross_attention, "launches")
    return out, lse


def flash_cross_attention_backward(q, kv, kv_bias, lse, out, dout, nh: int,
                                   key_chunk: int, seed: Optional[int] = None,
                                   rate: float = 0.0,
                                   scale: Optional[float] = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dq [B, Lq, H], dkv [B, Lk, 2H]) of ``flash_cross_attention``: the
    kernel on CUDA, the plain version on CPU.

    The kernel deals the key chunks to runs of whole chunks, several blocks
    per (head, row) as the forward does, writes dk and dv of every key once,
    and sums the runs' fp32 dq partials in run order (no atomics: the
    result repeats bit for bit; one count in ``.launches``)."""
    _check_cross(q, kv, kv_bias, nh, key_chunk)
    _dropout_args(seed, rate)
    if q.device.type == "cpu":
        return flash_cross_attention_bwd_reference(
            q, kv, kv_bias, lse, out, dout, nh, key_chunk, seed, rate, scale)
    return _launch_cross_backward(q, kv, kv_bias, lse, out, dout, nh,
                                  key_chunk, seed, rate, scale=scale)


def _launch_cross_backward(q, kv, kv_bias, lse, out, dout, nh: int,
                           key_chunk: int, seed: Optional[int], rate: float,
                           n_runs: Optional[int] = None,
                           scale: Optional[float] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check the CUDA tensors against the kernel's limits and launch it.
    ``n_runs``: runs of whole chunks a (head, row), reduced until none is
    empty; ``None`` takes ``_cross_splits``' choice (the tests force
    others)."""
    B, Lq, H = q.shape
    Lk = kv.shape[1]
    dout = dout.contiguous()
    _check_cuda("flash_cross_attention_backward",
                (q, kv, kv_bias, lse, out, dout), (q, kv, out, dout),
                (kv_bias, lse), H // nh, Lq)
    if out.shape != q.shape or dout.shape != q.shape \
            or lse.shape != (B, Lq, nh):
        raise ValueError(f"bad shapes for the backward kernel: q "
                         f"{tuple(q.shape)}, out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)}, lse {tuple(lse.shape)}")
    n_chunks = Lk // key_chunk
    if n_runs is None:
        n_runs = _cross_splits(B, nh, n_chunks, q.device,
                               _CROSS_BWD_BLOCKS_PER_SM)
    else:
        n_runs = _split_chunks(n_chunks, n_runs)[0]
    delta = torch.empty((B, Lq, nh), dtype=torch.float32, device=q.device)
    dq_part = (torch.empty((n_runs, B, Lq, H), dtype=torch.float32,
                           device=q.device) if n_runs > 1 else None)
    dq = torch.empty_like(q)
    dkv = torch.empty_like(kv)
    build.launch(
        "emdr2_flash_cross_attention_bwd_bf16",
        "flash_cross_attention_backward",
        q.device, q.data_ptr(), kv.data_ptr(), kv_bias.data_ptr(),
        lse.data_ptr(), out.data_ptr(), dout.data_ptr(), delta.data_ptr(),
        dq_part.data_ptr() if dq_part is not None else None, dq.data_ptr(),
        dkv.data_ptr(), B, Lq, Lk, nh, 64, key_chunk, n_runs,
        *_dropout_args(seed, rate), _scale(scale, H // nh), _stream(q))
    count(flash_cross_attention_backward, "launches")
    return dq, dkv


class _FlashCrossAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, kv, kv_bias, nh, key_chunk, seed, rate, scale):
        out, lse = flash_cross_attention_forward(q, kv, kv_bias, nh,
                                                 key_chunk, seed, rate,
                                                 scale=scale)
        ctx.save_for_backward(q, kv, kv_bias, lse, out)
        ctx.args = (nh, key_chunk, seed, rate, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, kv, kv_bias, lse, out = ctx.saved_tensors
        dq, dkv = flash_cross_attention_backward(q, kv, kv_bias, lse, out,
                                                 dout, *ctx.args)
        return dq, dkv, None, None, None, None, None, None


def flash_cross_attention(q: torch.Tensor, kv: torch.Tensor,
                          kv_bias: torch.Tensor, nh: int, key_chunk: int,
                          seed: Optional[int] = None,
                          rate: float = 0.0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """q [B, Lq, H], kv [B, Lk, 2H] ([k | v]), kv_bias [B, Lk] fp32 with Lk a
    multiple of ``key_chunk`` -> [B, Lq, H] in q's dtype, differentiable
    w.r.t. q and kv. ``scale``: the scores' scale (None: hd^-0.5)."""
    if torch.is_grad_enabled() and (q.requires_grad or kv.requires_grad):
        return _FlashCrossAttention.apply(q, kv, kv_bias, nh, key_chunk, seed,
                                          rate, scale)
    return flash_cross_attention_forward(q, kv, kv_bias, nh, key_chunk, seed,
                                         rate, scale=scale)[0]


# --------------------------------------- K4: general per-head attention

def fid_cross_attention_reference(q, k, v, kv_bias,
                                  seed: Optional[int] = None,
                                  key_chunk: int = 512,
                                  dropout_rate: float = 0.0
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch forward of the general kernel, with the TPU kernel's
    chunked online softmax and rounding (as
    ``flash_cross_attention_reference``, on unfused heads): q [B, Lq, nh,
    hd], k, v [B, Lk, nh, hd], kv_bias [B, Lk] -> (out [B, Lq, nh, hd] in
    q's dtype, lse [B*nh, Lq, 1] fp32)."""
    B, Lq, nh, hd = q.shape
    Lk = k.shape[1]
    rate = dropout_rate
    qf = q.permute(0, 2, 1, 3).float()
    kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    bias = kv_bias.float()
    bh = _bh(B, nh, q.device)
    m = torch.full((B, nh, Lq, 1), -1e30, device=q.device)
    l = torch.zeros((B, nh, Lq, 1), device=q.device)
    acc = torch.zeros((B, nh, Lq, hd), device=q.device)
    for j in range(Lk // key_chunk):
        sl = slice(j * key_chunk, (j + 1) * key_chunk)
        s = torch.matmul(qf, kh[:, :, sl].float().transpose(-1, -2))
        s = s * (hd ** -0.5) + bias[:, None, None, sl]
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        if rate:
            keep = keep_mask(seed, bh, rate, Lq, key_chunk, j)
            p = torch.where(keep, p, torch.zeros((), device=p.device))
        acc = acc * corr + torch.matmul(p.to(v.dtype).float(),
                                        vh[:, :, sl].float())
        m = m_new
    l_eff = l * (1.0 - rate) if rate else l
    safe = torch.where(l_eff > 0, l_eff, torch.ones_like(l_eff))
    out = (acc / safe).to(q.dtype).permute(0, 2, 1, 3)
    lse = m + torch.log(torch.where(l > 0, l, torch.ones_like(l)))
    return out, lse.reshape(B * nh, Lq, 1)


def fid_cross_attention_bwd_reference(q, k, v, kv_bias, lse, out, dout,
                                      seed: Optional[int] = None,
                                      key_chunk: int = 512,
                                      dropout_rate: float = 0.0
                                      ) -> Tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor]:
    """Plain PyTorch backward of the TPU kernel (``_bwd_kernel``), chunk by
    chunk from the saved lse [B*nh, Lq, 1]: ``delta = rowsum(do * out)``,
    ``P = exp(s - lse)``, ``dP = do v^T`` (dropped, rescaled), ``dS = P (dP
    - delta)``; dq = sum over chunks of dS k * scale (fp32), dk = dS^T q *
    scale and dv = P_d^T do per key. Returns (dq, dk, dv) in the inputs'
    shapes and dtypes."""
    B, Lq, nh, hd = q.shape
    Lk = k.shape[1]
    rate = dropout_rate
    scale = hd ** -0.5
    qf = q.permute(0, 2, 1, 3).float()
    kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    do = dout.permute(0, 2, 1, 3).float()
    o = out.permute(0, 2, 1, 3).float()
    lse_h = lse.reshape(B, nh, Lq, 1).float()
    delta = (do * o).sum(dim=-1, keepdim=True)
    bias = kv_bias.float()
    bh = _bh(B, nh, q.device)
    dq = torch.zeros((B, nh, Lq, hd), device=q.device)
    dk = torch.empty((B, nh, Lk, hd), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, nh, Lk, hd), dtype=v.dtype, device=q.device)
    for j in range(Lk // key_chunk):
        sl = slice(j * key_chunk, (j + 1) * key_chunk)
        kf = kh[:, :, sl].float()
        s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
        s = s + bias[:, None, None, sl]
        p = torch.exp(s - lse_h)
        dp = torch.matmul(do, vh[:, :, sl].float().transpose(-1, -2))
        if rate:
            keep = keep_mask(seed, bh, rate, Lq, key_chunk, j)
            inv_keep = 1.0 / (1.0 - rate)
            zero = torch.zeros((), device=p.device)
            dp = torch.where(keep, dp, zero) * inv_keep
            pd = torch.where(keep, p, zero) * inv_keep
        else:
            pd = p
        ds = p * (dp - delta)
        dq = dq + torch.matmul(ds, kf) * scale
        dk[:, :, sl] = (torch.matmul(ds.transpose(-1, -2), qf) * scale
                        ).to(k.dtype)
        dv[:, :, sl] = torch.matmul(pd.transpose(-1, -2), do).to(v.dtype)
    return (dq.to(q.dtype).permute(0, 2, 1, 3), dk.permute(0, 2, 1, 3),
            dv.permute(0, 2, 1, 3))


def _head_strides(what: str, t: torch.Tensor) -> Tuple[int, int]:
    """(batch stride, row stride) in elements of a [B, L, nh, hd] tensor
    whose heads and head dim are contiguous (a view of a projection slab
    qualifies); raises on anything else."""
    hd = t.shape[3]
    if t.stride(3) != 1 or t.stride(2) != hd or t.stride(0) % 8 \
            or t.stride(1) % 8 or t.data_ptr() % 16:
        raise ValueError(f"fid_cross_attention: {what} must keep [nh, hd] "
                         f"contiguous, with 16-byte aligned rows; strides "
                         f"{t.stride()}")
    return t.stride(0), t.stride(1)


def _check_fid(q, k, v, kv_bias, seed, key_chunk, dropout_rate) -> bool:
    """Validate the K4 arguments; True when they lie on a CUDA device (the
    kernels' route), False on the CPU (the plain versions')."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"q must be [B, Lq, nh, hd] and k, v [B, Lk, nh, "
                         f"hd], got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Lk = k.shape[:2]
    if kv_bias.shape != (B, Lk):
        raise ValueError(f"kv_bias must be {(B, Lk)}, got "
                         f"{tuple(kv_bias.shape)}")
    if key_chunk <= 0 or Lk % key_chunk:
        raise ValueError(f"Lk={Lk} must be a multiple of key_chunk="
                         f"{key_chunk} (pad the keys at -1e9 bias)")
    _dropout_args(seed, dropout_rate)
    tensors = (q, k, v, kv_bias)
    if all(t.device.type == "cpu" for t in tensors):
        return False
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError(f"fid_cross_attention: unsupported devices "
                         f"{[str(t.device) for t in tensors]}")
    for t in (q, k, v):
        check_kernel_limits("fid_cross_attention", t.dtype, q.shape[3])
    if kv_bias.dtype != torch.float32:
        raise TypeError(f"fid_cross_attention: the kernel takes an fp32 "
                        f"bias, got {kv_bias.dtype}")
    return True


def _qkv_strides(q, k, v) -> list:
    return [x for name, t in (("q", q), ("k", k), ("v", v))
            for x in _head_strides(name, t)]


def fid_cross_attention_forward(q, k, v, kv_bias, seed: Optional[int] = None,
                                key_chunk: int = 512,
                                dropout_rate: float = 0.0
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, Lq, nh, hd], lse [B*nh, Lq, 1] fp32): the kernel on CUDA
    (q, k and v are read through their strides: views of a fused slab are
    not copied), the plain version on CPU. Not differentiable (see
    ``fid_cross_attention``)."""
    if not _check_fid(q, k, v, kv_bias, seed, key_chunk, dropout_rate):
        return fid_cross_attention_reference(q, k, v, kv_bias, seed,
                                             key_chunk, dropout_rate)
    B, Lq, nh, hd = q.shape
    Lk = k.shape[1]
    strides = _qkv_strides(q, k, v)
    kv_bias = kv_bias.contiguous()
    out = torch.empty((B, Lq, nh, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * nh, Lq, 1), dtype=torch.float32, device=q.device)
    build.launch(
        "emdr2_fid_attention_bf16", "fid_cross_attention",
        q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_bias.data_ptr(), out.data_ptr(), lse.data_ptr(), *strides, B, Lq,
        Lk, nh, hd,
        key_chunk, *_dropout_args(seed, dropout_rate), _stream(q))
    count(fid_cross_attention, "launches")
    return out, lse


def fid_cross_attention_backward(q, k, v, kv_bias, lse, out, dout,
                                 seed: Optional[int] = None,
                                 key_chunk: int = 512,
                                 dropout_rate: float = 0.0,
                                 grads: Optional[Tuple[torch.Tensor,
                                                       torch.Tensor,
                                                       torch.Tensor]] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """(dq [B, Lq, nh, hd], dk, dv [B, Lk, nh, hd]) of
    ``fid_cross_attention`` from the forward's ``out`` and ``lse``: the
    kernels on CUDA (no atomics: the gradients repeat bit for bit), the
    plain version on CPU. ``grads`` gives the three tensors to write into
    (of q's, k's and v's shapes and dtypes, [nh, hd] contiguous: column
    slices of one slab's gradient qualify; nothing around them is touched)
    and is returned; without it three contiguous tensors are made."""
    B, Lq, nh, hd = q.shape
    Lk = k.shape[1]
    if out.shape != q.shape or dout.shape != q.shape \
            or lse.shape != (B * nh, Lq, 1):
        raise ValueError(f"bad shapes for the backward: q {tuple(q.shape)}, "
                         f"out {tuple(out.shape)}, dout {tuple(dout.shape)}, "
                         f"lse {tuple(lse.shape)}")
    if grads is not None:
        for g, like in zip(grads, (q, k, v)):
            if g.shape != like.shape or g.dtype != like.dtype \
                    or g.device != like.device:
                raise ValueError(f"grads must match q, k and v, got "
                                 f"{tuple(g.shape)} {g.dtype} {g.device} for "
                                 f"{tuple(like.shape)} {like.dtype} "
                                 f"{like.device}")
    if not _check_fid(q, k, v, kv_bias, seed, key_chunk, dropout_rate):
        got = fid_cross_attention_bwd_reference(
            q, k, v, kv_bias, lse, out, dout, seed, key_chunk, dropout_rate)
        if grads is None:
            return got
        for g, x in zip(grads, got):
            g.copy_(x)
        return tuple(grads)
    strides = _qkv_strides(q, k, v)
    kv_bias, out, dout = kv_bias.contiguous(), out.contiguous(), \
        dout.contiguous()
    _check_cuda("fid_cross_attention_backward", (kv_bias, lse, out, dout),
                (out, dout), (kv_bias, lse))
    delta = torch.empty((B * nh, Lq), dtype=torch.float32, device=q.device)
    if grads is None:
        grads = tuple(torch.empty(t.shape, dtype=t.dtype, device=q.device)
                      for t in (q, k, v))
    dq, dk, dv = grads
    grad_strides = [x for name, t in (("dq", dq), ("dk", dk), ("dv", dv))
                    for x in _head_strides(name, t)]
    build.launch(
        "emdr2_fid_attention_bwd_bf16", "fid_cross_attention_backward",
        q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_bias.data_ptr(), lse.data_ptr(), out.data_ptr(), dout.data_ptr(),
        delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *strides, *grad_strides,
        B, Lq, Lk, nh, hd, key_chunk, *_dropout_args(seed, dropout_rate),
        _stream(q))
    count(fid_cross_attention_backward, "launches")
    return dq, dk, dv


class _FidCrossAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, kv_bias, seed, key_chunk, rate):
        out, lse = fid_cross_attention_forward(q, k, v, kv_bias, seed,
                                               key_chunk, rate)
        ctx.save_for_backward(q, k, v, kv_bias, lse, out)
        ctx.args = (seed, key_chunk, rate)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_bias, lse, out = ctx.saved_tensors
        dq, dk, dv = fid_cross_attention_backward(q, k, v, kv_bias, lse, out,
                                                  dout, *ctx.args)
        return dq, dk, dv, None, None, None, None


def fid_cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_bias: torch.Tensor, seed: Optional[int] = None,
                        key_chunk: int = 512,
                        dropout_rate: float = 0.0) -> torch.Tensor:
    """General per-head flash attention: q [B, Lq, nh, hd], k, v [B, Lk, nh,
    hd], kv_bias [B, Lk] fp32 with Lk a multiple of ``key_chunk`` ->
    [B, Lq, nh, hd] in q's dtype, differentiable w.r.t. q, k and v (the TPU
    kernel's backward from the saved lse, on both devices)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FidCrossAttention.apply(q, k, v, kv_bias, seed, key_chunk,
                                        dropout_rate)
    return fid_cross_attention_forward(q, k, v, kv_bias, seed, key_chunk,
                                       dropout_rate)[0]


def _slab_heads(qkv: torch.Tensor, nh: int):
    """The q, k and v column slices of a [B, L, 3H] slab as [B, L, nh, hd]
    views (no copy)."""
    B, L, H3 = qkv.shape
    return tuple(t.view(B, L, nh, H3 // 3 // nh)
                 for t in qkv.chunk(3, dim=-1))


class _FidSelfAttention(torch.autograd.Function):
    """K4 on the slab: one gradient slab, written in place by the backward
    kernels through its three column slices."""

    @staticmethod
    def forward(ctx, qkv, kv_bias, nh, seed, key_chunk, rate):
        out, lse = fid_cross_attention_forward(*_slab_heads(qkv, nh), kv_bias,
                                               seed, key_chunk, rate)
        B, L = qkv.shape[:2]
        out = out.reshape(B, L, -1)
        ctx.save_for_backward(qkv, kv_bias, lse, out)
        ctx.args = (seed, key_chunk, rate)
        ctx.nh = nh
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, kv_bias, lse, out = ctx.saved_tensors
        q, k, v = _slab_heads(qkv, ctx.nh)
        dqkv = torch.empty(qkv.shape, dtype=qkv.dtype, device=qkv.device)
        fid_cross_attention_backward(
            q, k, v, kv_bias, lse, out.view(q.shape), dout.reshape(q.shape),
            *ctx.args, grads=_slab_heads(dqkv, ctx.nh))
        return dqkv, None, None, None, None, None


def fid_self_attention(qkv: torch.Tensor, kv_bias: torch.Tensor, nh: int,
                       seed: Optional[int] = None, key_chunk: int = 512,
                       dropout_rate: float = 0.0) -> torch.Tensor:
    """``fid_cross_attention`` of a fused projection slab on itself: qkv
    [B, L, 3H] (features [q | k | v]), kv_bias [B, L] fp32 with L a multiple
    of ``key_chunk`` -> [B, L, H] in qkv's dtype, differentiable w.r.t. qkv.
    The same kernels read the three column slices through their strides;
    the backward writes dq, dk and dv into the slices of one [B, L, 3H]
    gradient (the three-tensor route leaves autograd to assemble it)."""
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * nh):
        raise ValueError(f"qkv must be [B, L, 3H] with H % nh == 0, "
                         f"got {tuple(qkv.shape)} and nh={nh}")
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _FidSelfAttention.apply(qkv, kv_bias, nh, seed, key_chunk,
                                       dropout_rate)
    B, L = qkv.shape[:2]
    return fid_cross_attention_forward(*_slab_heads(qkv, nh), kv_bias, seed,
                                       key_chunk, dropout_rate
                                       )[0].reshape(B, L, -1)


# kernel launches since the last reset (a run proves its path went through
# each kernel by reading these)
flash_self_attention.launches = 0
# ... and by (device, B, L): which card ran which shape
flash_self_attention.launches_by_shape = {}
flash_self_attention_backward.launches = 0
# ... of the relative-position bias, with their FLOPs and bytes
for _fn in (flash_self_attention, flash_self_attention_backward):
    _fn.rel_launches = _fn.rel_flops = _fn.rel_bytes = 0
flash_cross_attention.launches = 0
flash_cross_attention_backward.launches = 0
fid_cross_attention.launches = 0
fid_cross_attention_backward.launches = 0
