"""int8-stored cross-attention for the incremental decode token loop (port
of ``emdr2_tpu/ops/decode_attention.py``).

The token loop re-reads the whole precomputed cross K/V slab at every step
(K contexts x reader length keys, 12 decoder layers), so a decode step is
bound by that read. Here the slab is stored as int8 rows with one fp32 scale
per (batch, head, key row) and dequantized inside the kernel: device memory
holds, and a step reads, one byte per element.

- ``quantize_kv_rows``: [..., Lk, hd] -> (int8 rows, fp32 row scales),
  symmetric absmax per key row. The scale axis is the key row, so
  dequantization folds into the score columns (K) and the probability
  columns (V), never into the slab.
- ``decode_cross_attention_int8`` (K5): attention of the few query rows of a
  step (R = beams x new tokens) over the int8 slab,
  ``s = (q k8^T) * (hd^-0.5 * kscale) + bias``, ``out = softmax(s) *
  vscale @ v8``. On a CUDA tensor it launches the hand-written kernel
  (``csrc/decode_attention.cu``) or raises; on a CPU tensor it runs the
  plain PyTorch version beside it, which walks the keys in chunks of
  ``key_chunk`` with an online softmax and rounds where the TPU kernel
  rounds. The wrapper counts its launches in ``.launches``.
- ``decode_cross_attention_int8_reference``: dense, dequantize outright.

Quantization is opt-in (``DecoderSession(kv_quant="int8")``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from emdr2_tpu_torch.ops import build
from emdr2_tpu_torch.ops.fid_attention import check_kernel_limits
from emdr2_tpu_torch.utils.timing import count

DEFAULT_KEY_CHUNK = 3200
# query rows one kernel launch takes; more rows go in blocks of this many
MAX_KERNEL_ROWS = 8
# blocks the kernel wants for every block the card holds at once (counted as
# two a multiprocessor, the least the kernel is built for): enough that the last, partly filled round of blocks is a
# small share of the walk, few enough that a block's start and end (the
# queries, the first stage's latency, the merge) are one too
_DECODE_ROUNDS = 4


def padded_rows(Lk: int, key_chunk: int = DEFAULT_KEY_CHUNK) -> int:
    """Key-row count the quantized slab is padded to so that chunks divide
    it evenly: the next multiple of 128 when one chunk covers everything,
    else the next ``key_chunk`` multiple."""
    if Lk <= key_chunk:
        return -(-Lk // 128) * 128
    return -(-Lk // key_chunk) * key_chunk


def quantize_kv_rows(x: torch.Tensor):
    """[..., Lk, hd] float -> (int8 [..., Lk, hd], fp32 scales [..., Lk]).

    Symmetric absmax per key row: ``x ~= x8 * scale[..., None]``. All-zero
    rows (chunk padding) get scale 1, so they stay exactly zero. Rounds
    half to even."""
    xf = x.float()
    a = xf.abs().amax(dim=-1)
    scale = torch.where(a > 0, a / 127.0, torch.ones_like(a))
    x8 = torch.round(xf / scale[..., None]).to(torch.int8)
    return x8, scale


def _check_shapes(q, k8, kscale, v8, vscale, kv_bias):
    if q.dim() != 4:
        raise ValueError(f"q must be [B, R, nh, hd], got {tuple(q.shape)}")
    B, R, nh, hd = q.shape
    Lk = k8.shape[2] if k8.dim() == 4 else -1
    if tuple(k8.shape) != (B, nh, Lk, hd) or v8.shape != k8.shape:
        raise ValueError(f"k8 and v8 must be [{B}, {nh}, Lk, {hd}], got "
                         f"{tuple(k8.shape)} and {tuple(v8.shape)}")
    if tuple(kscale.shape) != (B, nh, Lk) or vscale.shape != kscale.shape:
        raise ValueError(f"kscale and vscale must be {(B, nh, Lk)}, got "
                         f"{tuple(kscale.shape)} and {tuple(vscale.shape)}")
    if tuple(kv_bias.shape) != (B, Lk):
        raise ValueError(f"kv_bias must be {(B, Lk)}, got "
                         f"{tuple(kv_bias.shape)}")
    if k8.dtype != torch.int8 or v8.dtype != torch.int8:
        raise TypeError(f"k8 and v8 must be int8, got {k8.dtype}, {v8.dtype}")
    return B, R, nh, hd, Lk


def decode_cross_attention_int8_plain(q, k8, kscale, v8, vscale, kv_bias,
                                      key_chunk: int = DEFAULT_KEY_CHUNK):
    """Plain PyTorch version with the TPU kernel's chunking and rounding:
    per chunk of ``key_chunk`` keys, fp32 scores ``(q k8^T) * (kscale *
    hd^-0.5) + bias``, ``p = exp(s - m_new)`` against the running max,
    ``l`` over ``p``, ``p * vscale`` cast to q's dtype before the
    fp32-accumulated product with v8; ``out = acc / l`` (guarded ``> 0``)
    in q's dtype. int8 values are exact in bf16 and fp32."""
    B, R, nh, hd, Lk = _check_shapes(q, k8, kscale, v8, vscale, kv_bias)
    key_chunk = min(key_chunk, Lk)
    if Lk % key_chunk:
        raise ValueError(f"Lk={Lk} must be a multiple of key_chunk="
                         f"{key_chunk}: pad the quantized slab (bias -1e9)")
    scale = hd ** -0.5
    qf = q.permute(0, 2, 1, 3).float()                       # [B, nh, R, hd]
    bias = kv_bias.float()
    m = torch.full((B, nh, R, 1), -1e30, device=q.device)
    l = torch.zeros((B, nh, R, 1), device=q.device)
    acc = torch.zeros((B, nh, R, hd), device=q.device)
    for j in range(Lk // key_chunk):
        sl = slice(j * key_chunk, (j + 1) * key_chunk)
        s = torch.matmul(qf, k8[:, :, sl].float().transpose(-1, -2))
        s = s * (kscale[:, :, None, sl] * scale) + bias[:, None, None, sl]
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        pv = (p * vscale[:, :, None, sl]).to(q.dtype).float()
        acc = acc * corr + torch.matmul(pv, v8[:, :, sl].float())
        m = m_new
    safe = torch.where(l > 0, l, torch.ones_like(l))
    return (acc / safe).to(q.dtype).permute(0, 2, 1, 3)


def decode_cross_attention_int8_reference(q, k8, kscale, v8, vscale,
                                          kv_bias):
    """Dense reference (tests): dequantize outright, softmax, mix."""
    kf = k8.float() * kscale[..., None]
    vf = v8.float() * vscale[..., None]
    qf = q.float() * (q.shape[-1] ** -0.5)
    s = torch.einsum("brnd,bnkd->bnrk", qf, kf)
    s = s + kv_bias.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bnrk,bnkd->brnd", p, vf).to(q.dtype)


def decode_cross_attention_int8_split_reference(
        q, k8, kscale, v8, vscale, kv_bias, stages_per_block: int,
        stage_keys: int, warps: int):
    """The arithmetic of the kernel's key walk, in plain PyTorch: the keys
    are cut into stages of ``stage_keys`` (keys past Lk count as scale 0,
    bias -inf), a stage into ``warps`` equal slices (the kernel's own:
    ``kernel_layout()``); each (block, warp)
    walks its slice of the block's ``stages_per_block`` stages with an
    online softmax of its own (fp32 ``p * vscale``, no rounding to q's
    dtype); a block merges its warps' (m, l, acc) in warp order, and the
    blocks' partials are combined in block order: M = max m_i, l = sum l_i
    exp(m_i - M), acc likewise, out = acc / l (0 where l == 0). It equals
    the plain version up to rounding. Nothing on the card's path calls it:
    the tests hold the split and combine rule with it."""
    B, R, nh, hd, Lk = _check_shapes(q, k8, kscale, v8, vscale, kv_bias)
    if stages_per_block < 1 or stage_keys % warps:
        raise ValueError(f"bad split: stages_per_block={stages_per_block}, "
                         f"stage_keys={stage_keys}, warps={warps}")
    n_stages = -(-Lk // stage_keys)
    pad = n_stages * stage_keys - Lk
    F = torch.nn.functional
    kf = F.pad(k8.float(), (0, 0, 0, pad))
    vf = F.pad(v8.float(), (0, 0, 0, pad))
    ksc = F.pad(kscale.float(), (0, pad))
    vsc = F.pad(vscale.float(), (0, pad))
    bias = F.pad(kv_bias.float(), (0, pad), value=float("-inf"))
    qf = q.permute(0, 2, 1, 3).float()                       # [B, nh, R, hd]
    s = torch.matmul(qf, kf.transpose(-1, -2))
    s = s * (ksc[:, :, None, :] * hd ** -0.5) + bias[:, None, None, :]
    kw = stage_keys // warps
    s = s.view(B, nh, R, n_stages, warps, kw)
    vf = vf.view(B, nh, n_stages, warps, kw, hd)
    vsc = vsc.view(B, nh, n_stages, warps, kw)
    parts = []
    for first in range(0, n_stages, stages_per_block):
        m = torch.full((B, nh, R, warps), -1e30, device=q.device)
        l = torch.zeros((B, nh, R, warps), device=q.device)
        acc = torch.zeros((B, nh, R, warps, hd), device=q.device)
        for st in range(first, min(n_stages, first + stages_per_block)):
            m_new = torch.maximum(m, s[:, :, :, st].amax(dim=-1))
            p = torch.exp(s[:, :, :, st] - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = p * vsc[:, :, None, st]
            acc = acc * corr[..., None] + torch.einsum(
                "bnrwk,bnwkd->bnrwd", pv, vf[:, :, st])
            m = m_new
        m_blk = m.amax(dim=-1)
        l_blk = torch.zeros_like(m_blk)
        acc_blk = torch.zeros_like(acc[:, :, :, 0])
        for w in range(warps):
            wt = torch.exp(m[..., w] - m_blk)
            l_blk = l_blk + l[..., w] * wt
            acc_blk = acc_blk + acc[:, :, :, w] * wt[..., None]
        parts.append((m_blk, l_blk, acc_blk))
    m = torch.stack([part[0] for part in parts]).amax(dim=0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    for m_i, l_i, acc_i in parts:
        wt = torch.exp(m_i - m)
        l = l + l_i * wt
        acc = acc + acc_i * wt[..., None]
    safe = torch.where(l > 0, l, torch.ones_like(l))
    out = torch.where(l[..., None] > 0, acc / safe[..., None],
                      torch.zeros_like(acc))
    return out.to(q.dtype).permute(0, 2, 1, 3)


class KernelLayout(NamedTuple):
    """What the built kernel says of itself (``kernel_layout``)."""
    stage_keys: int                 # keys a slot of the ring holds
    slots: int                      # slots of the ring
    warps: int                      # warps that share a stage
    smem_bytes: Tuple[int, ...]     # [R - 1]: dynamic shared memory a block
    resident_blocks: Tuple[int, ...]    # [R - 1]: blocks a multiprocessor
                                        # holds at once, as the runtime's
                                        # occupancy query counts them


@functools.lru_cache(maxsize=None)
def kernel_layout() -> KernelLayout:
    """The kernel's stage size, ring depth, warps, and for R = 1..8 query
    rows its shared memory and its residency on the current card, read from
    the library (``emdr2_decode_attention_layout``): the constants live in
    ``csrc/decode_attention.cu`` alone."""
    n = MAX_KERNEL_ROWS
    out = (ctypes.c_int * (3 + 2 * n))()
    build.check(build.load().emdr2_decode_attention_layout(out),
                "emdr2_decode_attention_layout")
    return KernelLayout(out[0], out[1], out[2], tuple(out[3:3 + n]),
                        tuple(out[3 + n:3 + 2 * n]))


@functools.lru_cache(maxsize=None)
def _multiprocessors(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_plan(B: int, nh: int, Lk: int, device,
               stages_per_block: Optional[int] = None) -> Tuple[int, int]:
    """(stages a block walks, blocks a (head, example)) of the kernel at
    this shape on this card: about ``_DECODE_ROUNDS`` blocks for every block
    the card holds at once, at least one stage a block. A given
    ``stages_per_block`` is kept (cut to the number of stages)."""
    n_stages = -(-Lk // kernel_layout().stage_keys)
    if stages_per_block is None:
        sms = _multiprocessors(torch.device(device))
        blocks_per_bh = max(1, _DECODE_ROUNDS * 2 * sms // (B * nh))
        stages_per_block = max(1, n_stages // blocks_per_bh)
    elif stages_per_block < 1:
        raise ValueError(f"stages_per_block must be >= 1, got "
                         f"{stages_per_block}")
    stages_per_block = min(stages_per_block, n_stages)
    return stages_per_block, -(-n_stages // stages_per_block)


def decode_cross_attention_int8(q, k8, kscale, v8, vscale, kv_bias,
                                key_chunk: int = DEFAULT_KEY_CHUNK):
    """Decode attention over int8-stored K/V.

    q        [B, R, nh, hd]   query rows (R = beams x new tokens)
    k8, v8   [B, nh, Lk, hd]  int8 rows (``quantize_kv_rows``), pre-headed
    kscale,  [B, nh, Lk]      fp32 row scales
    vscale
    kv_bias  [B, Lk]          fp32 key-side bias (0 / -1e9), Lk a multiple
                              of min(key_chunk, Lk)
    -> [B, R, nh, hd] in q's dtype

    On CUDA (bf16 q, head dim 64) the kernel deals the keys to blocks in
    runs of whole stages, whatever ``key_chunk`` is, and combines the
    blocks' partial softmaxes in a fixed order (``split_plan`` picks the
    runs from the shape and the card); on CPU the plain chunked version
    runs."""
    B, R, nh, hd, Lk = _check_shapes(q, k8, kscale, v8, vscale, kv_bias)
    if Lk % min(key_chunk, Lk):
        raise ValueError(f"Lk={Lk} must be a multiple of key_chunk="
                         f"{key_chunk}: pad the quantized slab (bias -1e9)")
    tensors = (q, k8, kscale, v8, vscale, kv_bias)
    if all(t.device.type == "cpu" for t in tensors):
        return decode_cross_attention_int8_plain(q, k8, kscale, v8, vscale,
                                                 kv_bias, key_chunk)
    return _launch(q, k8, kscale, v8, vscale, kv_bias)


def _launch(q, k8, kscale, v8, vscale, kv_bias,
            plan: Optional[Tuple[int, int]] = None):
    """Check the tensors against the kernel's limits and launch it, once
    for every ``MAX_KERNEL_ROWS`` query rows. ``plan`` = (stages a block
    walks, blocks a (head, example)); ``None`` takes ``split_plan``'s (the
    tests force other runs)."""
    B, R, nh, hd = q.shape
    Lk = k8.shape[2]
    tensors = (q, k8, kscale, v8, vscale, kv_bias)
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError(f"decode_cross_attention_int8: unsupported devices "
                         f"{[str(t.device) for t in tensors]}")
    check_kernel_limits("decode_cross_attention_int8", q.dtype, hd)
    for t in (kscale, vscale, kv_bias):
        if t.dtype != torch.float32:
            raise TypeError(f"the kernel takes fp32 scales and bias, got "
                            f"{t.dtype}")
    q = q.contiguous()
    for t in (q, k8, kscale, v8, vscale, kv_bias):
        if not t.is_contiguous():
            raise ValueError("decode_cross_attention_int8: needs contiguous "
                             "inputs")
        if t.data_ptr() % 16:
            raise ValueError("decode_cross_attention_int8: inputs must be "
                             "16-byte aligned")
    stages_per_block, n_blocks = plan or split_plan(B, nh, Lk, q.device)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    for r0 in range(0, R, MAX_KERNEL_ROWS):
        rows = min(MAX_KERNEL_ROWS, R - r0)
        part = torch.empty((B, nh, n_blocks, rows, hd + 2),
                           dtype=torch.float32, device=q.device)
        build.launch(
            "emdr2_decode_attention_int8", "decode_cross_attention_int8",
            q.device, q.data_ptr(), k8.data_ptr(), kscale.data_ptr(),
            v8.data_ptr(), vscale.data_ptr(), kv_bias.data_ptr(),
            part.data_ptr(), out.data_ptr(), B, R, r0, rows, nh, hd, Lk,
            stages_per_block, n_blocks, stream)
        count(decode_cross_attention_int8, "launches")
    return out


# kernel launches since the last reset
decode_cross_attention_int8.launches = 0
