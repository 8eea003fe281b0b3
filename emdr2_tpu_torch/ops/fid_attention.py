"""Flash self-attention on the fused QKV slab (port of the forward of
``emdr2_tpu/ops/fid_attention.py:flash_self_attention``).

``flash_self_attention`` is padding-masked self-attention for every encoder
on the serving path (the BERT query tower at L=64, the T5 FiD encoder at
L=512). It consumes the fused projection as a flat [B, L, 3H] slab (features
ordered [q | k | v], heads sliced inside the kernel) and the key-side bias
[B, L] (0 / -1e9), and returns [B, L, H].

On a CUDA tensor it launches the hand-written kernel
(``csrc/flash_self_attention.cu``) or raises; on a CPU tensor it runs
:func:`flash_self_attention_reference`, the plain PyTorch version with the
same rounding. The backward kernel, and with it autograd, comes with the
training slice; dropout is off when serving.
"""

from __future__ import annotations

import torch

from emdr2_tpu_torch.ops import build


def flash_self_attention_reference(qkv: torch.Tensor, kv_bias: torch.Tensor,
                                   nh: int) -> torch.Tensor:
    """Plain PyTorch version, rounding where the TPU kernel rounds: fp32
    scores ``s*scale + bias``, ``p = exp(s - max)``, ``l = sum(p)`` in fp32,
    ``p`` cast to the input dtype before the fp32-accumulated P.V product,
    then ``/ l`` (guarded ``l > 0``) and a cast to the input dtype.

    The products run on fp32 copies; bf16 inputs are exact in fp32 (and in
    TF32), so TF32 settings cannot change the scores."""
    B, L, H3 = qkv.shape
    H = H3 // 3
    hd = H // nh
    heads = qkv.view(B, L, 3, nh, hd).permute(2, 0, 3, 1, 4)  # [3,B,nh,L,hd]
    q, k, v = heads[0].float(), heads[1].float(), heads[2]
    s = torch.matmul(q, k.transpose(-1, -2)) * (hd ** -0.5)
    s = s + kv_bias.float()[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    safe = torch.where(l > 0, l, torch.ones_like(l))
    o = torch.matmul(p.to(qkv.dtype).float(), v.float()) / safe
    return o.to(qkv.dtype).permute(0, 2, 1, 3).reshape(B, L, H)


def flash_self_attention(qkv: torch.Tensor, kv_bias: torch.Tensor,
                         nh: int) -> torch.Tensor:
    """qkv [B, L, 3H], kv_bias [B, L] fp32 -> [B, L, H] in qkv's dtype."""
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * nh):
        raise ValueError(f"qkv must be [B, L, 3H] with H % nh == 0, "
                         f"got {tuple(qkv.shape)} and nh={nh}")
    B, L, H3 = qkv.shape
    if kv_bias.shape != (B, L):
        raise ValueError(f"kv_bias must be {(B, L)}, got {tuple(kv_bias.shape)}")
    if qkv.device.type == "cpu":
        return flash_self_attention_reference(qkv, kv_bias, nh)
    if qkv.device.type != "cuda" or kv_bias.device != qkv.device:
        raise ValueError(f"flash_self_attention: unsupported devices "
                         f"{qkv.device} / {kv_bias.device}")
    if qkv.requires_grad:
        raise NotImplementedError(
            "flash_self_attention has no backward kernel yet (training)")
    H = H3 // 3
    hd = H // nh
    if qkv.dtype != torch.bfloat16 or kv_bias.dtype != torch.float32:
        raise TypeError(f"kernel takes bf16 qkv and fp32 kv_bias, got "
                        f"{qkv.dtype} / {kv_bias.dtype}")
    if hd != 64:
        raise ValueError(f"kernel is built for head_dim 64, got {hd}")
    if not (qkv.is_contiguous() and kv_bias.is_contiguous()):
        raise ValueError("flash_self_attention needs contiguous inputs")
    if qkv.data_ptr() % 16:
        raise ValueError("qkv must be 16-byte aligned")
    out = torch.empty((B, L, H), dtype=qkv.dtype, device=qkv.device)
    lib = build.load()
    err = lib.emdr2_flash_self_attention_bf16(
        qkv.data_ptr(), kv_bias.data_ptr(), out.data_ptr(), B, L, nh, hd,
        torch.cuda.current_stream(qkv.device).cuda_stream)
    build.check(err, "flash_self_attention")
    flash_self_attention.launches += 1
    return out


# kernel launches since the last reset (a run proves its path went through
# the kernel by reading this)
flash_self_attention.launches = 0
