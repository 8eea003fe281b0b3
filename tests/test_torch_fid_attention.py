"""The port's flash self-attention (plain version, CPU) against the JAX
Pallas kernel run in interpret mode, plus the wrapper's dispatch rules.

Tolerance: both sides compute in fp32 and differ only in summation order:
atol 1e-5, rtol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from emdr2_tpu.ops.fid_attention import (  # noqa: E402
    flash_self_attention as jax_flash_self_attention,
)
from emdr2_tpu_torch.ops import fid_attention  # noqa: E402
from emdr2_tpu_torch.ops.fid_attention import (  # noqa: E402
    flash_self_attention,
    flash_self_attention_reference,
)

torch.set_num_threads(2)


def make_inputs(B, L, nh, hd=8, seed=0):
    """qkv [B, L, 3H] and a key-side pad bias with random padding; row 0 is
    fully padded (every key -1e9)."""
    rng = np.random.RandomState(seed)
    qkv = rng.randn(B, L, 3 * nh * hd).astype(np.float32)
    bias = np.zeros((B, L), np.float32)
    for b in range(1, B):
        bias[b, rng.randint(1, L + 1):] = -1e9
    bias[0, :] = -1e9
    return qkv, bias


@pytest.mark.parametrize("L", [16, 48, 64])
@pytest.mark.parametrize("nh", [2, 4])
def test_reference_matches_jax_kernel(L, nh):
    qkv, bias = make_inputs(3, L, nh, seed=L + nh)
    want = jax_flash_self_attention(jnp.asarray(qkv), jnp.asarray(bias),
                                    None, nh, True, 0.0)
    got = flash_self_attention(torch.as_tensor(qkv), torch.as_tensor(bias),
                               nh)
    assert got.shape == (3, L, nh * 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-4)


def test_bf16_rounds_probs_before_pv():
    """In bf16 the probabilities are rounded to bf16 before the P.V product
    and the division comes after it (the TPU kernel's order): check against
    a numpy transcription of that order."""
    qkv, bias = make_inputs(2, 16, 2, seed=5)
    x = torch.as_tensor(qkv).to(torch.bfloat16)
    got = flash_self_attention_reference(x, torch.as_tensor(bias), 2)
    a = x.float().numpy()
    H = a.shape[-1] // 3
    out = np.zeros((2, 16, H), np.float32)
    for b in range(2):
        for h in range(2):
            q = a[b, :, h * 8:(h + 1) * 8]
            k = a[b, :, H + h * 8:H + (h + 1) * 8]
            v = a[b, :, 2 * H + h * 8:2 * H + (h + 1) * 8]
            s = q @ k.T * np.float32(8 ** -0.5) + bias[b][None, :]
            p = np.exp(s - s.max(axis=1, keepdims=True))
            l = p.sum(axis=1, keepdims=True)
            pb = torch.as_tensor(p).to(torch.bfloat16).float().numpy()
            out[b, :, h * 8:(h + 1) * 8] = (pb @ v) / l
    want = torch.as_tensor(out).to(torch.bfloat16).float().numpy()
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2)


def test_cpu_runs_plain_version_without_counting():
    qkv, bias = make_inputs(2, 16, 2)
    before = fid_attention.flash_self_attention.launches
    flash_self_attention(torch.as_tensor(qkv), torch.as_tensor(bias), 2)
    assert fid_attention.flash_self_attention.launches == before


def test_rejects_bad_shapes_and_foreign_devices():
    qkv, bias = make_inputs(2, 16, 2)
    with pytest.raises(ValueError):
        flash_self_attention(torch.as_tensor(qkv), torch.as_tensor(bias), 5)
    with pytest.raises(ValueError):
        flash_self_attention(torch.as_tensor(qkv),
                             torch.as_tensor(bias[:, :8]), 2)
    # neither CPU nor CUDA: the wrapper raises instead of falling back
    with pytest.raises(ValueError):
        flash_self_attention(torch.empty(2, 16, 48, device="meta"),
                             torch.empty(2, 16, device="meta"), 2)
