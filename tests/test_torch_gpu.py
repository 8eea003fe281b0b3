"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Marked ``gpu``: they skip without CUDA. This file imports neither
jax nor the JAX package, so the machine with the card runs it alone:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_gpu.py

Tolerances: bf16 attention output keeps 8 mantissa bits and the sums run in
another order, so max abs error <= 2e-2; candidate values are fp32 sums of
exact products in another order, so |dv| <= 1e-3*|v| + 1e-3, and int8
values are exact.
"""

import pytest

torch = pytest.importorskip("torch")

from emdr2_tpu_torch.ops import fid_attention, mips  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("B,L", [(3, 64), (2, 48), (2, 130), (2, 512)])
def test_flash_self_attention_matches_plain(cuda, B, L):
    g = _gen(L)
    nh = 12
    qkv = torch.randn(B, L, 3 * nh * 64, device=cuda, generator=g
                      ).to(torch.bfloat16)
    bias = torch.zeros(B, L, device=cuda)
    bias[0, :] = -1e9                        # a fully padded row
    bias[-1, L // 3:] = -1e9                 # random-length padding
    before = fid_attention.flash_self_attention.launches
    got = fid_attention.flash_self_attention(qkv, bias, nh)
    torch.cuda.synchronize()
    assert fid_attention.flash_self_attention.launches == before + 1
    want = fid_attention.flash_self_attention_reference(qkv, bias, nh)
    err = (got.float() - want.float()).abs()
    assert err.max().item() <= 2e-2 and err.mean().item() <= 2e-3


def test_flash_self_attention_refuses_grad(cuda):
    qkv = torch.zeros(1, 8, 3 * 64, device=cuda, dtype=torch.bfloat16,
                      requires_grad=True)
    with pytest.raises(NotImplementedError):
        fid_attention.flash_self_attention(qkv, torch.zeros(1, 8,
                                                            device=cuda), 1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("nq", [3, 8, 40])
@pytest.mark.parametrize("cands", [1, 2])
def test_candidate_scan_matches_plain(cuda, dtype, nq, cands):
    g = _gen(nq)
    n, d, G = 128 * 96, 768, 128
    if dtype == torch.int8:
        q = torch.randint(-127, 128, (nq, d), device=cuda, generator=g,
                          dtype=torch.int8)
        e = torch.randint(-127, 128, (n, d), device=cuda, generator=g,
                          dtype=torch.int8)
        e[256:512] = 1                       # tied groups
    else:
        q = torch.randn(nq, d, device=cuda, generator=g).to(dtype)
        e = torch.randn(n, d, device=cuda, generator=g).to(dtype)
    n_valid = n - 200                        # one and a half masked groups
    gv, gi = mips.candidate_scan(q, e, n_valid, G, cands)
    torch.cuda.synchronize()
    wv, wi = mips.candidate_scan_reference(q, e, n_valid, G, cands)
    if dtype == torch.int8:
        assert torch.equal(gv, wv) and torch.equal(gi, wi)
    else:
        assert ((gv - wv).abs() <= 1e-3 * wv.abs() + 1e-3).all()
        # ids may differ only where two rows' scores are within tolerance
        diff = gi != wi
        assert diff.float().mean().item() < 1e-3
