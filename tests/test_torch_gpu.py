"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Marked ``gpu``: they skip without CUDA. This file imports neither
jax nor the JAX package, so the machine with the card runs it alone:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_gpu.py

Tolerances: bf16 attention output keeps 8 mantissa bits and the sums run in
another order, so max abs error <= 2e-2; the backward kernels also round dS
and the dropped probabilities to bf16 for the tensor-core products (the
plain versions multiply in fp32), so gradients are held to 2e-2 of the
largest reference gradient at most and 2e-3 of it on average; candidate
values are fp32 sums of exact products in another order, so |dv| <=
1e-3*|v| + 1e-3, and int8 values are exact. The int8 decode kernel keeps
``p * vscale`` in fp32 where its plain version rounds it to bf16, and sums
its stages, warps and blocks in another order: the same 2e-2 / 2e-3 of the
largest reference output, also against the plain form of its own order.
"""

import pytest

torch = pytest.importorskip("torch")

from emdr2_tpu_torch.ops import decode_attention, fid_attention, mips  # noqa: E402

pytestmark = pytest.mark.gpu

NH = 12


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


def _assert_close(got, want, rel_max=2e-2, rel_mean=2e-3):
    """Errors relative to the largest reference magnitude (bf16 results)."""
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs()
    ref = want.float().abs().max().item() or 1.0
    assert err.max().item() <= rel_max * ref, (err.max().item(), ref)
    assert err.mean().item() <= rel_mean * ref, (err.mean().item(), ref)


def _self_inputs(B, L, seed):
    g = _gen(seed)
    qkv = torch.randn(B, L, 3 * NH * 64, device="cuda", generator=g
                      ).to(torch.bfloat16)
    bias = torch.zeros(B, L, device="cuda")
    bias[0, :] = -1e9                        # a fully padded row
    bias[-1, L // 3:] = -1e9                 # random-length padding
    dout = torch.randn(B, L, NH * 64, device="cuda", generator=g
                       ).to(torch.bfloat16)
    return qkv, bias, dout


def _cross_inputs(B, Lq, Lk, real, seed):
    """q, kv and a bias whose keys past ``real`` (per row) are padding."""
    g = _gen(seed)
    H = NH * 64
    q = torch.randn(B, Lq, H, device="cuda", generator=g).to(torch.bfloat16)
    kv = torch.randn(B, Lk, 2 * H, device="cuda", generator=g
                     ).to(torch.bfloat16)
    bias = torch.zeros(B, Lk, device="cuda")
    bias[:, real:] = -1e9
    bias[-1, real // 2:] = -1e9
    dout = torch.randn(B, Lq, H, device="cuda", generator=g
                       ).to(torch.bfloat16)
    return q, kv, bias, dout


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


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,L", [(3, 64), (2, 48), (2, 130), (1, 512)])
def test_self_attention_forward_backward_match_plain(cuda, B, L, rate):
    qkv, bias, dout = _self_inputs(B, L, seed=L)
    x = qkv.clone().requires_grad_(True)
    fwd0 = fid_attention.flash_self_attention.launches
    bwd0 = fid_attention.flash_self_attention_backward.launches
    out = fid_attention.flash_self_attention(x, bias, NH, 77, rate)
    out.backward(dout)
    torch.cuda.synchronize()
    assert fid_attention.flash_self_attention.launches == fwd0 + 1
    assert fid_attention.flash_self_attention_backward.launches == bwd0 + 1
    want = fid_attention.flash_self_attention_reference(qkv, bias, NH, 77,
                                                        rate)
    _assert_close(out.detach(), want)
    dwant = fid_attention.flash_self_attention_bwd_reference(
        qkv, bias, out.detach(), dout, NH, 77, rate)
    _assert_close(x.grad, dwant)


def test_self_attention_masked_keys_get_no_gradient(cuda):
    qkv, bias, dout = _self_inputs(2, 100, seed=3)
    x = qkv.clone().requires_grad_(True)
    fid_attention.flash_self_attention(x, bias, NH, 5, 0.1).backward(dout)
    H = NH * 64
    # row 1 has real keys [0, 33): its padded keys get exactly zero dk, dv
    assert (x.grad[1, 33:, H:] == 0).all()
    assert torch.isfinite(x.grad.float()).all()      # row 0: fully masked


def test_self_attention_rate_zero_is_no_dropout_and_repeats(cuda):
    qkv, bias, dout = _self_inputs(2, 130, seed=4)
    grads = []
    for seed in (None, 9, 9):
        x = qkv.clone().requires_grad_(True)
        out = fid_attention.flash_self_attention(x, bias, NH, seed, 0.0)
        out.backward(dout)
        grads.append((out.detach(), x.grad))
    for out, grad in grads[1:]:
        assert torch.equal(out, grads[0][0]) and torch.equal(grad,
                                                             grads[0][1])
    x = qkv.clone().requires_grad_(True)
    out = fid_attention.flash_self_attention(x, bias, NH, 9, 0.1)
    out.backward(dout)
    x2 = qkv.clone().requires_grad_(True)
    out2 = fid_attention.flash_self_attention(x2, bias, NH, 9, 0.1)
    out2.backward(dout)
    assert torch.equal(out, out2) and torch.equal(x.grad, x2.grad)
    assert not torch.equal(out, grads[0][0])


# ---- K1 on the shared walks: one pass forward, backward in registers ----

def _stats_close(got, want, live):
    """(rowmax, 1/l) [B, nh, 2, L]: rows with a live key to 1e-3 (1/l
    relative), a fully padded row's rowmax is its scores (about -1e9) and
    its 1/l exactly 1/L."""
    B, nh, _, L = want.shape
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert (got[live, :, 0] - want[live, :, 0]).abs().max().item() <= 1e-3
    rel = (got[live, :, 1] / want[live, :, 1] - 1.0).abs().max().item()
    assert rel <= 1e-3, rel
    if (~live).any():
        assert (got[~live, :, 0] < -9e8).all()
        assert torch.equal(got[~live, :, 1],
                           torch.full_like(got[~live, :, 1], 1.0 / L))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,L", [(3, 64), (2, 100), (2, 130), (2, 256),
                                 (2, 288), (2, 512)])
def test_self_attention_kernels_match_plain_and_repeat(cuda, B, L, rate):
    """Forward, saved statistics and backward against the plain versions,
    with a fully padded row and a ragged last tile; both repeat bit for
    bit."""
    qkv, bias, dout = _self_inputs(B, L, seed=L + 1)
    out, stats = fid_attention.flash_self_attention_forward(qkv, bias, NH, 77,
                                                            rate)
    torch.cuda.synchronize()
    want = fid_attention.flash_self_attention_reference(qkv, bias, NH, 77,
                                                        rate)
    _assert_close(out, want)
    live = (bias > -1e8).any(dim=1)
    _stats_close(stats, fid_attention.flash_self_attention_stats_reference(
        qkv, bias, NH), live)
    again, stats2 = fid_attention.flash_self_attention_forward(qkv, bias, NH,
                                                               77, rate)
    assert torch.equal(again, out) and torch.equal(stats2, stats)
    # the backward from the plain statistics and from the kernel's own
    plain_stats = fid_attention.flash_self_attention_stats_reference(qkv,
                                                                     bias, NH)
    dwant = fid_attention.flash_self_attention_bwd_reference(
        qkv, bias, want, dout, NH, 77, rate)
    for st, o in ((plain_stats, want), (stats, out)):
        got = fid_attention.flash_self_attention_backward(
            qkv, bias, o, dout, NH, 77, rate, st)
        torch.cuda.synchronize()
        _assert_close(got, dwant)
        assert torch.equal(fid_attention.flash_self_attention_backward(
            qkv, bias, o, dout, NH, 77, rate, st), got)


@pytest.mark.parametrize("L", [64, 130, 512])
def test_self_attention_without_stats_is_the_same_forward(cuda, L):
    qkv, bias, _ = _self_inputs(2, L, seed=L + 2)
    out, stats = fid_attention.flash_self_attention_forward(qkv, bias, NH)
    bare, none = fid_attention.flash_self_attention_forward(
        qkv, bias, NH, with_stats=False)
    assert none is None and stats is not None and torch.equal(bare, out)
    with torch.no_grad():
        assert torch.equal(fid_attention.flash_self_attention(qkv, bias, NH),
                           out)


def test_self_attention_fully_padded_row_keeps_exact_statistics(cuda):
    """Every key of row 0 is padding: uniform p, 1/l = 1/L exactly, finite
    gradients that match the plain backward's on that row."""
    qkv, bias, dout = _self_inputs(2, 288, seed=11)
    x = qkv.clone().requires_grad_(True)
    out = fid_attention.flash_self_attention(x, bias, NH, 3, 0.1)
    out.backward(dout)
    _, stats = fid_attention.flash_self_attention_forward(qkv, bias, NH, 3,
                                                          0.1)
    assert torch.equal(stats[0, :, 1], torch.full_like(stats[0, :, 1],
                                                       1.0 / 288))
    dwant = fid_attention.flash_self_attention_bwd_reference(
        qkv, bias, out.detach(), dout, NH, 3, 0.1)
    _assert_close(x.grad[0], dwant[0])


def test_model_refuses_a_configuration_the_kernels_do_not_take(cuda):
    """At construction on the card, before any work: fp32 activations, a
    head dim other than 64, a decoder longer than the cross-attention
    kernel's 64 queries. With flash attention off nothing is refused."""
    import dataclasses

    from emdr2_tpu_torch.config import (tiny_config, with_flash_attention,
                                        with_transformers)
    from emdr2_tpu_torch.models.emdr2 import EMDR2Model

    tiny = tiny_config()
    hd64 = {"hidden_size": 128, "num_heads": 2, "dtype": torch.bfloat16}
    ok = with_flash_attention(with_transformers(tiny, hd64, hd64))
    EMDR2Model(ok, device=cuda)
    EMDR2Model(tiny, device=cuda)                       # flash off
    with pytest.raises(TypeError, match="bf16"):
        EMDR2Model(with_transformers(ok, {"dtype": torch.float32}, {}),
                   device=cuda)
    with pytest.raises(ValueError, match="head_dim 64"):
        EMDR2Model(with_transformers(ok, {}, {"num_heads": 4}), device=cuda)
    long_decoder = ok.replace(reader=dataclasses.replace(
        ok.reader, decoder_seq_len=80))
    with pytest.raises(ValueError, match="at most 64 decoder positions"):
        EMDR2Model(long_decoder, device=cuda)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,Lq,Lk,chunk,real", [
    (2, 32, 1024, 512, 700),      # several chunks, padded tail
    (3, 8, 96, 96, 50),           # one chunk, ragged: not a tile multiple
    (2, 32, 144, 48, 100),        # chunk smaller than a tile
    (1, 64, 512, 512, 512),
    (2, 32, 3584, 512, 1200),     # seven chunks, seven splits, four padded
    (1, 32, 25600, 256, 20000),   # the reader's keys under key chunk 256
])
def test_cross_attention_forward_backward_match_plain(cuda, B, Lq, Lk,
                                                      chunk, real, rate):
    q, kv, bias, dout = _cross_inputs(B, Lq, Lk, real, seed=Lk + Lq)
    a = q.clone().requires_grad_(True)
    b = kv.clone().requires_grad_(True)
    fwd0 = fid_attention.flash_cross_attention.launches
    bwd0 = fid_attention.flash_cross_attention_backward.launches
    out = fid_attention.flash_cross_attention(a, b, bias, NH, chunk, 31, rate)
    out.backward(dout)
    torch.cuda.synchronize()
    assert fid_attention.flash_cross_attention.launches == fwd0 + 1
    assert fid_attention.flash_cross_attention_backward.launches == bwd0 + 1
    want, lse = fid_attention.flash_cross_attention_reference(
        q, kv, bias, NH, chunk, 31, rate)
    _assert_close(out.detach(), want)
    _, got_lse = fid_attention.flash_cross_attention_forward(
        q, kv, bias, NH, chunk, 31, rate)
    assert (got_lse - lse).abs().max().item() <= 1e-3 * lse.abs().max()
    dq, dkv = fid_attention.flash_cross_attention_bwd_reference(
        q, kv, bias, lse, out.detach(), dout, NH, chunk, 31, rate)
    _assert_close(a.grad, dq)
    _assert_close(b.grad, dkv)
    # padded keys of every row get exactly zero dk and dv
    assert (b.grad[:, real:] == 0).all()


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Lk,chunk,real,n_splits", [
    (3584, 512, 1200, 1),         # seven chunks walked by one block
    (3584, 512, 1200, 2),         # 4 + 3
    (3584, 512, 1200, 3),         # 3 + 3 + 1; the last two all padding
    (3584, 512, 1200, 5),         # reduced to four splits of 2, 2, 2, 1
    (3584, 512, 1200, 7),
    (512, 512, 400, 4),           # one chunk: one split, no combine
    (25600, 256, 20000, None),    # 100 chunks, the wrapper's own choice
    (144, 48, 100, 3),            # chunks smaller than a tile
])
def test_cross_attention_key_splits_match_plain(cuda, Lk, chunk, real,
                                                n_splits, rate):
    q, kv, bias, _ = _cross_inputs(2, 32, Lk, real, seed=Lk + (n_splits or 0))
    bias[0, :] = -1e9                                 # a fully padded row
    before = fid_attention.flash_cross_attention.launches
    out, lse = fid_attention.flash_cross_attention_forward(
        q, kv, bias, NH, chunk, 31, rate, n_splits)
    torch.cuda.synchronize()
    assert fid_attention.flash_cross_attention.launches == before + 1
    want, want_lse = fid_attention.flash_cross_attention_reference(
        q, kv, bias, NH, chunk, 31, rate)
    _assert_close(out, want)
    assert torch.isfinite(lse).all()
    assert (lse - want_lse).abs().max().item() <= 1e-3 * want_lse.abs().max()
    assert (lse[1] - want_lse[1]).abs().max().item() <= 1e-3
    again = fid_attention.flash_cross_attention_forward(
        q, kv, bias, NH, chunk, 31, rate, n_splits)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Lq,Lk,chunk,real,n_runs", [
    (32, 3584, 512, 1200, 1),     # seven chunks walked by one block
    (32, 3584, 512, 1200, 2),     # 4 + 3
    (32, 3584, 512, 1200, 3),     # 3 + 3 + 1; the last two all padding
    (32, 3584, 512, 1200, 5),     # reduced to four runs of 2, 2, 2, 1
    (32, 3584, 512, 1200, 7),
    (40, 3584, 512, 1200, 3),     # three atoms of 16 queries
    (64, 1024, 256, 700, 2),      # four atoms
    (8, 144, 48, 100, 3),         # one atom; chunks shorter than a step
    (32, 25600, 256, 20000, None),    # the wrapper's own choice
])
def test_cross_attention_backward_runs_match_plain(cuda, Lq, Lk, chunk, real,
                                                   n_runs, rate):
    """The backward kernel over forced runs of whole chunks against the
    plain backward and its run-split form; row 0 fully padded (P = 1 from
    its lse: held to the plain result, not only finite), row 1 padded from
    real // 2 (its padded keys get exactly zero dk and dv); repeats are
    bit-identical."""
    q, kv, bias, dout = _cross_inputs(2, Lq, Lk, real,
                                      seed=Lk + Lq + (n_runs or 0))
    bias[0, :] = -1e9
    out, lse = fid_attention.flash_cross_attention_reference(
        q, kv, bias, NH, chunk, 31, rate)
    args = (q, kv, bias, lse, out, dout, NH, chunk)
    before = fid_attention.flash_cross_attention_backward.launches
    dq, dkv = fid_attention._launch_cross_backward(*args, 31, rate, n_runs)
    torch.cuda.synchronize()
    assert fid_attention.flash_cross_attention_backward.launches == before + 1
    want_dq, want_dkv = fid_attention.flash_cross_attention_bwd_reference(
        *args, 31, rate)
    _assert_close(dq, want_dq)
    _assert_close(dkv, want_dkv)
    if n_runs is not None:
        split_dq, _ = fid_attention.flash_cross_attention_bwd_split_reference(
            *args, n_runs, 31, rate)
        _assert_close(dq, split_dq)
    _assert_close(dq[0], want_dq[0])
    _assert_close(dkv[0], want_dkv[0])
    assert (dkv[1, real // 2:] == 0).all()
    again = fid_attention._launch_cross_backward(*args, 31, rate, n_runs)
    assert torch.equal(again[0], dq) and torch.equal(again[1], dkv)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_cross_attention_backward_reader_shape_chunk_256(cuda, rate):
    """The reader's shape under key chunk 256 (8 rows of 32 queries over
    25,600 keys, each row padded from its own length), through autograd:
    padded keys get exactly zero dk and dv, the gradients match the plain
    backward on two rows, and a repeat is bit-identical."""
    g = _gen(256)
    B, Lq, Lk, H = 8, 32, 25_600, NH * 64
    q = torch.randn(B, Lq, H, device=cuda, generator=g).to(torch.bfloat16)
    kv = torch.randn(B, Lk, 2 * H, device=cuda, generator=g
                     ).to(torch.bfloat16)
    real = torch.randint(Lk // 2, Lk - 100, (B,), device=cuda, generator=g)
    bias = torch.where(torch.arange(Lk, device=cuda)[None, :] < real[:, None],
                       0.0, -1e9).float()
    dout = torch.randn(B, Lq, H, device=cuda, generator=g).to(torch.bfloat16)
    grads = []
    for _ in range(2):
        a = q.clone().requires_grad_(True)
        b = kv.clone().requires_grad_(True)
        out = fid_attention.flash_cross_attention(a, b, bias, NH, 256, 5, rate)
        out.backward(dout)
        grads.append((a.grad, b.grad))
    torch.cuda.synchronize()
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])
    dq, dkv = grads[0]
    for r in range(B):
        assert (dkv[r, real[r]:] == 0).all()
    _, lse = fid_attention.flash_cross_attention_forward(q, kv, bias, NH, 256,
                                                         5, rate)
    rows = slice(0, 2)
    want_dq, want_dkv = fid_attention.flash_cross_attention_bwd_reference(
        q[rows], kv[rows], bias[rows], lse[rows], out.detach()[rows],
        dout[rows], NH, 256, 5, rate)
    _assert_close(dq[rows], want_dq)
    _assert_close(dkv[rows], want_dkv)


def test_cross_attention_fully_masked_row_stays_finite(cuda):
    q, kv, bias, dout = _cross_inputs(2, 32, 512, 512, seed=8)
    bias[0] = -1e9
    a = q.clone().requires_grad_(True)
    b = kv.clone().requires_grad_(True)
    out = fid_attention.flash_cross_attention(a, b, bias, NH, 256, 3, 0.1)
    out.backward(dout)
    for t in (out, a.grad, b.grad):
        assert torch.isfinite(t.float()).all()


def test_cross_attention_rate_zero_is_no_dropout_and_repeats(cuda):
    q, kv, bias, dout = _cross_inputs(2, 32, 1024, 900, seed=9)
    runs = []
    for seed, rate in ((None, 0.0), (4, 0.0), (4, 0.1), (4, 0.1)):
        a = q.clone().requires_grad_(True)
        b = kv.clone().requires_grad_(True)
        out = fid_attention.flash_cross_attention(a, b, bias, NH, 512, seed,
                                                  rate)
        out.backward(dout)
        runs.append((out.detach(), a.grad, b.grad))
    for x, y in zip(runs[0], runs[1]):
        assert torch.equal(x, y)
    for x, y in zip(runs[2], runs[3]):
        assert torch.equal(x, y)
    assert not torch.equal(runs[0][0], runs[2][0])


def test_kernels_refuse_wrong_dtype_shape_device(cuda):
    qkv, bias, dout = _self_inputs(2, 64, seed=1)
    with pytest.raises(TypeError):
        fid_attention.flash_self_attention(qkv.float(), bias, NH)
    with pytest.raises(TypeError):
        fid_attention.flash_self_attention(qkv, bias.half(), NH)
    with pytest.raises(ValueError):
        fid_attention.flash_self_attention(qkv, bias.cpu(), NH)
    with pytest.raises(ValueError):                      # head_dim 32
        fid_attention.flash_self_attention(qkv, bias, 2 * NH)
    q, kv, kb, _ = _cross_inputs(2, 32, 512, 512, seed=2)
    with pytest.raises(TypeError):
        fid_attention.flash_cross_attention(q.float(), kv, kb, NH, 512)
    with pytest.raises(ValueError):                      # Lk % chunk
        fid_attention.flash_cross_attention(q, kv, kb, NH, 500)
    with pytest.raises(ValueError):                      # Lq > 64
        q2 = torch.zeros(2, 80, NH * 64, device=cuda, dtype=torch.bfloat16)
        fid_attention.flash_cross_attention(q2, kv, kb, NH, 512)
    with pytest.raises(ValueError):
        fid_attention.flash_cross_attention(q, kv.cpu(), kb, NH, 512)
    with pytest.raises(ValueError):                      # dropout, no seed
        fid_attention.flash_cross_attention(q, kv, kb, NH, 512, None, 0.1)


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
    # the dispatch, the CUDA-core kernel forced, and groups of 64 (which
    # only the CUDA-core kernel takes), each against the plain version
    for G, route in ((128, None), (128, "cuda_core"), (64, None)):
        if route is None:
            gv, gi = mips.candidate_scan(q, e, n_valid, G, cands)
        else:
            gv, gi = mips._launch(q, e, n_valid, G, cands, route)
        torch.cuda.synchronize()
        wv, wi = mips.candidate_scan_reference(q, e, n_valid, G, cands)
        if dtype == torch.int8:
            assert torch.equal(gv, wv) and torch.equal(gi, wi)
        else:
            assert ((gv - wv).abs() <= 1e-3 * wv.abs() + 1e-3).all()
            # ids may differ only where two rows' scores are within
            # tolerance
            diff = gi != wi
            assert diff.float().mean().item() < 1e-3


def _scan_inputs(dtype, nq, n, seed, cuda):
    """Queries and rows of 768 values (int8 in [-127, 127], or bf16 from a
    normal), with one group of 128 equal rows (rows 256-383)."""
    g = _gen(seed)
    d = 768
    if dtype == torch.int8:
        q = torch.randint(-127, 128, (nq, d), device=cuda, generator=g,
                          dtype=torch.int8)
        e = torch.randint(-127, 128, (n, d), device=cuda, generator=g,
                          dtype=torch.int8)
    else:
        q = torch.randn(nq, d, device=cuda, generator=g).to(dtype)
        e = torch.randn(n, d, device=cuda, generator=g).to(dtype)
    e[256:384] = e[5]                        # one group of equal rows
    return q, e


def _assert_scan_matches(gv, gi, wv, wi, dtype, groups, cands, n, G=128):
    """A tensor-core scan's output against the plain version's: the tied
    group's lowest rows win, the fully masked last group gives (NEG_INF,
    its first row) twice; int8 equal, bf16 within the candidate
    tolerance."""
    assert (gi[:, 2] == 256).all()
    if cands == 2:
        assert (gi[:, groups + 2] == 257).all()
        assert (gi[:, groups - 1] == n - G).all()
        assert (gi[:, 2 * groups - 1] == n - G).all()
        assert (gv[:, 2 * groups - 1] == mips.NEG_INF).all()
    if dtype == torch.int8:
        assert torch.equal(gv, wv) and torch.equal(gi, wi)
    else:
        assert ((gv - wv).abs() <= 1e-3 * wv.abs() + 1e-3).all()
        assert (gi != wi).float().mean().item() < 1e-3


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("nq", [9, 65, 100, 512, 1031])
@pytest.mark.parametrize("cands", [1, 2])
def test_candidate_scan_tensor_core_matches_plain(cuda, dtype, nq, cands):
    """The tensor-core scan (wgmma, TMA ring) through the dispatch against
    the plain version over 700 groups (a block walks several; int8 above
    128 queries takes 128 queries a block): masked rows (a whole group and
    part of one), a group of 128 equal rows (every query ties across it:
    the lowest rows win), query rows past nq in the last tile; the dispatch
    sends these batches to it and counts the launch, and two launches are
    bit-equal."""
    n, G = 128 * 700, 128
    q, e = _scan_inputs(dtype, nq, n, 1000 + nq, cuda)
    n_valid = n - 200                        # one and a half masked groups
    assert mips.scan_route(nq, G, dtype) == "tensor_core"
    before = (mips.candidate_scan.launches,
              mips.candidate_scan.tensor_core_launches)
    gv, gi = mips.candidate_scan(q, e, n_valid, G, cands)
    torch.cuda.synchronize()
    assert (mips.candidate_scan.launches,
            mips.candidate_scan.tensor_core_launches) == (before[0] + 1,
                                                          before[1] + 1)
    rv, ri = mips.candidate_scan(q, e, n_valid, G, cands)
    assert torch.equal(gv, rv) and torch.equal(gi, ri)
    wv, wi = mips.candidate_scan_reference(q, e, n_valid, G, cands)
    _assert_scan_matches(gv, gi, wv, wi, dtype, n // G, cands, n)


@pytest.mark.parametrize("route", ["cuda_core", "tensor_core"])
def test_candidate_scan_beyond_65535_groups(cuda, route):
    """An int8 index of 66,000 groups of 128 rows (8,448,000 x 768, 6.5 GB):
    more groups than a grid dimension other than x holds. The first and the
    last 1,000 groups, the masked tail among them, against the plain
    version on those rows."""
    g = _gen(11)
    groups, d, nq, G = 66_000, 768, 16, 128
    n = groups * G
    q = torch.randint(-127, 128, (nq, d), device=cuda, generator=g,
                      dtype=torch.int8)
    e = torch.randint(-127, 128, (n, d), device=cuda, generator=g,
                      dtype=torch.int8)
    n_valid = n - 200
    gv, gi = mips._launch(q, e, n_valid, G, 2, route)
    torch.cuda.synchronize()
    for g0 in (0, groups - 1000):
        rows = e[g0 * G:(g0 + 1000) * G]
        wv, wi = mips.candidate_scan_reference(q, rows, n_valid - g0 * G, G,
                                               2)
        cols = torch.cat([torch.arange(g0, g0 + 1000),
                          groups + torch.arange(g0, g0 + 1000)]).to(cuda)
        assert torch.equal(gv[:, cols], wv)
        assert torch.equal(gi[:, cols], wi + g0 * G)
    del e


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_candidate_scan_routes_agree(cuda, dtype):
    """Both kernels forced on the same inputs below the crossover: int8
    equal, bf16 within the candidate tolerance; a group other than 128 is
    refused by the tensor-core route."""
    g = _gen(7)
    n, d, nq = 128 * 40, 768, 8
    if dtype == torch.int8:
        q = torch.randint(-127, 128, (nq, d), device=cuda, generator=g,
                          dtype=torch.int8)
        e = torch.randint(-127, 128, (n, d), device=cuda, generator=g,
                          dtype=torch.int8)
    else:
        q = torch.randn(nq, d, device=cuda, generator=g).to(dtype)
        e = torch.randn(n, d, device=cuda, generator=g).to(dtype)
    cv, ci = mips._launch(q, e, n - 50, 128, 2, "cuda_core")
    tv, ti = mips._launch(q, e, n - 50, 128, 2, "tensor_core")
    if dtype == torch.int8:
        assert torch.equal(cv, tv) and torch.equal(ci, ti)
    else:
        assert ((cv - tv).abs() <= 1e-3 * cv.abs() + 1e-3).all()
    with pytest.raises(ValueError, match="groups of 128"):
        mips._launch(q, e, n, 64, 2, "tensor_core")
    low = mips.TENSOR_CORE_MIN_NQ[dtype]
    if low > 1:
        assert mips.scan_route(low - 1, 128, dtype) == "cuda_core"
    assert mips.scan_route(low, 128, dtype) == "tensor_core"
    assert mips.scan_route(low, 64, dtype) == "cuda_core"


def _bert(cuda, flash=True, dtype=torch.bfloat16, **fields):
    """A BERT encoder with head dim 64 on the card (bf16 unless ``dtype``
    says otherwise), weights from seed 3."""
    import dataclasses

    from emdr2_tpu_torch.config import tiny_config
    from emdr2_tpu_torch.models.bert import BertEncoder
    from emdr2_tpu_torch.models.layers import init_weights

    cfg = dataclasses.replace(
        tiny_config().retriever.encoder, hidden_size=128, num_heads=2,
        ffn_size=256, dtype=dtype, vocab_size=512,
        fid_flash_attention=flash, **fields)
    model = BertEncoder(cfg, device=cuda)
    init_weights(model, _gen(3))
    return model


def _fwd_bwd(model, ids, w):
    out = model(ids)
    (out.float() * w).sum().backward()
    return out, {n: p.grad for n, p in model.named_parameters()}


def test_shared_stack_with_dots_no_batch_on_the_card(cuda):
    """12 layer calls over 6 unique layers (spaced), remat dots_no_batch,
    flash kernels on. Against the same stack without remat: the same
    output and gradients bit for bit (no product is recomputed, attention
    is recomputed by the deterministic kernel), and K1-fwd launched again
    by the recompute. Against 12 unshared layers holding the same weights
    per call: the same output, and each shared gradient the sum of its two
    calls'. Against the plain route (flash off) in fp32: the output and
    every gradient no further from it, on average and at most, than twice
    the plain route's own bf16 distance (a 12-call bf16 stack compounds
    each call's rounding in the deepest layers' gradients, so a fixed
    per-kernel tolerance does not apply)."""
    shared = dict(num_layers=12, num_unique_layers=6,
                  param_sharing_style="spaced")
    kern = _bert(cuda, remat=True, remat_policy="dots_no_batch", **shared)
    assert sum(1 for n, _ in kern.encoder.named_children()
               if n.startswith("layer_")) == 6
    g = _gen(4)
    ids = torch.randint(2, 500, (4, 96), device=cuda, generator=g)
    ids[1, 50:] = 0
    w = torch.randn(4, 96, 128, device=cuda, generator=g) / 384
    fwd0 = fid_attention.flash_self_attention.launches
    bwd0 = fid_attention.flash_self_attention_backward.launches
    out, grads = _fwd_bwd(kern, ids, w)
    torch.cuda.synchronize()
    assert fid_attention.flash_self_attention.launches == fwd0 + 24
    assert fid_attention.flash_self_attention_backward.launches == bwd0 + 12

    stored = _bert(cuda, **shared)
    stored.load_state_dict(kern.state_dict())
    s_out, s_grads = _fwd_bwd(stored, ids, w)
    diffs = {n: (grads[n] - s_grads[n]).abs().max().item() for n in grads}
    assert torch.equal(out, s_out) and max(diffs.values()) == 0.0, diffs

    unshared = _bert(cuda, num_layers=12)
    sd = {}
    for k, v in kern.state_dict().items():
        if k.startswith("encoder.layer_"):
            u, rest = k.split(".", 2)[1:]
            for i in range(12):
                if kern.encoder.unique_index(i) == int(u[len("layer_"):]):
                    sd[f"encoder.layer_{i}.{rest}"] = v
        else:
            sd[k] = v
    unshared.load_state_dict(sd)
    u_out, u_grads = _fwd_bwd(unshared, ids, w)
    assert torch.equal(out, u_out)
    for name, grad in grads.items():
        if name.startswith("encoder.layer_"):
            u, rest = name.split(".", 2)[1:]
            calls = [i for i in range(12)
                     if kern.encoder.unique_index(i) == int(u[len("layer_"):])]
            want = u_grads[f"encoder.layer_{calls[1]}.{rest}"] + \
                u_grads[f"encoder.layer_{calls[0]}.{rest}"]
        else:
            want = u_grads[name]
        assert torch.equal(grad, want), name

    ref = {}
    for dtype in (torch.bfloat16, torch.float32):
        plain = _bert(cuda, flash=False, dtype=dtype, **shared)
        plain.load_state_dict(kern.state_dict())
        ref[dtype] = _fwd_bwd(plain, ids, w)
    (o32, g32), (o16, g16) = ref[torch.float32], ref[torch.bfloat16]

    def no_further(got, bf16, want, what):
        err, own = (got.float() - want).abs(), (bf16.float() - want).abs()
        floor = 1e-6 * want.abs().max().item()
        assert err.mean().item() <= 2 * own.mean().item() + floor, what
        assert err.max().item() <= 2 * own.max().item() + floor, what

    no_further(out, o16, o32, "output")
    for name, grad in grads.items():
        no_further(grad, g16[name], g32[name], name)


def test_dual_encoder_refuses_what_the_kernels_do_not_take(cuda):
    """At construction on the card (fp32 activations, head dim 32), and a
    model built on the CPU and moved to the card at its first forward."""
    import dataclasses

    from emdr2_tpu_torch.config import tiny_config
    from emdr2_tpu_torch.models.bert import DualEncoder

    tiny = tiny_config().retriever
    flash = dataclasses.replace(tiny, encoder=dataclasses.replace(
        tiny.encoder, fid_flash_attention=True))
    with pytest.raises(TypeError, match="bf16"):
        DualEncoder(flash, device=cuda)
    hd32 = dataclasses.replace(flash, encoder=dataclasses.replace(
        flash.encoder, dtype=torch.bfloat16, hidden_size=64, num_heads=2))
    with pytest.raises(ValueError, match="head_dim 64"):
        DualEncoder(hd32, device=cuda)
    DualEncoder(tiny, device=cuda)                      # flash off
    moved = DualEncoder(flash, device="cpu").to(cuda)
    ids = torch.ones(2, 8, dtype=torch.long, device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        moved(ids, ids)


# ---- K4-fwd: the general per-head kernel on strided views of a slab ----

@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,Lq,Lk,chunk", [
    (2, 512, 512, 256),           # the reader encoder under key chunk 256
    (2, 100, 288, 96),            # Lq != Lk, three chunks, ragged tiles
    (1, 70, 192, 64),
    (3, 130, 130, 130),           # one chunk, not a tile multiple
    (2, 256, 1024, 512),          # two chunks of 512
    (1, 200, 128, 64),            # query tiles past Lq, two whole chunks
])
def test_fid_cross_attention_matches_plain(cuda, B, Lq, Lk, chunk, rate):
    g = _gen(Lq + Lk)
    H = NH * 64
    L = max(Lq, Lk)
    slab = torch.randn(B, L, 3 * H, device=cuda, generator=g
                       ).to(torch.bfloat16)
    q = slab[:, :Lq, :H].view(B, Lq, NH, 64)          # views, not copies
    k = slab[:, :Lk, H:2 * H].view(B, Lk, NH, 64)
    v = slab[:, :Lk, 2 * H:].view(B, Lk, NH, 64)
    bias = torch.zeros(B, Lk, device=cuda)
    bias[0, :] = -1e9                                 # a fully masked row
    bias[-1, Lk // 3:] = -1e9
    before = fid_attention.fid_cross_attention.launches
    out, lse = fid_attention.fid_cross_attention_forward(q, k, v, bias, 41,
                                                         chunk, rate)
    torch.cuda.synchronize()
    assert fid_attention.fid_cross_attention.launches == before + 1
    want, want_lse = fid_attention.fid_cross_attention_reference(
        q, k, v, bias, 41, chunk, rate)
    assert out.shape == (B, Lq, NH, 64) and out.is_contiguous()
    _assert_close(out, want)
    assert (lse - want_lse).abs().max().item() <= 1e-3 * want_lse.abs().max()
    again, _ = fid_attention.fid_cross_attention_forward(q, k, v, bias, 41,
                                                         chunk, rate)
    assert torch.equal(again, out)


def _fid_slab_views(B, Lq, Lk, seed):
    """q, k, v as [B, L, NH, 64] views of one qkv slab, a bias whose row 0
    is fully masked, and a non-contiguous cotangent."""
    g = _gen(seed)
    H = NH * 64
    L = max(Lq, Lk)
    slab = torch.randn(B, L, 3 * H, device="cuda", generator=g
                       ).to(torch.bfloat16)
    q = slab[:, :Lq, :H].view(B, Lq, NH, 64)
    k = slab[:, :Lk, H:2 * H].view(B, Lk, NH, 64)
    v = slab[:, :Lk, 2 * H:].view(B, Lk, NH, 64)
    bias = torch.zeros(B, Lk, device="cuda")
    bias[0, :] = -1e9
    bias[-1, Lk // 3:] = -1e9
    dout = torch.randn(B, NH, Lq, 64, device="cuda", generator=g
                       ).to(torch.bfloat16).transpose(1, 2)
    return q, k, v, bias, dout


# ---- K4-bwd: dq, dk, dv from the saved lse ----

@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,Lq,Lk,chunk", [
    (2, 512, 512, 256),           # the reader encoder under key chunk 256
    (2, 100, 288, 96),            # Lq != Lk, three chunks, ragged tiles
    (1, 70, 192, 64),
    (3, 130, 130, 130),           # one chunk, not a tile multiple
    (2, 300, 512, 256),           # keys padded to a chunk multiple
])
def test_fid_cross_attention_backward_matches_plain(cuda, B, Lq, Lk, chunk,
                                                    rate):
    q, k, v, bias, dout = _fid_slab_views(B, Lq, Lk, Lq + Lk)
    out, lse = fid_attention.fid_cross_attention_reference(q, k, v, bias, 41,
                                                           chunk, rate)
    before = fid_attention.fid_cross_attention_backward.launches
    got = fid_attention.fid_cross_attention_backward(
        q, k, v, bias, lse, out, dout, 41, chunk, rate)
    torch.cuda.synchronize()
    assert fid_attention.fid_cross_attention_backward.launches == before + 1
    want = fid_attention.fid_cross_attention_bwd_reference(
        q, k, v, bias, lse, out, dout, 41, chunk, rate)
    for g_, w_, like in zip(got, want, (q, k, v)):
        assert g_.shape == like.shape and g_.is_contiguous()
        _assert_close(g_, w_)
    again = fid_attention.fid_cross_attention_backward(
        q, k, v, bias, lse, out, dout, 41, chunk, rate)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def test_fid_cross_attention_autograd_runs_both_kernels(cuda):
    """Through autograd on views of a slab that requires grad: the slab's
    gradient equals the three kernels' gradients side by side, and a fully
    masked row (P = 1 on every key, as the TPU backward has it) stays
    finite."""
    q, k, v, bias, dout = _fid_slab_views(2, 128, 128, 9)
    H = NH * 64
    slab = torch.cat([t.reshape(2, 128, H) for t in (q, k, v)], dim=-1
                     ).requires_grad_(True)
    qs, ks, vs = (t.view(2, 128, NH, 64) for t in slab.chunk(3, dim=-1))
    counts = (fid_attention.fid_cross_attention.launches,
              fid_attention.fid_cross_attention_backward.launches)
    out = fid_attention.fid_cross_attention(qs, ks, vs, bias, 7, 64, 0.1)
    out.backward(dout)
    assert (fid_attention.fid_cross_attention.launches,
            fid_attention.fid_cross_attention_backward.launches) == (
                counts[0] + 1, counts[1] + 1)
    assert torch.isfinite(slab.grad).all()
    o2, lse = fid_attention.fid_cross_attention_forward(q, k, v, bias, 7, 64,
                                                        0.1)
    want = fid_attention.fid_cross_attention_backward(
        q, k, v, bias, lse, o2, dout, 7, 64, 0.1)
    assert torch.equal(slab.grad, torch.cat(
        [t.reshape(2, 128, H) for t in want], dim=-1))
    # the fully masked row against the plain backward
    plain = fid_attention.fid_cross_attention_bwd_reference(
        q, k, v, bias, lse, o2, dout, 7, 64, 0.1)
    for g_, w_ in zip(want, plain):
        _assert_close(g_[0], w_[0])


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,Lq,Lk,chunk", [
    (2, 128, 128, 64), (2, 100, 288, 96), (3, 130, 130, 130),
    (2, 512, 512, 256), (2, 256, 1024, 512),
])
def test_fid_cross_attention_forward_then_backward_match_plain(cuda, B, Lq,
                                                               Lk, chunk,
                                                               rate):
    """Through the autograd Function: the backward kernels take the forward
    kernel's out and lse, which agree with the plain forward's, and their
    gradients match the plain backward's from the same out and lse."""
    q, k, v, bias, dout = _fid_slab_views(B, Lq, Lk, Lq + Lk + chunk)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    counts = (fid_attention.fid_cross_attention.launches,
              fid_attention.fid_cross_attention_backward.launches)
    out = fid_attention.fid_cross_attention(*leaves, bias, 41, chunk, rate)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (fid_attention.fid_cross_attention.launches,
            fid_attention.fid_cross_attention_backward.launches) == (
                counts[0] + 1, counts[1] + 1)
    w_out, w_lse = fid_attention.fid_cross_attention_reference(
        q, k, v, bias, 41, chunk, rate)
    _assert_close(out.detach(), w_out)
    out2, lse = fid_attention.fid_cross_attention_forward(q, k, v, bias, 41,
                                                          chunk, rate)
    assert torch.equal(out2, out.detach())
    assert (lse - w_lse).abs().max().item() <= 1e-3 * w_lse.abs().max()
    want = fid_attention.fid_cross_attention_bwd_reference(
        q, k, v, bias, lse, out2, dout, 41, chunk, rate)
    for leaf, w_ in zip(leaves, want):
        _assert_close(leaf.grad, w_)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,Lq,Lk,chunk", [
    (2, 512, 512, 256),           # the reader encoder under key chunk 256
    (2, 100, 288, 96),            # Lq != Lk, three ragged chunks
    (2, 300, 512, 256),
])
def test_fid_backward_writes_gradients_through_their_strides(cuda, B, Lq, Lk,
                                                             chunk, rate):
    """dq, dk and dv as column slices of one wider slab: they equal the
    contiguous gradients bit for bit, twice, and no other element of the
    slab (the rows past Lq under dq, a spare column block) is touched."""
    q, k, v, bias, dout = _fid_slab_views(B, Lq, Lk, Lq + Lk + 1)
    out, lse = fid_attention.fid_cross_attention_forward(q, k, v, bias, 41,
                                                         chunk, rate)
    want = fid_attention.fid_cross_attention_backward(
        q, k, v, bias, lse, out, dout, 41, chunk, rate)
    H = NH * 64
    L = max(Lq, Lk)
    slab = torch.full((B, L, 3 * H + 64), 7.0, device=cuda,
                      dtype=torch.bfloat16)
    grads = (slab[:, :Lq, :H].view(B, Lq, NH, 64),
             slab[:, :Lk, H:2 * H].view(B, Lk, NH, 64),
             slab[:, :Lk, 2 * H:3 * H].view(B, Lk, NH, 64))
    for _ in range(2):
        before = fid_attention.fid_cross_attention_backward.launches
        got = fid_attention.fid_cross_attention_backward(
            q, k, v, bias, lse, out, dout, 41, chunk, rate, grads=grads)
        torch.cuda.synchronize()
        assert fid_attention.fid_cross_attention_backward.launches \
            == before + 1
        for g_, w_, view in zip(got, want, grads):
            assert g_.data_ptr() == view.data_ptr()
            assert torch.equal(g_, w_)
        assert bool((slab[:, :, 3 * H:] == 7.0).all())
        assert bool((slab[:, Lq:, :H] == 7.0).all())
        assert bool((slab[:, Lk:, H:3 * H] == 7.0).all())
    with pytest.raises(ValueError):                      # heads not contiguous
        bad = torch.empty(B, NH, Lq, 64, device=cuda, dtype=torch.bfloat16
                          ).transpose(1, 2)
        fid_attention.fid_cross_attention_backward(
            q, k, v, bias, lse, out, dout, 41, chunk, rate,
            grads=(bad, grads[1], grads[2]))


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fid_self_attention_slab_route_equals_three_tensors(cuda, rate):
    """``fid_self_attention`` on the slab: the same two kernels, one
    gradient slab written in place; output and gradient equal the
    three-tensor route's bit for bit; row 0 is fully masked (P = 1)."""
    B, L, chunk = 2, 512, 256
    H = NH * 64
    q, k, v, bias, dout = _fid_slab_views(B, L, L, 21)
    base = torch.cat([t.reshape(B, L, H) for t in (q, k, v)], dim=-1)
    dout = dout.reshape(B, L, H)
    slab = base.clone().requires_grad_(True)
    counts = (fid_attention.fid_cross_attention.launches,
              fid_attention.fid_cross_attention_backward.launches)
    out = fid_attention.fid_self_attention(slab, bias, NH, 7, chunk, rate)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (fid_attention.fid_cross_attention.launches,
            fid_attention.fid_cross_attention_backward.launches) == (
                counts[0] + 1, counts[1] + 1)
    other = base.clone().requires_grad_(True)
    views = [t.view(B, L, NH, 64) for t in other.chunk(3, dim=-1)]
    out3 = fid_attention.fid_cross_attention(*views, bias, 7, chunk, rate)
    out3.backward(dout.view(B, L, NH, 64))
    assert torch.equal(out, out3.reshape(B, L, H))
    assert torch.isfinite(slab.grad).all()
    assert torch.equal(slab.grad, other.grad)
    lse = fid_attention.fid_cross_attention_forward(*views, bias, 7, chunk,
                                                    rate)[1]
    plain = fid_attention.fid_cross_attention_bwd_reference(
        *[t.detach() for t in views], bias, lse, out3.detach(),
        dout.view(B, L, NH, 64), 7, chunk, rate)
    _assert_close(slab.grad, torch.cat([t.reshape(B, L, H) for t in plain],
                                       dim=-1))


def test_fid_cross_attention_refuses_grad_and_bad_inputs(cuda):
    g = _gen(5)
    q = torch.randn(2, 64, NH, 64, device=cuda, generator=g
                    ).to(torch.bfloat16)
    bias = torch.zeros(2, 64, device=cuda)
    with pytest.raises(ValueError):                      # lse of another shape
        fid_attention.fid_cross_attention_backward(
            q, q, q, bias, torch.zeros(2, 64, NH, device=cuda), q, q, None,
            64)
    with pytest.raises(TypeError):
        fid_attention.fid_cross_attention(q.float(), q.float(), q.float(),
                                          bias, None, 64)
    with pytest.raises(ValueError):                      # Lk % chunk
        fid_attention.fid_cross_attention(q, q, q, bias, None, 48)
    with pytest.raises(ValueError):                      # heads not contiguous
        t = q.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
        fid_attention.fid_cross_attention(q, t, q, bias, None, 64)
    with pytest.raises(ValueError):
        fid_attention.fid_cross_attention(q, q, q, bias.cpu(), None, 64)


# ---- K5: decode attention over the int8 slab ----

def _int8_inputs(B, R, Lk, real, seed):
    """Quantized K/V padded from ``real`` to ``Lk`` rows as the decoder
    session pads them (value 0, scale 1, bias -1e9)."""
    g = _gen(seed)
    q = torch.randn(B, R, NH, 64, device="cuda", generator=g
                    ).to(torch.bfloat16)
    kf = torch.randn(B, NH, Lk, 64, device="cuda", generator=g)
    vf = torch.randn(B, NH, Lk, 64, device="cuda", generator=g)
    kf[:, :, real:] = 0
    vf[:, :, real:] = 0
    k8, ks = decode_attention.quantize_kv_rows(kf)
    v8, vs = decode_attention.quantize_kv_rows(vf)
    bias = torch.zeros(B, Lk, device="cuda")
    bias[:, real:] = -1e9
    return q, k8, ks, v8, vs, bias


@pytest.mark.parametrize("B,R,Lk,real", [
    (2, 1, 128, 100),             # one short split
    (2, 3, 256, 256),
    (1, 5, 6400, 6000),           # two chunks of 3,200; a half split last
    (2, 8, 1024, 900),
    (2, 11, 768, 768),            # more rows than one launch takes
])
def test_decode_attention_int8_matches_plain(cuda, B, R, Lk, real):
    q, k8, ks, v8, vs, bias = _int8_inputs(B, R, Lk, real, seed=Lk + R)
    bias[-1, real // 2:] = -1e9                       # a masked tail
    before = decode_attention.decode_cross_attention_int8.launches
    got = decode_attention.decode_cross_attention_int8(q, k8, ks, v8, vs,
                                                       bias)
    torch.cuda.synchronize()
    n = -(-R // decode_attention.MAX_KERNEL_ROWS)
    assert decode_attention.decode_cross_attention_int8.launches == before + n
    want = decode_attention.decode_cross_attention_int8_plain(
        q, k8, ks, v8, vs, bias)
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    _assert_close(got, want)
    _assert_close(got, decode_attention.decode_cross_attention_int8_reference(
        q, k8, ks, v8, vs, bias), rel_max=3e-2)
    again = decode_attention.decode_cross_attention_int8(q, k8, ks, v8, vs,
                                                         bias)
    assert torch.equal(again, got)
    # masked rows poisoned with +-127 change nothing
    k8[-1, :, real // 2:] = 127
    v8[-1, :, real // 2:] = -127
    poisoned = decode_attention.decode_cross_attention_int8(q, k8, ks, v8,
                                                            vs, bias)
    assert torch.equal(poisoned, got)


@pytest.mark.parametrize("stages_per_block", [None, 1, 3])
@pytest.mark.parametrize("B,R,Lk,real", [
    (2, 1, 1000, 900),            # Lk no multiple of the 256-key stage
    (2, 5, 1000, 1000),
    (1, 8, 2100, 2000),
    (2, 1, 100, 80),              # Lk shorter than one stage
    (2, 5, 77, 77),               # ... and odd: scales at any alignment
    (2, 8, 200, 150),
    (8, 5, 25_600, 25_000),       # the decode shape
])
def test_decode_attention_int8_stages_and_blocks(cuda, B, R, Lk, real,
                                                 stages_per_block):
    """Short last stages, runs of one and three stages a block and the
    wrapper's own choice: against the plain version and against the plain
    form of the kernel's own order of sums; a repeat is bit-identical."""
    q, k8, ks, v8, vs, bias = _int8_inputs(B, R, Lk, real, seed=Lk + R)
    bias[-1, real // 2:] = -1e9
    layout = decode_attention.kernel_layout()
    spb, n_blocks = decode_attention.split_plan(B, NH, Lk, q.device,
                                                stages_per_block)
    assert n_blocks == -(-(-(-Lk // layout.stage_keys)) // spb)
    if stages_per_block is None:
        got = decode_attention.decode_cross_attention_int8(q, k8, ks, v8, vs,
                                                           bias)
    else:
        got = decode_attention._launch(q, k8, ks, v8, vs, bias,
                                       plan=(spb, n_blocks))
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    _assert_close(got, decode_attention.decode_cross_attention_int8_plain(
        q, k8, ks, v8, vs, bias))
    _assert_close(
        got, decode_attention.decode_cross_attention_int8_split_reference(
            q, k8, ks, v8, vs, bias, spb, layout.stage_keys, layout.warps))
    again = decode_attention._launch(q, k8, ks, v8, vs, bias,
                                     plan=(spb, n_blocks))
    assert torch.equal(again, got)


def test_decode_attention_int8_fully_masked_example_is_finite(cuda):
    q, k8, ks, v8, vs, bias = _int8_inputs(2, 5, 1024, 1024, seed=3)
    bias[0] = -1e9
    got = decode_attention.decode_cross_attention_int8(q, k8, ks, v8, vs,
                                                       bias)
    want = decode_attention.decode_cross_attention_int8_plain(
        q, k8, ks, v8, vs, bias)
    assert torch.isfinite(got.float()).all()
    _assert_close(got, want)


def test_decode_attention_int8_refuses_wrong_inputs(cuda):
    q, k8, ks, v8, vs, bias = _int8_inputs(2, 1, 256, 256, seed=4)
    with pytest.raises(TypeError):
        decode_attention.decode_cross_attention_int8(q.float(), k8, ks, v8,
                                                     vs, bias)
    with pytest.raises(TypeError):
        decode_attention.decode_cross_attention_int8(q, k8.float(), ks, v8,
                                                     vs, bias)
    with pytest.raises(ValueError):
        decode_attention.decode_cross_attention_int8(q, k8.cpu(), ks, v8, vs,
                                                     bias)
    with pytest.raises(ValueError):                      # Lk % key_chunk
        decode_attention.decode_cross_attention_int8(q, k8, ks, v8, vs, bias,
                                                     key_chunk=100)
    with pytest.raises(ValueError):                      # not contiguous
        decode_attention.decode_cross_attention_int8(
            q, k8.transpose(2, 3).contiguous().transpose(2, 3), ks, v8, vs,
            bias)


# ---- the evidence index on the card: the swap, the builder, the refresher

def test_index_swap_outlives_a_search_on_another_stream(cuda):
    """Fault C4: a search queued on a reader stream behind a long kernel
    still reads the rows it snapshotted after ``update`` (on the writer
    stream that made them) has dropped them and new tensors were allocated
    over their memory: its ids are those of a search on the old index."""
    from emdr2_tpu_torch.config import IndexConfig
    from emdr2_tpu_torch.retrieval.index import ShardedEvidenceIndex

    g = _gen(21)
    n, d = 65_536, 768
    writer, reader = torch.cuda.Stream(), torch.cuda.Stream()

    def swap_and_overwrite(rows):
        index.update(rows)
        return [torch.full((n, d), 127, dtype=torch.int8, device=cuda)
                for _ in range(64)]

    with torch.cuda.stream(writer):
        old = torch.randn(n, d, device=cuda, generator=g)
        new = -old
        index = ShardedEvidenceIndex(IndexConfig(quantize="int8"), old,
                                     device=cuda)
        q = torch.randn(8, d, device=cuda, generator=g)
        # rehearse the section below once: a kernel's first launch (module
        # loading) and a fresh cudaMalloc both wait for the whole device,
        # which would let the sleeping search finish and hide the fault
        torch.empty(4 << 30, dtype=torch.int8, device=cuda)
        with torch.cuda.stream(reader):
            torch.cuda._sleep(1000)
            index.search(q, k=50)
        swap_and_overwrite(new)
        index.update(old)
        want = index.search(q, k=50)[1].clone()
    torch.cuda.synchronize()
    with torch.cuda.stream(reader):
        torch.cuda._sleep(1_000_000_000)             # ~0.5 s of cycles
        got = index.search(q, k=50)[1]
    with torch.cuda.stream(writer):
        over = swap_and_overwrite(new)  # as many blocks as the cache holds
    assert not reader.query(), "the search ran before the update: no test"
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert not torch.equal(index.search(q, k=50)[1], want)
    del over


def _card_cfg(flash=True):
    """A two-layer BERT-shaped configuration at head dim 64 in bf16 (what
    the kernels take), contexts of 64 tokens, a bf16 index of 128-d rows."""
    import dataclasses

    from emdr2_tpu_torch.config import (tiny_config, with_flash_attention,
                                        with_transformers)

    hd64 = {"hidden_size": 128, "num_heads": 2, "dtype": torch.bfloat16,
            "fid_flash_attention": flash}
    cfg = with_transformers(tiny_config(), hd64, hd64)
    return cfg.replace(
        retriever=dataclasses.replace(cfg.retriever, embed_dim=128,
                                      seq_len=64),
        index=dataclasses.replace(cfg.index, embed_dim=128, group_size=128,
                                  dtype=torch.bfloat16))


def _card_world(tmp_path, cuda, n_docs):
    """``_card_cfg()``, a corpus of ``n_docs`` passages, a model from a
    seed on the card and a builder at batch 128."""
    import numpy as np

    from emdr2_tpu_torch.data.evidence import EvidenceCorpus
    from emdr2_tpu_torch.data.indexed_dataset import MMapIndexedDatasetBuilder
    from emdr2_tpu_torch.models.emdr2 import EMDR2Model
    from emdr2_tpu_torch.retrieval.builder import EvidenceIndexBuilder

    cfg = _card_cfg()
    rng = np.random.RandomState(0)
    for name, lo, hi in (("title", 1, 4), ("text", 20, 70)):
        with MMapIndexedDatasetBuilder(str(tmp_path / name)) as b:
            for _ in range(n_docs):
                b.add_item(rng.randint(5, 500, size=rng.randint(lo, hi))
                           .tolist())
    corpus = EvidenceCorpus.load(str(tmp_path / "text"),
                                 str(tmp_path / "title"))
    model = EMDR2Model(cfg, device=cuda, generator=_gen(5))
    return cfg, corpus, model, EvidenceIndexBuilder(
        cfg, model, corpus, 101, 102, 0, batch_size=128)


def test_builder_rows_on_the_card_match_the_plain_route(cuda, tmp_path):
    """The builder's rows through the flash self-attention kernel, by the
    host and the device path, against the same weights with plain
    attention on the card (bf16 tolerance)."""
    from emdr2_tpu_torch.models.emdr2 import EMDR2Model
    from emdr2_tpu_torch.retrieval.builder import EvidenceIndexBuilder

    cfg, corpus, model, builder = _card_world(tmp_path, cuda, 300)
    plain = EMDR2Model(_card_cfg(flash=False), device=cuda)
    plain.load_state_dict(model.state_dict())
    fid_attention.flash_self_attention.launches = 0
    host = builder.embed_corpus()
    assert fid_attention.flash_self_attention.launches == 3 * 2   # 3 batches
    dev = builder.embed_corpus_device(None, 384)
    want = EvidenceIndexBuilder(cfg, plain, corpus, 101, 102, 0,
                                batch_size=128).embed_corpus()
    assert dev.dtype == torch.bfloat16 and tuple(dev.shape) == (384, 128)
    _assert_close(torch.from_numpy(host).float(),
                  torch.from_numpy(want).float())
    _assert_close(dev[:300].float().cpu(), torch.from_numpy(host).float())


@pytest.mark.parametrize("zero_copy", [False, True])
def test_refresher_snapshot_unchanged_by_a_step_during_an_embed(
        cuda, tmp_path, zero_copy):
    """An optimizer step on the live tower while the embedder runs does
    not reach the pass in flight: the swapped rows are those of the
    weights handed over at ``start``."""
    import copy

    from emdr2_tpu_torch.config import IndexConfig
    from emdr2_tpu_torch.retrieval.builder import context_tower
    from emdr2_tpu_torch.retrieval.index import ShardedEvidenceIndex
    from emdr2_tpu_torch.training.async_refresh import AsyncIndexRefresher

    cfg, corpus, model, builder = _card_world(tmp_path, cuda, 4096)
    index = ShardedEvidenceIndex(
        IndexConfig(embed_dim=128, dtype=torch.bfloat16),
        torch.zeros(4096, 128), device=cuda)
    tower = context_tower(model)
    handed = copy.deepcopy(tower)
    r = AsyncIndexRefresher(builder, index, reload_interval=1,
                            zero_copy=zero_copy)
    r.start(model)
    opt = torch.optim.SGD(tower.parameters(), lr=1.0)
    for p in tower.parameters():
        p.grad = torch.ones_like(p)
    opt.step()                                     # in place, mid-pass
    assert r.wait_for_result(timeout=300)
    (snapshot,) = r._snapshot                      # one copy, one device
    for a, b in zip(snapshot.parameters(), handed.parameters()):
        assert torch.equal(a, b)
    assert r.maybe_swap(1, model)
    r.stop()
    assert r.error is None and not r._thread.is_alive()
    want = torch.from_numpy(builder.embed_corpus(handed)).float()
    _assert_close(index.embeddings[:4096].float().cpu(), want)
    # the fresh weights were published at the swap
    for a, b in zip(snapshot.parameters(), tower.parameters()):
        assert torch.equal(a, b)


# ---- the embedder on a card of its own ----------------------------------

@pytest.fixture
def two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: an embedder card beside the "
                    "trainer's")
    return torch.device("cuda", 0), torch.device("cuda", 1)


def test_kernels_launch_on_the_tensors_card_from_another_threads_device(
        two_cards):
    """A thread whose current device is card 0 launches K1 and K3 on
    tensors of card 1 (an embedder thread beside its process's trainer):
    each wrapper launches on the tensors' card, and the results equal the
    plain versions there; K1's count by card names card 1."""
    import threading

    _, card1 = two_cards
    g = torch.Generator(device=card1)
    g.manual_seed(11)
    qkv = torch.randn(4, 256, 3 * NH * 64, device=card1, generator=g
                      ).to(torch.bfloat16)
    bias = torch.zeros(4, 256, device=card1)
    bias[-1, 100:] = -1e9
    q = torch.randint(-127, 128, (8, 768), device=card1, generator=g,
                      dtype=torch.int8)
    e = torch.randint(-127, 128, (128 * 64, 768), device=card1, generator=g,
                      dtype=torch.int8)
    fid_attention.flash_self_attention.launches_by_shape = {}
    out = {}

    def run():
        torch.cuda.set_device(0)
        assert torch.cuda.current_device() == 0
        out["k1"] = fid_attention.flash_self_attention(qkv, bias, NH)
        out["k3"] = mips.candidate_scan(q, e, e.shape[0], 128, 2)
        torch.cuda.synchronize(card1)

    t = threading.Thread(target=run)
    t.start()
    t.join(120)
    assert not t.is_alive() and set(out) == {"k1", "k3"}
    want = fid_attention.flash_self_attention_reference(qkv, bias, NH)
    assert out["k1"].device == card1
    _assert_close(out["k1"], want)
    wv, wi = mips.candidate_scan_reference(q, e, e.shape[0], 128, 2)
    assert torch.equal(out["k3"][0], wv) and torch.equal(out["k3"][1], wi)
    assert fid_attention.flash_self_attention.launches_by_shape == {
        ("cuda:1", 4, 256): 1}


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_refresh_on_an_embedder_card_swaps_in_the_hand_off_rows(
        two_cards, tmp_path, quantize):
    """The index on card 0, the builder's copy of the tower on card 1: the
    asynchronous refresher (zero-copy by default there) embeds on card 1
    only, quantizes there, and the swap copies the block card to card: the
    index then holds what ``_to_device`` makes of the same rows, bit for
    bit, and the rows are the hand-off tower's (bf16 tolerance)."""
    import dataclasses

    from emdr2_tpu_torch.retrieval.builder import (EvidenceIndexBuilder,
                                                   context_tower)
    from emdr2_tpu_torch.retrieval.index import ShardedEvidenceIndex
    from emdr2_tpu_torch.training.async_refresh import AsyncIndexRefresher

    card0, card1 = two_cards
    cfg, corpus, model, _ = _card_world(tmp_path, card0, 1000)
    icfg = dataclasses.replace(cfg.index, quantize=quantize)
    builder = EvidenceIndexBuilder(cfg, model, corpus, 101, 102, 0,
                                   batch_size=128, devices=[card1])
    index = ShardedEvidenceIndex(icfg, torch.zeros(1000, 128), device=card0)
    r = AsyncIndexRefresher(builder, index, reload_interval=1)
    assert r.zero_copy
    fid_attention.flash_self_attention.launches_by_shape = {}
    r.start(model)
    assert r.wait_for_result(timeout=300)
    assert r.maybe_swap(1, model)
    r.stop()
    assert r.error is None
    assert index.embeddings.device == card0
    assert {k[0] for k in fid_attention.flash_self_attention
            .launches_by_shape} == {"cuda:1"}
    rows = builder.embed_corpus_device(None, row_partition=(0, 1024))
    assert rows.device == card1
    want = ShardedEvidenceIndex(icfg, torch.zeros(1000, 128), device=card0)
    want.update(rows.to(card0))
    assert torch.equal(index.embeddings, want.embeddings)
    if quantize == "int8":
        assert torch.equal(index.scales, want.scales)
    host = torch.from_numpy(builder.embed_corpus(context_tower(model)))
    host = host.float()
    if quantize == "none":
        _assert_close(index.embeddings[:1000].float().cpu(), host)
    else:
        # one int8 step of the row's group, plus the bf16 tolerance
        step = index.scales.repeat_interleave(128)[:1000, None].cpu()
        got = index.embeddings[:1000].float().cpu() * step
        assert ((got - host).abs() <= step + 2e-2 * host.abs().max()).all()


# ---- one step repeats bit for bit (C5), and the one-rank NCCL search ----

def _dropout_card_cfg():
    from emdr2_tpu_torch.config import with_transformers
    drop = {"hidden_dropout": 0.1, "attention_dropout": 0.1}
    return with_transformers(_card_cfg(), drop, drop)


def _first_difference_text(result):
    if result["first_difference"] is None:
        return "equal"
    i, a, b = result["first_difference"]
    return f"{result['differing']} entries differ; first at {i}: {a} vs {b}"


def test_dpr_step_repeats_bit_for_bit(cuda):
    """``DPRTask.train_step`` run twice from one saved state on the card:
    every module output, every incoming and parameter gradient, the
    metrics and the updated parameters are equal bit for bit. The context
    tower looks its 2-row tokentype table up 16,384 times (the lookup whose
    CUDA backward did not repeat)."""
    import numpy as np

    from emdr2_tpu_torch.config import OptimizerConfig
    from emdr2_tpu_torch.tasks.dense_retriever import DPRBatch, DPRTask
    from emdr2_tpu_torch.utils.repeat import repeat_step

    rc = _dropout_card_cfg().retriever
    B, Lq, Lc = 128, 32, 64
    rng = np.random.RandomState(0)
    q = rng.randint(5, 500, size=(B, Lq)).astype(np.int32)
    c = rng.randint(5, 500, size=(2 * B, Lc)).astype(np.int32)
    types = np.zeros_like(c)
    types[:, Lc // 4:] = 1
    batch = DPRBatch(q, np.zeros_like(q), c, types,
                     labels=np.arange(B, dtype=np.int32))
    task = DPRTask(rc, OptimizerConfig(lr=1e-3, warmup=0.0),
                   total_train_iters=10, device=cuda)
    task.init_state(3)
    task.train_step(batch)
    for _ in range(2):
        result = repeat_step(task, batch)
        assert result["equal"], _first_difference_text(result)
        a, b = result["metrics"]
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_openqa_step_repeats_bit_for_bit(cuda, tmp_path):
    """``E2EQATask.train_step`` (retrieval, the three towers, the reader
    and the teacher, dropout 0.1) run twice from one saved state on the
    card: equal bit for bit, gradients and parameters included."""
    import numpy as np

    from emdr2_tpu_torch.data.qa_dataset import OpenQADataset
    from emdr2_tpu_torch.data.tokenizer import (BertWordPieceTokenizer,
                                                toy_vocab)
    from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex
    from emdr2_tpu_torch.tasks import E2EQATask
    from emdr2_tpu_torch.utils.repeat import repeat_step

    cfg, corpus, _, _ = _card_world(tmp_path, cuda, 300)
    cfg = cfg.replace(retriever=_dropout_card_cfg().retriever,
                      reader=_dropout_card_cfg().reader)
    tok = BertWordPieceTokenizer(
        toy_vocab(["what", "is", "the", "color", "of", "item"]
                  + [f"w{i}" for i in range(300)]), vocab_extra_ids=10)
    qa = tmp_path / "qa.tsv"
    qa.write_text("".join(f"what is the color of item w{i}\t['w{3 * i}']\n"
                          for i in range(8)))
    ds = OpenQADataset([str(qa)], tok, cfg.retriever.query_seq_len,
                       cfg.reader.decoder_seq_len)
    emb = torch.randn(len(corpus), 128, device=cuda, generator=_gen(9))
    index = ShardedEvidenceIndex(cfg.index, emb, device=cuda)
    task = E2EQATask(cfg, tok, corpus, index, total_train_iters=10,
                     device=cuda)
    task.init_state(4)
    batches = list(ds.epoch_batches(4, seed=0))
    task.train_step(batches[0])
    result = repeat_step(task, batches[1])
    assert result["equal"], _first_difference_text(result)


def test_sharded_search_over_one_rank_nccl_equals_mips_topk(cuda, tmp_path):
    """``sharded_mips_topk`` over a one-rank NCCL group (the collectives
    run, the merge sorts the candidates stably) returns ``mips_topk``'s
    values and rows bit for bit, in bf16 and in int8."""
    from emdr2_tpu_torch.parallel import DataParallel
    from emdr2_tpu_torch.parallel import distributed as dist_lib

    dist_lib.init_process_group(f"file://{tmp_path / 'store'}", 1, 0,
                                "nccl", timeout_s=60, device=cuda)
    try:
        dp = DataParallel.from_process_group()
        g = _gen(11)
        rows = torch.randn(40_960, 256, device=cuda, generator=g)
        for nq in (8, 64):
            q = torch.randn(nq, 256, device=cuda, generator=g)
            bf16 = rows.to(torch.bfloat16)
            want = mips.mips_topk(q.to(torch.bfloat16), bf16, 20)
            got = mips.sharded_mips_topk(q.to(torch.bfloat16), bf16, 20, dp,
                                         n_real=40_960)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
            q8, scales = mips.quantize_int8(rows, 128)
            want = mips.mips_topk(q, q8, 20, shard_scales=scales)
            got = mips.sharded_mips_topk(q, q8, 20, dp, n_real=40_960,
                                         local_scales=scales)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
        assert dp.bytes_moved["all_gather"] > 0
    finally:
        dist_lib.shutdown()



@pytest.mark.parametrize("k", [20, 51])
def test_mips_topk_without_rescore_matches_plain(cuda, k):
    """``rescore=0`` on the card (the K3 scan, the scales on its winners,
    no re-rank) against the plain path on the CPU: the same approximate
    int8 scores, integer sums scaled in the same order, within 3 fp32 eps
    (a query's scale, ``max|q| / 127``, may differ in its last bit: on the
    card PyTorch divides by a Python number as a product with its
    reciprocal); the same rows, but where two score within that of
    the k-th score (``torch.topk`` orders such ties as it likes)."""
    g = _gen(31)
    n_valid = 131_072 - 300
    rows = torch.randn(131_072, 768, device=cuda, generator=g)
    rows[n_valid:] = 0.0
    q8, scales = mips.quantize_int8(rows, 128)
    q = torch.randn(64, 768, device=cuda, generator=g)
    got = mips.mips_topk(q, q8, k, n_valid=n_valid, shard_scales=scales,
                         rescore=0)
    want = mips.mips_topk(q.cpu(), q8.cpu(), k, n_valid=n_valid,
                          shard_scales=scales.cpu(), rescore=0)
    tol = 3 * torch.finfo(torch.float32).eps
    torch.testing.assert_close(got[0].cpu().sort(dim=1).values,
                               want[0].sort(dim=1).values, rtol=tol, atol=0)
    for r in range(q.shape[0]):
        g_ids = dict(zip(got[1][r].tolist(), got[0][r].tolist()))
        w_ids = dict(zip(want[1][r].tolist(), want[0][r].tolist()))
        kth = min(w_ids.values())
        for a, b in ((g_ids, w_ids), (w_ids, g_ids)):
            assert all(abs(v - kth) <= tol * abs(kth)
                       for i, v in a.items() if i not in b), (
                r, sorted(set(a) - set(b)), kth)
    # without the re-rank the scores are not the rows' exact products
    exact = torch.einsum("qd,qkd->qk", q.double(), mips.dequantize_int8(
        q8, scales, 128)[got[1]].double())
    assert (got[0].double() - exact).abs().max().item() > 1e-4

# ---- tensor parallelism: the kernels on a tp rank's heads ----

TP_NH = 6                         # a tp=2 rank's heads of the flagship 12


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_self_attention_on_a_tp_ranks_six_heads(cuda, rate):
    """K1 forward and backward on a [B, L, 3H/2] slab of 6 heads (what a
    rank at --tp 2 runs), against the plain versions."""
    g = _gen(61)
    H = TP_NH * 64
    qkv = torch.randn(4, 512, 3 * H, device=cuda, generator=g
                      ).to(torch.bfloat16)
    bias = torch.zeros(4, 512, device=cuda)
    bias[-1, 300:] = -1e9
    dout = torch.randn(4, 512, H, device=cuda, generator=g
                       ).to(torch.bfloat16)
    x = qkv.clone().requires_grad_(True)
    out = fid_attention.flash_self_attention(x, bias, TP_NH, 13, rate)
    out.backward(dout)
    _assert_close(out.detach(), fid_attention.flash_self_attention_reference(
        qkv, bias, TP_NH, 13, rate))
    _assert_close(x.grad, fid_attention.flash_self_attention_bwd_reference(
        qkv, bias, out.detach(), dout, TP_NH, 13, rate))


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_cross_attention_on_a_tp_ranks_six_heads(cuda, rate):
    """K2 forward and backward on q [B, 32, H/2] over kv [B, Lk, 2H/2] of
    6 heads (the reader's FiD cross-attention on a rank at --tp 2)."""
    g = _gen(62)
    H = TP_NH * 64
    q = torch.randn(2, 32, H, device=cuda, generator=g).to(torch.bfloat16)
    kv = torch.randn(2, 6144, 2 * H, device=cuda, generator=g
                     ).to(torch.bfloat16)
    bias = torch.zeros(2, 6144, device=cuda)
    bias[:, 5000:] = -1e9
    dout = torch.randn(2, 32, H, device=cuda, generator=g).to(torch.bfloat16)
    out, lse = fid_attention.flash_cross_attention_forward(
        q, kv, bias, TP_NH, 512, 17, rate)
    want, wlse = fid_attention.flash_cross_attention_reference(
        q, kv, bias, TP_NH, 512, 17, rate)
    _assert_close(out, want)
    assert (lse - wlse).abs().max().item() <= 1e-3
    dq, dkv = fid_attention.flash_cross_attention_backward(
        q, kv, bias, lse, out, dout, TP_NH, 512, 17, rate)
    wq, wkv = fid_attention.flash_cross_attention_bwd_reference(
        q, kv, bias, lse, out, dout, TP_NH, 512, 17, rate)
    _assert_close(dq, wq)
    _assert_close(dkv, wkv)


def test_decode_attention_int8_on_a_tp_ranks_six_heads(cuda):
    """K5 over int8 K/V of 6 heads at the decode shape (evaluate_em on a
    rank at --tp 2)."""
    g = _gen(63)
    q = torch.randn(8, 5, TP_NH, 64, device=cuda, generator=g
                    ).to(torch.bfloat16)
    kf = torch.randn(8, TP_NH, 25_600, 64, device=cuda, generator=g)
    vf = torch.randn(8, TP_NH, 25_600, 64, device=cuda, generator=g)
    k8, ks = decode_attention.quantize_kv_rows(kf)
    v8, vs = decode_attention.quantize_kv_rows(vf)
    bias = torch.zeros(8, 25_600, device=cuda)
    bias[:, 25_000:] = -1e9
    got = decode_attention.decode_cross_attention_int8(q, k8, ks, v8, vs,
                                                       bias)
    _assert_close(got, decode_attention.decode_cross_attention_int8_plain(
        q, k8, ks, v8, vs, bias))


def _tp_openqa_step(root, dev, dp=None):
    """One OPENQA step at dropout 0 from seed 4 on ``dev`` over a
    ``_card_world`` of 300 passages, split over ``dp.tp``: (loss, global
    gradient norm, the whole parameters on the host)."""
    import pathlib

    from emdr2_tpu_torch.data.qa_dataset import OpenQADataset
    from emdr2_tpu_torch.data.tokenizer import (BertWordPieceTokenizer,
                                                toy_vocab)
    from emdr2_tpu_torch.parallel.tensor import all_gather_params
    from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex
    from emdr2_tpu_torch.tasks import E2EQATask

    root = pathlib.Path(root)
    root.mkdir(parents=True, exist_ok=True)
    cfg, corpus, _, _ = _card_world(root, dev, 300)
    tok = BertWordPieceTokenizer(
        toy_vocab(["what", "is", "the", "color", "of", "item"]
                  + [f"w{i}" for i in range(300)]), vocab_extra_ids=10)
    qa = root / "qa.tsv"
    qa.write_text("".join(f"what is the color of item w{i}\t['w{3 * i}']\n"
                          for i in range(8)))
    ds = OpenQADataset([str(qa)], tok, cfg.retriever.query_seq_len,
                       cfg.reader.decoder_seq_len)
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    emb = torch.randn(len(corpus), 128, device=dev, generator=g)
    index = ShardedEvidenceIndex(cfg.index, emb, device=dev, dp=dp)
    task = E2EQATask(cfg, tok, corpus, index, total_train_iters=10,
                     device=dev, dp=dp)
    task.init_state(4)
    m = task.train_step(next(ds.epoch_batches(4, seed=0)))
    whole = all_gather_params(task.state.model.state_dict(),
                              dp.tp if dp is not None else None)
    return (float(m["loss"]), float(m["grad_norm"]),
            {k: v.cpu() for k, v in whole.items()})


_TP_RANK = r"""
import importlib.util
import os
import sys
import torch
sys.path.insert(0, sys.argv[5])
from emdr2_tpu_torch.parallel import DataParallel
from emdr2_tpu_torch.parallel import distributed as dist_lib
# this file by its path: a ``tests`` package installed elsewhere would
# shadow the repository's directory of that name
spec = importlib.util.spec_from_file_location(
    "gpu_tests", os.path.join(sys.argv[5], "tests", "test_torch_gpu.py"))
gpu_tests = importlib.util.module_from_spec(spec)
spec.loader.exec_module(gpu_tests)
_tp_openqa_step = gpu_tests._tp_openqa_step
rank = int(sys.argv[1])
dev = torch.device("cuda", rank)
torch.backends.cuda.matmul.allow_tf32 = False
dist_lib.init_process_group(sys.argv[2], 2, rank, "nccl", timeout_s=120,
                            device=dev)
try:
    dp = DataParallel.from_process_group(tp=2)
    torch.save(_tp_openqa_step(sys.argv[3] + str(rank), dev, dp),
               sys.argv[4] + str(rank) + ".pt")
finally:
    dist_lib.shutdown()
"""


def test_tp2_openqa_step_on_two_cards_equals_one_card(two_cards, tmp_path):
    """One OPENQA step at --tp 2 over NCCL, rank r on card r (each on its
    half of the heads, MLP columns and vocabulary, the index's rows over
    both), against one card from the same seed: the loss and the global
    gradient norm within 1e-2 (bf16, another order of sums); the gathered
    parameters bit-equal on both ranks and within 1e-4 of the one card's
    (the parts of one initialization, then one AdamW step of at most the
    learning rate 2e-5 a parameter from gradients summed in another
    order; a part cut from the wrong columns would be off by the init's
    0.02)."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "rank.py"
    script.write_text(_TP_RANK)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r),
         f"file://{tmp_path / 'store'}", str(tmp_path / "world"),
         str(tmp_path / "out"), repo], cwd=repo,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    got = [torch.load(tmp_path / f"out{r}.pt", weights_only=False)
           for r in range(2)]
    loss, norm, params = _tp_openqa_step(tmp_path / "one", two_cards[0])
    assert all(torch.equal(got[0][2][k], got[1][2][k]) for k in params)
    for g_loss, g_norm, g_params in got:
        assert abs(g_loss - loss) <= 1e-2 * abs(loss)
        assert abs(g_norm - norm) <= 1e-2 * abs(norm)
        for k in params:
            assert (g_params[k] - params[k]).abs().max().item() <= 1e-4, k
