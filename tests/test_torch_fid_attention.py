"""The port's flash self-attention (plain versions, CPU) against the JAX
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


# ---- K1 with dropout and its backward, against the JAX kernels' VJP ----

@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("L,nh", [(16, 2), (48, 4)])
def test_forward_and_backward_match_jax_vjp(L, nh, rate):
    """The plain forward and the plain backward (through autograd) against
    ``jax.vjp`` of the Pallas kernel in interpret mode, masked keys and a
    fully padded row included; dropout with the same seed."""
    import jax

    qkv, bias = make_inputs(3, L, nh, seed=7 * L + nh)
    g = np.random.RandomState(L).randn(3, L, nh * 8).astype(np.float32)
    seed = 2 ** 31 + 5

    def f(x):
        return jax_flash_self_attention(x, jnp.asarray(bias), jnp.uint32(seed),
                                        nh, True, rate)

    want, vjp = jax.vjp(f, jnp.asarray(qkv))
    (want_dqkv,) = vjp(jnp.asarray(g))
    x = torch.tensor(qkv, requires_grad=True)
    got = flash_self_attention(x, torch.as_tensor(bias), nh, seed, rate)
    got.backward(torch.as_tensor(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_dqkv),
                               atol=1e-5, rtol=1e-4)


def test_dropout_changes_output_and_needs_a_seed():
    qkv, bias = make_inputs(2, 16, 2)
    x, b = torch.as_tensor(qkv), torch.as_tensor(bias)
    plain = flash_self_attention(x, b, 2)
    assert torch.equal(plain, flash_self_attention(x, b, 2, 3, 0.0))
    assert not torch.equal(plain, flash_self_attention(x, b, 2, 3, 0.2))
    with pytest.raises(ValueError):
        flash_self_attention(x, b, 2, None, 0.2)


# ---- K4: the general per-head kernel's plain version against the JAX ----
# ---- kernel (interpret mode): out and lse, chunked keys, dropout      ----

def make_heads(B, Lq, Lk, nh, hd=8, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Lq, nh, hd).astype(np.float32)
    k = rng.randn(B, Lk, nh, hd).astype(np.float32)
    v = rng.randn(B, Lk, nh, hd).astype(np.float32)
    bias = np.zeros((B, Lk), np.float32)
    for b in range(1, B):
        bias[b, rng.randint(1, Lk + 1):] = -1e9
    bias[0, :] = -1e9                                   # a fully masked row
    return q, k, v, bias


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Lq,Lk,chunk", [(16, 32, 16), (24, 48, 16),
                                         (8, 24, 8), (32, 32, 32)])
def test_fid_reference_matches_jax_kernel(Lq, Lk, chunk, rate):
    """Lq != Lk, one, two and three chunks; at rate 0.1 both sides draw the
    keep mask from the same seed."""
    from emdr2_tpu.ops.fid_attention import _fid_fwd

    q, k, v, bias = make_heads(3, Lq, Lk, 2, seed=Lq + Lk)
    seed = 2 ** 31 + 11
    want, res = _fid_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
        jnp.uint32(seed), chunk, None, rate)
    want_lse = res[-1]                                  # [B*nh, Lq, 1]
    args = [torch.as_tensor(a) for a in (q, k, v, bias)]
    got, lse = fid_attention.fid_cross_attention_forward(*args, seed, chunk,
                                                         rate)
    assert got.shape == (3, Lq, 2, 8) and lse.shape == (3 * 2, Lq, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(want_lse).reshape(lse.shape),
                               atol=1e-5, rtol=1e-5)
    assert torch.equal(got, fid_attention.fid_cross_attention(
        *args, seed, chunk, rate))
    if rate:
        plain = fid_attention.fid_cross_attention(*args, None, chunk, 0.0)
        assert not torch.equal(plain, got)


def test_fid_cpu_runs_plain_version_and_checks_inputs():
    q, k, v, bias = (torch.as_tensor(a) for a in make_heads(2, 8, 16, 2))
    before = fid_attention.fid_cross_attention.launches
    got = fid_attention.fid_cross_attention(q, k, v, bias, None, 8)
    assert fid_attention.fid_cross_attention.launches == before
    want, _ = fid_attention.fid_cross_attention_reference(q, k, v, bias,
                                                          None, 8)
    assert torch.equal(got, want)
    # on the CPU the plain version carries gradients
    qg = q.clone().requires_grad_(True)
    fid_attention.fid_cross_attention(qg, k, v, bias, None, 8).sum().backward()
    assert qg.grad is not None and torch.isfinite(qg.grad).all()
    with pytest.raises(ValueError):                      # Lk % key_chunk
        fid_attention.fid_cross_attention(q, k, v, bias, None, 12)
    with pytest.raises(ValueError):
        fid_attention.fid_cross_attention(q, k, v, bias[:, :-1], None, 8)
    with pytest.raises(ValueError):
        fid_attention.fid_cross_attention(q[0], k, v, bias, None, 8)
    with pytest.raises(ValueError):                      # rate without seed
        fid_attention.fid_cross_attention(q, k, v, bias, None, 8, 0.1)
    meta = [t.to("meta") for t in (q, k, v, bias)]
    with pytest.raises(ValueError):                      # neither CPU nor CUDA
        fid_attention.fid_cross_attention(*meta, None, 8)


# ---- K4 backward: the plain version (and the autograd Function over it) ----
# ---- against jax.vjp of the Pallas kernel in interpret mode             ----

def _jax_fid_vjp(q, k, v, bias, seed, chunk, rate, g):
    import jax
    from emdr2_tpu.ops.fid_attention import (
        fid_cross_attention as jax_fid_cross_attention)

    def f(q_, k_, v_):
        return jax_fid_cross_attention(q_, k_, v_, jnp.asarray(bias),
                                       jnp.uint32(seed), chunk, True, rate)

    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return out, vjp(jnp.asarray(g).astype(out.dtype))


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("Lq,Lk,chunk", [(16, 32, 16), (24, 48, 16),
                                         (8, 24, 8), (32, 32, 32)])
def test_fid_backward_matches_jax_vjp(Lq, Lk, chunk, rate):
    """One, two and three chunks, Lq != Lk, masked keys and a fully masked
    row; at rate 0.3 both sides regenerate the keep mask from the same
    seed. fp32 on both sides: atol 1e-5, rtol 1e-4."""
    q, k, v, bias = make_heads(3, Lq, Lk, 2, seed=3 * Lq + Lk)
    g = np.random.RandomState(Lq).randn(3, Lq, 2, 8).astype(np.float32)
    seed = 2 ** 31 + 17
    want, (want_dq, want_dk, want_dv) = _jax_fid_vjp(q, k, v, bias, seed,
                                                     chunk, rate, g)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    got = fid_attention.fid_cross_attention(tq, tk, tv, torch.as_tensor(bias),
                                            seed, chunk, rate)
    got.backward(torch.as_tensor(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-4)
    for t, w in ((tq, want_dq), (tk, want_dk), (tv, want_dv)):
        assert t.grad.shape == t.shape and torch.isfinite(t.grad).all()
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=1e-5, rtol=1e-4)


def test_fid_backward_padded_keys_match_jax_vjp():
    """Lk = 40 is no chunk multiple: keys padded to 48 at -1e9 bias as the
    encoder layer pads them; autograd slices the gradients back."""
    Lq, Lk, chunk, pad = 40, 40, 16, 8
    q, k, v, bias = make_heads(2, Lq, Lk, 2, seed=4)
    g = np.random.RandomState(1).randn(2, Lq, 2, 8).astype(np.float32)
    widths = ((0, 0), (0, pad), (0, 0), (0, 0))
    bias_p = np.pad(bias, ((0, 0), (0, pad)), constant_values=-1e9)
    _, want = _jax_fid_vjp(q, np.pad(k, widths), np.pad(v, widths), bias_p,
                           5, chunk, 0.2, g)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    F = torch.nn.functional
    out = fid_attention.fid_cross_attention(
        tq, F.pad(tk, (0, 0, 0, 0, 0, pad)), F.pad(tv, (0, 0, 0, 0, 0, pad)),
        torch.as_tensor(bias_p), 5, chunk, 0.2)
    out.backward(torch.as_tensor(g))
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(want[0]),
                               atol=1e-5, rtol=1e-4)
    for t, w in ((tk, want[1]), (tv, want[2])):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w)[:, :Lk],
                                   atol=1e-5, rtol=1e-4)


def test_fid_backward_bf16_follows_jax_vjp():
    """bf16 inputs: both sides round q, k, v, out and the cotangent to bf16
    and the gradients to bf16 at the end; one bf16 ulp of the largest
    gradient (2^-7 of it) plus the rounding of out that feeds delta."""
    q, k, v, bias = make_heads(2, 16, 32, 2, seed=8)
    g = np.random.RandomState(2).randn(2, 16, 2, 8).astype(np.float32)
    bf = jnp.bfloat16
    _, want = _jax_fid_vjp(jnp.asarray(q, bf), jnp.asarray(k, bf),
                           jnp.asarray(v, bf), bias, 3, 16, 0.0, g)
    tq, tk, tv = (torch.tensor(a).to(torch.bfloat16).requires_grad_(True)
                  for a in (q, k, v))
    out = fid_attention.fid_cross_attention(tq, tk, tv, torch.as_tensor(bias),
                                            3, 16, 0.0)
    out.backward(torch.as_tensor(g).to(torch.bfloat16))
    for t, w in zip((tq, tk, tv), want):
        assert t.grad.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(t.grad.float().numpy(), w,
                                   atol=2 ** -6 * np.abs(w).max(), rtol=0)


def test_fid_backward_fully_masked_row_is_finite_with_unit_probs():
    """A row whose every key is masked has lse equal to its scores, so the
    backward's P is 1 on every key (the TPU kernel's behaviour): dv of that
    row is the column sum of do."""
    q, k, v, bias = (torch.as_tensor(a) for a in make_heads(2, 8, 16, 2))
    out, lse = fid_attention.fid_cross_attention_forward(q, k, v, bias, None,
                                                         8)
    do = torch.ones_like(out)
    dq, dk, dv = fid_attention.fid_cross_attention_backward(
        q, k, v, bias, lse, out, do, None, 8)
    for t in (dq, dk, dv):
        assert torch.isfinite(t).all()
    assert torch.allclose(dv[0], torch.full_like(dv[0], 8.0))
    before = fid_attention.fid_cross_attention_backward.launches
    fid_attention.fid_cross_attention_backward(q, k, v, bias, lse, out, do,
                                               None, 8)
    assert fid_attention.fid_cross_attention_backward.launches == before
    with pytest.raises(ValueError):                      # lse of another shape
        fid_attention.fid_cross_attention_backward(
            q, k, v, bias, lse[:, :4], out, do, None, 8)


# ---- K4 on the slab itself: one gradient slab, no concatenation ----

@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fid_self_attention_slab_gradient_matches_jax_and_three_tensors(rate):
    """The slab route (``fid_self_attention``: L a multiple of the chunk,
    two chunks, row 0 fully masked so P = 1 there) against (a) jax.vjp of
    the Pallas kernel in interpret mode on the slab's column slices and (b)
    the port's three-tensor route on views of the same slab. fp32 on both
    sides, the same keep mask from the same seed: atol 1e-5, rtol 1e-4."""
    B, L, nh, hd, chunk, seed = 3, 32, 2, 8, 16, 2 ** 31 + 23
    H = nh * hd
    qkv, bias = make_inputs(B, L, nh, hd, seed=17)
    g = np.random.RandomState(3).randn(B, L, H).astype(np.float32)
    q, k, v = (qkv[..., i * H:(i + 1) * H].reshape(B, L, nh, hd)
               for i in range(3))
    want_out, want = _jax_fid_vjp(q, k, v, bias, seed, chunk, rate,
                                  g.reshape(B, L, nh, hd))
    want = np.concatenate([np.asarray(w).reshape(B, L, H) for w in want], -1)

    slab = torch.tensor(qkv, requires_grad=True)
    out = fid_attention.fid_self_attention(slab, torch.as_tensor(bias), nh,
                                           seed, chunk, rate)
    assert out.shape == (B, L, H)
    out.backward(torch.as_tensor(g))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(want_out).reshape(B, L, H),
                               atol=1e-5, rtol=1e-4)
    assert slab.grad.shape == slab.shape and torch.isfinite(slab.grad).all()
    np.testing.assert_allclose(slab.grad.numpy(), want, atol=1e-5, rtol=1e-4)

    other = torch.tensor(qkv, requires_grad=True)
    views = [t.view(B, L, nh, hd) for t in other.chunk(3, dim=-1)]
    out3 = fid_attention.fid_cross_attention(*views, torch.as_tensor(bias),
                                             seed, chunk, rate)
    out3.backward(torch.as_tensor(g).view(B, L, nh, hd))
    assert torch.equal(out3.reshape(B, L, H), out)
    np.testing.assert_allclose(slab.grad.numpy(), other.grad.numpy(),
                               atol=1e-5, rtol=0)
    # no gradient asked for: the forward alone, the same output
    with torch.no_grad():
        assert torch.equal(fid_attention.fid_self_attention(
            slab, torch.as_tensor(bias), nh, seed, chunk, rate), out)


def test_fid_backward_writes_only_the_given_gradient_slices():
    """``grads`` as the column slices of one slab: the backward fills them
    and they equal the three separate gradients; a tensor of another shape
    is refused."""
    B, L, nh, hd, chunk = 2, 16, 2, 8, 8
    H = nh * hd
    qkv, bias = make_inputs(B, L, nh, hd, seed=2)
    slab, bias = torch.as_tensor(qkv), torch.as_tensor(bias)
    q, k, v = fid_attention._slab_heads(slab, nh)
    out, lse = fid_attention.fid_cross_attention_forward(q, k, v, bias, 9,
                                                         chunk, 0.1)
    do = torch.as_tensor(np.random.RandomState(5).randn(*out.shape)
                         .astype(np.float32))
    want = fid_attention.fid_cross_attention_backward(q, k, v, bias, lse, out,
                                                      do, 9, chunk, 0.1)
    dqkv = torch.full_like(slab, float("nan"))
    got = fid_attention.fid_cross_attention_backward(
        q, k, v, bias, lse, out, do, 9, chunk, 0.1,
        grads=fid_attention._slab_heads(dqkv, nh))
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)
    assert torch.equal(dqkv, torch.cat([w.reshape(B, L, H) for w in want], -1))
    with pytest.raises(ValueError):
        fid_attention.fid_cross_attention_backward(
            q, k, v, bias, lse, out, do, 9, chunk, 0.1,
            grads=(want[0], want[1][:, :8], want[2]))


@pytest.mark.parametrize("L,slab_route", [(32, True), (40, False)])
def test_encoder_layer_routes_by_chunk_multiple(L, slab_route, monkeypatch):
    """``Attention.encode`` under a key chunk shorter than the row: the slab
    route when the chunk divides the length, the three-tensor route with
    padded keys when it does not; both give the materialized attention's
    output and input gradient (fp32: atol 1e-5)."""
    from emdr2_tpu_torch.config import TransformerConfig
    from emdr2_tpu_torch.models import layers

    calls = []
    for name in ("fid_self_attention", "fid_cross_attention"):
        fn = getattr(layers, name)
        monkeypatch.setattr(layers, name, lambda *a, _f=fn, _n=name, **kw: (
            calls.append(_n), _f(*a, **kw))[1])
    kw = dict(hidden_size=16, num_heads=2, num_layers=1, ffn_size=32,
              vocab_size=32, max_position_embeddings=64, dtype=torch.float32,
              hidden_dropout=0.0, attention_dropout=0.0)
    flash = TransformerConfig(fid_flash_attention=True, flash_key_chunk=16,
                              **kw)
    plain = TransformerConfig(fid_flash_attention=False, **kw)
    gen = torch.Generator().manual_seed(0)
    att = layers.Attention(flash, device="cpu")
    for prm in att.parameters():
        prm.data = torch.randn(prm.shape, generator=gen) * 0.3
    ref = layers.Attention(plain, device="cpu")
    ref.load_state_dict(att.state_dict())
    rng = np.random.RandomState(L)
    x = rng.randn(2, L, 16).astype(np.float32)
    bias = np.zeros((2, L), np.float32)
    bias[1, L - 5:] = -1e9
    grads = []
    for module in (att, ref):
        xt = torch.tensor(x, requires_grad=True)
        out = module.encode(xt, torch.as_tensor(bias))
        out.square().sum().backward()
        grads.append((out.detach(), xt.grad))
    assert calls == ["fid_self_attention" if slab_route
                     else "fid_cross_attention"]
    np.testing.assert_allclose(grads[0][0].numpy(), grads[1][0].numpy(),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(grads[0][1].numpy(), grads[1][1].numpy(),
                               atol=1e-5, rtol=1e-4)


# ------------------------- the row statistics (rowmax, 1/l) of the forward

def _numpy_stats(qkv, bias, nh):
    """(rowmax, l) [B, nh, L] in float64, scores as the kernels form them:
    fp32 ``s * scale + bias``."""
    B, L, H3 = qkv.shape
    hd = H3 // 3 // nh
    x = qkv.reshape(B, L, 3, nh, hd)
    q = x[:, :, 0].transpose(0, 2, 1, 3).astype(np.float64)
    k = x[:, :, 1].transpose(0, 2, 1, 3).astype(np.float64)
    s = (q @ k.transpose(0, 1, 3, 2) * hd ** -0.5).astype(np.float32)
    s = (s + bias[:, None, None, :]).astype(np.float64)
    m = s.max(axis=-1)
    return m, np.exp(s - m[..., None]).sum(axis=-1)


@pytest.mark.parametrize("L,nh", [(16, 2), (48, 4), (100, 2)])
def test_stats_reference_matches_float64(L, nh):
    """``flash_self_attention_stats_reference`` against float64 numpy,
    tolerance 1e-5 (fp32 sums of at most 100 terms in [0, 1]); row 0 is
    fully padded: its rowmax is its scores (about -1e9) and 1/l = 1/L."""
    qkv, bias = make_inputs(3, L, nh, seed=L)
    got = fid_attention.flash_self_attention_stats_reference(
        torch.as_tensor(qkv), torch.as_tensor(bias), nh).numpy()
    m, l = _numpy_stats(qkv, bias, nh)
    assert got.shape == (3, nh, 2, L) and got.dtype == np.float32
    np.testing.assert_allclose(got[1:, :, 0], m[1:], atol=1e-5)
    np.testing.assert_allclose(got[:, :, 1], 1.0 / l, rtol=1e-5, atol=1e-5)
    assert (got[0, :, 0] < -9e8).all()
    np.testing.assert_allclose(got[0, :, 1], 1.0 / L, rtol=1e-6)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("L,nh", [(16, 2), (48, 4)])
def test_stats_rebuild_the_backward(L, nh, rate):
    """The statistics are what the backward needs: P rebuilt as
    ``exp(s - rowmax) * (1/l)`` gives the gradients of
    ``flash_self_attention_bwd_reference`` (which the test above holds
    against the JAX VJP), a fully padded row included."""
    qkv_np, bias_np = make_inputs(3, L, nh, seed=L + 7)
    rng = np.random.RandomState(L)
    qkv, bias = torch.as_tensor(qkv_np), torch.as_tensor(bias_np)
    dout = torch.as_tensor(rng.randn(3, L, nh * 8).astype(np.float32))
    seed = 21 if rate else None
    out = flash_self_attention_reference(qkv, bias, nh, seed, rate)
    want = fid_attention.flash_self_attention_bwd_reference(
        qkv, bias, out, dout, nh, seed, rate)

    stats = fid_attention.flash_self_attention_stats_reference(qkv, bias, nh)
    B, hd, H = 3, 8, nh * 8
    heads = qkv.view(B, L, 3, nh, hd).permute(2, 0, 3, 1, 4)
    q, k, v = heads[0], heads[1], heads[2]
    do = dout.view(B, L, nh, hd).permute(0, 2, 1, 3)
    o = out.view(B, L, nh, hd).permute(0, 2, 1, 3)
    s = q @ k.transpose(-1, -2) * hd ** -0.5 + bias[:, None, None, :]
    P = torch.exp(s - stats[:, :, 0, :, None]) * stats[:, :, 1, :, None]
    np.testing.assert_allclose(P.sum(-1).numpy(), 1.0, atol=1e-5)
    dp = do @ v.transpose(-1, -2)
    Pd = P
    if rate:
        keep = fid_attention.keep_mask(seed, fid_attention._bh(B, nh, "cpu"),
                                       rate, L, L)
        dp = torch.where(keep, dp, torch.zeros(())) / (1.0 - rate)
        Pd = torch.where(keep, P, torch.zeros(())) / (1.0 - rate)
    ds = P * (dp - (do * o).sum(-1, keepdim=True))
    got = torch.stack([ds @ k * hd ** -0.5,
                       ds.transpose(-1, -2) @ q * hd ** -0.5,
                       Pd.transpose(-1, -2) @ do])
    got = got.permute(1, 3, 0, 2, 4).reshape(B, L, 3 * H)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-4)


# ----------------------------------- what the kernels take, stated once

@pytest.mark.parametrize("dtype,head_dim,decoder_len,flash,word", [
    (torch.bfloat16, 64, None, True, None),
    (torch.bfloat16, 64, 32, True, None),
    (torch.bfloat16, 64, 64, True, None),
    (torch.float32, 64, 32, True, "bf16"),
    (torch.float16, 64, None, True, "bf16"),
    (torch.bfloat16, 32, 32, True, "head_dim 64"),
    (torch.bfloat16, 128, None, True, "head_dim 64"),
    (torch.bfloat16, 64, 65, True, "at most 64 decoder positions"),
    (torch.float32, 16, 100, False, None),     # no kernel on the path
])
def test_kernel_limits_names_the_limit(dtype, head_dim, decoder_len, flash,
                                       word):
    reason = fid_attention.kernel_limits(dtype, head_dim, decoder_len, flash)
    if word is None:
        assert reason is None
        fid_attention.check_kernel_limits("x", dtype, head_dim, decoder_len,
                                          flash)
    else:
        assert word in reason
        err = TypeError if dtype != torch.bfloat16 else ValueError
        with pytest.raises(err, match=word):
            fid_attention.check_kernel_limits("x", dtype, head_dim,
                                              decoder_len, flash)


def test_kernel_limits_bind_no_cpu_path():
    """On the CPU the plain versions run whatever the limits say: fp32, head
    dim 8 (every parity test here), and a model outside them constructs."""
    from emdr2_tpu_torch.config import tiny_config, with_flash_attention
    from emdr2_tpu_torch.models import EMDR2Model
    cfg = with_flash_attention(tiny_config())
    enc = cfg.reader.transformer
    assert fid_attention.kernel_limits(enc.dtype, enc.head_dim,
                                       cfg.reader.decoder_seq_len,
                                       enc.fid_flash_attention) is not None
    EMDR2Model(cfg, device="cpu")
