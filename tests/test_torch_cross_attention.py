"""K2: the port's flash cross-attention (plain versions, CPU) against the
JAX Pallas kernel ``flash_cross_attention`` run in interpret mode: output,
lse, dq and dkv (the JAX dkv arrives in [B, Lk, 2H] after its own swap),
with one and several key chunks, a padded key tail, and dropout; and the
key split of the CUDA kernels (forward: partials per run of whole chunks,
combined in split order; backward: the runs' dq partials summed in run
order) against the unsplit plain versions and the JAX VJP.

Tolerance: both sides compute in fp32 and differ only in summation order:
atol 1e-5, rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from emdr2_tpu.ops.fid_attention import (  # noqa: E402
    _xslab_forward,
    flash_cross_attention as jax_flash_cross_attention,
)
from emdr2_tpu_torch.ops import fid_attention  # noqa: E402
from emdr2_tpu_torch.ops.fid_attention import (  # noqa: E402
    flash_cross_attention,
    flash_cross_attention_bwd_reference,
    flash_cross_attention_bwd_split_reference,
    flash_cross_attention_forward,
    flash_cross_attention_reference,
    flash_cross_attention_split_reference,
)

torch.set_num_threads(2)

SEED = 4242


def make_inputs(B, Lq, Lk, nh, real, hd=8, seed=0):
    """q, kv, a key bias with the keys past ``real`` padded (the layer pads
    Lk to a chunk multiple at -1e9), a shorter row, and an upstream grad."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Lq, nh * hd).astype(np.float32)
    kv = rng.randn(B, Lk, 2 * nh * hd).astype(np.float32)
    bias = np.zeros((B, Lk), np.float32)
    bias[:, real:] = -1e9
    bias[-1, real // 2:] = -1e9
    g = rng.randn(B, Lq, nh * hd).astype(np.float32)
    return q, kv, bias, g


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("Lk,chunk,real", [(40, 40, 40), (48, 16, 37),
                                           (64, 32, 64)])
def test_forward_lse_and_grads_match_jax(Lk, chunk, real, rate):
    nh = 2
    q, kv, bias, g = make_inputs(3, 5, Lk, nh, real, seed=Lk + chunk)

    def f(a, b):
        return jax_flash_cross_attention(a, b, jnp.asarray(bias),
                                         jnp.uint32(SEED), nh, chunk, True,
                                         rate)

    want, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(kv))
    want_dq, want_dkv = vjp(jnp.asarray(g))
    _, want_lse = _xslab_forward(jnp.asarray(q), jnp.asarray(kv),
                                 jnp.asarray(bias),
                                 jnp.asarray([SEED], jnp.uint32), nh, chunk,
                                 True, rate)

    a = torch.tensor(q, requires_grad=True)
    b = torch.tensor(kv, requires_grad=True)
    got = flash_cross_attention(a, b, torch.as_tensor(bias), nh, chunk, SEED,
                                rate)
    got.backward(torch.as_tensor(g))
    _, lse = flash_cross_attention_forward(
        torch.as_tensor(q), torch.as_tensor(kv), torch.as_tensor(bias), nh,
        chunk, SEED, rate)
    tol = dict(atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **tol)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(want_dq), **tol)
    assert b.grad.shape == kv.shape                  # [B, Lk, 2H]
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(want_dkv), **tol)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("n_splits", [1, 2, 3, 7])
def test_split_and_combine_equals_unsplit_walk(n_splits, rate):
    """Seven chunks of 16 keys dealt to 1, 2, 3 (3 + 3 + 1) and 7 splits:
    keys past 40 are padding, so whole splits hold padding only, and row 0
    is padded throughout. fp32 on both sides, another summation order:
    atol = rtol = 1e-5."""
    nh, chunk = 2, 16
    q, kv, bias, _ = make_inputs(3, 5, 7 * chunk, nh, real=40, seed=n_splits)
    bias[0] = -1e9
    q, kv, bias = (torch.as_tensor(x) for x in (q, kv, bias))
    want, want_lse = flash_cross_attention_reference(q, kv, bias, nh, chunk,
                                                     SEED, rate)
    got, lse = flash_cross_attention_split_reference(q, kv, bias, nh, chunk,
                                                     n_splits, SEED, rate)
    assert torch.isfinite(got).all() and torch.isfinite(lse).all()
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), **tol)
    assert lse[0].max().item() < -9e8                 # the padded row's lse


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("n_splits", [1, 2, 3, 7])
def test_backward_runs_equal_unsplit_backward_and_jax(n_splits, rate):
    """The backward kernel's run sums: seven chunks of 16 keys dealt to 1,
    2, 3 (3 + 3 + 1) and 7 runs; keys past 37 are padding (a ragged chunk,
    then whole runs of padding), row 0 is padded throughout (P = 1 from its
    lse) and row 2 from key 18. dq and dkv of the plain run-split backward
    against the unsplit plain backward and the JAX VJP (interpret mode).
    fp32 on every side, another summation order: atol = rtol = 1e-5."""
    nh, chunk = 2, 16
    q, kv, bias, g = make_inputs(3, 5, 7 * chunk, nh, real=37,
                                 seed=10 + n_splits)
    bias[0] = -1e9

    def f(a, b):
        return jax_flash_cross_attention(a, b, jnp.asarray(bias),
                                         jnp.uint32(SEED), nh, chunk, True,
                                         rate)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(kv))
    want_dq, want_dkv = vjp(jnp.asarray(g))

    q, kv, bias, g = (torch.as_tensor(x) for x in (q, kv, bias, g))
    out, lse = flash_cross_attention_reference(q, kv, bias, nh, chunk, SEED,
                                               rate)
    args = (q, kv, bias, lse, out, g, nh, chunk)
    plain_dq, plain_dkv = flash_cross_attention_bwd_reference(*args, SEED,
                                                              rate)
    dq, dkv = flash_cross_attention_bwd_split_reference(*args, n_splits, SEED,
                                                        rate)
    assert torch.isfinite(dq).all() and torch.isfinite(dkv).all()
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(dq.numpy(), plain_dq.numpy(), **tol)
    assert torch.equal(dkv, plain_dkv)               # dk, dv: no sum over runs
    np.testing.assert_allclose(dq.numpy(), np.asarray(want_dq), **tol)
    np.testing.assert_allclose(dkv.numpy(), np.asarray(want_dkv), **tol)
    # padded keys of the rows with a live key get exactly zero dk and dv;
    # the fully padded row's keys do not (P = 1 on every key)
    assert (dkv[1, 37:] == 0).all() and (dkv[2, 18:] == 0).all()
    assert (dkv[0] != 0).any()


def test_backward_runs_are_dealt_as_the_forward_splits():
    """One chunk a run and one run for everything give the unsplit sums
    exactly; a run count above the chunks is cut to one chunk a run."""
    nh, chunk = 2, 16
    q, kv, bias, g = (torch.as_tensor(x) for x in
                      make_inputs(2, 4, 3 * chunk, nh, real=40, seed=5))
    out, lse = flash_cross_attention_reference(q, kv, bias, nh, chunk)
    args = (q, kv, bias, lse, out, g, nh, chunk)
    plain = flash_cross_attention_bwd_reference(*args)
    for n in (1, 3, 50):
        got = flash_cross_attention_bwd_split_reference(*args, n)
        assert torch.equal(got[1], plain[1])
        if n == 1:
            assert torch.equal(got[0], plain[0])
    assert torch.equal(flash_cross_attention_bwd_split_reference(*args, 3)[0],
                       flash_cross_attention_bwd_split_reference(*args, 50)[0])


def test_split_counts_leave_no_split_empty():
    assert fid_attention._split_chunks(7, 3) == (3, 3)
    assert fid_attention._split_chunks(7, 5) == (4, 2)     # 2 + 2 + 2 + 1
    assert fid_attention._split_chunks(7, 50) == (7, 1)
    assert fid_attention._split_chunks(1, 4) == (1, 1)
    assert fid_attention._split_chunks(100, 11) == (10, 10)
    with pytest.raises(ValueError):
        fid_attention._split_chunks(7, 0)


def test_cpu_runs_plain_version_without_counting():
    q, kv, bias, g = make_inputs(2, 4, 32, 2, 20)
    before = (fid_attention.flash_cross_attention.launches,
              fid_attention.flash_cross_attention_backward.launches)
    a = torch.tensor(q, requires_grad=True)
    flash_cross_attention(a, torch.as_tensor(kv), torch.as_tensor(bias), 2,
                          16).sum().backward()
    assert (fid_attention.flash_cross_attention.launches,
            fid_attention.flash_cross_attention_backward.launches) == before


def test_rejects_bad_shapes_and_foreign_devices():
    q, kv, bias, _ = make_inputs(2, 4, 32, 2, 20)
    q, kv, bias = (torch.as_tensor(x) for x in (q, kv, bias))
    with pytest.raises(ValueError):                  # Lk % key_chunk
        flash_cross_attention(q, kv, bias, 2, 24)
    with pytest.raises(ValueError):                  # kv width
        flash_cross_attention(q, kv[..., :16], bias, 2, 16)
    with pytest.raises(ValueError):
        flash_cross_attention(q, kv, bias[:, :16], 2, 16)
    with pytest.raises(ValueError):                  # dropout without seed
        flash_cross_attention(q, kv, bias, 2, 16, None, 0.1)
    with pytest.raises(ValueError):
        flash_cross_attention(q.to("meta"), kv.to("meta"), bias.to("meta"),
                              2, 16)
