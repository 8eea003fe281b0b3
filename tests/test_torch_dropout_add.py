"""The dropout-add wrapper (``ops/dropout_add.py``) on the CPU: its route
equals ``r + packed_dropout(...)`` bit for bit (``packed_dropout`` is held
to the JAX package in ``test_torch_hashing.py``), evaluation is the plain
add, bad inputs raise, and the autograd Function's launches are counted
and save no tensor. The kernel itself is held to the plain path on the
card (``test_torch_gpu.py -k dropout_add``)."""

import pytest

torch = pytest.importorskip("torch")

from emdr2_tpu_torch.ops import build, dropout_add as da  # noqa: E402
from emdr2_tpu_torch.ops.hashing import packed_dropout  # noqa: E402


def _inputs(shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    y = torch.randn(shape, generator=g).to(dtype)
    r = torch.randn(shape, generator=g).to(dtype)
    return y, r


@pytest.mark.parametrize("shape", [(33,), (7, 40), (3, 5, 33), (2, 4, 6, 8)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("seed,row_offset,head_offset",
                         [(0, 0, 0), (2 ** 31 + 11, 3, 5)])
def test_cpu_route_equals_the_plain_path(shape, dtype, seed, row_offset,
                                         head_offset):
    y, r = _inputs(shape, dtype)
    for rate in (0.1, 0.5):
        d = packed_dropout(y, rate, seed, row_offset, head_offset)
        assert torch.equal(da.dropout_add(y, r, rate, seed, row_offset,
                                          head_offset), r + d)
        assert torch.equal(da.dropout_add(y, None, rate, seed, row_offset,
                                          head_offset), d)
        # the gradient in y is the rule over the incoming gradient, the
        # pass the kernel's backward makes on the card
        leaf = y.clone().requires_grad_()
        g = torch.randn(shape).to(dtype)
        (dy,) = torch.autograd.grad(
            da.dropout_add(leaf, r, rate, seed, row_offset, head_offset),
            leaf, g)
        assert torch.equal(dy, packed_dropout(g, rate, seed, row_offset,
                                              head_offset))


def test_evaluation_is_the_plain_add():
    y, r = _inputs((2, 3, 8), torch.float32)
    for seed, rate in ((None, 0.1), (17, 0.0)):
        assert da.dropout_add(y, None, rate, seed) is y
        assert torch.equal(da.dropout_add(y, r, rate, seed), r + y)
    # evaluation checks nothing: the add broadcasts as it did
    assert torch.equal(da.dropout_add(y, r[0], 0.1, None), r[0] + y)


def test_bad_inputs_raise():
    y, r = _inputs((2, 3, 4, 5, 6), torch.float32)
    with pytest.raises(ValueError, match="rank 1 to 4"):
        da.dropout_add(y, r, 0.1, 3)
    with pytest.raises(ValueError, match="rank 1 to 4"):
        da.dropout_add(torch.tensor(1.0), None, 0.1, 3)
    y, r = _inputs((2, 3, 4), torch.float32)
    with pytest.raises(ValueError, match="shape"):
        da.dropout_add(y, r[:, :2], 0.1, 3)
    with pytest.raises(ValueError, match="shape"):
        da.dropout_add(y, r[0], 0.1, 3)
    with pytest.raises(ValueError, match="on meta"):
        da.dropout_add(y, r.to("meta"), 0.1, 3)
    with pytest.raises(ValueError, match="outside"):
        da.dropout_add(y, r, 1.0, 3)
    with pytest.raises(ValueError, match="outside"):
        da.dropout_add(y, r, 1e-12, 3)


def test_cuda_checks_refuse_what_the_kernel_does_not_take():
    """The checks a CUDA tensor meets before the launch, on CPU tensors."""
    y, r = _inputs((2, 3, 4), torch.float32)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        da._check_cuda(y.half(), None)
    with pytest.raises(TypeError, match="one dtype"):
        da._check_cuda(y, r.to(torch.bfloat16))
    with pytest.raises(ValueError, match="below 2"):
        da._check_cuda(torch.empty(2 ** 31, 0), None)
    da._check_cuda(y, r)
    da._check_cuda(y.to(torch.bfloat16), r.to(torch.bfloat16))


def test_scale_is_rounded_to_the_dtype_as_the_plain_path_rounds_it():
    t = da._threshold(0.1)
    assert t == round(0.1 * 2 ** 32)
    ones = torch.ones(4096, dtype=torch.bfloat16)
    kept = packed_dropout(ones, 0.1, 5)
    assert da._scale(t, torch.bfloat16) == kept.max().item()
    assert da._scale(t, torch.float32) == packed_dropout(
        ones.float(), 0.1, 5).max().item()


@pytest.fixture
def fake_launch(monkeypatch):
    """``build.launch`` recording its arguments instead of launching, and
    the counters at zero."""
    calls = []
    monkeypatch.setattr(build, "launch",
                        lambda entry, what, device, *args:
                        calls.append((entry, what, args)))
    monkeypatch.setattr(da, "_stream", lambda t: 0)
    for fn in (da.dropout_add, da.dropout_add_backward):
        for name in ("launches", "elements", "bytes"):
            monkeypatch.setattr(fn, name, 0)
    return calls


@pytest.mark.parametrize("shape,e1,e2", [((33,), 1, 1), ((7, 40), 1, 7),
                                         ((3, 5, 33), 3, 5),
                                         ((2, 4, 6, 8), 4, 6)])
def test_launch_passes_the_tensors_axes_and_the_sites_scalars(
        fake_launch, shape, e1, e2):
    y, r = _inputs(shape, torch.bfloat16)
    t = da._threshold(0.1)
    site = (2 ** 32 - 5, t, da._scale(t, torch.bfloat16), 3, 2 ** 32 - 1)
    da._launch(y, r, site, da.dropout_add)
    entry, what, args = fake_launch[-1]
    assert entry == "emdr2_dropout_add_bf16" and what == "dropout_add"
    n = y.numel()
    assert args[3:] == (n, len(shape), e1, e2, shape[-1], 3, 2 ** 32 - 1,
                        2 ** 32 - 5, t, site[2], 0)
    assert args[0] == y.data_ptr() and args[1] == r.data_ptr()
    da._launch(y.float(), None, site, da.dropout_add_backward)
    entry, what, args = fake_launch[-1]
    assert entry == "emdr2_dropout_add_f32" and args[1] is None
    assert (da.dropout_add.launches, da.dropout_add.elements,
            da.dropout_add.bytes) == (1, n, 3 * 2 * n)
    assert (da.dropout_add_backward.launches,
            da.dropout_add_backward.elements,
            da.dropout_add_backward.bytes) == (1, n, 2 * 4 * n)


@pytest.mark.parametrize("residual", [True, False])
def test_function_saves_no_tensor_and_passes_the_residual_gradient(
        fake_launch, residual):
    """The Function (run on CPU tensors with the launch recorded, not made)
    saves nothing for the backward; its backward launches once for ``y``
    and hands the incoming gradient to the residual as it is."""
    y, r = _inputs((2, 3, 8), torch.bfloat16)
    y.requires_grad_(True)
    r.requires_grad_(True)
    t = da._threshold(0.1)
    site = (7, t, da._scale(t, torch.bfloat16), 0, 0)
    packed = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda x: packed.append(x) or x, lambda x: x):
        out = da._DropoutAdd.apply(y, r if residual else None, site)
    assert packed == []
    g = torch.randn(out.shape).to(out.dtype)
    out.backward(g)
    assert da.dropout_add.launches == 1
    assert da.dropout_add_backward.launches == 1
    assert y.grad is not None and y.grad.shape == y.shape
    if residual:
        assert torch.equal(r.grad, g)
    else:
        assert r.grad is None
    y.grad = None
    out = da._DropoutAdd.apply(y.detach(), r if residual else None, site)
    if residual:
        out.backward(g)                       # y needs no gradient
        assert da.dropout_add_backward.launches == 1
