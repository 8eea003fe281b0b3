"""The LayerNorm wrapper (``ops/layer_norm.py``) on the CPU: its route is the
model's old formula bit for bit, output and gradients; bad inputs raise;
the launches' arguments, grid and counted bytes; the autograd Function
saves x and the weight alone. The kernels themselves are held to the
formula on the card (``test_torch_gpu.py -k layer_norm``)."""

import pytest

torch = pytest.importorskip("torch")

from emdr2_tpu_torch.models.layers import LayerNorm  # noqa: E402
from emdr2_tpu_torch.ops import build, layer_norm as ln  # noqa: E402


def _old_forward(x, weight, bias, eps):
    """``LayerNorm.forward`` as the model ran it before the kernels."""
    orig = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    return (y * weight + bias).to(orig)


def _inputs(shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    h = shape[-1]
    x = (3.0 * torch.randn(shape, generator=g) + 0.5).to(dtype)
    w = 1.0 + 0.1 * torch.randn(h, generator=g)
    b = 0.1 * torch.randn(h, generator=g)
    dy = torch.randn(shape, generator=g).to(dtype)
    return x, w, b, dy


def _grads(fn, x, w, b, dy, eps):
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    out = fn(*leaves, eps)
    out.backward(dy)
    return [out.detach()] + [t.grad for t in leaves]


@pytest.mark.parametrize("shape", [(16,), (7, 64), (3, 5, 768), (2, 3, 4, 32)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("eps", [1e-5, 1e-12])
def test_cpu_route_is_the_old_formula_bit_for_bit(shape, dtype, eps):
    x, w, b, dy = _inputs(shape, dtype)
    got = _grads(ln.layer_norm, x, w, b, dy, eps)
    want = _grads(_old_forward, x, w, b, dy, eps)
    assert got[0].dtype == dtype and got[1].dtype == dtype
    for a, c in zip(got, want):
        assert torch.equal(a, c)


def test_the_module_runs_the_wrapper(monkeypatch):
    from emdr2_tpu_torch.models import layers
    calls = []
    monkeypatch.setattr(layers, "layer_norm",
                        lambda *a: calls.append(a) or ln.layer_norm(*a))
    norm = LayerNorm(64, 1e-5)
    norm.reset_parameters()
    x, _, _, _ = _inputs((4, 64), torch.bfloat16)
    out = norm(x)
    assert len(calls) == 1 and calls[0][3] == 1e-5
    assert torch.equal(out, _old_forward(x, norm.weight, norm.bias, 1e-5))


def test_bad_inputs_raise():
    x, w, b, _ = _inputs((2, 3, 16), torch.float32)
    with pytest.raises(ValueError, match="multiple of 8"):
        ln.layer_norm(x[..., :12], w[:12], b[:12], 1e-5)
    with pytest.raises(ValueError, match="multiple of 8"):
        ln.layer_norm(torch.tensor(1.0), w, b, 1e-5)
    with pytest.raises(ValueError, match=r"weight \(8,\) is not \[16\]"):
        ln.layer_norm(x, w[:8], b, 1e-5)
    with pytest.raises(ValueError, match=r"bias \(1, 16\) is not \[16\]"):
        ln.layer_norm(x, w, b[None], 1e-5)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        ln.layer_norm(x.half(), w, b, 1e-5)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        ln.layer_norm(x.double(), w, b, 1e-5)
    with pytest.raises(TypeError, match="weight is torch.bfloat16"):
        ln.layer_norm(x, w.to(torch.bfloat16), b, 1e-5)
    with pytest.raises(TypeError, match="bias is torch.float64"):
        ln.layer_norm(x, w, b.double(), 1e-5)
    with pytest.raises(ValueError, match="the weight on meta"):
        ln.layer_norm(x, w.to("meta"), b, 1e-5)
    with pytest.raises(ValueError, match="the bias on meta"):
        ln.layer_norm(x, w, b.to("meta"), 1e-5)


def test_cuda_checks_refuse_what_the_kernel_does_not_take():
    """The checks a CUDA tensor meets before the launch, on CPU tensors."""
    with pytest.raises(ValueError, match="up to 8192"):
        ln._check_cuda(torch.empty(2, 8200))
    with pytest.raises(ValueError, match="2\\^31 rows"):
        ln._check_cuda(torch.empty(1, 8).expand(2 ** 31, 8))
    ln._check_cuda(torch.empty(3, 8192))


@pytest.fixture
def fake_launch(monkeypatch):
    """``build.launch`` recording its arguments instead of launching, a
    card of 132 multiprocessors, and the counters at zero."""
    calls = []
    monkeypatch.setattr(build, "launch",
                        lambda entry, what, device, *args:
                        calls.append((entry, what, args)))
    monkeypatch.setattr(ln, "_stream", lambda t: 0)
    monkeypatch.setattr(ln, "_sm_count", lambda device: 132)
    for fn in (ln.layer_norm, ln.layer_norm_backward):
        for name in ("launches", "bytes"):
            monkeypatch.setattr(fn, name, 0)
    return calls


# (rows, H): the warp walk, 8 rows a block, up to 4 blocks a multiprocessor
# forward and 2 backward; the block walk, a row a block
@pytest.mark.parametrize("rows,h,fwd_grid,bwd_grid", [
    (204800, 768, 528, 264), (512, 768, 64, 64), (13, 768, 2, 2),
    (5, 64, 1, 1), (300, 2048, 300, 264), (1000, 2048, 528, 264)])
def test_grid_follows_the_shape_and_the_card(fake_launch, rows, h, fwd_grid,
                                             bwd_grid):
    cpu = torch.device("cpu")
    assert ln._grid(rows, h, cpu, ln._FWD_BLOCKS_PER_SM) == fwd_grid
    assert ln._grid(rows, h, cpu, ln._BWD_BLOCKS_PER_SM) == bwd_grid


@pytest.mark.parametrize("shape", [(3, 5, 768), (13, 768), (5, 64),
                                   (2, 2048)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_launches_pass_the_rows_and_grid_and_count_the_bytes(
        fake_launch, shape, dtype):
    x, w, b, dy = _inputs(shape, dtype)
    rows, h, es = x.numel() // shape[-1], shape[-1], x.element_size()
    cpu = torch.device("cpu")
    fwd_grid = ln._grid(rows, h, cpu, ln._FWD_BLOCKS_PER_SM)
    bwd_grid = ln._grid(rows, h, cpu, ln._BWD_BLOCKS_PER_SM)
    ln._forward(x, w, b, 1e-5)
    entry, what, args = fake_launch[-1]
    assert entry == ln._ENTRIES[dtype] and what == "layer_norm"
    assert args[:3] == (x.data_ptr(), w.data_ptr(), b.data_ptr())
    assert args[4:] == (rows, h, 1e-5, fwd_grid, 0)
    assert (ln.layer_norm.launches, ln.layer_norm.bytes) == (
        1, 2 * rows * h * es + 2 * h * 4)

    dx, dw, db = ln.layer_norm_backward(x, dy, w, 1e-5)
    entry, what, args = fake_launch[-1]
    assert entry == ln._BWD_ENTRIES[dtype] and what == "layer_norm_backward"
    assert args[:4] == (x.data_ptr(), dy.data_ptr(), w.data_ptr(),
                        dx.data_ptr())
    assert args[5:7] == (dw.data_ptr(), db.data_ptr())
    assert args[7:] == (rows, h, 1e-5, bwd_grid, 0)
    assert dx.shape == x.shape and dx.dtype == dtype
    assert dw.shape == db.shape == (h,) and dw.dtype == torch.float32
    # x, dy, dx; the weight; partials [2, G, H] written and read; dw, db
    assert (ln.layer_norm_backward.launches,
            ln.layer_norm_backward.bytes) == (
        1, 3 * rows * h * es + h * 4 + 2 * 2 * bwd_grid * h * 4 + 2 * h * 4)


def test_no_rows_no_launch(fake_launch):
    x, w, b, dy = _inputs((0, 64), torch.bfloat16)
    assert ln._forward(x, w, b, 1e-5).shape == (0, 64)
    dx, dw, db = ln.layer_norm_backward(x, dy, w, 1e-5)
    assert dx.shape == (0, 64) and torch.equal(dw, torch.zeros(64))
    assert fake_launch == [] and ln.layer_norm.launches == 0


def test_function_saves_x_and_the_weight_alone(fake_launch):
    """No fp32 copy of a row is kept for the backward (the formula's
    autograd keeps three); a strided x is made contiguous first."""
    x, w, b, dy = _inputs((6, 4, 64), torch.bfloat16)
    x = x.transpose(0, 1).contiguous().transpose(0, 1).requires_grad_()
    w.requires_grad_()
    b.requires_grad_()
    packed = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: packed.append(t) or t, lambda t: t):
        out = ln._LayerNorm.apply(x, w, b, 1e-5)
    assert [(tuple(t.shape), t.dtype, t.is_contiguous()) for t in packed] \
        == [((6, 4, 64), torch.bfloat16, True), ((64,), torch.float32, True)]
    assert out.shape == x.shape and out.dtype == x.dtype
    assert ln.layer_norm.launches == 1
    out.backward(dy)
    assert ln.layer_norm_backward.launches == 1
    assert x.grad.shape == x.shape and w.grad.shape == b.grad.shape == (64,)
