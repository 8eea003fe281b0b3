"""``emdr2_tpu_torch/ops/decode_attention.py`` against
``emdr2_tpu/ops/decode_attention.py``: the same numpy inputs go through the
JAX functions (the Pallas kernel in interpret mode, as the JAX package's own
tests run it on the CPU) and the port's.

Tolerances. ``quantize_kv_rows`` on fp32 input: int8 values and scales
equal. The plain version repeats the TPU kernel's chunking and rounding, but
the interpreted kernel multiplies bf16 operands where the plain version
multiplies their fp32 copies and sums in another order: atol = rtol = 2e-2
in bf16 outputs of size ~1 (one bf16 ulp at 1 is 7.8e-3). Against the dense
reference the JAX tests' own atol = rtol = 3e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from emdr2_tpu.ops import decode_attention as jax_da  # noqa: E402
from emdr2_tpu_torch.ops import decode_attention as da  # noqa: E402

torch.set_num_threads(2)


def _f32(t):
    return t.float().numpy()


def make(B=2, R=3, nh=4, hd=16, Lk=128, masked_tail=5, seed=0):
    """numpy (q fp32 on bf16 values, k, v fp32, bias fp32)."""
    rs = np.random.RandomState(seed)
    q = torch.tensor(rs.randn(B, R, nh, hd).astype(np.float32)
                     ).to(torch.bfloat16).float().numpy()
    k = rs.randn(B, nh, Lk, hd).astype(np.float32)
    v = rs.randn(B, nh, Lk, hd).astype(np.float32)
    bias = np.zeros((B, Lk), np.float32)
    if masked_tail:
        bias[:, -masked_tail:] = -1e9
    return q, k, v, bias


def both_sides(q, k, v, bias):
    """(JAX args, port args) of the attention call, quantized on each
    side by its own ``quantize_kv_rows``."""
    jk8, jks = jax_da.quantize_kv_rows(jnp.asarray(k))
    jv8, jvs = jax_da.quantize_kv_rows(jnp.asarray(v))
    jargs = (jnp.asarray(q, jnp.bfloat16), jk8, jks, jv8, jvs,
             jnp.asarray(bias))
    k8, ks = da.quantize_kv_rows(torch.tensor(k))
    v8, vs = da.quantize_kv_rows(torch.tensor(v))
    args = (torch.tensor(q).to(torch.bfloat16), k8, ks, v8, vs,
            torch.tensor(bias))
    return jargs, args


@pytest.mark.parametrize("shape", [(2, 3, 17, 8), (1, 2, 128, 64)])
def test_quantize_kv_rows_equals_jax(shape):
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    x[0, 0, 3] = 0.0                                    # an all-zero row
    x[0, 1, 5, 0] = 0.5 * np.abs(x[0, 1, 5]).max() / 127.0   # a rounding tie
    want8, wants = jax_da.quantize_kv_rows(jnp.asarray(x))
    got8, gots = da.quantize_kv_rows(torch.tensor(x))
    assert got8.dtype == torch.int8 and gots.dtype == torch.float32
    assert gots.shape == shape[:-1]
    np.testing.assert_array_equal(got8.numpy(), np.asarray(want8))
    np.testing.assert_array_equal(gots.numpy(), np.asarray(wants))
    assert gots[0, 0, 3] == 1.0 and not got8[0, 0, 3].any()
    err = np.abs(got8.float().numpy() * gots.numpy()[..., None] - x)
    assert (err <= gots.numpy()[..., None] / 2 + 1e-7).all()


def test_quantize_zero_rows_exact():
    x8, s = da.quantize_kv_rows(torch.zeros(1, 2, 4, 8))
    assert s.min() == 1.0 and x8.abs().max() == 0


@pytest.mark.parametrize("Lk", [1, 100, 128, 129, 3200, 3201, 6400, 25600])
def test_padded_rows_equals_jax(Lk):
    assert da.padded_rows(Lk) == jax_da.padded_rows(Lk)
    assert da.padded_rows(Lk, 256) == jax_da.padded_rows(Lk, 256)
    assert da.DEFAULT_KEY_CHUNK == jax_da.DEFAULT_KEY_CHUNK


@pytest.mark.parametrize("R,Lk,key_chunk,tail", [
    (1, 128, None, 5),
    (3, 128, None, 0),
    (1, 512, 128, 17),
    (3, 512, 128, 140),           # the last chunk fully masked
])
def test_plain_matches_jax_kernel(R, Lk, key_chunk, tail):
    jargs, args = both_sides(*make(R=R, Lk=Lk, masked_tail=tail,
                                   seed=R + Lk))
    kw = {} if key_chunk is None else {"key_chunk": key_chunk}
    want = np.asarray(jax_da.decode_cross_attention_int8(*jargs, **kw),
                      np.float32)
    got = da.decode_cross_attention_int8(*args, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == args[0].shape
    np.testing.assert_allclose(_f32(got), want, atol=2e-2, rtol=2e-2)
    ref = da.decode_cross_attention_int8_reference(*args)
    jref = jax_da.decode_cross_attention_int8_reference(*jargs)
    np.testing.assert_allclose(_f32(ref), np.asarray(jref, np.float32),
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(_f32(got), _f32(ref), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("R,Lk,tail,stages_per_block,stage_keys", [
    (1, 128, 5, 1, 32),           # four stages, a block each
    (3, 200, 0, 2, 32),           # Lk no stage multiple: a short last stage
    (5, 20, 3, 4, 32),            # Lk shorter than one stage
    (8, 512, 140, 3, 64),         # a run of three stages, then a shorter one
    (2, 256, 0, 1, 256),          # the kernel's own stage length
])
def test_split_reference_matches_plain_and_jax_kernel(R, Lk, tail,
                                                      stages_per_block,
                                                      stage_keys):
    """The kernel's order of sums (stages dealt to blocks, a stage's keys to
    four warps, warps then blocks merged in order) against the plain chunked
    version and the Pallas kernel in interpret mode. With fp32 queries both
    plain forms keep ``p * vscale`` in fp32 and differ in the order of the
    sums only: atol = rtol = 1e-5. In bf16 the split form does not round
    ``p * vscale`` where the others do, and the outputs are bf16: the
    tolerances of ``test_plain_matches_jax_kernel``."""
    q, k, v, bias = make(R=R, Lk=Lk, masked_tail=tail, seed=R + Lk)
    bias[-1] = -1e9                                   # a fully masked example
    jargs, args = both_sides(q, k, v, bias)
    got = da.decode_cross_attention_int8_split_reference(
        *args, stages_per_block, stage_keys, 4)
    assert got.dtype == torch.bfloat16 and got.shape == args[0].shape
    assert torch.isfinite(got.float()).all()
    want = np.asarray(jax_da.decode_cross_attention_int8(*jargs), np.float32)
    np.testing.assert_allclose(_f32(got), want, atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(
        _f32(got), _f32(da.decode_cross_attention_int8_plain(*args)),
        atol=2e-2, rtol=2e-2)
    args32 = (args[0].float(),) + args[1:]
    np.testing.assert_allclose(
        da.decode_cross_attention_int8_split_reference(
            *args32, stages_per_block, stage_keys, 4).numpy(),
        da.decode_cross_attention_int8_plain(*args32).numpy(),
        atol=1e-5, rtol=1e-5)
    # one block walking every stage is the same function
    np.testing.assert_allclose(
        da.decode_cross_attention_int8_split_reference(
            *args32, 1000, stage_keys, 4).numpy(),
        da.decode_cross_attention_int8_plain(*args32).numpy(),
        atol=1e-5, rtol=1e-5)


def test_split_reference_refuses_a_bad_split():
    _, args = both_sides(*make())
    with pytest.raises(ValueError):
        da.decode_cross_attention_int8_split_reference(*args, 0, 32, 4)
    with pytest.raises(ValueError):
        da.decode_cross_attention_int8_split_reference(*args, 1, 30, 4)


def test_fully_masked_example_matches_jax_and_is_finite():
    q, k, v, bias = make(R=3, Lk=256, masked_tail=9, seed=4)
    bias[0] = -1e9
    jargs, args = both_sides(q, k, v, bias)
    want = np.asarray(jax_da.decode_cross_attention_int8(*jargs,
                                                         key_chunk=128),
                      np.float32)
    got = _f32(da.decode_cross_attention_int8(*args, key_chunk=128))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


def test_poisoned_masked_rows_change_nothing():
    _, (q, k8, ks, v8, vs, bias) = both_sides(*make(masked_tail=13, seed=1))
    out = da.decode_cross_attention_int8(q, k8, ks, v8, vs, bias)
    k8p, v8p = k8.clone(), v8.clone()
    k8p[:, :, -13:] = 127
    v8p[:, :, -13:] = -127
    outp = da.decode_cross_attention_int8(q, k8p, ks, v8p, vs, bias)
    assert torch.equal(out, outp)


def test_cpu_runs_plain_version_without_counting():
    _, args = both_sides(*make())
    before = da.decode_cross_attention_int8.launches
    got = da.decode_cross_attention_int8(*args)
    assert da.decode_cross_attention_int8.launches == before
    assert torch.equal(got, da.decode_cross_attention_int8_plain(*args))


def test_rejects_bad_shapes_types_and_foreign_devices():
    _, (q, k8, ks, v8, vs, bias) = both_sides(*make())
    with pytest.raises(ValueError):
        da.decode_cross_attention_int8(q[0], k8, ks, v8, vs, bias)
    with pytest.raises(ValueError):
        da.decode_cross_attention_int8(q, k8, ks[:, :, :-1], v8, vs, bias)
    with pytest.raises(ValueError):
        da.decode_cross_attention_int8(q, k8, ks, v8, vs, bias[:, :-1])
    with pytest.raises(TypeError):
        da.decode_cross_attention_int8(q, k8.float(), ks, v8, vs, bias)
    with pytest.raises(ValueError):                    # Lk % key_chunk
        da.decode_cross_attention_int8(q, k8, ks, v8, vs, bias,
                                       key_chunk=100)
    meta = [t.to("meta") for t in (q, k8, ks, v8, vs, bias)]
    with pytest.raises(ValueError):                    # neither CPU nor CUDA
        da.decode_cross_attention_int8(*meta)
