"""The port's MIPS search (plain candidate scan, CPU) against the JAX Pallas
kernel in interpret mode and the JAX ``mips_topk``.

Candidate ids must be equal; values agree to 1e-5 (fp32 sums in another
order; int8 sums are exact integers). Final results are compared as id
sets per query plus sorted values, since tie order may differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from emdr2_tpu.ops import mips as jax_mips  # noqa: E402
from emdr2_tpu_torch.ops import mips  # noqa: E402

torch.set_num_threads(2)


def np_bf16(a):
    return torch.as_tensor(a).to(torch.bfloat16)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("cands", [1, 2])
def test_candidate_scan_matches_jax_kernel(dtype, cands):
    rng = np.random.RandomState(7)
    n, d, G, chunk, nq = 2048, 128, 8, 1024, 8
    n_valid = 2000
    if dtype == "bf16":
        qt = np_bf16(rng.randn(nq, d).astype(np.float32))
        et = np_bf16(rng.randn(n, d).astype(np.float32))
        qj = jnp.asarray(qt.float().numpy()).astype(jnp.bfloat16)
        ej = jnp.asarray(et.float().numpy()).astype(jnp.bfloat16)
    else:
        q8 = rng.randint(-127, 128, size=(nq, d)).astype(np.int8)
        e8 = rng.randint(-127, 128, size=(n, d)).astype(np.int8)
        e8[96:112] = 3         # tied groups: lowest row first, twice
        qt, et = torch.as_tensor(q8), torch.as_tensor(e8)
        qj, ej = jnp.asarray(q8), jnp.asarray(e8)
    wv, wi = jax_mips._candidate_scan(qj, ej, n_valid, chunk, G, nq, True,
                                      cands_per_group=cands, masked=True)
    gv, gi = mips.candidate_scan(qt, et, n_valid, G, cands)
    assert gv.shape == (nq, cands * n // G) and gi.dtype == torch.int32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    if dtype == "int8":
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    else:
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5,
                                   atol=1e-5)


def _edge_inputs(dtype, nq, n, d, rng):
    """Queries and rows (bf16 from a normal, or int8), the group of rows
    256-383 all equal to row 5."""
    if dtype == "bf16":
        qt = np_bf16(rng.randn(nq, d).astype(np.float32))
        et = np_bf16(rng.randn(n, d).astype(np.float32))
        et[256:384] = et[5]
        qj = jnp.asarray(qt.float().numpy()).astype(jnp.bfloat16)
        ej = jnp.asarray(et.float().numpy()).astype(jnp.bfloat16)
    else:
        q8 = rng.randint(-127, 128, size=(nq, d)).astype(np.int8)
        e8 = rng.randint(-127, 128, size=(n, d)).astype(np.int8)
        e8[256:384] = e8[5]
        qt, et = torch.as_tensor(q8), torch.as_tensor(e8)
        qj, ej = jnp.asarray(q8), jnp.asarray(e8)
    return qt, et, qj, ej


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("cands", [1, 2])
def test_candidate_scan_edges_of_the_tensor_core_group(dtype, cands):
    """The edges the tensor-core kernel must honour, at its only group of
    128 rows, the plain version against the JAX kernel (interpret mode,
    one query tile of all 67 queries): a ragged query count, n_valid in
    the middle of group 126, group 127 wholly past it, and a group of 128
    equal rows (the lowest two win)."""
    rng = np.random.RandomState(13)
    nq, d, G = 67, 256, 128
    n = 128 * G                    # the JAX kernel's one output block
    n_valid = n - G - 50
    qt, et, qj, ej = _edge_inputs(dtype, nq, n, d, rng)
    wv, wi = jax_mips._candidate_scan(qj, ej, n_valid, n, G, nq, True,
                                      cands_per_group=cands, masked=True)
    gv, gi = mips.candidate_scan(qt, et, n_valid, G, cands)
    groups = n // G
    assert gv.shape == (nq, cands * groups)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    if dtype == "int8":
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    else:
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5,
                                   atol=1e-5)
    gi = gi.numpy()
    assert (gi[:, 2] == 256).all()
    assert (gi[:, groups - 2] < n_valid).all()       # group 126's live rows
    assert (gi[:, groups - 1] == n - G).all()        # (NEG_INF, first row)
    assert (gv.numpy()[:, groups - 1] == mips.NEG_INF).all()
    if cands == 2:
        assert (gi[:, groups + 2] == 257).all()
        assert (gi[:, 2 * groups - 2] < n_valid).all()
        assert (gi[:, 2 * groups - 1] == n - G).all()


def test_scan_route_takes_each_type_at_its_own_crossover():
    """The routing table: each type's tensor-core kernel from its own
    measured crossover on (PERF.md section 6), groups of 128 rows of at
    most TENSOR_CORE_MAX_ROW_BYTES only."""
    assert mips.TENSOR_CORE_MIN_NQ == {torch.bfloat16: 1, torch.int8: 1}
    for dtype, low in mips.TENSOR_CORE_MIN_NQ.items():
        if low > 1:
            assert mips.scan_route(low - 1, 128, dtype) == "cuda_core"
        for nq in (low, low + 1, 512, 3610):
            assert mips.scan_route(nq, 128, dtype) == "tensor_core"
            assert mips.scan_route(nq, 64, dtype) == "cuda_core"
        itemsize = torch.empty((), dtype=dtype).element_size()
        wide = mips.TENSOR_CORE_MAX_ROW_BYTES // itemsize + 128
        assert mips.scan_route(512, 128, dtype, d=wide) == "cuda_core"
    # the serving batch of 8 over the int8 index: the tensor-core kernel
    assert mips.scan_route(8, 128, torch.int8) == "tensor_core"


def test_candidate_scan_cpu_path_does_not_count():
    q = torch.zeros(2, 64, dtype=torch.int8)
    e = torch.zeros(128, 64, dtype=torch.int8)
    before = mips.candidate_scan.launches
    mips.candidate_scan(q, e, 128, 64, 2)
    assert mips.candidate_scan.launches == before
    with pytest.raises(ValueError):   # neither CPU nor CUDA: no fallback
        mips.candidate_scan(q.to("meta"), e.to("meta"), 128, 64, 2)


def _assert_same_topk(got, want):
    gv, gi = (t.numpy() for t in got)
    wv, wi = (np.asarray(t) for t in want)
    for r in range(gi.shape[0]):
        assert set(gi[r].tolist()) == set(wi[r].tolist()), r
    np.testing.assert_allclose(np.sort(gv, axis=1), np.sort(wv, axis=1),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("k", [8, 60])
def test_mips_topk_matches_jax(quantize, k):
    """N >= 4096 with chunk_rows 512 and group 64: the scan path, n_valid
    masking of pad rows, and (int8) the exact re-rank over an M=48 (k=8) or
    M=128 (k=60) window."""
    rng = np.random.RandomState(11)
    n, d, G, chunk, nq = 4352, 64, 64, 512, 6
    n_valid = 4300
    e = rng.randn(n, d).astype(np.float32)
    e[n_valid:] = 0.0
    q = rng.randn(nq, d).astype(np.float32)
    kw = dict(chunk_rows=chunk, group_size=G, cands_per_group=2,
              n_valid=n_valid)
    if quantize:
        e8, sc = mips.quantize_int8(torch.as_tensor(e), G)
        je8, jsc = jax_mips.quantize_int8(e, G)
        np.testing.assert_array_equal(e8.numpy(), je8)
        np.testing.assert_array_equal(sc.numpy(), jsc)
        got = mips.mips_topk(torch.as_tensor(q), e8, k, shard_scales=sc,
                             **kw)
        want = jax_mips.mips_topk(jnp.asarray(q), jnp.asarray(je8), k,
                                  shard_scales=jnp.asarray(jsc),
                                  query_tile=8, interpret=True, **kw)
    else:
        got = mips.mips_topk(torch.as_tensor(q), torch.as_tensor(e), k, **kw)
        want = jax_mips.mips_topk(jnp.asarray(q), jnp.asarray(e), k,
                                  query_tile=8, interpret=True, **kw)
    assert (got[1].numpy() < n_valid).all()
    _assert_same_topk(got, want)


def test_mips_topk_int8_blocked_window_matches_jax():
    """An int8 buffer wide enough (2 * N / 64 = 8192 columns) that the k=60
    re-rank window is selected by the blocked two-stage top-k."""
    rng = np.random.RandomState(5)
    n, d, nq, k = 262144, 64, 4, 60
    e = rng.randn(n, d).astype(np.float32)
    q = rng.randn(nq, d).astype(np.float32)
    kw = dict(chunk_rows=512, group_size=64, n_valid=n - 100)
    je8, jsc = jax_mips.quantize_int8(e, 64)
    want = jax_mips.mips_topk(jnp.asarray(q), jnp.asarray(je8), k,
                              shard_scales=jnp.asarray(jsc), query_tile=8,
                              interpret=True, **kw)
    e8, sc = mips.quantize_int8(torch.as_tensor(e), 64)
    got = mips.mips_topk(torch.as_tensor(q), e8, k, shard_scales=sc, **kw)
    _assert_same_topk(got, want)


def test_blocked_window_matches_jax():
    rng = np.random.RandomState(2)
    cand = rng.randn(3, 9000).astype(np.float32)
    got = mips._blocked_window_topk(torch.as_tensor(cand), 128)
    want = jax_mips._blocked_window_topk(jnp.asarray(cand), 128)
    for r in range(3):
        assert set(got[r].tolist()) == set(np.asarray(want)[r].tolist())


def test_small_shard_is_exact_search():
    rng = np.random.RandomState(4)
    e = rng.randn(200, 32).astype(np.float32)
    q = rng.randn(3, 32).astype(np.float32)
    got = mips.mips_topk(torch.as_tensor(q), torch.as_tensor(e), 5,
                         chunk_rows=256, n_valid=150)
    want = jax_mips.exact_topk(jnp.asarray(q), jnp.asarray(e), 5, n_valid=150)
    _assert_same_topk(got, want)


def test_rerank_is_independent_of_tf32_and_matmul_precision():
    """The int8 re-rank runs in a form no TF32 / float32-matmul-precision
    setting reaches: its scores equal a float64 numpy product rounded once,
    whatever the global settings are."""
    rng = np.random.RandomState(9)
    qf = rng.randn(4, 768).astype(np.float32) * 3
    rows = rng.randint(-127, 128, size=(4, 16, 768)).astype(np.int8)
    want = np.einsum("qd,qmd->qm", qf.astype(np.float64),
                     rows.astype(np.float64)).astype(np.float32)
    prec = torch.get_float32_matmul_precision()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        for p, t in (("highest", False), ("medium", True)):
            torch.set_float32_matmul_precision(p)
            torch.backends.cuda.matmul.allow_tf32 = t
            got = mips._rerank_scores(torch.as_tensor(qf),
                                      torch.as_tensor(rows))
            np.testing.assert_array_equal(got.numpy(), want)
    finally:
        torch.set_float32_matmul_precision(prec)
        torch.backends.cuda.matmul.allow_tf32 = tf32
