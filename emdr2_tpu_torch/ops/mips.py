"""Maximum-inner-product search (port of ``emdr2_tpu/ops/mips.py``).

``mips_topk`` searches one resident index shard. The candidate scan
(``candidate_scan``: per ``group_size`` consecutive rows, the best row and
the runner-up) is the hand-written CUDA kernel ``csrc/candidate_scan.cu``;
everything after it is plain PyTorch, as the JAX package left it to XLA:
the int8 group/query scales on the winners, the final ``torch.topk``,
:func:`_blocked_window_topk`, and the exact re-rank of an int8 index.

On a CUDA tensor ``candidate_scan`` launches the kernel or raises; on a CPU
tensor it runs :func:`candidate_scan_reference`, the plain version. Shards
of at most ``chunk_rows`` rows are searched exactly, without the scan, as in
the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from emdr2_tpu_torch.ops import build
from emdr2_tpu_torch.utils.timing import count

NEG_INF = float(-3.0e38)


def quantize_int8(emb: torch.Tensor, group_size: int = 128
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization with one fp32 scale per ``group_size``
    consecutive rows (the groups the candidate scan reduces over).

    emb [N, d] float (N % group_size == 0) -> (q [N, d] int8,
    scales [N // group_size] fp32), on emb's device. All-zero groups get
    scale 1.0 so NEG_INF-masked pad candidates stay hugely negative after
    the scale multiply. Works 1024 groups at a time to bound the fp32
    temporaries; every row's result is independent of the blocking."""
    n, d = emb.shape
    if n % group_size:
        raise ValueError(f"rows {n} not a multiple of group {group_size}")
    q = torch.empty((n, d), dtype=torch.int8, device=emb.device)
    scales = torch.empty(n // group_size, dtype=torch.float32,
                         device=emb.device)
    step = 1024 * group_size
    for s in range(0, n, step):
        e = emb[s:s + step].float()
        g = e.shape[0] // group_size
        maxabs = e.reshape(g, -1).abs().amax(dim=1)
        sc = torch.where(maxabs > 0, maxabs / 127.0, torch.ones_like(maxabs))
        per_row = sc.repeat_interleave(group_size)
        q[s:s + step] = torch.clamp(torch.round(e / per_row[:, None]),
                                    -127, 127).to(torch.int8)
        scales[s // group_size:s // group_size + g] = sc
    return q, scales


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor,
                    group_size: int = 128) -> torch.Tensor:
    """Inverse of :func:`quantize_int8` -> fp32 [N, d]."""
    per_row = scales.float().repeat_interleave(group_size)
    return q.float() * per_row[:, None]


def exact_topk(queries: torch.Tensor, shard: torch.Tensor, k: int,
               n_valid=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full matmul + top-k: queries [nq, d], shard [N, d] ->
    (scores [nq, k] fp32, idx [nq, k] int64). Rows >= ``n_valid`` score
    NEG_INF before the top-k."""
    scores = torch.matmul(queries.to(shard.dtype).float(), shard.float().T)
    if n_valid is not None:
        rows = torch.arange(shard.shape[0], device=shard.device)
        scores = torch.where(rows[None, :] < n_valid, scores,
                             torch.full_like(scores, NEG_INF))
    vals, idx = torch.topk(scores, k, dim=1)
    return vals, idx


def candidate_scan_reference(queries: torch.Tensor, index: torch.Tensor,
                             n_valid: int, group_size: int = 128,
                             cands_per_group: int = 2
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the candidate scan (same signature and
    output as :func:`candidate_scan`). Scores are fp32 products of exact
    fp32 copies; for int8 every partial sum is an integer below 2^24, so
    they are exact in any order (and under TF32, which holds 8-bit values
    exactly)."""
    nq = queries.shape[0]
    N = index.shape[0]
    G = group_size
    s = torch.matmul(queries.float(), index.float().T)
    rows = torch.arange(N, device=index.device)
    s = torch.where(rows[None, :] < n_valid, s, torch.full_like(s, NEG_INF))
    s3 = s.view(nq, N // G, G)
    base = G * torch.arange(N // G, device=index.device, dtype=torch.int32)
    vals, idxs = [], []
    for c in range(cands_per_group):
        am = torch.argmax(s3, dim=-1, keepdim=True)   # first max: lowest row
        vals.append(torch.gather(s3, -1, am)[..., 0])
        idxs.append(base[None, :] + am[..., 0].to(torch.int32))
        if c + 1 < cands_per_group:   # knock out the winner, take the next
            s3 = s3.scatter(-1, am, NEG_INF)
    return torch.cat(vals, dim=1), torch.cat(idxs, dim=1)


# The candidate scan has two kernels (``csrc/candidate_scan.cu``): the
# CUDA-core scan, for any group of 32-256 rows, and the tensor-core scan
# (wgmma, its ring filled by TMA), for groups of 128 rows of at most
# ``TENSOR_CORE_MAX_ROW_BYTES``. ``candidate_scan`` takes the tensor-core one
# from ``TENSOR_CORE_MIN_NQ[dtype]`` queries on, each type at its own
# crossover: over 1,310,720 x 768 rows on an NVIDIA H100 80GB HBM3 at 700 W
# it is ahead from one query on in both (``tools/time_kernels.py``'s K3
# crossover rows, nq 1 to 256; PERF.md section 6), reading the index at near
# the memory rate where the CUDA-core kernel did.
TENSOR_CORE_MIN_NQ = {torch.bfloat16: 1, torch.int8: 1}
TENSOR_CORE_GROUP = 128
TENSOR_CORE_MAX_ROW_BYTES = 3072    # 64 resident queries and two stages
                                    # fit in a block's shared memory


def scan_route(nq: int, group_size: int, dtype: torch.dtype,
               d: int = 768) -> str:
    """The kernel ``candidate_scan`` launches for ``nq`` queries of ``d``
    values of ``dtype`` (bf16 or int8): ``"tensor_core"`` or
    ``"cuda_core"``."""
    row_bytes = d * torch.empty((), dtype=dtype).element_size()
    return ("tensor_core" if nq >= TENSOR_CORE_MIN_NQ[dtype]
            and group_size == TENSOR_CORE_GROUP
            and row_bytes <= TENSOR_CORE_MAX_ROW_BYTES else "cuda_core")


def candidate_scan(queries: torch.Tensor, index: torch.Tensor, n_valid: int,
                   group_size: int = 128, cands_per_group: int = 2
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-group top-``cands_per_group`` candidates of queries [nq, d]
    against index [N, d] (both bf16, both int8, or fp32 on the CPU).

    Returns (vals fp32, idx int32), each [nq, cands_per_group * N / G];
    column ``c = rank * (N/G) + group``. int8 values are raw int32 dots cast
    to fp32 (scales are applied by the caller). On the card the kernel is
    the one :func:`scan_route` names."""
    nq, d = queries.shape
    N, d2 = index.shape
    G = group_size
    if d != d2 or N % G:
        raise ValueError(f"bad shapes {tuple(queries.shape)} x "
                         f"{tuple(index.shape)} for group {G}")
    if index.device.type == "cpu":
        return candidate_scan_reference(queries, index, n_valid, G,
                                        cands_per_group)
    if index.dtype not in TENSOR_CORE_MIN_NQ:
        raise TypeError(f"kernel takes bf16 x bf16 or int8 x int8, got "
                        f"{queries.dtype} x {index.dtype}")
    return _launch(queries, index, n_valid, G, cands_per_group,
                   scan_route(nq, G, index.dtype, d))


def _launch(queries: torch.Tensor, index: torch.Tensor, n_valid: int,
            group_size: int, cands_per_group: int, route: str
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch one kernel of the scan on CUDA tensors: ``route`` is
    ``"cuda_core"`` or ``"tensor_core"`` (the ``gpu`` tests force each to
    hold both to the plain version, ``tools/time_kernels.py`` to time the
    crossover)."""
    nq, d = queries.shape
    N = index.shape[0]
    G = group_size
    if index.device.type != "cuda" or queries.device != index.device:
        raise ValueError(f"candidate_scan: unsupported devices "
                         f"{queries.device} / {index.device}")
    if queries.dtype != index.dtype or index.dtype not in (torch.bfloat16,
                                                           torch.int8):
        raise TypeError(f"kernel takes bf16 x bf16 or int8 x int8, got "
                        f"{queries.dtype} x {index.dtype}")
    if (d * index.element_size()) % 128 or G % 32 or not 32 <= G <= 256 \
            or cands_per_group not in (1, 2):
        raise ValueError(f"kernel needs d*itemsize % 128 == 0, group in "
                         f"32..256 (multiple of 32) and 1-2 candidates; got "
                         f"d={d}, group={G}, cands={cands_per_group}")
    if route == "tensor_core" and (
            G != TENSOR_CORE_GROUP
            or d * index.element_size() > TENSOR_CORE_MAX_ROW_BYTES):
        raise ValueError(f"the tensor-core scan takes groups of "
                         f"{TENSOR_CORE_GROUP} rows of at most "
                         f"{TENSOR_CORE_MAX_ROW_BYTES} bytes; got group {G}, "
                         f"{d * index.element_size()} bytes")
    if route not in ("cuda_core", "tensor_core"):
        raise ValueError(f"unknown route {route!r}")
    if not (queries.is_contiguous() and index.is_contiguous()):
        raise ValueError("candidate_scan needs contiguous inputs")
    if queries.data_ptr() % 16 or index.data_ptr() % 16:
        raise ValueError("candidate_scan needs 16-byte aligned inputs")
    cols = cands_per_group * (N // G)
    vals = torch.empty((nq, cols), dtype=torch.float32, device=index.device)
    idx = torch.empty((nq, cols), dtype=torch.int32, device=index.device)
    entry = ("emdr2_candidate_scan_"
             + ("tc_" if route == "tensor_core" else "")
             + ("i8" if index.dtype == torch.int8 else "bf16"))
    build.launch(entry, f"candidate_scan ({route})", index.device,
                 queries.data_ptr(), index.data_ptr(), vals.data_ptr(),
                 idx.data_ptr(), nq, N, d, int(min(n_valid, N)), G,
                 cands_per_group,
                 torch.cuda.current_stream(index.device).cuda_stream)
    count(candidate_scan, "launches")
    if route == "tensor_core":
        count(candidate_scan, "tensor_core_launches")
    return vals, idx


def kernel_info() -> list:
    """What the compiler made of each scan kernel, from the built library
    (``cudaFuncGetAttributes``): dicts of type, route, queries a block,
    registers, static shared bytes, local (spilled) bytes a thread, and the
    dynamic shared bytes and ring stages a launch at d = 768 takes."""
    import ctypes
    lib = build.load()
    cap, width = 32, 8
    out = (ctypes.c_int * (cap * width))()
    n = lib.emdr2_candidate_scan_kernels(out, cap)
    if n < 0:
        build.check(-n, "emdr2_candidate_scan_kernels")
    keys = ("dtype", "route", "queries", "registers", "static_smem",
            "local_bytes", "dynamic_smem", "stages")
    rows = []
    for i in range(n):
        row = dict(zip(keys, out[i * width:(i + 1) * width]))
        row["dtype"] = ("bf16", "int8")[row["dtype"]]
        row["route"] = ("cuda_core", "tensor_core")[row["route"]]
        rows.append(row)
    return rows


# kernel launches since the last reset (a run proves its path went through
# the kernel by reading this): every launch of either kernel, and those of
# the tensor-core kernel alone
candidate_scan.launches = 0
candidate_scan.tensor_core_launches = 0


def _blocked_window_topk(cand_vals: torch.Tensor, m: int,
                         block_width: int = 1024, margin: int = 4
                         ) -> torch.Tensor:
    """Top-``m`` column positions of the candidate buffer by a two-stage
    blocked selection: per-block top-t over width-``block_width`` blocks
    (t = margin*m/n_blocks), then an exact top-m over the survivors. It keeps
    every top-m member unless one block holds more than t of them."""
    nq, C = cand_vals.shape
    n_blk = -(-C // block_width)
    t = min(block_width, -(-margin * m // n_blk))
    if n_blk < 4 or n_blk * t >= C:   # too few blocks to pay for stage 2
        return torch.topk(cand_vals, m, dim=1).indices
    pad = n_blk * block_width - C
    v = cand_vals if pad == 0 else F.pad(cand_vals, (0, pad), value=NEG_INF)
    v = v.view(nq, n_blk, block_width)
    bv, bp = torch.topk(v, t, dim=-1)                  # [nq, n_blk, t]
    gp = bp + (torch.arange(n_blk, device=v.device)
               * block_width)[None, :, None]
    bv = bv.reshape(nq, n_blk * t)
    gp = gp.reshape(nq, n_blk * t)
    wp = torch.topk(bv, m, dim=1).indices
    return torch.gather(gp, 1, wp)


def _rerank_scores(qf: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """[nq, d] fp32 queries . [nq, M, d] int8 rows -> [nq, M] fp32.

    Computed in float64 and rounded once to fp32: no TF32 or reduced
    float32-matmul-precision setting reaches a float64 product, so the
    re-rank order is at least as exact as a true-fp32 scorer (the JAX
    package needs Precision.HIGHEST here; it took recall from 0.9963 to
    1.0)."""
    return torch.matmul(rows.double(), qf.double()[:, :, None])[..., 0].float()


def mips_topk(queries: torch.Tensor, shard: torch.Tensor, k: int, *,
              exact: bool = False, chunk_rows: int = 8192,
              group_size: int = 128, cands_per_group: int = 2,
              n_valid: Optional[int] = None,
              shard_scales: Optional[torch.Tensor] = None,
              rescore: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k inner-product search of queries [nq, d] against shard [N, d].
    Returns (scores [nq, k] fp32, row indices [nq, k]).

    ``n_valid``: rows >= n_valid never win (zero pad rows). ``shard_scales``
    (required iff the shard is int8): the per-group scales of
    :func:`quantize_int8`; queries are then quantized per query inside.

    ``rescore`` (int8 shards only; a bf16 shard ignores it): the window M
    of approximate winners re-scored exactly against the full-precision
    queries before the final top-k. ``None`` takes the default window, M =
    48 for k <= 20, else max(128, 2k); an int sets M (at least k, at most
    the candidate columns); 0 skips the re-rank and returns the top k of
    the scaled candidates with their approximate int8 scores. Semantics
    match ``emdr2_tpu.ops.mips.mips_topk``."""
    nq, d = queries.shape
    n, d2 = shard.shape
    if d != d2:
        raise ValueError(f"{tuple(queries.shape)} x {tuple(shard.shape)}")
    quantized = shard.dtype == torch.int8
    if quantized:
        if shard_scales is None:
            raise ValueError("int8 shard requires shard_scales")
        if n % group_size or shard_scales.shape != (n // group_size,):
            raise ValueError(f"scales {tuple(shard_scales.shape)} do not "
                             f"match {n} rows in groups of {group_size}")
    small = exact or n <= chunk_rows or (
        quantized and cands_per_group * (n // group_size) < k)
    if small:
        if quantized:
            shard = dequantize_int8(shard, shard_scales, group_size)
        return exact_topk(queries, shard, k, n_valid=n_valid)

    group_size = min(group_size, chunk_rows)
    while cands_per_group * (n // group_size) < k and group_size > 1:
        group_size //= 2
    if quantized:
        # per-query symmetric quantization (error symmetric to the rows')
        qf = queries.float()
        q_scale = torch.clamp(qf.abs().amax(dim=1), min=1e-30) / 127.0
        q = torch.clamp(torch.round(qf / q_scale[:, None]),
                        -127, 127).to(torch.int8)
    else:
        q = queries.to(shard.dtype)
    n_pad = -(-n // group_size) * group_size
    if n_pad != n:   # the index class keeps its rows aligned: no copy there
        shard = F.pad(shard, (0, 0, 0, n_pad - n))
    nv = n if n_valid is None else min(int(n_valid), n)
    cand_vals, cand_idx = candidate_scan(q.contiguous(), shard, nv,
                                         group_size, cands_per_group)

    if quantized:
        # column c holds group (c % n/G) of candidate rank (c // n/G)
        gscale = shard_scales.repeat(cands_per_group)
        cand_vals = cand_vals * gscale[None, :] * q_scale[:, None]
        rescore_m = ((48 if k <= 20 else max(128, 2 * k))
                     if rescore is None else rescore)
        if rescore_m:
            m_sel = min(max(rescore_m, k), cand_vals.shape[1])
            # through the module global, so a caller may swap the selection
            if m_sel >= 96 and cand_vals.shape[1] >= 8192:
                cpos = _blocked_window_topk(cand_vals, m_sel)
            else:
                cpos = torch.topk(cand_vals, m_sel, dim=1).indices
            cidx = torch.gather(cand_idx, 1, cpos).long()
            rows = shard[cidx]                              # [nq, M, d] i8
            gsc = shard_scales[cidx // group_size]
            scores = _rerank_scores(qf, rows) * gsc
            # candidates on padded/invalid rows never displace real ones
            scores = torch.where(cidx < nv, scores,
                                 torch.full_like(scores, NEG_INF))
            vals, pos2 = torch.topk(scores, k, dim=1)
            return vals, torch.gather(cidx, 1, pos2)

    vals, pos = torch.topk(cand_vals, k, dim=1)
    return vals, torch.gather(cand_idx, 1, pos).long()


def merge_topk(vals: torch.Tensor, ids: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top ``k`` of candidate columns [nq, m] by value, descending, a
    tie going to the lower column (as ``jax.lax.top_k`` breaks it;
    ``torch.topk`` promises no order on ties, so this is a stable sort)."""
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices
    pos = order[:, :k]
    return torch.gather(vals, 1, pos), torch.gather(ids, 1, pos)


def sharded_mips_topk(local_queries: torch.Tensor, local_shard: torch.Tensor,
                      k: int, dp, *, n_real: Optional[int] = None,
                      exact: bool = False, chunk_rows: int = 8192,
                      group_size: int = 128, cands_per_group: int = 2,
                      local_scales: Optional[torch.Tensor] = None,
                      rescore: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k search of every rank's queries against the index whose rows
    the ranks of ``dp.world`` hold in contiguous blocks of
    ``local_shard.shape[0]`` rows, by world rank (port of
    ``emdr2_tpu.ops.mips.sharded_mips_topk`` and the index's search,
    ``emdr2_tpu/retrieval/index.py:329-337``). ``dp`` is a
    ``parallel.mesh.DataParallel``: its ranks feed different queries, its
    tp ranks (``dp.tp``) the same ones; a ``Group`` without ``world`` is
    both.

    local_queries [b, d] (this rank's; equal b on every rank),
    local_shard [N/W, d] -> (scores [b, k] fp32, global row ids [b, k]).
    ``n_real``: rows at or past it (zero padding) never win. ``rescore``:
    the int8 re-rank window of the local search (``mips_topk``).

    1. all-gather the queries over dp -> [D * b, d] (D = dp ranks; the tp
       ranks hold the same ones, so no gather over tp);
    2. the local search (``mips_topk``: the K3 scan and its re-rank);
    3. local row ids + world rank * N/W -> global ids;
    4. all-gather (vals, ids) over the world -> [W, D * b, k];
    5. merge the W * k candidates of each query (``merge_topk``);
    6. keep this rank's b rows (its dp slice).
    With one rank the collectives copy nothing and the merge keeps the
    local order, so the result is the local search's."""
    b = local_queries.shape[0]
    blocks = getattr(dp, "world", dp)
    w = blocks.world_size
    shard_rows = local_shard.shape[0]
    start = blocks.rank * shard_rows
    n_valid = None
    if n_real is not None and n_real < start + shard_rows:
        n_valid = max(0, min(n_real - start, shard_rows))
    all_q = dp.all_gather_rows(local_queries)
    vals, idx = mips_topk(all_q, local_shard, k, exact=exact,
                          chunk_rows=chunk_rows, group_size=group_size,
                          cands_per_group=cands_per_group, n_valid=n_valid,
                          shard_scales=local_scales, rescore=rescore)
    idx = idx + start
    if n_real is not None:
        vals = torch.where(idx < n_real, vals, torch.full_like(vals, NEG_INF))
    nq = all_q.shape[0]
    av = blocks.all_gather(vals)                       # [W, D*b, k]
    ai = blocks.all_gather(idx)
    av = av.permute(1, 0, 2).reshape(nq, w * k)
    ai = ai.permute(1, 0, 2).reshape(nq, w * k)
    mvals, mids = merge_topk(av, ai, k)
    rank = dp.rank
    return mvals[rank * b:(rank + 1) * b], mids[rank * b:(rank + 1) * b]
