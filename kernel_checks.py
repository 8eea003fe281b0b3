"""The hand-written CUDA kernels held to their plain versions on the card,
at the shapes the main path gives them: one table of cases and limits
(``CHECKS``) that the ``gpu`` tests (``tests/test_torch_gpu.py``) run one
case a test and ``chip_smoke.py``'s kernel phase runs whole; and the recall
rule of the retrieval checks (``TIE_EPS``, ``explain_misses``), which the
tests and the smoke's retrieval phases share.

Limits, relative to the largest reference magnitude where a pair is given:
bf16 outputs within one bf16 step of the largest value at most and a tenth
of it on average (``FWD_TOL``); gradients likewise, dS and the dropped
probabilities rounded to bf16 for the tensor-core products (``GRAD_TOL``);
K2's fp32 lse absolutely (``LSE_TOL``, K4's relative to its largest) and
K1's saved (rowmax, 1/l) (``STATS_TOL``, 1/l relative); DA bit for bit.
Inputs pad each row from a random length, one row fully.

Each check raises ``AssertionError`` on a miss and returns the largest
error it saw relative to its reference's largest magnitude (0.0 where it
holds bits equal). The checks need a CUDA device; the module imports no
jax.
"""

from __future__ import annotations

import math

import torch

from emdr2_tpu_torch.ops import decode_attention, fid_attention, mips
from emdr2_tpu_torch.ops import dropout_add as dropadd
from emdr2_tpu_torch.ops.hashing import packed_dropout

FWD_TOL = (2e-2, 2e-3)
GRAD_TOL = (2e-2, 2e-3)
LSE_TOL = 1e-3
STATS_TOL = 1e-3
NH = 12                                  # the flagship's heads
TP_NH = 6                                # a tp=2 rank's heads of the 12
MAIN_RATE, MAIN_SEED = 0.1, 0x5EED       # the flagship recipe's dropout
SHARD_ROWS = 1_310_720                   # a card's shard of the index

# the recall rule: a search's top k against an exact one
TIE_EPS = 4             # a boundary tie: scores within this many fp32 eps
                        # of |k-th score|
K3_EXTRA = 8            # exact rows kept past the k-th
K3_BLOCK = 512          # exact and plain comparisons, queries a block


def gen(seed, dev="cuda"):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def assert_close(got, want, rel_max=2e-2, rel_mean=2e-3) -> float:
    """Errors relative to the largest reference magnitude (bf16 results);
    -> the largest."""
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs()
    ref = want.float().abs().max().item() or 1.0
    assert err.max().item() <= rel_max * ref, (err.max().item(), ref)
    assert err.mean().item() <= rel_mean * ref, (err.mean().item(), ref)
    return err.max().item() / ref


def stats_close(got, want, live, tol=1e-3) -> float:
    """(rowmax, 1/l) [B, nh, 2, L]: rows with a live key to ``tol`` (1/l
    relative), a fully padded row's rowmax is its scores (about -1e9) and
    its 1/l exactly 1/L."""
    B, nh, _, L = want.shape
    assert got.shape == want.shape and torch.isfinite(got).all()
    err = (got[live, :, 0] - want[live, :, 0]).abs().max().item()
    assert err <= tol
    rel = (got[live, :, 1] / want[live, :, 1] - 1.0).abs().max().item()
    assert rel <= tol, rel
    if (~live).any():
        assert (got[~live, :, 0] < -9e8).all()
        assert torch.equal(got[~live, :, 1],
                           torch.full_like(got[~live, :, 1], 1.0 / L))
    return max(err, rel)


def padded_bias(lens, L):
    return torch.where(torch.arange(L, device=lens.device)[None, :]
                       < lens[:, None], 0.0, -1e9).float()


# ---- K1: the flash self-attention of the towers and the FiD encoder ----

def _main_self_inputs(dev, B, L, seed, padded_row=True):
    g = gen(seed, dev)
    qkv = torch.randn(B, L, 3 * NH * 64, device=dev, generator=g
                      ).to(torch.bfloat16)
    lens = torch.randint(1, L + 1, (B,), device=dev, generator=g)
    if padded_row:
        lens[B // 2] = 0
    dout = torch.randn(B, L, NH * 64, device=dev, generator=g
                       ).to(torch.bfloat16)
    return qkv, padded_bias(lens, L), dout


SELF_FORWARD = [
    (8, 64, 0.0), (128, 64, 0.0),         # the query tower: serving, DPR
    (128, 256, 0.0), (256, 256, 0.0),     # the index builder, DPR contexts
    (400, 256, 0.0), (400, 512, 0.0),     # the context tower, the FiD reader
    (400, 512, MAIN_RATE)]


def self_attention_forward(dev, B, L, rate):
    """K1's output; the statistics it saves leave the output as it is, and
    hold to the plain ones on the first 32 rows and the fully padded
    one."""
    qkv, bias, _ = _main_self_inputs(dev, B, L, B + L)
    seed = MAIN_SEED if rate else None
    got = fid_attention.flash_self_attention(qkv, bias, NH, seed, rate)
    torch.cuda.synchronize()
    want = fid_attention.flash_self_attention_reference(qkv, bias, NH, seed,
                                                        rate)
    err = assert_close(got, want, *FWD_TOL)
    del want
    out, stats = fid_attention.flash_self_attention_forward(qkv, bias, NH,
                                                            seed, rate)
    assert torch.equal(out, got)
    rows = torch.unique(torch.tensor([*range(min(B, 32)), B // 2],
                                     device=dev))
    plain = fid_attention.flash_self_attention_stats_reference(
        qkv[rows], bias[rows], NH)
    stats_close(stats[rows], plain, (bias[rows] > -1e8).any(dim=1),
                STATS_TOL)
    return err


SELF_BACKWARD = [(8, 64), (128, 64), (256, 256), (400, 256), (400, 512)]


def self_attention_backward(dev, B, L):
    """K1's backward at rate 0.1 from its forward's output and statistics:
    the first 32 rows against the plain backward (its fp32 [B, nh, L, L]
    tensors), and a repeat bit for bit."""
    qkv, bias, dout = _main_self_inputs(dev, B, L, B + L + 1,
                                        padded_row=False)
    out, stats = fid_attention.flash_self_attention_forward(
        qkv, bias, NH, MAIN_SEED, MAIN_RATE)
    args = (qkv, bias, out, dout, NH, MAIN_SEED, MAIN_RATE)
    got = fid_attention.flash_self_attention_backward(*args, stats)
    torch.cuda.synchronize()
    n = min(B, 32)
    want = fid_attention.flash_self_attention_bwd_reference(
        *(t[:n] for t in args[:4]), *args[4:])
    err = assert_close(got[:n], want, *GRAD_TOL)
    assert torch.equal(fid_attention.flash_self_attention_backward(
        *args, stats), got)
    return err


def rel_inputs(B, L, nh, seed, spread=0.35, dev="cuda"):
    """T5's unscaled attention: q, k and v of N(0, spread^2), so that the
    scores (q . k over 64 dims, no scale) have s.d. about 1; a
    relative-position vector [nh, 2L-1] of N(0, 1) (the learned table's
    entries); a pad bias with a fully padded row and a padded tail."""
    g = gen(seed, dev)
    qkv = (spread * torch.randn(B, L, 3 * nh * 64, device=dev,
                                generator=g)).to(torch.bfloat16)
    rel = torch.randn(nh, 2 * L - 1, device=dev, generator=g)
    bias = torch.zeros(B, L, device=dev)
    bias[0, :] = -1e9
    bias[-1, L // 3:] = -1e9
    dout = torch.randn(B, L, nh * 64, device=dev, generator=g
                       ).to(torch.bfloat16)
    return qkv, rel, bias, dout


# the reader's [200, 512] x 16 heads of the atlas-large-b4 cell (B = 4
# questions x 50 passages), and smaller shapes with short tiles. The output
# and dqkv are held as every K1 check holds them; the bias's gradient is an
# fp32 sum of dS along a diagonal (up to B * L terms) in another order, over
# dS that differs from the plain version's by the forward's online softmax
# statistics and the fast exp, held to the same 2e-2 / 2e-3 of its largest
# entry
SELF_RELATIVE_BIAS = [(B, L, nh, rate) for rate in (0.0, 0.1)
                      for B, L, nh in ((2, 130, 16), (3, 64, 4),
                                       (200, 512, 16))]


def self_attention_relative_bias(dev, B, L, nh, rate):
    """K1 with T5 v1.1's relative-position bias (scale 1) through autograd:
    one launch each way, the output, dqkv and the bias's gradient against
    the plain versions."""
    qkv, rel, bias, dout = rel_inputs(B, L, nh, L + B, dev=dev)
    x = qkv.clone().requires_grad_(True)
    r = rel.clone().requires_grad_(True)
    fwd0 = fid_attention.flash_self_attention.rel_launches
    bwd0 = fid_attention.flash_self_attention_backward.rel_launches
    out = fid_attention.flash_self_attention(x, bias, nh, 77, rate, 1.0, r)
    out.backward(dout)
    torch.cuda.synchronize()
    assert fid_attention.flash_self_attention.rel_launches == fwd0 + 1
    assert fid_attention.flash_self_attention_backward.rel_launches == \
        bwd0 + 1
    want = fid_attention.flash_self_attention_reference(qkv, bias, nh, 77,
                                                        rate, 1.0, rel)
    errs = [assert_close(out.detach(), want)]
    del want
    dwant, drel = fid_attention.flash_self_attention_bwd_reference(
        qkv, bias, out.detach(), dout, nh, 77, rate, 1.0, rel)
    errs += [assert_close(x.grad, dwant), assert_close(r.grad, drel)]
    return max(errs)


def t5v11_encoder_relative_bias(dev):
    """The encoder of a T5 v1.1 reader (``t5_v11``: 24 layers of 1,024, 16
    heads, bf16, remat, flash attention) over the atlas-large cell's
    [200, 512] ids with padding, forward and backward under dropout: K1's
    relative-bias kernels launch 48 times forward (24 and their recompute)
    and 24 backward, and the bucket table gets a finite, non-zero
    gradient."""
    from emdr2_tpu_torch.config import t5_v11
    from emdr2_tpu_torch.models.layers import init_weights
    from emdr2_tpu_torch.models.t5 import T5Model
    from emdr2_tpu_torch.ops.hashing import DropoutSeeds
    B, L = 200, 512
    cfg = t5_v11(dtype=torch.bfloat16, remat=True, fid_flash_attention=True,
                 flash_key_chunk=L)
    model = T5Model(cfg, device=dev)
    init_weights(model)
    g = gen(21, dev)
    ids = torch.randint(1, cfg.vocab_size, (B, L), device=dev, generator=g)
    lens = torch.randint(L // 4, L + 1, (B,), device=dev, generator=g)
    ids = torch.where(torch.arange(L, device=dev)[None, :] < lens[:, None],
                      ids, torch.zeros_like(ids))
    fwd, bwd = (fid_attention.flash_self_attention,
                fid_attention.flash_self_attention_backward)
    before = (fwd.rel_launches, bwd.rel_launches)
    model.encode(ids, DropoutSeeds(MAIN_SEED)).float().square().mean(
        ).backward()
    torch.cuda.synchronize()
    assert (fwd.rel_launches - before[0], bwd.rel_launches - before[1]) == (
        2 * cfg.num_layers, cfg.num_layers)
    table = model.encoder.relative_attention_bias.grad
    assert table is not None and torch.isfinite(table).all()
    assert table.abs().max().item() > 0
    return 0.0


# ---- K2: the flash cross-attention of the decoders ----

def _reader_cross_inputs(dev, B, Lk, lo, hi, seed):
    g = gen(seed, dev)
    H = NH * 64
    q = torch.randn(B, 32, H, device=dev, generator=g).to(torch.bfloat16)
    kv = torch.randn(B, Lk, 2 * H, device=dev, generator=g
                     ).to(torch.bfloat16)
    real = torch.randint(lo, hi, (B,), device=dev, generator=g)
    dout = torch.randn(B, 32, H, device=dev, generator=g).to(torch.bfloat16)
    return q, kv, real, dout


CROSS = [(B, Lk, chunk, rate) for rate in (0.0, MAIN_RATE)
         for B, Lk, chunk in (
             (8, 25_600, 512),    # the reader's decoder over 50 x 512 keys
             (8, 25_600, 256),    # ... in the engine's chunks (100)
             (400, 512, 512))]    # the teacher's decoder


def cross_attention(dev, B, Lk, chunk, rate):
    """K2 forward (the wrapper's own key split) and backward against the
    plain versions, each row's keys past its length padded: the output, the
    lse to LSE_TOL on every row, dq and dkv, padded keys' dkv exactly 0,
    repeats bit for bit."""
    q, kv, real, dout = _reader_cross_inputs(dev, B, Lk, Lk // 2, Lk - 100,
                                             Lk + chunk)
    bias = padded_bias(real, Lk)
    seed = MAIN_SEED if rate else None
    fwd = (q, kv, bias, NH, chunk, seed, rate)
    out, lse = fid_attention.flash_cross_attention_forward(*fwd)
    torch.cuda.synchronize()
    w_out, w_lse = fid_attention.flash_cross_attention_reference(*fwd)
    errs = [assert_close(out, w_out, *FWD_TOL)]
    assert (lse - w_lse).abs().max().item() <= LSE_TOL
    again = fid_attention.flash_cross_attention_forward(*fwd)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)
    args = (q, kv, bias, w_lse, w_out, dout, NH, chunk, seed, rate)
    dq, dkv = fid_attention.flash_cross_attention_backward(*args)
    torch.cuda.synchronize()
    w_dq, w_dkv = fid_attention.flash_cross_attention_bwd_reference(*args)
    errs += [assert_close(dq, w_dq, *GRAD_TOL),
             assert_close(dkv, w_dkv, *GRAD_TOL)]
    assert bool((dkv[bias < -1e8] == 0).all())
    again = fid_attention.flash_cross_attention_backward(*args)
    assert torch.equal(again[0], dq) and torch.equal(again[1], dkv)
    return max(errs)


CROSS_SPLITS = [(n, rate) for rate in (0.0, MAIN_RATE) for n in (1, 2, 3, 7)]


def cross_attention_splits(dev, n, rate):
    """Seven chunks of 512 keys dealt to ``n`` splits of K2's forward and
    ``n`` runs of its backward (3 deals them 3, 3, 1), every key past the
    first 1,000-1,500 padded (whole splits hold padding only) and row 0
    fully: the forward against the plain version and its split + combine
    (lse to LSE_TOL on live rows, below -9e8 on row 0), the backward
    against the plain backward and its run sums (row 0 against the plain
    P = 1 result; padded keys of rows 1-3 get exactly zero dk and dv),
    repeats bit for bit."""
    B, Lk = 4, 7 * 512
    q, kv, real, dout = _reader_cross_inputs(dev, B, Lk, 1000, 1500, 100 + n)
    real[0] = 0
    bias = padded_bias(real, Lk)
    seed = MAIN_SEED if rate else None
    fwd = (q, kv, bias, NH, 512)
    out, lse = fid_attention.flash_cross_attention_forward(*fwd, seed, rate,
                                                           n)
    torch.cuda.synchronize()
    live = real > 0
    errs = []
    for w_out, w_lse in (
            fid_attention.flash_cross_attention_reference(*fwd, seed, rate),
            fid_attention.flash_cross_attention_split_reference(*fwd, n, seed,
                                                                rate)):
        errs.append(assert_close(out, w_out, *FWD_TOL))
        assert (lse - w_lse)[live].abs().max().item() <= LSE_TOL
    assert torch.isfinite(lse).all() and bool((lse[~live] < -9e8).all())
    again = fid_attention.flash_cross_attention_forward(*fwd, seed, rate, n)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)
    out, lse = fid_attention.flash_cross_attention_reference(*fwd, seed, rate)
    args = (q, kv, bias, lse, out, dout, NH, 512, seed, rate)
    dq, dkv = fid_attention._launch_cross_backward(*args, n_runs=n)
    torch.cuda.synchronize()
    w_dq, w_dkv = fid_attention.flash_cross_attention_bwd_reference(*args)
    s_dq, _ = fid_attention.flash_cross_attention_bwd_split_reference(
        *args[:8], n, seed, rate)
    for got, want in ((dq, w_dq), (dkv, w_dkv), (dq, s_dq), (dq[0], w_dq[0]),
                      (dkv[0], w_dkv[0])):
        errs.append(assert_close(got, want, *GRAD_TOL))
    for r in range(1, B):
        assert bool((dkv[r, real[r]:] == 0).all())
    again = fid_attention._launch_cross_backward(*args, n_runs=n)
    assert torch.equal(again[0], dq) and torch.equal(again[1], dkv)
    return max(errs)


# ---- K3: the candidate scan over a card's shard of the index ----

def _shard(dev, dtype, seed):
    """A shard of 1,310,720 x 768 rows of N(0, 1), the last 1,000 zero and
    masked: (fp32 rows, the stored rows, their scales or None, n_valid)."""
    emb = torch.randn(SHARD_ROWS, 768, device=dev, generator=gen(seed, dev))
    n_valid = SHARD_ROWS - 1000
    emb[n_valid:] = 0.0
    if dtype == torch.bfloat16:
        return emb, emb.to(torch.bfloat16), None, n_valid
    return (emb, *mips.quantize_int8(emb, 128), n_valid)


def _shard_queries(dev, dtype, nq, seed):
    """fp32 queries and the scan's: bf16, or int8 quantized per query as
    ``mips_topk`` does."""
    qf = torch.randn(nq, 768, device=dev, generator=gen(seed, dev))
    if dtype == torch.bfloat16:
        return qf, qf.to(torch.bfloat16)
    qs = qf.abs().amax(dim=1).clamp(min=1e-30) / 127.0
    return qf, torch.clamp(torch.round(qf / qs[:, None]), -127,
                           127).to(torch.int8)


def _scan_error(v, i, wv, wi, dtype):
    """The candidates against the plain scan's: int8 values and ids equal,
    bf16 values within 1e-3 |v| + 1e-3; -> the largest value error relative
    to the largest |value| of a live row (a masked one scores -inf)."""
    if dtype == torch.int8:
        assert torch.equal(v, wv) and torch.equal(i, wi)
        return 0.0
    err = (v - wv).abs()
    assert bool((err <= 1e-3 * wv.abs() + 1e-3).all()), err.max().item()
    live = wv.abs() < 1e30
    return err[live].max().item() / (wv[live].abs().max().item() or 1.0)


SCAN_DTYPES = [torch.bfloat16, torch.int8]
SCAN_NQ = [1, 2, 4, 8, 9, 16, 32, 64, 128, 256]
SCAN = [(dtype, nq) for nq in SCAN_NQ for dtype in SCAN_DTYPES]


def candidate_scan_both_kernels(dev, dtype, nq):
    """Both of K3's kernels forced over a shard's rows at the query counts
    around each type's crossover, against the plain version: int8 equal,
    bf16 within 1e-3 |v| + 1e-3."""
    _, index, _, n_valid = _shard(dev, dtype, 20)
    _, q = _shard_queries(dev, dtype, nq, nq)
    wv, wi = mips.candidate_scan_reference(q, index, n_valid, 128, 2)
    errs = []
    for route in ("cuda_core", "tensor_core"):
        v, i = mips._launch(q, index, n_valid, 128, 2, route)
        torch.cuda.synchronize()
        errs.append(_scan_error(v, i, wv, wi, dtype))
    return max(errs)


def exact_top(qf, rows_f, n_valid, k, q_dtype=None):
    """Exact top-(k + K3_EXTRA) (float64 scores, rows) over the stored rows
    (fp32 values, summed in float64), in query blocks: the rows past the
    k-th are the ones a boundary tie may trade in."""
    rows_d = rows_f[:n_valid].double()
    vals, idx = [], []
    for s in range(0, qf.shape[0], K3_BLOCK):
        q = qf[s:s + K3_BLOCK]
        if q_dtype is not None:
            q = q.to(q_dtype)
        v, i = torch.topk(torch.matmul(q.double(), rows_d.T), k + K3_EXTRA,
                          dim=1)
        vals.append(v)
        idx.append(i)
    del rows_d
    return torch.cat(vals), torch.cat(idx)


def explain_misses(ids, oracle, oracle_vals, k, ties=False, group=128):
    """Sort the misses of the search's rows ``ids`` [nq, k] against the
    exact top-k (the first k of ``oracle``, the exact top-(k + K3_EXTRA)
    rows with their float64 scores ``oracle_vals``) by what the search
    gives up by design. ``collided``: the row's group holds >= 3 of the
    true top-k (the scan keeps two a group). ``ties`` (counted when
    ``ties``): a retrieved row outside the true top-k scores within TIE_EPS
    fp32 eps of |k-th score| of the missed one, each retrieved row paired
    with one miss (the lowest miss with the best such row first), so an
    order of sums other than the exact search's may trade the two. Returns
    the counts, the widest tie in eps of |k-th score| (``tie_eps``), and
    the misses neither explains, [(query, row)]."""
    eps = torch.finfo(torch.float32).eps
    out = dict(misses=0, collided=0, ties=0, tie_eps=0.0, unexplained=[])
    for qi, (got, ext, v) in enumerate(zip(ids.tolist(), oracle.tolist(),
                                           oracle_vals.tolist())):
        want = ext[:k]
        score = dict(zip(ext, v))
        unit = eps * abs(v[k - 1])
        groups = [w // group for w in want]
        # rows outside the k-th place keep no score past the extended list
        intruders = sorted((score.get(x, -math.inf)
                            for x in set(got) - set(want)), reverse=True)
        for w in sorted(set(want) - set(got), key=score.get):
            out["misses"] += 1
            if groups.count(w // group) >= 3:
                out["collided"] += 1
                continue
            gap = (score[w] - intruders[0]) / unit if intruders else math.inf
            if ties and gap <= TIE_EPS:
                out["ties"] += 1
                out["tie_eps"] = max(out["tie_eps"], gap)
                intruders.pop(0)
            else:
                out["unexplained"].append((qi, w))
    return out


def misses_text(ex, k):
    return (f"misses {ex['misses']}: in a group holding >= 3 of the true "
            f"top-{k} {ex['collided']}, boundary ties {ex['ties']} (widest "
            f"{ex['tie_eps']:.3f} fp32 eps of |k-th score|), unexplained "
            f"{ex['unexplained']}")


def recall_at(ids, oracle, group=128):
    """Mean recall of ``ids`` against ``oracle`` (rows of equal length), and
    (misses, misses whose group holds >= 3 oracle rows)."""
    hits, misses, collided = 0, 0, 0
    for got, want in zip(ids.tolist(), oracle.tolist()):
        groups = [w // group for w in want]
        for w in set(want) - set(got):
            misses += 1
            collided += groups.count(w // group) >= 3
        hits += len(set(got) & set(want))
    return hits / oracle.numel(), (misses, collided)


TOPK = [*[(t, nq, 1234) for t in (torch.bfloat16, torch.int8)
          for nq in (8, 64, 512, 3610)],     # serving, above it, NQ-test
        (torch.bfloat16, 3610, 1235), (torch.bfloat16, 3610, 1236)]


def mips_topk_recall(dev, dtype, nq, seed):
    """The dispatch's scan against the plain version (in blocks of 512
    queries: a plain [3,610, 1.31M] score matrix is 19 GB), then the whole
    search's top 50 against an exact search over the stored rows (float64
    sums): at the serving batch every row; above it, every miss is a row
    whose group holds three of the true top 50 (the scan keeps two a group)
    or a boundary tie within ``TIE_EPS`` fp32 eps of the 50th score (the
    kernel's order of sums in bf16, the re-rank's fp32 rounding in int8)."""
    rows, index, scales, n_valid = _shard(dev, dtype, seed)
    del rows
    qf, q = _shard_queries(dev, dtype, nq, seed + nq)
    gv, gi = mips.candidate_scan(q, index, n_valid, 128, 2)
    torch.cuda.synchronize()
    errs = []
    for s in range(0, nq, K3_BLOCK):
        wv, wi = mips.candidate_scan_reference(q[s:s + K3_BLOCK], index,
                                               n_valid, 128, 2)
        errs.append(_scan_error(gv[s:s + K3_BLOCK], gi[s:s + K3_BLOCK], wv,
                                wi, dtype))
    del gv, gi, wv, wi
    _, ids = mips.mips_topk(qf, index, 50, n_valid=n_valid,
                            shard_scales=scales)
    stored = (index.float() if scales is None
              else mips.dequantize_int8(index, scales, 128))
    oracle_vals, oracle = exact_top(
        qf, stored, n_valid, 50, torch.bfloat16 if scales is None else None)
    del stored
    recall, _ = recall_at(ids, oracle[:, :50])
    ex = explain_misses(ids, oracle, oracle_vals, 50, ties=nq > 8)
    assert (nq > 8 or recall == 1.0) and not ex["unexplained"], (
        recall, misses_text(ex, 50))
    return max(errs)


# ---- K4: the general flash attention (FiD encoder under a key chunk) ----

FID_FORWARD = [(B, Lq, Lk, chunk, rate) for rate in (0.0, MAIN_RATE)
               for B, Lq, Lk, chunk in (
                   (400, 512, 512, 256),   # the reader's encoder, chunk 256
                   (3, 100, 288, 96),      # Lq != Lk, 3 chunks, ragged tiles
                   (16, 1024, 1024, 512))]  # 1,024 tokens in chunks of 512


def fid_cross_attention_forward(dev, B, Lq, Lk, chunk, rate):
    """K4's forward on [B, L, 12, 64] views of a qkv slab: the output, the
    lse to LSE_TOL of its largest, a repeat bit for bit."""
    g = gen(Lq + Lk + chunk, dev)
    H = NH * 64
    slab = torch.randn(B, max(Lq, Lk), 3 * H, device=dev, generator=g
                       ).to(torch.bfloat16)
    q = slab[:, :Lq, :H].view(B, Lq, NH, 64)
    k = slab[:, :Lk, H:2 * H].view(B, Lk, NH, 64)
    v = slab[:, :Lk, 2 * H:].view(B, Lk, NH, 64)
    bias = padded_bias(torch.randint(1, Lk + 1, (B,), device=dev,
                                     generator=g), Lk)
    args = (q, k, v, bias, MAIN_SEED if rate else None, chunk, rate)
    out, lse = fid_attention.fid_cross_attention_forward(*args)
    torch.cuda.synchronize()
    w_out, w_lse = fid_attention.fid_cross_attention_reference(*args)
    err = assert_close(out, w_out, *FWD_TOL)
    assert (lse - w_lse).abs().max().item() <= LSE_TOL * max(
        1.0, w_lse.abs().max().item())
    assert torch.equal(fid_attention.fid_cross_attention_forward(*args)[0],
                       out)
    return err


FID_BACKWARD = [(B, Lq, lens, rate) for rate in (0.0, MAIN_RATE)
                for B, Lq, lens in (
                    (400, 512, None),           # the reader, random lengths
                    (3, 300, (0, 300, 200)))]   # keys padded, row 0 masked


def fid_cross_attention_backward(dev, B, Lq, lens, rate):
    """K4's backward over 512 keys in chunks of 256 from its forward's out
    and lse, a cotangent that is not contiguous: the first 32 rows against
    the plain backward, a repeat bit for bit; with Lq = Lk, through autograd
    on the slab itself and on three views of it, gradients equal to the
    kernel's bit for bit."""
    Lk, chunk = 512, 256
    g = gen(B + Lq, dev)
    H = NH * 64
    slab = torch.randn(B, Lk, 3 * H, device=dev, generator=g
                       ).to(torch.bfloat16)
    q = slab[:, :Lq, :H].view(B, Lq, NH, 64)
    k = slab[:, :, H:2 * H].view(B, Lk, NH, 64)
    v = slab[:, :, 2 * H:].view(B, Lk, NH, 64)
    bias = padded_bias(torch.randint(1, Lk + 1, (B,), device=dev,
                                     generator=g) if lens is None
                       else torch.tensor(lens, device=dev), Lk)
    dout = torch.randn(B, NH, Lq, 64, device=dev, generator=g
                       ).to(torch.bfloat16).transpose(1, 2)
    seed = MAIN_SEED if rate else None
    out, lse = fid_attention.fid_cross_attention_forward(q, k, v, bias, seed,
                                                         chunk, rate)
    got = fid_attention.fid_cross_attention_backward(q, k, v, bias, lse, out,
                                                     dout, seed, chunk, rate)
    torch.cuda.synchronize()
    n = min(B, 32)
    want = fid_attention.fid_cross_attention_bwd_reference(
        q[:n], k[:n], v[:n], bias[:n], lse[:n * NH], out[:n], dout[:n], seed,
        chunk, rate)
    errs = [assert_close(g_[:n], w_, *GRAD_TOL) for g_, w_ in zip(got, want)]
    again = fid_attention.fid_cross_attention_backward(
        q, k, v, bias, lse, out, dout, seed, chunk, rate)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    if Lq == Lk:
        whole = torch.cat([t.reshape(B, Lk, H) for t in got], dim=-1)
        for route in ("slab", "three tensors"):
            leaf = slab.detach().clone().requires_grad_(True)
            if route == "slab":
                o = fid_attention.fid_self_attention(leaf, bias, NH, seed,
                                                     chunk, rate)
                o.backward(dout.reshape(B, Lk, H))
            else:
                views = [t.view(B, Lk, NH, 64) for t in leaf.chunk(3, dim=-1)]
                fid_attention.fid_cross_attention(*views, bias, seed, chunk,
                                                  rate).backward(dout)
            assert torch.equal(leaf.grad, whole), route
    return max(errs)


# ---- K5: the int8 decode attention of generation ----

DECODE = [
    (1, 25_600, 12_800, False),   # greedy over the reader's 50 x 512 keys
    (5, 25_600, 12_800, False),   # beam 5
    (5, 256, 200, False),         # a slab padded from 200 to 256 rows
    (5, 25_600, 12_800, True)]    # example 0 fully masked


def decode_attention_int8(dev, R, Lk, lo, masked):
    """K5 at [8, R, 12, Lk, 64], each example's rows padded as the decoder
    session pads them: against the plain version, the dense reference
    (3e-2 / 3e-3: the plain version rounds p * vscale to bf16, the kernel
    keeps it in fp32) and the plain form of its own order of sums; a
    repeat bit for bit; a fully masked example stays within twice the
    largest reference value."""
    B = 8
    g = gen(R + Lk, dev)
    q = torch.randn(B, R, NH, 64, device=dev, generator=g).to(torch.bfloat16)
    kf = torch.randn(B, NH, Lk, 64, device=dev, generator=g)
    vf = torch.randn(B, NH, Lk, 64, device=dev, generator=g)
    real = torch.randint(lo, Lk - 50 if Lk > 256 else lo + 1, (B,),
                         device=dev, generator=g)
    pad = torch.arange(Lk, device=dev)[None, :] >= real[:, None]
    kf.masked_fill_(pad[:, None, :, None], 0.0)
    vf.masked_fill_(pad[:, None, :, None], 0.0)
    k8, ks = decode_attention.quantize_kv_rows(kf)
    v8, vs = decode_attention.quantize_kv_rows(vf)
    bias = torch.where(pad, -1e9, 0.0).float()
    if masked:
        bias[0] = -1e9
    args = (q, k8, ks, v8, vs, bias)
    got = decode_attention.decode_cross_attention_int8(*args)
    torch.cuda.synchronize()
    want = decode_attention.decode_cross_attention_int8_plain(*args)
    errs = [assert_close(got, want, *FWD_TOL)]
    assert_close(got, decode_attention.decode_cross_attention_int8_reference(
        *args), 3e-2, 3e-3)
    layout = decode_attention.kernel_layout()
    spb, _ = decode_attention.split_plan(B, NH, Lk, dev)
    split = decode_attention.decode_cross_attention_int8_split_reference(
        *args, spb, layout.stage_keys, layout.warps)
    errs.append(assert_close(got, split, *FWD_TOL))
    assert torch.equal(decode_attention.decode_cross_attention_int8(*args),
                       got)
    if masked:
        assert got[0].abs().max().item() <= 2 * want.float().abs().max().item()
    return max(errs)


def tp_six_heads(dev):
    """What a rank at --tp 2 runs, at the flagship's shapes: K1 forward and
    backward on an [8, 512] slab of 6 heads at rate 0.1, K2 forward and
    backward over the reader's 25,600 keys in chunks of 512, K5 greedy over
    an int8 slab of 6 heads, each against its plain version."""
    g = gen(64, dev)
    H = TP_NH * 64
    qkv = torch.randn(8, 512, 3 * H, device=dev, generator=g
                      ).to(torch.bfloat16)
    bias = padded_bias(torch.randint(1, 513, (8,), device=dev, generator=g),
                       512)
    dout = torch.randn(8, 512, H, device=dev, generator=g).to(torch.bfloat16)
    drop = (MAIN_SEED, MAIN_RATE)
    out, stats = fid_attention.flash_self_attention_forward(qkv, bias, TP_NH,
                                                            *drop)
    errs = [assert_close(out, fid_attention.flash_self_attention_reference(
        qkv, bias, TP_NH, *drop), *FWD_TOL)]
    errs.append(assert_close(fid_attention.flash_self_attention_backward(
        qkv, bias, out, dout, TP_NH, *drop, stats),
        fid_attention.flash_self_attention_bwd_reference(
            qkv, bias, out, dout, TP_NH, *drop), *GRAD_TOL))
    del qkv, out, dout
    q = torch.randn(2, 32, H, device=dev, generator=g).to(torch.bfloat16)
    kv = torch.randn(2, 25_600, 2 * H, device=dev, generator=g
                     ).to(torch.bfloat16)
    kb = torch.zeros(2, 25_600, device=dev)
    kb[:, 24_000:] = -1e9
    dout = torch.randn(2, 32, H, device=dev, generator=g).to(torch.bfloat16)
    o, lse = fid_attention.flash_cross_attention_forward(q, kv, kb, TP_NH,
                                                         512, *drop)
    errs.append(assert_close(o, fid_attention.flash_cross_attention_reference(
        q, kv, kb, TP_NH, 512, *drop)[0], *FWD_TOL))
    args = (q, kv, kb, lse, o, dout, TP_NH, 512, *drop)
    for got, want in zip(
            fid_attention.flash_cross_attention_backward(*args),
            fid_attention.flash_cross_attention_bwd_reference(*args)):
        errs.append(assert_close(got, want, *GRAD_TOL))
    del kv
    qd = torch.randn(8, 1, TP_NH, 64, device=dev, generator=g
                     ).to(torch.bfloat16)
    k8, ks = decode_attention.quantize_kv_rows(torch.randn(
        8, TP_NH, 25_600, 64, device=dev, generator=g))
    v8, vs = decode_attention.quantize_kv_rows(torch.randn(
        8, TP_NH, 25_600, 64, device=dev, generator=g))
    db = torch.zeros(8, 25_600, device=dev)
    errs.append(assert_close(
        decode_attention.decode_cross_attention_int8(qd, k8, ks, v8, vs, db),
        decode_attention.decode_cross_attention_int8_plain(qd, k8, ks, v8, vs,
                                                           db), *FWD_TOL))
    return max(errs)


# ---- DA: dropout and the residual add in one pass ----

def plain_dropout_add(y, r, rate, seed, row_offset=0, head_offset=0):
    """``r + packed_dropout(y, ...)`` in plain PyTorch (the dropout alone
    without ``r``; ``r + y`` / ``y`` when evaluating)."""
    if seed is None or rate == 0.0:
        return y if r is None else r + y
    d = packed_dropout(y, rate, seed, row_offset, head_offset)
    return d if r is None else r + d


def dropout_add_matches_plain(shape, residual, dtype, rate, seed, row_offset,
                              head_offset, strided=False, misaligned=False,
                              dev="cuda"):
    """The kernel's output and its gradients against autograd through the
    plain path, ``torch.equal``; one launch each way. ``misaligned``: the
    kernel's inputs sit one element into a storage of their own, off 16
    bytes."""
    g = gen(seed % 1000, dev)
    y = torch.randn(shape, device=dev, generator=g).to(dtype)
    r = torch.randn(shape, device=dev, generator=g).to(dtype)
    y.view(-1)[:3] = torch.tensor([0.0, -0.0, -0.0])
    r.view(-1)[:3] = torch.tensor([-0.0, -0.0, 0.0])
    grad = torch.randn(shape, device=dev, generator=g).to(dtype)
    if strided:                          # a transposed view of each
        y, r, grad = (t.transpose(-1, -2).contiguous().transpose(-1, -2)
                      for t in (y, r, grad))
    r = r if residual else None

    def leaf(t):
        t = t.detach()
        if misaligned:
            return torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].view(
                t.shape).requires_grad_()
        return t.clone().requires_grad_()

    leaves = [leaf(t) for t in (y, r) if t is not None]
    assert all((t.data_ptr() % 16 != 0) == misaligned for t in leaves)
    plain = [t.detach().clone().requires_grad_() for t in (y, r)
             if t is not None]
    fwd, bwd = dropadd.dropout_add.launches, \
        dropadd.dropout_add_backward.launches
    got = dropadd.dropout_add(*leaves[:1], leaves[1] if residual else None,
                              rate, seed, row_offset, head_offset)
    want = plain_dropout_add(*plain[:1], plain[1] if residual else None,
                             rate, seed, row_offset, head_offset)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    got.backward(grad)
    want.backward(grad)
    for a, b in zip(leaves, plain):
        assert torch.equal(a.grad, b.grad)
    assert dropadd.dropout_add.launches == fwd + 1
    assert dropadd.dropout_add_backward.launches == bwd + 1
    return 0.0


DROPOUT_ADD = [
    ((400, 512, 768), True, 0, 0), ((400, 512, 768), False, 0, 0),
    ((400, 256, 768), True, 0, 0), ((400, 256, 768), False, 0, 0),
    ((400, 12, 32, 32), False, 0, 0),      # the decoders' probabilities
    ((400, 6, 32, 32), False, 400, 6)]     # ... a tp rank's 6 heads


def dropout_add_at_the_main_paths_shapes(dev, shape, residual, row_offset,
                                         head_offset):
    """DA in bf16 at the hidden rate and the residual sites' and the
    decoders' shapes: the output and the autograd gradients, and
    ``dropout_add_backward`` over a gradient, ``torch.equal`` to the plain
    path's."""
    seed = 2 ** 32 - 5
    dropout_add_matches_plain(shape, residual, torch.bfloat16, MAIN_RATE,
                              seed, row_offset, head_offset, dev=dev)
    grad = torch.randn(shape, device=dev, generator=gen(7, dev)
                       ).to(torch.bfloat16)
    site = dropadd._site(MAIN_RATE, seed, row_offset, head_offset,
                         grad.dtype)
    assert torch.equal(dropadd.dropout_add_backward(grad, site),
                       packed_dropout(grad, MAIN_RATE, seed, row_offset,
                                      head_offset))
    return 0.0


# ---- LN: the layer norm of the Megatron block ----

def layer_norm_inputs(shape, dtype, seed, dev="cuda"):
    g = gen(seed, dev)
    h = shape[-1]
    x = (3.0 * torch.randn(shape, device=dev, generator=g) + 0.5).to(dtype)
    w = 1.0 + 0.1 * torch.randn(h, device=dev, generator=g)
    b = 0.1 * torch.randn(h, device=dev, generator=g)
    dy = torch.randn(shape, device=dev, generator=g).to(dtype)
    return x, w, b, dy


def layer_norm_run(fn, x, w, b, dy, eps=1e-5):
    leaves = [t.detach().clone().requires_grad_() for t in (x, w, b)]
    out = fn(*leaves, eps)
    out.backward(dy)
    return [out.detach()] + [t.grad for t in leaves]


# The reader's and the context tower's rows, the embedder's batch, the
# query tower's, a ragged row count, H = 64 (8 lanes of a warp) and
# H = 2,048 (a block a row). Limits, relative to the largest reference
# magnitude: the kernels and the formula both compute in fp32 and round the
# output and dx once to x's dtype, but sum each row in another order: in
# bf16 a value may round to its neighbour, one bf16 step (2^-7 of the
# largest value at most; 1e-3 of it on average); in fp32 the sums of
# 768-2,048 terms differ by a few ulps (1e-5). dw and db are fp32 sums over
# up to 204,800 rows in another order on both sides (1e-5; a lost block's
# partial would be 1/264 off).
LAYER_NORM_DTYPES = [torch.bfloat16, torch.float32]
LAYER_NORM_SHAPES = [(400, 512, 768), (400, 256, 768), (128, 256, 768),
                     (8, 64, 768), (1001, 768), (3, 4099, 64), (300, 2048)]
LAYER_NORM = [(shape, dtype) for dtype in LAYER_NORM_DTYPES
              for shape in LAYER_NORM_SHAPES]


def layer_norm_matches_the_formula(dev, shape, dtype):
    """LN through autograd against autograd through the formula
    (``layer_norm_reference``): one launch each way, y, dx, dw, db."""
    from emdr2_tpu_torch.ops import layer_norm as ln
    x, w, b, dy = layer_norm_inputs(shape, dtype, sum(shape), dev)
    fwd, bwd = ln.layer_norm.launches, ln.layer_norm_backward.launches
    got = layer_norm_run(ln.layer_norm, x, w, b, dy)
    assert (ln.layer_norm.launches, ln.layer_norm_backward.launches) == (
        fwd + 1, bwd + 1)
    want = layer_norm_run(ln.layer_norm_reference, x, w, b, dy)
    assert got[0].dtype == got[1].dtype == dtype
    tol = (2 ** -7, 1e-3) if dtype == torch.bfloat16 else (1e-5, 1e-6)
    return max(assert_close(got[0], want[0], *tol),
               assert_close(got[1], want[1], *tol),
               assert_close(got[2], want[2], 1e-5, 1e-6),
               assert_close(got[3], want[3], 1e-5, 1e-6))


def layer_norm_step_launches(cfg):
    """(forward, backward) launches of the layer-norm kernel in one
    ``E2EQATask.train_step`` of the Megatron block, by the code: a tower is
    2 norms a layer and its stack's final one, a T5 encoder likewise, a T5
    decoder 3 a layer and the final one; a checkpointed stack's recompute
    runs each layer's norms again (the final norm is outside the
    checkpoints). Forward: stage A's query tower, stage C's query and
    context towers, the reader's encoder and decoder (their recompute
    under remat) and, under ``no_grad``, the teacher's encoder and decoder;
    backward: the two towers, the reader's encoder and decoder."""
    t, r = cfg.retriever.encoder, cfg.reader.transformer
    tower, enc, dec = (2 * t.num_layers + 1, 2 * r.num_layers + 1,
                       3 * r.num_layers + 1)
    redo_tower = 2 * t.num_layers if t.remat else 0
    redo_reader = 5 * r.num_layers if r.remat else 0
    fwd = tower + 2 * (tower + redo_tower) + 2 * (enc + dec) + redo_reader
    return fwd, 2 * tower + enc + dec


# ---- the embedding lookup's backward (PyTorch's, made to repeat) ----

LOOKUPS = [
    (2, 65_536),                  # a tower's tokentype table
    (30_592, 65_536),             # its word table
    (30_720, 204_800)]            # the reader's shared table


def embedding_lookup_backward_repeats(dev, rows, lookups):
    """``layers.embedding``'s weight gradient over a step's lookups (ids
    skewed towards the table's first rows) is the same bits in five runs
    (``F.embedding``'s CUDA backward sums in the order its threads
    arrive)."""
    from emdr2_tpu_torch.models.layers import embedding
    g = gen(rows, dev)
    ids = (torch.rand(lookups, device=dev, generator=g) ** 4 * rows
           ).long().clamp_(max=rows - 1)
    dout = torch.randn(lookups, 768, device=dev, generator=g)
    w = torch.zeros(rows, 768, device=dev, requires_grad=True)
    grads = []
    for _ in range(5):
        w.grad = None
        embedding(ids, w).backward(dout)
        grads.append(w.grad.clone())
    assert all(torch.equal(grads[0], x) for x in grads[1:])
    return 0.0


# every check and its cases, in the order the smoke runs them
CHECKS = (
    (self_attention_forward, SELF_FORWARD),
    (self_attention_backward, SELF_BACKWARD),
    (self_attention_relative_bias, SELF_RELATIVE_BIAS),
    (t5v11_encoder_relative_bias, [()]),
    (cross_attention, CROSS),
    (cross_attention_splits, CROSS_SPLITS),
    (candidate_scan_both_kernels, SCAN),
    (mips_topk_recall, TOPK),
    (fid_cross_attention_forward, FID_FORWARD),
    (fid_cross_attention_backward, FID_BACKWARD),
    (decode_attention_int8, DECODE),
    (tp_six_heads, [()]),
    (dropout_add_at_the_main_paths_shapes, DROPOUT_ADD),
    (layer_norm_matches_the_formula, LAYER_NORM),
    (embedding_lookup_backward_repeats, LOOKUPS),
)

# each counted kernel (the wrapper whose ``.launches`` counts it), its
# source under ``emdr2_tpu_torch/ops/csrc/`` and the checks that hold it
KERNELS = {
    "flash_self_attention": ("flash_self_attention.cu", (
        self_attention_forward, self_attention_relative_bias, tp_six_heads)),
    "flash_self_attention_backward": ("flash_self_attention.cu", (
        self_attention_backward, self_attention_relative_bias,
        tp_six_heads)),
    "flash_cross_attention": ("flash_cross_attention.cu", (
        cross_attention, cross_attention_splits, tp_six_heads)),
    "flash_cross_attention_backward": ("flash_cross_attention.cu", (
        cross_attention, cross_attention_splits, tp_six_heads)),
    "candidate_scan": ("candidate_scan.cu", (candidate_scan_both_kernels,
                                             mips_topk_recall)),
    "fid_cross_attention": ("fid_attention.cu", (
        fid_cross_attention_forward,)),
    "fid_cross_attention_backward": ("fid_attention.cu", (
        fid_cross_attention_backward,)),
    "decode_cross_attention_int8": ("decode_attention.cu", (
        decode_attention_int8, tp_six_heads)),
    "dropout_add": ("dropout_add.cu", (dropout_add_at_the_main_paths_shapes,)),
    "dropout_add_backward": ("dropout_add.cu", (
        dropout_add_at_the_main_paths_shapes,)),
    "layer_norm": ("layer_norm.cu", (layer_norm_matches_the_formula,)),
    "layer_norm_backward": ("layer_norm.cu", (
        layer_norm_matches_the_formula,)),
}
