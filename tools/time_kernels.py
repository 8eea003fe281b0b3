#!/usr/bin/env python3
"""Time the port's hand-written kernels on the card, one JSON row a shape.

    python3 tools/time_kernels.py [--tree DIR] [--kernel ID]

``ID`` is one of K1-fwd, K1-bwd, K1-bias, K2-fwd, K2-bwd, K3, K4-fwd,
K4-bwd, K5, DA, LN (default: every one), at the shapes PERF.md section 6
reports: the main path's and the cells'. Each row holds:

- ``one_call_ms``: one call between two CUDA events, median of 20 after 3
  warm-up calls. It holds the wrapper's host work where that is longer
  than the kernel.
- ``queued_ms``: ten calls queued back to back between two events, a
  tenth of the median of 10: the kernels' own time a call.
- ``plain_ms``: the plain PyTorch version of the same call (the CPU route
  and the tests' oracle), one call, median of 3 after 1.
- ``library`` and ``library_ms``: the PyTorch call that does the same work
  where one exists (``scaled_dot_product_attention``, the score GEMM alone,
  ``r + F.dropout(y)``, ``F.layer_norm``: yardsticks only, the port never
  calls them), ten queued calls, a call.
- ``bound_ms``, ``bound_by``: max(bytes / the memory rate, operations /
  the peak rate of their type) on this card (``flagship.bound_ms``), from
  ``bytes`` (each input read once, each output written once) and ``ops``.

K3 adds one crossover row a type (both of its kernels forced at 1-256
queries), and K2-bwd's reader row its time by forced run count. Nothing
here checks a result: ``tests/test_torch_gpu.py`` holds every kernel to
its plain version, on the card.

``--tree DIR`` times the kernels of another checkout (the root of a tree
that holds ``emdr2_tpu_torch``; its kernels are built there) with this
file's timer and rates. To compare two commits, unpack the other one with
``git archive`` into a directory and run this script once a tree, on one
card, in the order parent, change, change, parent: a process imports one
tree only. Needs a CUDA device. Prints the card's name and power limit,
then the rows.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 1234
RATE, DROP_SEED = 0.1, 0x5EED        # the flagship recipe's dropout
N_INDEX, D = 1_310_720, 768          # a card's shard of the evidence index
NH = 12
KERNELS = ("K1-fwd", "K1-bwd", "K1-bias", "K2-fwd", "K2-bwd", "K3",
           "K4-fwd", "K4-bwd", "K5", "DA", "LN")


def _flagship():
    """This file's ``tools/flagship.py`` (the timer and the card's rates),
    whichever tree's ``emdr2_tpu_torch`` is on the path."""
    spec = importlib.util.spec_from_file_location(
        "time_kernels_flagship",
        os.path.join(HERE, "emdr2_tpu_torch", "tools", "flagship.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def padding_bias(lens, L, dev):
    """[B, L] key bias: 0 on each row's first ``lens`` keys, -1e9 past."""
    return torch.where(torch.arange(L, device=dev)[None, :] < lens[:, None],
                       0.0, -1e9).float()


def sdpa(q, k, v, bias, scale=None):
    """heads-first q [B, nh, Lq, hd], k, v [B, nh, Lk, hd] and the key bias
    [B, Lk] (or a whole mask) as an additive mask."""
    mask = bias if bias.dim() == 4 else bias[:, None, None, :]
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask.to(q.dtype), scale=scale)


def heads(slab, n, nh=NH):
    """[B, L, n*H] projection slab -> n heads-first views [B, nh, L, hd]."""
    B, L = slab.shape[:2]
    parts = slab.view(B, L, n, nh, -1).permute(2, 0, 3, 1, 4)
    return [parts[i] for i in range(n)]


def sdpa_backward(q_slab, n_q, kv_slab, n_kv, bias, dout):
    """SDPA's backward alone from saved state, on views of the slabs (rate
    0): a callable."""
    leaves = [t.detach().clone().requires_grad_(True)
              for t in ((q_slab,) if kv_slab is q_slab else (q_slab, kv_slab))]
    q = heads(leaves[0], n_q)[0]
    k, v = heads(leaves[-1], n_kv)[-2:]
    out = sdpa(q, k, v, bias)
    g = heads(dout, 1)[0]
    return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)


def sdpa_forward(q_slab, n_q, kv_slab, n_kv, bias):
    with torch.no_grad():
        q = heads(q_slab, n_q)[0]
        k, v = heads(kv_slab, n_kv)[-2:]
    return lambda: sdpa(q, k, v, bias)


def no_grad(fn):
    def call():
        with torch.no_grad():
            return fn()
    return call


def k1_fwd(dev, gen):
    from emdr2_tpu_torch.ops import fid_attention as fa
    # the query tower (serving and the DPR step), the index builder, the
    # DPR step's contexts, the context tower and the FiD encoder
    for B, L, rate in ((8, 64, 0.0), (128, 64, 0.0), (128, 256, 0.0),
                       (256, 256, 0.0), (400, 256, 0.0), (400, 512, 0.0),
                       (400, 512, RATE)):
        qkv = torch.randn(B, L, 3 * NH * 64, device=dev, generator=gen
                          ).to(torch.bfloat16)
        bias = padding_bias(torch.randint(1, L + 1, (B,), device=dev,
                                          generator=gen), L, dev)
        seed = DROP_SEED if rate else None
        out = fa.flash_self_attention(qkv, bias, NH, seed, rate)
        yield dict(
            case=dict(shape=[B, L, 3 * NH * 64], rate=rate),
            call=no_grad(lambda: fa.flash_self_attention(qkv, bias, NH, seed,
                                                         rate)),
            plain=lambda: fa.flash_self_attention_reference(qkv, bias, NH,
                                                            seed, rate),
            library=("SDPA, rate 0", sdpa_forward(qkv, 3, qkv, 3, bias)),
            bytes=nbytes(qkv, bias, out), ops=4 * B * NH * L * L * 64)


def k1_bwd(dev, gen):
    from emdr2_tpu_torch.ops import fid_attention as fa
    for B, L in ((8, 64), (128, 64), (256, 256), (400, 256), (400, 512)):
        qkv = torch.randn(B, L, 3 * NH * 64, device=dev, generator=gen
                          ).to(torch.bfloat16)
        bias = padding_bias(torch.randint(1, L + 1, (B,), device=dev,
                                          generator=gen), L, dev)
        dout = torch.randn(B, L, NH * 64, device=dev, generator=gen
                           ).to(torch.bfloat16)
        out, stats = fa.flash_self_attention_forward(qkv, bias, NH,
                                                     DROP_SEED, RATE)
        yield dict(
            case=dict(shape=[B, L, 3 * NH * 64], rate=RATE),
            call=lambda: fa.flash_self_attention_backward(
                qkv, bias, out, dout, NH, DROP_SEED, RATE, stats),
            plain=lambda: fa.flash_self_attention_bwd_reference(
                qkv, bias, out, dout, NH, DROP_SEED, RATE),
            library=("SDPA backward, rate 0",
                     sdpa_backward(qkv, 3, qkv, 3, bias, dout)),
            bytes=nbytes(qkv, bias, out, dout, stats, qkv),
            ops=2.5 * 4 * B * NH * L * L * 64)


def k1_bias(dev, gen):
    """T5 v1.1's relative-position variant at the atlas-large reader's
    [200, 512] x 16 heads, scale 1; q, k, v of N(0, 0.35^2) so that the
    unscaled scores have s.d. about 1. ``no_bias_queued_ms``: the same kernel
    without the bias (scale 1), ten queued calls."""
    from emdr2_tpu_torch.ops import fid_attention as fa
    B, L, nh = 200, 512, 16
    qkv = (0.35 * torch.randn(B, L, 3 * nh * 64, device=dev, generator=gen)
           ).to(torch.bfloat16)
    rel = torch.randn(nh, 2 * L - 1, device=dev, generator=gen)
    bias = padding_bias(torch.randint(1, L + 1, (B,), device=dev,
                                      generator=gen), L, dev)
    dout = torch.randn(B, L, nh * 64, device=dev, generator=gen
                       ).to(torch.bfloat16)
    flop = 4 * B * nh * L * L * 64
    for rate in (RATE, 0.0):
        seed = DROP_SEED if rate else None
        out, stats = fa.flash_self_attention_forward(
            qkv, bias, nh, seed, rate, scale=1.0, rel_bias=rel)
        _, stats0 = fa.flash_self_attention_forward(qkv, bias, nh, seed,
                                                    rate, scale=1.0)
        with torch.no_grad():
            q, k, v = (t.transpose(1, 2)
                       for t in qkv.view(B, L, 3, nh, 64).unbind(2))
            mask = (bias[:, None, None, :] + fa.rel_bias_full(rel, L, L)[None]
                    ).to(torch.bfloat16)
        yield dict(
            case=dict(shape=[B, L, nh, 64], rate=rate, way="forward"),
            call=lambda: fa.flash_self_attention_forward(
                qkv, bias, nh, seed, rate, scale=1.0, rel_bias=rel),
            plain=lambda: fa.flash_self_attention_reference(
                qkv, bias, nh, seed, rate, 1.0, rel),
            library=("SDPA, the bias as a [B, nh, L, L] mask, rate 0",
                     no_grad(lambda: sdpa(q, k, v, mask, 1.0))),
            extra=dict(no_bias=lambda: fa.flash_self_attention_forward(
                qkv, bias, nh, seed, rate, scale=1.0)),
            bytes=nbytes(qkv, bias, rel, out, stats), ops=flop)
        # q, k, v, out, dout, the pad bias, the statistics, delta (written
        # and read), dqkv, the vector and its gradient
        yield dict(
            case=dict(shape=[B, L, nh, 64], rate=rate, way="backward"),
            call=lambda: fa.flash_self_attention_backward(
                qkv, bias, out, dout, nh, seed, rate, stats, 1.0, rel),
            plain=lambda: fa.flash_self_attention_bwd_reference(
                qkv, bias, out, dout, nh, seed, rate, 1.0, rel),
            extra=dict(no_bias=lambda: fa.flash_self_attention_backward(
                qkv, bias, out, dout, nh, seed, rate, stats0, 1.0)),
            bytes=(nbytes(qkv, bias, out, dout, stats, qkv, rel, rel)
                   + 2 * B * nh * L * 4),
            ops=2.5 * flop)


def _cross_cases(dev, gen):
    """(name, B, Lk, key chunk, q, kv, bias, dout): the reader's decoder
    over 50 x 512 keys in chunks of 512 and 256 (the engine's), and the
    teacher's over 512; each row's keys past its length padded."""
    for name, B, Lk, chunk in (("reader", 8, 25_600, 512),
                               ("reader", 8, 25_600, 256),
                               ("teacher", 400, 512, 512)):
        H = NH * 64
        q = torch.randn(B, 32, H, device=dev, generator=gen).to(torch.bfloat16)
        kv = torch.randn(B, Lk, 2 * H, device=dev, generator=gen
                         ).to(torch.bfloat16)
        bias = padding_bias(torch.randint(Lk // 2, Lk - 100, (B,), device=dev,
                                          generator=gen), Lk, dev)
        dout = torch.randn(B, 32, H, device=dev, generator=gen
                           ).to(torch.bfloat16)
        yield name, B, Lk, chunk, q, kv, bias, dout


def k2_fwd(dev, gen):
    from emdr2_tpu_torch.ops import fid_attention as fa
    for name, B, Lk, chunk, q, kv, bias, _ in _cross_cases(dev, gen):
        out, lse = fa.flash_cross_attention_forward(q, kv, bias, NH, chunk,
                                                    DROP_SEED, RATE)
        yield dict(
            case=dict(shape=[B, 32, Lk], name=name, key_chunk=chunk,
                      rate=RATE),
            call=lambda: fa.flash_cross_attention_forward(
                q, kv, bias, NH, chunk, DROP_SEED, RATE),
            plain=lambda: fa.flash_cross_attention_reference(
                q, kv, bias, NH, chunk, DROP_SEED, RATE),
            library=("SDPA, rate 0", sdpa_forward(q, 1, kv, 2, bias)),
            bytes=nbytes(q, kv, bias, out, lse),
            ops=4 * B * NH * 32 * Lk * 64)


def k2_bwd(dev, gen):
    """``by_runs``: the reader's backward at key chunk 512 with its keys
    forced into 2-50 runs (blocks = runs x 96), ten queued calls."""
    from emdr2_tpu_torch.ops import fid_attention as fa
    for name, B, Lk, chunk, q, kv, bias, dout in _cross_cases(dev, gen):
        out, lse = fa.flash_cross_attention_reference(q, kv, bias, NH, chunk,
                                                      DROP_SEED, RATE)
        args = (q, kv, bias, lse, out, dout, NH, chunk, DROP_SEED, RATE)
        extra = {}
        if name == "reader" and chunk == 512:
            n_chunks = Lk // chunk
            for n in sorted({fa._split_chunks(n_chunks, n)[0]
                             for n in (2, 5, 10, 17, 25, n_chunks)}):
                extra[f"runs_{n}"] = (
                    lambda n=n: fa._launch_cross_backward(*args, n_runs=n))
        yield dict(
            case=dict(shape=[B, 32, Lk], name=name, key_chunk=chunk,
                      rate=RATE),
            call=lambda: fa.flash_cross_attention_backward(*args),
            plain=lambda: fa.flash_cross_attention_bwd_reference(*args),
            library=("SDPA backward, rate 0",
                     sdpa_backward(q, 1, kv, 2, bias, dout)),
            extra=extra,
            bytes=nbytes(q, kv, bias, lse, out, dout, q, kv),
            ops=2.5 * 4 * B * NH * 32 * Lk * 64)


def _queries(name, nq, dev, gen):
    """bf16 queries, or int8 quantized per query as ``mips_topk`` does."""
    qf = torch.randn(nq, D, device=dev, generator=gen)
    if name == "bf16":
        return qf.to(torch.bfloat16)
    qs = qf.abs().amax(dim=1).clamp(min=1e-30) / 127.0
    return torch.clamp(torch.round(qf / qs[:, None]), -127, 127
                       ).to(torch.int8)


def _score_gemm(q, index):
    """The score matrix alone: a bf16 GEMM, or ``torch._int_mm`` (int8 in,
    int32 out; it wants more than 16 rows: queries padded to 32s)."""
    if q.dtype == torch.int8:
        pad = -q.shape[0] % 32
        qp = torch.nn.functional.pad(q, (0, 0, 0, pad)) if pad else q
        return torch._int_mm(qp, index.T)
    return torch.matmul(q, index.T)


def k3(dev, gen, clock):
    """The candidate scan over a shard of 1,310,720 x 768 rows (the last
    1,000 masked), per-group top-2 of 128-row groups: the dispatch at the
    serving batch (8 queries), 64, 512 and the 3,610 questions of
    NQ-test's evaluation; the plain version in blocks of 512 queries (a
    plain [3,610, 1.31M] fp32 score matrix is 19 GB)."""
    from emdr2_tpu_torch.ops import mips
    n_valid = N_INDEX - 1000
    emb = torch.randn(N_INDEX, D, device=dev, generator=gen)
    emb[n_valid:] = 0.0
    stored = {"bf16": emb.to(torch.bfloat16),
              "int8": mips.quantize_int8(emb, 128)[0]}
    del emb
    for name, index in stored.items():
        sweep = {"cuda_core": [], "tensor_core": []}
        nqs = (1, 2, 4, 8, 9, 16, 32, 64, 128, 256)
        for nq in nqs:
            q = _queries(name, nq, dev, gen)
            for route, times in sweep.items():
                times.append(clock.event_ms(lambda r=route: mips._launch(
                    q, index, n_valid, 128, 2, r), reps=10, calls=10))
        yield dict(row=dict(case="crossover", dtype=name, nq=list(nqs),
                            **{f"{r}_queued_ms": t for r, t in sweep.items()},
                            tensor_core_min_nq=mips.TENSOR_CORE_MIN_NQ[
                                index.dtype]))
        for nq in (8, 64, 512, 3610):
            q = _queries(name, nq, dev, gen)
            gv, gi = mips.candidate_scan(q, index, n_valid, 128, 2)
            yield dict(
                case=dict(shape=[nq, N_INDEX, D], dtype=name,
                          route=mips.scan_route(nq, 128, index.dtype)),
                call=lambda: mips.candidate_scan(q, index, n_valid, 128, 2),
                plain=lambda: [mips.candidate_scan_reference(
                    q[s:s + 512], index, n_valid, 128, 2)
                    for s in range(0, nq, 512)],
                library=("the score GEMM alone",
                         lambda: _score_gemm(q, index)),
                bytes=nbytes(q, index, gv, gi), ops=2 * nq * N_INDEX * D,
                op_type=name)
    del stored


def _fid_views(dev, gen, B, L, lens):
    """q, k, v as [B, L, 12, 64] views of one qkv slab (no copies), the
    slab, and the key bias."""
    slab = torch.randn(B, L, 3 * NH * 64, device=dev, generator=gen
                       ).to(torch.bfloat16)
    q, k, v = (t.view(B, L, NH, 64) for t in slab.chunk(3, dim=-1))
    return slab, q, k, v, padding_bias(lens, L, dev)


def k4_fwd(dev, gen):
    """The reader's encoder under key chunk 256 (its 512 keys in two
    chunks)."""
    from emdr2_tpu_torch.ops import fid_attention as fa
    B, L, chunk = 400, 512, 256
    slab, q, k, v, bias = _fid_views(dev, gen, B, L, torch.randint(
        1, L + 1, (B,), device=dev, generator=gen))
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    for rate in (0.0, RATE):
        seed = DROP_SEED if rate else None
        out, lse = fa.fid_cross_attention_forward(q, k, v, bias, seed, chunk,
                                                  rate)
        yield dict(
            case=dict(shape=[B, L, L, NH, 64], key_chunk=chunk, rate=rate),
            call=lambda: fa.fid_cross_attention_forward(q, k, v, bias, seed,
                                                        chunk, rate),
            plain=lambda: fa.fid_cross_attention_reference(q, k, v, bias,
                                                           seed, chunk, rate),
            library=("SDPA, rate 0", no_grad(lambda: sdpa(qh, kh, vh, bias))),
            bytes=nbytes(q, k, v, bias, out, lse),
            ops=4 * B * NH * L * L * 64)


def k4_bwd(dev, gen):
    from emdr2_tpu_torch.ops import fid_attention as fa
    B, L, chunk = 400, 512, 256
    slab, q, k, v, bias = _fid_views(dev, gen, B, L, torch.randint(
        1, L + 1, (B,), device=dev, generator=gen))
    # a cotangent that is not contiguous, as a reshape may hand over
    dout = torch.randn(B, NH, L, 64, device=dev, generator=gen
                       ).to(torch.bfloat16).transpose(1, 2)
    for rate in (RATE, 0.0):
        seed = DROP_SEED if rate else None
        out, lse = fa.fid_cross_attention_forward(q, k, v, bias, seed, chunk,
                                                  rate)
        yield dict(
            case=dict(shape=[B, L, L, NH, 64], key_chunk=chunk, rate=rate),
            call=lambda: fa.fid_cross_attention_backward(
                q, k, v, bias, lse, out, dout, seed, chunk, rate),
            plain=lambda: fa.fid_cross_attention_bwd_reference(
                q, k, v, bias, lse, out, dout, seed, chunk, rate),
            library=("SDPA backward, rate 0", sdpa_backward(
                slab, 3, slab, 3, bias, dout.reshape(B, L, NH * 64))),
            bytes=nbytes(q, k, v, bias, lse, out, dout, q, k, v),
            ops=2.5 * 4 * B * NH * L * L * 64)


def k5(dev, gen):
    """The int8 decode attention at the reader's decoder over 50 x 512
    keys: beam 5 and greedy (R query rows an example); rows past each
    example's length padded as the decoder session pads them (value 0,
    scale 1, bias -1e9)."""
    from emdr2_tpu_torch.ops import decode_attention as da
    B, Lk = 8, 25_600
    kf = torch.randn(B, NH, Lk, 64, device=dev, generator=gen)
    vf = torch.randn(B, NH, Lk, 64, device=dev, generator=gen)
    pad = torch.arange(Lk, device=dev)[None, :] >= torch.randint(
        Lk // 2, Lk - 50, (B,), device=dev, generator=gen)[:, None]
    kf.masked_fill_(pad[:, None, :, None], 0.0)
    vf.masked_fill_(pad[:, None, :, None], 0.0)
    k8, ks = da.quantize_kv_rows(kf)
    v8, vs = da.quantize_kv_rows(vf)
    bias = torch.where(pad, -1e9, 0.0).float()
    # the same call on the slab dequantized to bf16: twice the bytes
    kb = (k8.float() * ks[..., None]).to(torch.bfloat16)
    vb = (v8.float() * vs[..., None]).to(torch.bfloat16)
    del kf, vf
    for R in (5, 1):
        q = torch.randn(B, R, NH, 64, device=dev, generator=gen
                        ).to(torch.bfloat16)
        out = da.decode_cross_attention_int8(q, k8, ks, v8, vs, bias)
        qh = q.transpose(1, 2)
        yield dict(
            case=dict(shape=[B, R, NH, Lk, 64]),
            call=lambda: da.decode_cross_attention_int8(q, k8, ks, v8, vs,
                                                        bias),
            plain=lambda: da.decode_cross_attention_int8_plain(
                q, k8, ks, v8, vs, bias),
            library=("SDPA on the bf16 slab",
                     no_grad(lambda: sdpa(qh, kb, vb, bias))),
            bytes=nbytes(q, k8, ks, v8, vs, bias, out),
            ops=4 * B * R * NH * Lk * 64)


def dropout_add(dev, gen):
    """DA at the residual sites' [400, 512, 768] (the FiD and teacher
    encoders) and [400, 256, 768] (the context tower), bf16, with and
    without the residual: forward, and the backward its autograd Function
    launches (it hashes the mask again) against the plain path's autograd
    over its saved mask. Bound by bytes: 6 (4) bytes an element forward
    with (without) the residual, 4 backward."""
    from emdr2_tpu_torch.ops import dropout_add as da
    from emdr2_tpu_torch.ops.hashing import packed_dropout
    F = torch.nn.functional
    for shape in ((400, 512, 768), (400, 256, 768)):
        y, r0, g = (torch.randn(shape, device=dev, generator=gen
                                ).to(torch.bfloat16) for _ in range(3))
        n = y.numel()
        site = da._site(RATE, DROP_SEED, 0, 0, y.dtype)
        for residual in (True, False):
            r = r0 if residual else None

            def plain(y, r):
                d = packed_dropout(y, RATE, DROP_SEED)
                return d if r is None else r + d

            def library(y, r):
                d = F.dropout(y, RATE)
                return d if r is None else r + d

            graphs = {}
            for name, fn in (("plain", plain), ("library", library)):
                leaf = y.clone().requires_grad_()
                graphs[name] = (fn(leaf, r), leaf)

            def backward(name):
                out, leaf = graphs[name]
                return lambda: torch.autograd.grad(out, leaf, g,
                                                   retain_graph=True)

            case = dict(shape=list(shape), residual=residual, rate=RATE)
            yield dict(
                case=dict(case, way="forward"),
                call=no_grad(lambda: da.dropout_add(y, r, RATE, DROP_SEED)),
                plain=no_grad(lambda: plain(y, r)),
                library=("r + F.dropout(y)", no_grad(lambda: library(y, r))),
                bytes=(3 if residual else 2) * 2 * n, ops=0)
            yield dict(
                case=dict(case, way="backward"),
                call=lambda: da.dropout_add_backward(g, site),
                plain=backward("plain"),
                library=("r + F.dropout(y)", backward("library")),
                bytes=2 * 2 * n, ops=0)


def layer_norm(dev, gen):
    """LN in bf16 at the FiD and teacher encoders' [400, 512, 768], the
    context tower's [400, 256, 768], the embedder's batch [128, 256, 768]
    and the query tower's [8, 64, 768]: forward, and the kernel's backward
    launch against the formula's autograd over its saved graph; bound by
    the wrapper's counted bytes."""
    from emdr2_tpu_torch.ops import layer_norm as ln
    F = torch.nn.functional
    eps = 1e-5
    for shape in ((400, 512, 768), (400, 256, 768), (128, 256, 768),
                  (8, 64, 768)):
        h, rows = shape[-1], math.prod(shape[:-1])
        x = (3.0 * torch.randn(shape, device=dev, generator=gen) + 0.5
             ).to(torch.bfloat16)
        w = 1.0 + 0.1 * torch.randn(h, device=dev, generator=gen)
        b = 0.1 * torch.randn(h, device=dev, generator=gen)
        dy = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
        wl, bl = w.to(torch.bfloat16), b.to(torch.bfloat16)
        graphs = {}
        for name, fn in (("plain", ln.layer_norm_reference),
                         ("library", lambda x, w, b, e: F.layer_norm(
                             x, (h,), w.to(x.dtype), b.to(x.dtype), e))):
            leaves = [t.clone().requires_grad_() for t in (x, w, b)]
            graphs[name] = (fn(*leaves, eps), leaves)

        def backward(name):
            out, leaves = graphs[name]
            return lambda: torch.autograd.grad(out, leaves, dy,
                                               retain_graph=True)

        groups = ln._grid(rows, h, dev, ln._BWD_BLOCKS_PER_SM)
        yield dict(
            case=dict(shape=list(shape), way="forward"),
            call=no_grad(lambda: ln.layer_norm(x, w, b, eps)),
            plain=no_grad(lambda: ln.layer_norm_reference(x, w, b, eps)),
            library=("F.layer_norm (bf16 weight)",
                     no_grad(lambda: F.layer_norm(x, (h,), wl, bl, eps))),
            bytes=ln.forward_bytes(rows, h, 2), ops=0)
        yield dict(
            case=dict(shape=list(shape), way="backward", partials=groups),
            call=lambda: ln.layer_norm_backward(x, dy, w, eps),
            plain=backward("plain"),
            library=("F.layer_norm (bf16 weight)", backward("library")),
            bytes=ln.backward_bytes(rows, h, 2, groups), ops=0)


CASES = {"K1-fwd": k1_fwd, "K1-bwd": k1_bwd, "K1-bias": k1_bias,
         "K2-fwd": k2_fwd, "K2-bwd": k2_bwd, "K3": k3, "K4-fwd": k4_fwd,
         "K4-bwd": k4_bwd, "K5": k5, "DA": dropout_add, "LN": layer_norm}


def time_case(kernel, c, clock, dev):
    """One JSON row of ``c`` (a case the functions above yield)."""
    if "row" in c:
        return {"kernel": kernel, **c["row"]}
    row = {"kernel": kernel, **c["case"],
           "one_call_ms": clock.event_ms(c["call"], reps=20, warmup=3),
           "queued_ms": clock.event_ms(c["call"], reps=10, calls=10)}
    for name, fn in c.get("extra", {}).items():
        row[f"{name}_queued_ms"] = clock.event_ms(fn, reps=10, calls=10)
    row["plain_ms"] = clock.event_ms(c["plain"], reps=3, warmup=1)
    library = c.get("library")
    row["library"] = library[0] if library else None
    row["library_ms"] = (clock.event_ms(library[1], reps=10, calls=10)
                         if library else None)
    row["bound_ms"], row["bound_by"] = clock.bound_ms(
        c["bytes"], c["ops"], dev, c.get("op_type", "bf16"))
    row.update(bytes=c["bytes"], ops=c["ops"])
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE,
                    help="the checkout whose kernels are timed")
    ap.add_argument("--kernel", choices=KERNELS, default=None,
                    help="time this kernel only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("time_kernels: needs a CUDA device")
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    clock = _flagship()
    print(clock.card_name_and_power(), flush=True)
    # plain versions and yardsticks in true fp32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    for kernel in ([args.kernel] if args.kernel else KERNELS):
        cases = (CASES[kernel](dev, gen, clock) if kernel == "K3"
                 else CASES[kernel](dev, gen))
        for c in cases:
            row = time_case(kernel, c, clock, dev)
            print(json.dumps({"tree": tree, **row}), flush=True)
            del c
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
