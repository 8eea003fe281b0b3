#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]
    python3 chip_smoke.py --dp-cards N       (N cards: the ranks phase alone,
                                             and with 4 the embedder group,
                                             two hosts and tp)

1. Builds the hand-written CUDA kernels from ``emdr2_tpu_torch/ops/csrc``
   (one nvcc per source, in parallel).
2. Holds each kernel against its plain PyTorch version at the shapes the
   serving and training paths give it, and times both with CUDA events:
   flash self-attention (K1) forward at [8, 64, 2304], [128, 256, 2304] (the
   index builder's batch), [400, 256, 2304] and [400, 512, 2304] (bf16, 12
   heads, one row fully padded; the saved (rowmax, 1/l) held against the
   plain statistics) and with dropout 0.1,
   its backward at [8, 64], [400, 256] and [400, 512] (gradients checked on
   32 rows, timed on all); the registers, spills and shared memory of the
   K1, K2-bwd, K4 and K5 kernels are printed by name, and a spill fails the
   run; flash cross-attention (K2) forward and backward at the reader shape
   (8 rows, 32 queries x 25,600 keys; the backward in key chunks of 512 and
   256, and over several forced run counts) and the teacher shape (400
   rows, 32 x 512), dropout 0 and 0.1, padded keys present, and its key
   split under key chunk 256 (100 chunks) and with seven chunks dealt to 1,
   2, 3 and 7 splits (forward) or runs (backward), whole splits and one row
   padded; the MIPS candidate scan
   (K3) over a 1,310,720 x 768 index in bf16 and int8: its kernels'
   registers, shared memory and spills, both of its kernels (CUDA-core and
   tensor-core) forced at nq in {1, 2, 4, 8, 9, 16, 32, 64, 128, 256}, each
   held to the plain version, for each type's crossover, and the dispatch
   at nq in {8, 64, 512, 3,610} against the plain version (in blocks of 512
   queries), beside the score GEMM alone, plus top-50 recall of the whole
   search against an exact search (float64 sums), an int8 search split
   into scan, selection and re-rank at 512 and 3,610, and the widest bf16
   boundary tie over two more random indexes; the
   general flash forward (K4) on [400, 512, 12, 64] views of a qkv slab in
   key chunks of 256, dropout 0 and 0.1, at a small Lq != Lk shape and on
   1,024 tokens in key chunks of 512; its
   backward (K4-bwd) at the same shape (gradients checked on 32 rows, timed
   on all) and on a shape with padded keys and a fully masked row; the
   int8 decode attention (K5) at [8, R, 12, 25,600, 64] for R = 1 and 5, on
   a slab padded to 256 rows and with a fully masked example. Beside each
   attention kernel one ``scaled_dot_product_attention`` call on the same
   inputs is timed as a yardstick (the port never calls it), and each
   kernel's bound on this card is computed from its inputs: the larger of
   bytes moved / 3.35 TB/s and operations / the peak rate of their type.
3. Serving: drives ``QAPipeline.ask`` on 16 questions at batch 8 at full
   published width (BERT-base query tower, T5-base reader, K=50, reader
   length 512, 32 decode steps, int8 index, flash attention on: the
   flagship recipe), with weights from a seed, a synthetic ~20k-passage
   corpus and a 1,310,720-row index made on the device. Prints ms per
   stage, peak memory and each kernel's launch count during ``ask``, and
   checks the answers and the retrieved ids against an exact search.
   Generation, on the same model and questions: greedy with the int8 cross
   K/V, then ``QAPipeline(beam_size=5, kv_quant="int8")``; prints the
   stages, the slab's bytes in both forms, the share of int8 greedy answers
   equal to the bf16-path ones, and holds one decode step's log-probs of
   the int8 session against the bf16-path session's.
4. Training: three ``E2EQATask.train_step``s at ``EMDR2Config()`` widths
   (BERT-base x 2, T5-base, K=50, Lr=512, Lc=256, Lq=64, Ld=32, dropout
   0.1, flash attention, the flagship AdamW / clip / schedule) at batch 8,
   the flagship ``--remat --no-remat-towers`` layout, on the same world
   with synthetic question/answer pairs. Prints ms per stage, peak memory,
   the metrics of each step and each kernel's launch count during the
   steps; checks the metrics are finite, the gradient norm positive and
   the parameters moved once the learning rate is non-zero.
   ``--profile`` adds a fourth step under ``torch.profiler`` and prints its
   top device kernels and the device time by operator, and does the same
   for one warm greedy batch with the fp32-K slab and one with the int8
   slab, for K4-fwd beside SDPA, for K4's backward through autograd by
   both routes and for K1's three kernels at each shape.
5. Evaluation under ``flash_key_chunk=256`` (the reader's 512-token rows
   then take the general flash kernel): ``E2EQATask.evaluate_em`` on 16
   synthetic QA examples (greedy, int8 K/V), beam 5 on 8 of them, and
   ``validation_loss`` over two batches of 8; checks counts, EM range,
   finite losses, and the losses of one batch against the same weights
   with the flash kernels off.
6. The training loop under ``flash_key_chunk=256``, full width and depth:
   ``training.engine.train`` for four iterations at B=8 (dropout 0.1,
   ``--remat --no-remat-towers``) with ``prefetch_depth=2``, an async
   interval checkpoint at 2, the final one at 4 and an evaluation callback
   at 4 (``validation_loss`` on one batch, ``evaluate_em`` on 8 examples,
   greedy over the int8 K/V); then three more iterations with
   ``prefetch_depth=0`` for the time per iteration without the prefetcher.
   Checks the final iteration, ``TrainLog.history``, that the parameters
   moved, every kernel's launch count, the tracker and the ``iter_*``
   directories, that no worker thread is left, and that the final
   checkpoint restores into a fresh task bit for bit (every parameter and
   moment), from which one more step runs. Prints ms per iteration and per
   stage, peak memory, and the checkpoint's bytes and seconds (async
   stage, background write, synchronous save, load).

7. The evidence-index build at the same widths: ``EvidenceIndexBuilder``
   embeds 32,768 synthetic passages at Lc=256, batch 128, by the host path
   (fp16 rows in host RAM) and by the device path (bf16 rows on the card):
   passages/s, peak memory and K1-fwd's 3,072 launches of each; the paths'
   rows agree and 64 sampled rows equal ``retriever.embed_context``. Then
   ``ShardedEvidenceIndex.update`` of a 1,310,720-row int8 index (the
   reference's shard a GPU) from a host fp16 array and from a device tensor:
   the swap's stall; and the full-shard pass time at the measured rates.
8. The loop with a live ``AsyncIndexRefresher`` (the flagship layout, B=8,
   prefetch 0, 8 iterations, a 16,384-passage corpus and int8 index, reload
   interval 2), then 3 iterations without it: ms per iteration with an embed
   pass in flight and without, passages/s while training, each swap's ms,
   ``refresh_count`` >= 1, peak memory; the first swapped index held to the
   embedding of the tower handed over at ``start``; no thread left.
9. The command line: ``tools.create_doc_index.main`` and
   ``tasks.run.main(["--task", "OPENQA", ...])`` by their argv with the
   flagship flags, ``--async-indexer --index-reload-interval 2
   --index-quantize int8 --train-iters 4 --save-interval 2`` and 8 valid
   examples (rc 0, the tracker at 4, "valid EM" printed), then
   ``QAPipeline.load`` from that save answers 8 questions.
10. The RETRIEVER task: ``DPRTask.train_step`` at BERT-base x 2, global
   batch 128 with one hard negative (256 contexts), dropout 0.1, under no
   remat, ``remat_policy="nothing"`` and ``"dots_no_batch"`` (ms per step,
   peak memory, K1 launches), then ``validate`` in the 30+30 layout.
11. Retrieval evaluation: 16,384 passages embedded by a DPR context tower
   into a 1,310,720-row index (random rows beyond), bf16 and int8, and
   ``OpenRetrievalEvaluator.evaluate_recall`` of 3,610 questions at k=100 in
   one search (the tensor-core K3); rows and recall held to an exact
   search.
12. Two OPENQA steps at B=4 under ``--remat-policy nothing`` and
   ``dots_no_batch`` (ms, peak memory).
13. The RETRIEVER command line (``tasks.run --task RETRIEVER``: 4
   iterations, saves, validation, post-train recall), ``checkpoint_surgery
   extract`` loaded into an OPENQA model, and ``tools.evaluate_retrieval``,
   whose recall must equal the run's.
14. One step repeats bit for bit: the embedding lookups' backward at a
   step's shapes (``F.embedding`` against ``layers.embedding``), then a DPR
   step at 128 and an OPENQA step at B=8 each twice from one state,
   fingerprinted module by module (``utils/repeat.py``).
15. Data parallelism: (a) one rank over NCCL, the DPR step and the int8
   search bit-equal to the plain path; (b) two ranks sharing the card over
   gloo (subprocesses: ``--dp-rank R --dp-spec PATH``), each with half of
   one index, against one process: searches, step-1 losses, bit-equal
   replicas, ``evaluate_em``. ``--dp-cards N`` runs only this phase over
   NCCL, a rank a card, beside one card at the same batch a rank.
16. The embedder group: two ranks sharing the card over gloo, each running
   ``engine.train`` under the flagship layout with its
   ``AsyncIndexRefresher`` on the card (``--embed-devices 0``) and
   ``prefetch_depth=1``, an int8 index over 16,384 passages, reload
   interval 2, 6 iterations at 2 questions a rank, then 1 without the
   refresher: the ranks swap at the same iterations, the rows after the
   first swap are the hand-off tower's, the replicas bit-equal, the
   losses finite; ms per iteration with a pass in flight and without, the
   swap's stall, a rank's block of 655,360 int8 rows swapped in.
   ``--dp-cards 4`` adds the disjoint layout after its ranks phase: two
   trainers on cards 0-1 over NCCL at 8 questions a rank beside their
   embedders on cards 2-3 (32,768 passages, 8 + 3 iterations); the same
   checks, and no K1 launch at the builder's shape on a trainer card.
17. A launch across hosts: two emulated hosts of one rank each, each a
   subprocess with its own ``CUDA_VISIBLE_DEVICES`` and torchrun's
   variables, joining through ``parallel.init_distributed`` (the ranks
   learn their hosts at the rendezvous; a rank takes the card of its
   local rank on its host). Both hosts see card 0 and share it over gloo:
   the dp phase (b)'s OPENQA work without DPR (K3 searches on each rank's
   block, check steps at dropout 0, three steps at 0.1, ``evaluate_em``
   over int8 K/V) held to (b)'s one-process references by the same rules.
   ``--dp-cards 4`` adds two hosts of cards 0,1 and 2,3 over NCCL, a
   trainer on each host's card 0 beside its embedder on its card 1
   (the embedder phase's run and checks at 8 questions a rank); no two
   ranks on one trainer card, no embedder card on another host, by UUID.
18. The port's measurement tools (``emdr2_tpu_torch/tools/bench_*``), each
   through its ``main(argv)`` at ``EMDR2Config()`` widths and full depth,
   grids and iterations cut (``TOOLS_*``): the int8 re-rank window's two
   selections at k 20 and 51 over 1,310,720 rows (the same rows, the
   default window held to an exact search by the k3 phase's tie rule, the
   recall of ``rescore=0`` beside it); K4 and K1 forward + backward at
   key chunks 256-3,200 (256 and 512 must give times); the step's passes
   with their share of the peak (in (0, 1]); the dropout variants; a cut
   train sweep (B 8 and 16 under full remat beside an int8 index, B 8
   with the towers stored); the pipeline's stages A and B, index swap,
   embedding rate, prefetch overlap, decode and one decode-sweep row.
   Prints each tool's rows, its seconds and the phase's; its in-process
   launches go into each kernel row as ``launches_tools``.

Every failure propagates (non-zero exit). The second-to-last line is the
kernel summary as JSON; the last line is
``{"ok": true, "device": {...}}``. Needs one CUDA device; without one it
exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
N_INDEX = 1_310_720
SEED = 1234
# forward kernels, bf16 output: max / mean abs error relative to the
# largest |reference output| (the readings are about one bf16 ulp of it)
FWD_TOL = (2e-2, 2e-3)
# backward kernels: bf16 gradients, dS and the dropped probabilities rounded
# to bf16 for the products -> max / mean abs error relative to the largest
# reference gradient
GRAD_TOL = (2e-2, 2e-3)
LSE_TOL = 1e-3                 # abs error of K2's fp32 lse
STATS_TOL = 1e-3               # K1's fp32 (rowmax, 1/l): abs, relative
RATE = 0.1                     # attention dropout of the flagship recipe
DROP_SEED = 0x5EED
# NVIDIA H100 SXM data sheet (dense): device memory rate, tensor-core rates
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}


def log(*args):
    print(*args, flush=True)


def time_ms(fn, reps=10, warmup=2):
    """Median ms of ``reps`` runs of ``fn``, each between CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, n_ops: float, op_type: str = "bf16"):
    """(ms, "bytes" | "operations"): the least time this card could take to
    move ``n_bytes`` (each input read once, each output written once) and
    to do ``n_ops`` operations of ``op_type``, by the data sheet."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / PEAK_OPS_PER_S[op_type] * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def sdpa(q, k, v, bias):
    """The one PyTorch call that computes the same attention: heads-first
    q [B, nh, Lq, hd], k, v [B, nh, Lk, hd] (views are fine) and the
    key-side bias [B, Lk] as an additive mask. A yardstick only."""
    mask = bias.to(q.dtype)[:, None, None, :]
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask)


def slab_heads(slab, n, nh=12):
    """[B, L, n*H] projection slab -> n heads-first views [B, nh, L, hd]."""
    B, L = slab.shape[:2]
    parts = slab.view(B, L, n, nh, -1).permute(2, 0, 3, 1, 4)
    return [parts[i] for i in range(n)]


def sdpa_times(q_slab, n_q, kv_slab, n_kv, bias, dout=None):
    """(forward ms, backward ms or None) of ``sdpa`` on views of the
    projection slabs; the backward is timed alone, from saved state."""
    with torch.no_grad():
        q = slab_heads(q_slab, n_q)[0]
        k, v = slab_heads(kv_slab, n_kv)[-2:]
        fwd = time_ms(lambda: sdpa(q, k, v, bias))
    if dout is None:
        return fwd, None
    leaves = [t.detach().clone().requires_grad_(True)
              for t in ((q_slab,) if kv_slab is q_slab
                        else (q_slab, kv_slab))]
    q = slab_heads(leaves[0], n_q)[0]
    k, v = slab_heads(leaves[-1], n_kv)[-2:]
    out = sdpa(q, k, v, bias)
    g = slab_heads(dout, 1)[0]
    bwd = time_ms(lambda: torch.autograd.grad(out, leaves, g,
                                              retain_graph=True))
    return fwd, bwd


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def _check_self_stats(name, stats, want, bias):
    """The saved (rowmax, 1/l) [B, nh, 2, L] against the plain statistics:
    rowmax to STATS_TOL on rows with a live key, 1/l to STATS_TOL of
    itself; a fully padded row's rowmax is its scores (about -1e9) and its
    1/l exactly 1/L. Returns the two errors over the live rows."""
    L = want.shape[-1]
    live = (bias > -1e8).any(dim=1)
    m_err = (stats[live, :, 0] - want[live, :, 0]).abs().max().item()
    il_err = (stats[live, :, 1] / want[live, :, 1] - 1.0).abs().max().item()
    padded = stats[~live]
    if not (torch.isfinite(stats).all() and m_err <= STATS_TOL
            and il_err <= STATS_TOL and bool((padded[:, :, 0] < -9e8).all())
            and bool((padded[:, :, 1] == 1.0 / L).all())):
        raise AssertionError(f"{name}: statistics disagree with the plain "
                             f"ones: rowmax {m_err}, 1/l {il_err} (relative)")
    return m_err, il_err


def flash_kernel_report(ptxas_log: str) -> None:
    """Registers, spills and shared memory of the kernels instantiated from
    ``attention_flash.cuh`` (K1 and K4, each forward and backward: the
    statistic ``RowMaxInv`` is K1's, ``Lse`` K4's), of K2's backward walk
    (M = 2..4 atoms of 16 queries, dropout off and on) and of K5's walk, by
    name, from the compilers' ``-Xptxas -v`` output and the library's launch
    configuration. Fails if one of them spills, or if a kernel is missing
    from the log. A library built earlier comes with no log: that is said,
    and nothing is checked."""
    import ctypes
    import re

    from emdr2_tpu_torch.ops import build
    from emdr2_tpu_torch.ops.decode_attention import kernel_layout
    if not ptxas_log:
        log("  the kernel library was built earlier: no compiler report, the "
            "check for spills and missing kernels is skipped (remove "
            "emdr2_tpu_torch/_build to have it)")
        return
    lib = build.load()
    smem = (ctypes.c_int * 2)()
    lib.emdr2_flash_self_attention_smem(smem)
    tail = (r".*?\n.*?\n\s*(\d+) bytes stack frame, (\d+) bytes spill stores, "
            r"(\d+) bytes spill loads\n.*?Used (\d+) registers")
    entry = re.compile(
        r"Compiling entry function '_ZN6aflash\d+(flash_\w+?_kernel)ILb([01])"
        r"ENS_\d+(\w+?)EEE" + tail)
    seen = set()
    for kernel, drop, stat, stack, st, ld, regs in entry.findall(ptxas_log):
        dyn = smem[0] if kernel == "flash_fwd_kernel" else smem[1]
        seen.add((kernel, stat))
        log(f"  {kernel}<dropout {'on' if drop == '1' else 'off'}, {stat}>: "
            f"{regs} registers, {stack} bytes stack, spill stores {st} loads "
            f"{ld} bytes, {dyn} bytes of dynamic shared memory a block")
        if int(st) or int(ld):
            raise AssertionError(f"{kernel}<{drop}, {stat}> spills registers")
    want = {(k, stat) for k in ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                                "flash_bwd_dkv_kernel")
            for stat in ("RowMaxInv", "Lse")}
    if seen != want:
        raise AssertionError(f"flash kernels in the ptxas log: {sorted(seen)}")
    cross = (ctypes.c_int * 14)()
    build.check(lib.emdr2_flash_cross_attention_bwd_layout(cross),
                "emdr2_flash_cross_attention_bwd_layout")
    bwd = re.compile(r"Compiling entry function '\w*?cross_bwd_kernelILi(\d)"
                     r"ELb([01])EEE" + tail)
    rows = sorted(bwd.findall(ptxas_log))
    if [r[:2] for r in rows] != [(str(m), d) for m in range(2, 5)
                                 for d in "01"]:
        raise AssertionError(f"K2 backward kernels in the ptxas log: {rows}")
    for M, drop, stack, st, ld, regs in rows:
        m = int(M)
        log(f"  cross_bwd_kernel<M={M}, dropout {'on' if drop == '1' else 'off'}"
            f">: {regs} registers, {stack} bytes stack, spill stores {st} "
            f"loads {ld} bytes, {cross[1 + m]} bytes of dynamic shared memory "
            f"a block ({cross[1]} threads, rings of {cross[0]} slots), "
            f"{cross[5 + m + 4 * int(drop)]} blocks resident a multiprocessor "
            f"by the occupancy query")
        if int(st) or int(ld):
            raise AssertionError(f"cross_bwd_kernel<{M}, {drop}> spills "
                                 f"registers")
    layout = kernel_layout()
    walk = re.compile(r"Compiling entry function '\w*?decode_walk_kernelILi"
                      r"(\d)EEE" + tail)
    rows = sorted(walk.findall(ptxas_log))
    if [r[0] for r in rows] != [str(i) for i in range(1, 9)]:
        raise AssertionError(f"K5 walk kernels in the ptxas log: {rows}")
    for R, stack, st, ld, regs in rows:
        log(f"  decode_walk_kernel<R={R}>: {regs} registers, {stack} bytes "
            f"stack, spill stores {st} loads {ld} bytes, "
            f"{layout.smem_bytes[int(R) - 1]} bytes of dynamic shared memory "
            f"a block ({layout.slots} slots of {layout.stage_keys} keys), "
            f"{layout.resident_blocks[int(R) - 1]} blocks resident a "
            f"multiprocessor by the occupancy query")
        if int(st) or int(ld):
            raise AssertionError(f"decode_walk_kernel<{R}> spills registers")


def k1_phase(dev, gen):
    """K1 forward at the query tower's (serving batch 8 and the DPR step's
    128 queries), the index builder's (a batch of 128 passages), the DPR
    step's 256 contexts, the context tower's and the reader's shapes, rate 0,
    with one fully padded row: the output and the saved statistics against
    their plain versions."""
    from emdr2_tpu_torch.ops.fid_attention import (
        flash_self_attention, flash_self_attention_forward,
        flash_self_attention_reference, flash_self_attention_stats_reference)
    rows = []
    for B, L in ((8, 64), (128, 64), (128, 256), (256, 256), (400, 256),
                 (400, 512)):
        qkv = torch.randn(B, L, 3 * 768, device=dev, generator=gen
                          ).to(torch.bfloat16)
        lens = torch.randint(1, L + 1, (B,), device=dev, generator=gen)
        lens[B // 2] = 0                       # a fully padded row
        bias = torch.where(torch.arange(L, device=dev)[None, :] < lens[:, None],
                           0.0, -1e9).float()
        got = flash_self_attention(qkv, bias, 12)
        torch.cuda.synchronize()
        want = flash_self_attention_reference(qkv, bias, 12)
        max_err, mean_err, ref = _check(f"K1 [{B}, {L}]", got, want,
                                        FWD_TOL)
        with_stats, stats = flash_self_attention_forward(qkv, bias, 12)
        if not torch.equal(with_stats, got):
            raise AssertionError(f"K1 [{B}, {L}]: saving the statistics "
                                 f"changed the output")
        n = min(B, 32)
        idx = torch.unique(torch.tensor([*range(n), B // 2], device=dev))
        m_err, il_err = _check_self_stats(
            f"K1 [{B}, {L}]", stats[idx],
            flash_self_attention_stats_reference(qkv[idx], bias[idx], 12),
            bias[idx])
        del with_stats, stats
        ms = time_ms(lambda: flash_self_attention(qkv, bias, 12))
        plain_ms = time_ms(lambda: flash_self_attention_reference(qkv, bias,
                                                                  12))
        flop = 4 * B * 12 * L * L * 64
        moved = nbytes(qkv, bias, got)
        bound_ms, bound_by = bound(moved, flop)
        lib_ms, _ = sdpa_times(qkv, 3, qkv, 3, bias)
        log(f"K1 flash_self_attention [{B}, {L}, 2304] bf16: max_abs_err "
            f"{max_err:.3e} mean_abs_err {mean_err:.3e} (tol {FWD_TOL} x "
            f"max|ref| {ref:.3e}) | kernel {ms:.4f} ms "
            f"({flop / ms / 1e9:.2f} TFLOP/s) | plain {plain_ms:.4f} ms | "
            f"SDPA {lib_ms:.4f} ms | bound {bound_ms:.4f} ms by {bound_by} "
            f"({moved / 1e6:.1f} MB, {flop / 1e9:.1f} GFLOP) | statistics "
            f"(rows 0..{n - 1} and the fully padded row {B // 2}): rowmax "
            f"error {m_err:.3e}, 1/l relative error {il_err:.3e} (tol "
            f"{STATS_TOL}), the padded row's 1/l exactly 1/L")
        rows.append(dict(B=B, L=L, max_abs_err=max_err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=lib_ms))
        del qkv, bias, got, want
    return rows


def _errors(got, want):
    err = (got.float() - want.float()).abs()
    return err.max().item(), err.mean().item()


def _check(name, got, want, tol=GRAD_TOL):
    """max / mean abs error and max|want|; fails beyond ``tol`` times the
    largest |want|."""
    max_err, mean_err = _errors(got, want)
    ref = want.float().abs().max().item() or 1.0
    if not (torch.isfinite(got.float()).all() and max_err <= tol[0] * ref
            and mean_err <= tol[1] * ref):
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"max {max_err} mean {mean_err} (ref {ref})")
    return max_err, mean_err, ref


def _self_inputs(dev, gen, B, L):
    qkv = torch.randn(B, L, 3 * 768, device=dev, generator=gen
                      ).to(torch.bfloat16)
    lens = torch.randint(1, L + 1, (B,), device=dev, generator=gen)
    bias = torch.where(torch.arange(L, device=dev)[None, :] < lens[:, None],
                       0.0, -1e9).float()
    dout = torch.randn(B, L, 768, device=dev, generator=gen
                       ).to(torch.bfloat16)
    return qkv, bias, dout


def k1_dropout_phase(dev, gen):
    """K1 forward with the flagship attention dropout at [400, 512]."""
    from emdr2_tpu_torch.ops.fid_attention import (
        flash_self_attention, flash_self_attention_reference)
    qkv, bias, _ = _self_inputs(dev, gen, 400, 512)
    got = flash_self_attention(qkv, bias, 12, DROP_SEED, RATE)
    torch.cuda.synchronize()
    want = flash_self_attention_reference(qkv, bias, 12, DROP_SEED, RATE)
    max_err, mean_err, ref = _check(f"K1 dropout {RATE}", got, want, FWD_TOL)
    ms = time_ms(lambda: flash_self_attention(qkv, bias, 12, DROP_SEED,
                                              RATE))
    plain_ms = time_ms(lambda: flash_self_attention_reference(
        qkv, bias, 12, DROP_SEED, RATE), reps=5, warmup=1)
    log(f"K1 flash_self_attention [400, 512, 2304] bf16 dropout {RATE}: "
        f"max_abs_err {max_err:.3e} mean_abs_err {mean_err:.3e} (tol "
        f"{FWD_TOL} x max|ref| {ref:.3e}) | kernel {ms:.4f} ms | plain "
        f"{plain_ms:.4f} ms")
    return dict(B=400, L=512, max_abs_err=max_err, ms=ms, plain_ms=plain_ms)


def k1_bwd_phase(dev, gen, check_rows=32, profile=False):
    """K1 backward at the towers' (the OPENQA step's and the DPR step's:
    128 queries, 256 contexts) and the reader's shapes, dropout 0.1:
    gradients held against the plain backward on the first ``check_rows``
    rows (its fp32 [B, nh, L, L] tensors), both timed on all rows.
    ``profile`` adds the device time of the forward kernel and of the
    backward's two at each shape (five calls each under torch.profiler:
    at [8, 64] the events above time the launch, not the kernels)."""
    from emdr2_tpu_torch.ops.fid_attention import (
        flash_self_attention_backward, flash_self_attention_bwd_reference,
        flash_self_attention_forward)
    rows = []
    for B, L in ((8, 64), (128, 64), (256, 256), (400, 256), (400, 512)):
        qkv, bias, dout = _self_inputs(dev, gen, B, L)
        out, stats = flash_self_attention_forward(qkv, bias, 12, DROP_SEED,
                                                  RATE)

        def kernel():
            return flash_self_attention_backward(qkv, bias, out, dout, 12,
                                                 DROP_SEED, RATE, stats)

        def plain():
            return flash_self_attention_bwd_reference(qkv, bias, out, dout,
                                                      12, DROP_SEED, RATE)

        got = kernel()
        torch.cuda.synchronize()
        n = min(B, check_rows)
        want = flash_self_attention_bwd_reference(
            qkv[:n], bias[:n], out[:n], dout[:n], 12, DROP_SEED, RATE)
        max_err, mean_err, ref = _check(f"K1-bwd [{B}, {L}]", got[:n],
                                             want)
        if not torch.equal(kernel(), got):
            raise AssertionError(f"K1-bwd [{B}, {L}] is not deterministic")
        del want
        ms = time_ms(kernel)
        plain_ms = time_ms(plain, reps=3, warmup=1)
        flop = 2.5 * 4 * B * 12 * L * L * 64
        moved = nbytes(qkv, bias, out, dout, stats, got)
        bound_ms, bound_by = bound(moved, flop)
        _, lib_ms = sdpa_times(qkv, 3, qkv, 3, bias, dout)  # rate 0
        log(f"K1-bwd flash_self_attention_backward [{B}, {L}, 2304] dropout "
            f"{RATE}: max_abs_err {max_err:.3e} mean_abs_err {mean_err:.3e} "
            f"(rows 0..{n - 1}; tol {GRAD_TOL} x max|ref| {ref:.3e}), "
            f"repeat bit-identical | kernel {ms:.4f} ms "
            f"({flop / ms / 1e9:.2f} TFLOP/s by 2.5 x 4*L^2*hd) | plain "
            f"{plain_ms:.4f} ms | SDPA backward (rate 0) {lib_ms:.4f} ms | "
            f"bound {bound_ms:.4f} ms by {bound_by} ({moved / 1e6:.1f} MB, "
            f"{flop / 1e9:.1f} GFLOP)")
        rows.append(dict(B=B, L=L, max_abs_err=max_err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=lib_ms))
        if profile:
            def five_each():
                for _ in range(5):
                    flash_self_attention_forward(qkv, bias, 12, DROP_SEED,
                                                 RATE)
                for _ in range(5):
                    kernel()
            log_profile(f"K1 forward and backward at [{B}, {L}] dropout "
                        f"{RATE}, five calls each",
                        profile_call(five_each, f"k1_profile_{B}x{L}.txt",
                                     4))
        del qkv, bias, dout, out, stats, got
        torch.cuda.empty_cache()
    return rows


def k2_phase(dev, gen):
    """K2 forward and backward at the reader shape (8 x 32 queries over
    25,600 keys in 512-key chunks, and in 256-key chunks as the engine runs
    it; each row's keys past its length padded) and the teacher shape (400 x
    32 over 512), dropout 0 and 0.1. Then the backward's time at the reader
    shape, rate 0.1, over several forced run counts beside the wrapper's."""
    from emdr2_tpu_torch.ops import fid_attention as fa
    rows = []
    for name, B, Lk, chunks in (("reader", 8, 25_600, (512, 256)),
                                ("teacher", 400, 512, (512,))):
        q = torch.randn(B, 32, 768, device=dev, generator=gen
                        ).to(torch.bfloat16)
        kv = torch.randn(B, Lk, 1536, device=dev, generator=gen
                         ).to(torch.bfloat16)
        real = torch.randint(Lk // 2, Lk - 100, (B,), device=dev,
                             generator=gen)
        bias = torch.where(torch.arange(Lk, device=dev)[None, :]
                           < real[:, None], 0.0, -1e9).float()
        dout = torch.randn(B, 32, 768, device=dev, generator=gen
                           ).to(torch.bfloat16)
        for chunk, rate in ((c, r) for c in chunks for r in (0.0, RATE)):
            seed = DROP_SEED if rate else None
            out, lse = fa.flash_cross_attention_forward(q, kv, bias, 12,
                                                        chunk, seed, rate)
            torch.cuda.synchronize()
            w_out, w_lse = fa.flash_cross_attention_reference(
                q, kv, bias, 12, chunk, seed, rate)
            f_max, f_mean, f_ref = _check(f"K2-fwd {name} rate {rate}", out,
                                          w_out, FWD_TOL)
            lse_err = (lse - w_lse).abs().max().item()
            if lse_err > LSE_TOL:
                raise AssertionError(f"K2-fwd {name} rate {rate}: lse error "
                                     f"{lse_err}")
            again = fa.flash_cross_attention_forward(q, kv, bias, 12, chunk,
                                                     seed, rate)
            if not (torch.equal(again[0], out) and torch.equal(again[1], lse)):
                raise AssertionError(f"K2-fwd {name} is not deterministic")
            args = (q, kv, bias, w_lse, w_out, dout, 12, chunk, seed, rate)
            dq, dkv = fa.flash_cross_attention_backward(*args)
            torch.cuda.synchronize()
            w_dq, w_dkv = fa.flash_cross_attention_bwd_reference(*args)
            dq_err = _check(f"K2-bwd dq {name} chunk {chunk}", dq, w_dq)
            dkv_err = _check(f"K2-bwd dkv {name} chunk {chunk}", dkv, w_dkv)
            pad = torch.arange(Lk, device=dev)[None, :] >= real[:, None]
            if not bool((dkv[pad] == 0).all()):
                raise AssertionError(f"K2-bwd {name} chunk {chunk}: padded "
                                     f"keys got a gradient")
            again = fa.flash_cross_attention_backward(*args)
            if not (torch.equal(again[0], dq) and torch.equal(again[1], dkv)):
                raise AssertionError(f"K2-bwd {name} is not deterministic")
            del w_dq, w_dkv, again, pad
            ms = time_ms(lambda: fa.flash_cross_attention_forward(
                q, kv, bias, 12, chunk, seed, rate))
            plain_ms = time_ms(lambda: fa.flash_cross_attention_reference(
                q, kv, bias, 12, chunk, seed, rate), reps=3, warmup=1)
            bwd_ms = time_ms(lambda: fa.flash_cross_attention_backward(*args))
            bwd_plain_ms = time_ms(
                lambda: fa.flash_cross_attention_bwd_reference(*args),
                reps=3, warmup=1)
            kv_gb = kv.numel() * 2 / 1e9
            flop = 4 * B * 12 * 32 * Lk * 64
            f_bound = bound(nbytes(q, kv, bias, out, lse), flop)
            b_bound = bound(nbytes(q, kv, bias, w_lse, w_out, dout, dq, dkv),
                            2.5 * flop)
            lib_ms, lib_bwd_ms = sdpa_times(q, 1, kv, 2, bias, dout)
            log(f"K2 flash_cross_attention {name} [{B}, 32 x {Lk}] key_chunk "
                f"{chunk} rate {rate}: fwd max_abs_err {f_max:.3e} mean "
                f"{f_mean:.3e} (tol {FWD_TOL} x max|ref| {f_ref:.3e}) lse "
                f"{lse_err:.3e}, repeat bit-identical | bwd dq max "
                f"{dq_err[0]:.3e} mean {dq_err[1]:.3e}, dkv max "
                f"{dkv_err[0]:.3e} mean {dkv_err[1]:.3e} (tol {GRAD_TOL} x "
                f"max|ref|), padded keys' dkv exactly 0, repeat bit-identical"
                f" | fwd kernel {ms:.4f} ms ({kv_gb / ms * 1e3:.1f} GB/s of "
                f"kv) plain {plain_ms:.4f} ms | bwd kernel {bwd_ms:.4f} ms "
                f"({2 * kv_gb / bwd_ms * 1e3:.1f} GB/s of kv + dkv) plain "
                f"{bwd_plain_ms:.4f} ms | SDPA (rate 0) fwd {lib_ms:.4f} ms "
                f"bwd {lib_bwd_ms:.4f} ms | bound fwd {f_bound[0]:.4f} ms by "
                f"{f_bound[1]}, bwd {b_bound[0]:.4f} ms by {b_bound[1]}")
            rows.append(dict(shape=name, chunk=chunk, rate=rate,
                             max_abs_err=f_max,
                             bwd_max_abs_err=max(dq_err[0], dkv_err[0]),
                             ms=ms, plain_ms=plain_ms, bwd_ms=bwd_ms,
                             bwd_plain_ms=bwd_plain_ms,
                             bound_ms=f_bound[0], bound_by=f_bound[1],
                             bwd_bound_ms=b_bound[0], bwd_bound_by=b_bound[1],
                             library_ms=lib_ms, bwd_library_ms=lib_bwd_ms))
            if name == "reader" and chunk == 512 and rate == RATE:
                n_chunks = Lk // chunk
                runs = sorted({fa._split_chunks(n_chunks, n)[0]
                               for n in (2, 5, 10, 17, 25, n_chunks)})
                sweep = {n: time_ms(lambda n=n: fa._launch_cross_backward(
                    *args, n_runs=n)) for n in runs}
                log(f"K2-bwd reader key_chunk {chunk} rate {rate}, ms by "
                    f"forced run count (blocks = runs x 96): "
                    + ", ".join(f"{n}: {t:.4f}" for n, t in sweep.items())
                    + f"; the wrapper's choice {bwd_ms:.4f}")
                rows[-1]["bwd_ms_by_runs"] = sweep
            del out, lse, w_out, w_lse, dq, dkv
        del q, kv, bias, dout
        torch.cuda.empty_cache()
    return rows


def k2_split_phase(dev, gen):
    """K2's key split: the forward at the reader shape under key chunk 256
    (100 chunks, the engine phase's setting), timed; then seven chunks dealt
    to 1, 2, 3 and 7 splits of the forward and runs of the backward (3 deals
    them 3, 3, 1) with every key past the first 1,000-1,500 padded, so whole
    splits hold padding only, and one row fully padded. Every run against
    the plain version (the forced splits also against its split + combine,
    the forced runs against the run-split backward; the padded row against
    the plain P = 1 result; padded keys of the other rows get exactly zero
    dk and dv), repeated bit for bit."""
    from emdr2_tpu_torch.ops import fid_attention as fa
    rows = []

    def run(name, q, kv, bias, chunk, rate, n_splits):
        seed = DROP_SEED if rate else None
        out, lse = fa.flash_cross_attention_forward(q, kv, bias, 12, chunk,
                                                    seed, rate, n_splits)
        torch.cuda.synchronize()
        w_out, w_lse = fa.flash_cross_attention_reference(q, kv, bias, 12,
                                                          chunk, seed, rate)
        f_max, f_mean, f_ref = _check(f"K2-fwd {name} rate {rate}", out,
                                      w_out, FWD_TOL)
        # rows with a live key: the absolute limit; a fully padded row's lse
        # is its (equal) scores, about -1e9
        live = (bias > -1e8).any(dim=1)
        lse_err = (lse - w_lse)[live].abs().max().item()
        if lse_err > LSE_TOL or not (torch.isfinite(lse).all()
                                     and bool((lse[~live] < -9e8).all())):
            raise AssertionError(f"K2-fwd {name} rate {rate}: lse error "
                                 f"{lse_err}, padded rows {lse[~live]}")
        if n_splits is not None:      # and the split + combine arithmetic
            s_out, s_lse = fa.flash_cross_attention_split_reference(
                q, kv, bias, 12, chunk, n_splits, seed, rate)
            _check(f"K2-fwd {name} rate {rate} vs the plain split", out,
                   s_out, FWD_TOL)
            if (lse - s_lse)[live].abs().max().item() > LSE_TOL:
                raise AssertionError(f"K2-fwd {name} rate {rate}: lse off "
                                     f"the plain split's")
        again = fa.flash_cross_attention_forward(q, kv, bias, 12, chunk,
                                                 seed, rate, n_splits)
        if not (torch.equal(again[0], out) and torch.equal(again[1], lse)):
            raise AssertionError(f"K2-fwd {name} is not deterministic")
        return f_max, f_mean, f_ref, lse_err

    def bwd_run(name, q, kv, bias, dout, real, chunk, rate, n_runs):
        seed = DROP_SEED if rate else None
        out, lse = fa.flash_cross_attention_reference(q, kv, bias, 12, chunk,
                                                      seed, rate)
        args = (q, kv, bias, lse, out, dout, 12, chunk, seed, rate)
        dq, dkv = fa._launch_cross_backward(*args, n_runs=n_runs)
        torch.cuda.synchronize()
        w_dq, w_dkv = fa.flash_cross_attention_bwd_reference(*args)
        s_dq, _ = fa.flash_cross_attention_bwd_split_reference(
            *args[:8], n_runs, seed, rate)
        errs = [_check(f"K2-bwd {name} rate {rate} {what}", got, want)
                for what, got, want in (("dq", dq, w_dq), ("dkv", dkv, w_dkv),
                                        ("dq vs the run sums", dq, s_dq),
                                        ("padded row's dq", dq[0], w_dq[0]),
                                        ("padded row's dkv", dkv[0],
                                         w_dkv[0]))]
        for r in range(1, q.shape[0]):
            if not bool((dkv[r, real[r]:] == 0).all()):
                raise AssertionError(f"K2-bwd {name} rate {rate}: padded keys "
                                     f"of row {r} got a gradient")
        again = fa._launch_cross_backward(*args, n_runs=n_runs)
        if not (torch.equal(again[0], dq) and torch.equal(again[1], dkv)):
            raise AssertionError(f"K2-bwd {name} is not deterministic")
        return max(e[0] for e in errs), max(e[2] for e in errs)

    B, Lk = 8, 25_600
    q = torch.randn(B, 32, 768, device=dev, generator=gen).to(torch.bfloat16)
    kv = torch.randn(B, Lk, 1536, device=dev, generator=gen
                     ).to(torch.bfloat16)
    real = torch.randint(Lk // 2, Lk - 100, (B,), device=dev, generator=gen)
    bias = torch.where(torch.arange(Lk, device=dev)[None, :] < real[:, None],
                       0.0, -1e9).float()
    n_chunks = Lk // 256
    for rate in (0.0, RATE):
        seed = DROP_SEED if rate else None
        f_max, f_mean, f_ref, lse_err = run("reader chunk 256", q, kv, bias,
                                            256, rate, None)
        ms = time_ms(lambda: fa.flash_cross_attention_forward(
            q, kv, bias, 12, 256, seed, rate))
        log(f"K2 flash_cross_attention reader [{B}, 32 x {Lk}] key_chunk 256 "
            f"({n_chunks} chunks) rate {rate}: fwd "
            f"max_abs_err {f_max:.3e} mean {f_mean:.3e} (tol {FWD_TOL} x "
            f"max|ref| {f_ref:.3e}) lse {lse_err:.3e}, repeat bit-identical "
            f"| fwd kernel {ms:.4f} ms ({nbytes(kv) / ms / 1e6:.1f} GB/s of "
            f"kv)")
        rows.append(dict(shape="reader256", rate=rate, max_abs_err=f_max,
                         ms=ms))
    del q, kv, bias

    B, Lk = 4, 7 * 512
    q = torch.randn(B, 32, 768, device=dev, generator=gen).to(torch.bfloat16)
    kv = torch.randn(B, Lk, 1536, device=dev, generator=gen
                     ).to(torch.bfloat16)
    real = torch.randint(1000, 1500, (B,), device=dev, generator=gen)
    real[0] = 0                                       # a fully padded row
    bias = torch.where(torch.arange(Lk, device=dev)[None, :] < real[:, None],
                       0.0, -1e9).float()
    dout = torch.randn(B, 32, 768, device=dev, generator=gen
                       ).to(torch.bfloat16)
    for n_splits in (1, 2, 3, 7):
        for rate in (0.0, RATE):
            f_max, f_mean, f_ref, lse_err = run(
                f"7 chunks in {n_splits} splits", q, kv, bias, 512, rate,
                n_splits)
            b_max, b_ref = bwd_run(f"7 chunks in {n_splits} runs", q, kv,
                                   bias, dout, real, 512, rate, n_splits)
            rows.append(dict(shape="padded", rate=rate, splits=n_splits,
                             max_abs_err=f_max, bwd_max_abs_err=b_max,
                             bwd_ref=b_ref))
    log(f"K2 flash_cross_attention [{B}, 32 x {Lk}] 7 chunks in 1, 2, 3 and "
        f"7 splits, keys past {real[1:].min().item()}-{real.max().item()} "
        f"and all of row 0 padded, rate 0 and {RATE}: max_abs_err "
        f"{max(r['max_abs_err'] for r in rows if r['shape'] == 'padded'):.3e}"
        f" (tol {FWD_TOL} x max|ref|, against the plain version and its "
        f"split + combine), lse within {LSE_TOL} on live rows and below -9e8"
        f" on row 0, repeats bit-identical; backward in 1, 2, 3 and 7 runs: "
        f"max_abs_err "
        f"{max(r['bwd_max_abs_err'] for r in rows if r['shape'] == 'padded'):.3e}"
        f" (tol {GRAD_TOL} x max|ref|, max|ref| up to "
        f"{max(r['bwd_ref'] for r in rows if r['shape'] == 'padded'):.3e}, "
        f"against the plain backward and its run "
        f"sums; row 0 against the plain P = 1 result), padded keys of rows "
        f"1-{B - 1} get exactly zero dk and dv, repeats bit-identical")
    return rows


K3_NQ = (8, 64, 512, 3610)          # serving, just above the crossover,
                                    # the evaluator's batches (NQ-test)
K3_SWEEP_NQ = (1, 2, 4, 8, 9, 16, 32, 64, 128, 256)  # both kernels forced:
                                    # each type's crossover
K3_TIE_SEEDS = (SEED + 1, SEED + 2)  # more bf16 indexes for the widest tie
K3_SPLIT_NQ = (512, 3610)           # int8 mips_topk split into its parts
K3_EXTRA = 8                        # exact rows kept past the k-th
TIE_EPS = 4                         # a boundary tie: scores within this
                                    # many fp32 eps of |k-th score|
K3_BLOCK = 512                      # plain comparisons, queries a block


def _k3_queries(name, nq, dev, gen):
    """(fp32 queries, the scan's queries: bf16, or int8 per-query
    quantized as ``mips_topk`` does)."""
    qf = torch.randn(nq, 768, device=dev, generator=gen)
    return qf, (qf.to(torch.bfloat16) if name == "bf16"
                else quantize_queries(qf))


def _score_matmul(q, index):
    """The one library call for the score matrix alone (not the same
    function: no per-group top-2; a yardstick only): a bf16 GEMM, or
    ``torch._int_mm`` (int8 in, int32 out, which wants more than 16 rows:
    the queries are padded to a multiple of 32)."""
    if q.dtype == torch.int8:
        pad = -q.shape[0] % 32
        qp = torch.nn.functional.pad(q, (0, 0, 0, pad)) if pad else q
        return torch._int_mm(qp, index.T)
    return torch.matmul(q, index.T)


def _exact_top(qf, rows_f, n_valid, k, q_dtype=None):
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


def quantize_queries(qf):
    """int8 queries quantized per query, as ``mips_topk`` does."""
    qs = qf.abs().amax(dim=1).clamp(min=1e-30) / 127.0
    return torch.clamp(torch.round(qf / qs[:, None]), -127,
                       127).to(torch.int8)


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


def describe_int8_miss(qf, index, scales, n_valid, qi, w, k,
                       group=128):
    """What ``mips_topk`` did with true top-``k`` row ``w`` of int8 query
    ``qi``: its exact score beside the k-th, its rank among the scan's
    scaled candidates, and its exact re-rank score beside the k-th
    re-ranked one."""
    from emdr2_tpu_torch.ops import mips
    q = qf[qi:qi + 1]
    q8 = quantize_queries(q)
    qs = (q.abs().amax(dim=1).clamp(min=1e-30) / 127.0)[0]
    rows = mips.dequantize_int8(index, scales, group)[:n_valid]
    exact = torch.matmul(q, rows.T)[0]
    top = torch.topk(exact, k + 1).values
    cv, ci = mips.candidate_scan_reference(q8, index, n_valid, group, 2)
    cv = cv[0] * scales.repeat(2) * qs
    pos = (ci[0] == w).nonzero()
    cand_rank = (int((cv > cv[pos[0, 0]]).sum()) if len(pos) else None)
    got_vals, _ = mips.mips_topk(q, index, k, n_valid=n_valid,
                                 shard_scales=scales)
    rerank = (mips._rerank_scores(q, index[w][None, None, :])[0, 0]
              * scales[w // group]).item()
    return (f"query {qi} row {w}: exact score {exact[w].item():.6f}, k-th "
            f"{top[k - 1].item():.6f}, (k+1)-th {top[k].item():.6f}; rank "
            f"among the scan's scaled candidates {cand_rank}; re-rank score "
            f"{rerank:.6f} against the k-th retrieved "
            f"{got_vals[0, -1].item():.6f}")


def misses_text(ex, k):
    return (f"misses {ex['misses']}: in a group holding >= 3 of the true "
            f"top-{k} {ex['collided']}, boundary ties {ex['ties']} (widest "
            f"{ex['tie_eps']:.3f} fp32 eps of |k-th score|), unexplained "
            f"{ex['unexplained']}")


def k3_sass_counts():
    """Instructions of the tensor-core scan kernels in the built library, by
    ``cuobjdump -sass``: the warpgroup products (HGMMA bf16, IGMMA int8) and
    the tensor-map loads (UTMALDG) and bulk copies (UBLKCP). Fails if a
    kernel lacks its products or its loads; None without cuobjdump."""
    import re

    from emdr2_tpu_torch.ops import build
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        log("  K3: no cuobjdump beside nvcc, the SASS is not read")
        return None
    sass = subprocess.run([tool, "-sass", build.library_path()],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts = {}
    for part in re.split(r"\n\s+Function : ", sass)[1:]:
        name = part.split("\n", 1)[0]
        if "candidate_scan_tc_kernel" not in name:
            continue
        c = {op: len(re.findall(r"\b" + op + r"\.", part))
             for op in ("HGMMA", "IGMMA", "UTMALDG", "UBLKCP")}
        products = c["IGMMA"] if "candidate_scan_tc_kernelIa" in name \
            else c["HGMMA"]
        if not products or not (c["UTMALDG"] or c["UBLKCP"]):
            raise AssertionError(f"K3 {name}: SASS {c}")
        counts[name] = c
    if not counts:
        raise AssertionError("K3: no tensor-core scan kernel in the SASS")
    log(f"  K3 SASS of the tensor-core kernels (cuobjdump -sass): "
        f"{sorted(set(map(str, counts.values())))} in {len(counts)} kernels")
    return counts


def k3_kernel_report():
    """Registers, shared memory and spills of every scan kernel, from the
    built library (``cudaFuncGetAttributes``); fails if a tensor-core
    kernel spills."""
    from emdr2_tpu_torch.ops import mips
    rows = mips.kernel_info()
    for r in rows:
        log(f"  K3 {r['route']} {r['dtype']} {r['queries']} queries a block"
            + (f", a ring of {r['stages']} stages"
               if r["route"] == "tensor_core" else "")
            + f": {r['registers']} registers, {r['local_bytes']} local "
            f"(spilled) bytes a thread, {r['static_smem']} static + "
            f"{r['dynamic_smem']} dynamic shared bytes a block at d = 768")
        if r["route"] == "tensor_core" and r["local_bytes"]:
            raise AssertionError(f"K3 tensor-core kernel spills: {r}")
    return rows


def k3_topk_split(qf, index, scales, n_valid, k=50):
    """ms of a whole int8 ``mips_topk`` and of its parts: the scan, the
    float64 re-rank of the selected rows with its final top-k, and the
    selection between them (the scales on the candidates, the top-M and the
    gather of the M rows): the whole less the two."""
    from emdr2_tpu_torch.ops import mips
    nq = qf.shape[0]
    q = quantize_queries(qf)
    whole = time_ms(lambda: mips.mips_topk(qf, index, k, n_valid=n_valid,
                                           shard_scales=scales), reps=5)
    scan = time_ms(lambda: mips.candidate_scan(q, index, n_valid, 128, 2),
                   reps=5)
    m = 48 if k <= 20 else max(128, 2 * k)
    cidx = torch.randint(0, n_valid, (nq, m), device=index.device)
    rows = index[cidx]

    def rerank():
        s = mips._rerank_scores(qf, rows) * scales[cidx // 128]
        s = torch.where(cidx < n_valid, s, torch.full_like(s, mips.NEG_INF))
        v, p = torch.topk(s, k, dim=1)
        return v, torch.gather(cidx, 1, p)
    rr = time_ms(rerank, reps=5)
    return dict(nq=nq, whole_ms=whole, scan_ms=scan, rerank_ms=rr,
                selection_ms=whole - scan - rr)


def k3_bf16_ties(dev, seed, nq=3610, k=50):
    """The widest boundary tie of a bf16 search of ``nq`` random queries
    over a random 1,310,720 x 768 index made from ``seed`` (the rows and
    queries), against an exact search (float64 sums): in fp32 eps of
    |k-th score|. A miss neither a collision nor a tie fails."""
    from emdr2_tpu_torch.ops import mips
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    n_valid = N_INDEX - 1000
    emb = torch.randn(N_INDEX, 768, device=dev, generator=g)
    emb[n_valid:] = 0.0
    index = emb.to(torch.bfloat16)
    del emb
    qf = torch.randn(nq, 768, device=dev, generator=g)
    _, ids = mips.mips_topk(qf, index, k, n_valid=n_valid)
    oracle_vals, oracle = _exact_top(qf, index.float(), n_valid, k,
                                     torch.bfloat16)
    ex = explain_misses(ids, oracle, oracle_vals, k, ties=True)
    log(f"K3 bf16 seed {seed} nq={nq}: {misses_text(ex, k)}")
    if ex["unexplained"]:
        raise AssertionError(f"K3 bf16 seed {seed}: {misses_text(ex, k)}")
    return ex["tie_eps"]


def k3_phase(dev, gen):
    """K3 over 1,310,720 x 768 rows, bf16 and int8: the kernels' registers
    and shared memory; the crossover sweep (both kernels forced at nq in
    K3_SWEEP_NQ), then the dispatch at nq in K3_NQ held to the plain
    version (in blocks of K3_BLOCK queries: a plain [3,610, 1.31M] fp32
    score matrix is 19 GB), timed beside the plain version, the score
    matrix's library GEMM and the bound, and the whole search's recall@50
    against an exact search; an int8 ``mips_topk`` split into scan,
    selection and re-rank; the widest bf16 tie over more indexes."""
    from emdr2_tpu_torch.ops import mips
    kernels = k3_kernel_report()
    sass = k3_sass_counts()
    rows, sweep, split = [], [], []
    n_valid = N_INDEX - 1000
    emb = torch.randn(N_INDEX, 768, device=dev, generator=gen)
    emb[n_valid:] = 0.0
    stored = {"bf16": (emb.to(torch.bfloat16), None)}
    stored["int8"] = mips.quantize_int8(emb, 128)
    del emb
    for name in ("bf16", "int8"):
        index, scales = stored[name]
        for nq in K3_SWEEP_NQ:
            _, q = _k3_queries(name, nq, dev, gen)
            # each kernel forced and held to the plain version, then timed
            wv, wi = mips.candidate_scan_reference(q, index, n_valid, 128, 2)
            t, err = {}, {}
            for route in ("cuda_core", "tensor_core"):
                v, i = mips._launch(q, index, n_valid, 128, 2, route)
                torch.cuda.synchronize()
                ok = (torch.equal(v, wv) and torch.equal(i, wi)
                      if name == "int8" else
                      bool(((v - wv).abs() <= 1e-3 * wv.abs() + 1e-3).all()))
                err[route] = (v - wv).abs().max().item()
                if not ok:
                    raise AssertionError(f"K3 {name} nq={nq} {route} kernel "
                                         f"disagrees: max_abs_err "
                                         f"{err[route]:.3e}")
                del v, i
                t[route] = time_ms(lambda r=route: mips._launch(
                    q, index, n_valid, 128, 2, r))
            del wv, wi
            sweep.append(dict(dtype=name, nq=nq, **t,
                              max_abs_err=max(err.values())))
            log(f"K3 crossover {name} nq={nq}: CUDA-core kernel "
                f"{t['cuda_core']:.4f} ms (max_abs_err {err['cuda_core']:.3e}"
                f"), tensor-core kernel {t['tensor_core']:.4f} ms (max_abs_err "
                f"{err['tensor_core']:.3e})")
        for nq in K3_NQ:
            qf, q = _k3_queries(name, nq, dev, gen)
            route = mips.scan_route(nq, 128, q.dtype)
            gv, gi = mips.candidate_scan(q, index, n_valid, 128, 2)
            torch.cuda.synchronize()
            ok, max_err, agree = True, 0.0, 0
            for s in range(0, nq, K3_BLOCK):
                wv, wi = mips.candidate_scan_reference(
                    q[s:s + K3_BLOCK], index, n_valid, 128, 2)
                v, i = gv[s:s + K3_BLOCK], gi[s:s + K3_BLOCK]
                if name == "int8":
                    ok &= torch.equal(v, wv) and torch.equal(i, wi)
                else:
                    ok &= bool(((v - wv).abs() <= 1e-3 * wv.abs()
                                + 1e-3).all())
                max_err = max(max_err, (v - wv).abs().max().item())
                agree += (i == wi).sum().item()
                del wv, wi
            id_agree = agree / gi.numel()
            # the scales are applied outside the scan, so they do not count
            bound_ms, bound_by = bound(nbytes(q, index, gv, gi),
                                       2 * nq * N_INDEX * 768, name)
            del gv, gi
            ms = time_ms(lambda: mips.candidate_scan(q, index, n_valid, 128,
                                                     2))
            plain_ms = time_ms(lambda: [
                mips.candidate_scan_reference(q[s:s + K3_BLOCK], index,
                                              n_valid, 128, 2)
                for s in range(0, nq, K3_BLOCK)], reps=3, warmup=1)
            matmul_ms = time_ms(lambda: _score_matmul(q, index), reps=5,
                                warmup=1)
            index_bytes = nbytes(index)
            # top-50 recall of the whole search vs an exact search over the
            # stored rows (float64 sums; rows past n_valid excluded)
            vals, ids = mips.mips_topk(qf, index, 50, n_valid=n_valid,
                                       shard_scales=scales)
            rows_f = (index.float() if scales is None
                      else mips.dequantize_int8(index, scales, 128))
            oracle_vals, oracle = _exact_top(
                qf, rows_f, n_valid, 50,
                torch.bfloat16 if scales is None else None)
            del rows_f
            recall, _ = recall_at(ids, oracle[:, :50])
            # the kernel's order of sums (bf16), or the re-rank's float64
            # sums rounded to fp32 (int8), may trade a row at the 50th place
            # with one just outside when the two score within a few fp32
            # eps: above the serving batch such a miss is counted apart
            ex = explain_misses(ids, oracle, oracle_vals, 50, ties=nq > 8)
            log(f"K3 candidate_scan {name} nq={nq} N={N_INDEX} ({route} "
                f"kernel): {'equal' if name == 'int8' else 'within '}"
                f"{'' if name == 'int8' else '1e-3*|v|+1e-3'}={ok} "
                f"max_abs_err {max_err:.3e} id_agreement {id_agree:.6f} | "
                f"kernel {ms:.4f} ms ({index_bytes / ms / 1e6:.1f} GB/s, "
                f"{2 * nq * N_INDEX * 768 / ms / 1e9:.1f} TOP/s) | plain "
                f"{plain_ms:.4f} ms | score GEMM alone {matmul_ms:.4f} ms | "
                f"bound {bound_ms:.4f} ms by {bound_by} | recall@50 "
                f"{recall:.6f} ({misses_text(ex, 50)})")
            if not ok:
                raise AssertionError(f"K3 {name} nq={nq} disagrees")
            # per-group top-2 loses a row only when three true winners share
            # a 128-row group (~2e-4 per query at k=50, N=1.31M): the serving
            # batch must be exact, and any miss at larger nq must be such
            # one, or a boundary tie
            if name == "int8":
                for qi, w in ex["unexplained"]:
                    log("K3 int8 miss: " + describe_int8_miss(
                        qf, index, scales, n_valid, qi, w, 50))
            if (nq <= 8 and recall != 1.0) or ex["unexplained"]:
                raise AssertionError(f"K3 {name} nq={nq} recall {recall}, "
                                     f"{misses_text(ex, 50)}")
            rows.append(dict(dtype=name, nq=nq, route=route,
                             max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                             matmul_ms=matmul_ms,
                             gbps=index_bytes / ms / 1e6, recall=recall,
                             id_agree=id_agree, bound_ms=bound_ms,
                             bound_by=bound_by, misses=ex["misses"],
                             ties=ex["ties"], tie_eps=ex["tie_eps"]))
            if name == "int8" and nq in K3_SPLIT_NQ:
                split.append(k3_topk_split(qf, index, scales, n_valid))
                log(f"K3 int8 mips_topk nq={nq} k=50: {split[-1]}")
    del stored
    ties = [r["tie_eps"] for r in rows if r["dtype"] == "bf16"]
    ties += [k3_bf16_ties(dev, seed) for seed in K3_TIE_SEEDS]
    log(f"K3 bf16: the widest boundary tie over seeds {SEED}, "
        f"{', '.join(map(str, K3_TIE_SEEDS))}: {max(ties):.3f} fp32 eps of "
        f"|k-th score| (TIE_EPS {TIE_EPS})")
    crossover = {}
    for name in ("bf16", "int8"):
        runs = [r for r in sweep if r["dtype"] == name]
        # the smallest nq from which the tensor-core kernel stays faster
        crossover[name] = next(
            (r["nq"] for i, r in enumerate(runs)
             if all(x["tensor_core"] < x["cuda_core"] for x in runs[i:])),
            None)
    log(f"K3 crossover: the tensor-core kernel is faster from nq = "
        f"{crossover} on (of {list(K3_SWEEP_NQ)}); the dispatch takes it "
        f"from mips.TENSOR_CORE_MIN_NQ = "
        f"{ {str(t): n for t, n in mips.TENSOR_CORE_MIN_NQ.items()} }")
    return dict(rows=rows, sweep=sweep, crossover=crossover, split=split,
                kernels=kernels, sass=sass, bf16_ties=max(ties))


def k4_phase(dev, gen, profile=False):
    """K4 forward on [B, L, nh, hd] views of a qkv slab: the reader encoder
    under key chunk 256 (two chunks), dropout 0 and 0.1, a small shape
    with Lq != Lk, three chunks and ragged tiles, and 1,024 tokens under key
    chunk 512. ``profile`` adds five calls each of the kernel and of SDPA at
    the reader shape under torch.profiler."""
    from emdr2_tpu_torch.ops import fid_attention as fa
    rows = []
    for name, B, Lq, Lk, chunk in (("reader", 400, 512, 512, 256),
                                   ("small", 3, 100, 288, 96),
                                   ("long", 16, 1024, 1024, 512)):
        L = max(Lq, Lk)
        slab = torch.randn(B, L, 3 * 768, device=dev, generator=gen
                           ).to(torch.bfloat16)
        q = slab[:, :Lq, :768].view(B, Lq, 12, 64)       # views, no copies
        k = slab[:, :Lk, 768:1536].view(B, Lk, 12, 64)
        v = slab[:, :Lk, 1536:].view(B, Lk, 12, 64)
        lens = torch.randint(1, Lk + 1, (B,), device=dev, generator=gen)
        bias = torch.where(torch.arange(Lk, device=dev)[None, :]
                           < lens[:, None], 0.0, -1e9).float()
        for rate in (0.0, RATE):
            seed = DROP_SEED if rate else None
            out, lse = fa.fid_cross_attention_forward(q, k, v, bias, seed,
                                                      chunk, rate)
            torch.cuda.synchronize()
            w_out, w_lse = fa.fid_cross_attention_reference(q, k, v, bias,
                                                            seed, chunk, rate)
            max_err, mean_err, ref = _check(f"K4-fwd {name} rate {rate}", out,
                                            w_out, FWD_TOL)
            lse_err = (lse - w_lse).abs().max().item()
            if lse_err > LSE_TOL * max(1.0, w_lse.abs().max().item()):
                raise AssertionError(f"K4-fwd {name} rate {rate}: lse error "
                                     f"{lse_err}")
            again, _ = fa.fid_cross_attention_forward(q, k, v, bias, seed,
                                                      chunk, rate)
            if not torch.equal(again, out):
                raise AssertionError(f"K4-fwd {name} is not deterministic")
            del w_out, w_lse, again
            ms = time_ms(lambda: fa.fid_cross_attention_forward(
                q, k, v, bias, seed, chunk, rate))
            plain_ms = time_ms(lambda: fa.fid_cross_attention_reference(
                q, k, v, bias, seed, chunk, rate), reps=3, warmup=1)
            flop = 4 * B * 12 * Lq * Lk * 64
            moved = nbytes(q, k, v, bias, out, lse)
            bound_ms, bound_by = bound(moved, flop)
            with torch.no_grad():
                qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
                lib_ms = time_ms(lambda: sdpa(qh, kh, vh, bias))
            log(f"K4 fid_cross_attention {name} [{B}, {Lq} x {Lk}, 12, 64] "
                f"key_chunk {chunk} rate {rate}: max_abs_err {max_err:.3e} "
                f"mean {mean_err:.3e} (tol {FWD_TOL} x max|ref| {ref:.3e}) "
                f"lse {lse_err:.3e}, repeat bit-identical | kernel {ms:.4f} "
                f"ms ({flop / ms / 1e9:.2f} TFLOP/s) | plain {plain_ms:.4f} "
                f"ms | SDPA (rate 0) {lib_ms:.4f} ms | bound {bound_ms:.4f} "
                f"ms by {bound_by} ({moved / 1e6:.1f} MB, "
                f"{flop / 1e9:.1f} GFLOP)")
            rows.append(dict(shape=name, rate=rate, max_abs_err=max_err,
                             ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=lib_ms))
            if profile and name == "reader" and not rate:
                def five_each():
                    with torch.no_grad():
                        for _ in range(5):
                            fa.fid_cross_attention_forward(q, k, v, bias,
                                                           seed, chunk, rate)
                        for _ in range(5):
                            sdpa(qh, kh, vh, bias)
                log_profile("K4-fwd and SDPA at the reader shape, five calls "
                            "each", profile_call(five_each,
                                                 "k4_fwd_profile.txt", 6))
            del out, lse
        del slab, q, k, v, bias
        torch.cuda.empty_cache()
    return rows


def _slab_routes(fa, slab, bias, dout, chunk, rate, seed, profile=False):
    """The two ways from a [B, L, 3H] slab's attention output back to the
    slab's gradient: ``fid_self_attention`` (the backward kernels write one
    gradient slab in place) and ``fid_cross_attention`` on three views
    (autograd concatenates dq, dk, dv). Returns {route: (gradient, ms of
    the backward alone, bytes it allocates at its peak)}; ``profile`` adds
    three backward calls of each route under torch.profiler."""
    B, L = slab.shape[:2]
    res = {}
    for route in ("slab", "three tensors"):
        leaf = slab.detach().clone().requires_grad_(True)
        if route == "slab":
            out = fa.fid_self_attention(leaf, bias, 12, seed, chunk, rate)
            g = dout.reshape(B, L, 768)
        else:
            views = [t.view(B, L, 12, 64) for t in leaf.chunk(3, dim=-1)]
            out = fa.fid_cross_attention(*views, bias, seed, chunk, rate)
            g = dout

        def backward():
            return torch.autograd.grad(out, leaf, g, retain_graph=True)[0]

        backward()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grad = backward()
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        res[route] = (grad, time_ms(backward), extra)
        if profile:
            def three_calls():
                for _ in range(3):
                    backward()
            log_profile(f"K4 backward through autograd, {route} route, "
                        f"three calls", profile_call(
                            three_calls,
                            f"k4_bwd_{route.split()[0]}_profile.txt", 6))
        del out, leaf
    return res


def k4_bwd_phase(dev, gen, check_rows=32, profile=False):
    """K4 backward on [B, L, nh, hd] views of a qkv slab, from the plain
    forward's out and lse: the reader encoder under key chunk 256, dropout 0
    and 0.1 (gradients held against the plain backward on the first
    ``check_rows`` rows, both timed on all rows), and a small shape whose
    keys past 300 are padding and whose row 0 is fully masked. At the
    reader shape the backward also runs through autograd on the slab itself
    and on three views of it (``_slab_routes``): the gradients must be equal
    bit for bit; ``profile`` profiles both routes at rate 0.1."""
    from emdr2_tpu_torch.ops import fid_attention as fa
    rows = []
    for name, B, Lq, Lk, chunk in (("reader", 400, 512, 512, 256),
                                   ("padded", 3, 300, 512, 256)):
        slab = torch.randn(B, Lk, 3 * 768, device=dev, generator=gen
                           ).to(torch.bfloat16)
        q = slab[:, :Lq, :768].view(B, Lq, 12, 64)       # views, no copies
        k = slab[:, :, 768:1536].view(B, Lk, 12, 64)
        v = slab[:, :, 1536:].view(B, Lk, 12, 64)
        if name == "reader":
            lens = torch.randint(1, Lk + 1, (B,), device=dev, generator=gen)
        else:
            lens = torch.tensor([0, 300, 200], device=dev)
        bias = torch.where(torch.arange(Lk, device=dev)[None, :]
                           < lens[:, None], 0.0, -1e9).float()
        # a cotangent that is not contiguous, as a reshape may hand over
        dout = torch.randn(B, 12, Lq, 64, device=dev, generator=gen
                           ).to(torch.bfloat16).transpose(1, 2)
        n = min(B, check_rows)
        for rate in (0.0, RATE):
            seed = DROP_SEED if rate else None
            out, lse = fa.fid_cross_attention_forward(q, k, v, bias, seed,
                                                      chunk, rate)

            def kernel():
                return fa.fid_cross_attention_backward(
                    q, k, v, bias, lse, out, dout, seed, chunk, rate)

            def plain():
                return fa.fid_cross_attention_bwd_reference(
                    q, k, v, bias, lse, out, dout, seed, chunk, rate)

            got = kernel()
            torch.cuda.synchronize()
            want = fa.fid_cross_attention_bwd_reference(
                q[:n], k[:n], v[:n], bias[:n], lse[:n * 12], out[:n],
                dout[:n], seed, chunk, rate)
            errs = [_check(f"K4-bwd {name} rate {rate} d{x}", g[:n], w)
                    for x, g, w in zip("qkv", got, want)]
            again = kernel()
            if not all(torch.equal(a, g) for a, g in zip(again, got)):
                raise AssertionError(f"K4-bwd {name} is not deterministic")
            del want, again
            ms = time_ms(kernel)
            plain_ms = time_ms(plain, reps=3, warmup=1)
            flop = 2.5 * 4 * B * 12 * Lq * Lk * 64
            moved = nbytes(q, k, v, bias, lse, out, dout, *got)
            bound_ms, bound_by = bound(moved, flop)
            lib_ms = None
            if Lq == Lk:
                _, lib_ms = sdpa_times(slab, 3, slab, 3, bias,
                                       dout.reshape(B, Lq, 768))  # rate 0
            log(f"K4-bwd fid_cross_attention_backward {name} [{B}, {Lq} x "
                f"{Lk}, 12, 64] key_chunk {chunk} rate {rate}: "
                + ", ".join(f"d{x} max {e[0]:.3e} mean {e[1]:.3e}"
                            for x, e in zip("qkv", errs))
                + f" (rows 0..{n - 1}; tol {GRAD_TOL} x max|ref| "
                f"{max(e[2] for e in errs):.3e}), repeat bit-identical | "
                f"kernel {ms:.4f} ms ({flop / ms / 1e9:.2f} TFLOP/s by 2.5 x "
                f"4*Lq*Lk*hd) | plain {plain_ms:.4f} ms | SDPA backward "
                f"(rate 0) " + (f"{lib_ms:.4f} ms" if lib_ms else "not timed")
                + f" | bound {bound_ms:.4f} ms by {bound_by} "
                f"({moved / 1e6:.1f} MB, {flop / 1e9:.1f} GFLOP)")
            rows.append(dict(shape=name, rate=rate,
                             max_abs_err=max(e[0] for e in errs), ms=ms,
                             plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=lib_ms))
            if Lq == Lk:
                routes = _slab_routes(fa, slab, bias, dout, chunk, rate, seed,
                                      profile and bool(rate))
                (g_slab, slab_ms, slab_b), (g_three, three_ms, three_b) = (
                    routes["slab"], routes["three tensors"])
                if not (torch.equal(g_slab, g_three) and torch.equal(
                        g_slab, torch.cat([g.reshape(B, Lk, 768)
                                           for g in got], dim=-1))):
                    raise AssertionError(f"K4-bwd {name} rate {rate}: the "
                                         f"slab route's gradient differs")
                log(f"K4-bwd through autograd, {name} rate {rate}, the "
                    f"slab's gradient [{B}, {Lk}, 2304]: slab route "
                    f"{slab_ms:.4f} ms, {slab_b / 1e9:.3f} GB allocated by "
                    f"the backward | three-tensor route {three_ms:.4f} ms, "
                    f"{three_b / 1e9:.3f} GB (dq, dk, dv, then their "
                    f"concatenation) | gradients equal bit for bit")
                rows[-1].update(slab_route_ms=slab_ms,
                                three_tensor_route_ms=three_ms,
                                slab_route_bytes=slab_b,
                                three_tensor_route_bytes=three_b)
                del routes, g_slab, g_three
            del out, lse, got
        del slab, q, k, v, bias, dout
        torch.cuda.empty_cache()
    return rows


def k5_phase(dev, gen):
    """K5 at the decode shape [8, R, 12, 25,600, 64] for one query row
    (greedy) and five (beam 5), on a slab padded from 200 to 256 rows, and
    with a fully masked example. The kernel keeps ``p * vscale`` in fp32
    where the plain version rounds it to bf16 (as the TPU kernel does) and
    sums its stages, warps and blocks in another order: the forward
    tolerance, also against the plain form of that order
    (``decode_cross_attention_int8_split_reference``)."""
    from emdr2_tpu_torch.ops import decode_attention as da
    layout = da.kernel_layout()
    stage_keys, slots = layout.stage_keys, layout.slots
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for name, R, Lk, real_lo, masked in (("greedy", 1, 25_600, 12_800, False),
                                         ("beam5", 5, 25_600, 12_800, False),
                                         ("padded", 5, 256, 200, False),
                                         ("masked", 5, 25_600, 12_800, True)):
        B = 8
        q = torch.randn(B, R, 12, 64, device=dev, generator=gen
                        ).to(torch.bfloat16)
        kf = torch.randn(B, 12, Lk, 64, device=dev, generator=gen)
        vf = torch.randn(B, 12, Lk, 64, device=dev, generator=gen)
        real = torch.randint(real_lo, Lk - 50 if Lk > 256 else real_lo + 1,
                             (B,), device=dev, generator=gen)
        pad = torch.arange(Lk, device=dev)[None, :] >= real[:, None]
        kf.masked_fill_(pad[:, None, :, None], 0.0)      # padded rows: 0,
        vf.masked_fill_(pad[:, None, :, None], 0.0)      # scale 1, bias -1e9
        k8, ks = da.quantize_kv_rows(kf)
        v8, vs = da.quantize_kv_rows(vf)
        bias = torch.where(pad, -1e9, 0.0).float()
        if masked:
            bias[0] = -1e9
        got = da.decode_cross_attention_int8(q, k8, ks, v8, vs, bias)
        torch.cuda.synchronize()
        want = da.decode_cross_attention_int8_plain(q, k8, ks, v8, vs, bias)
        max_err, mean_err, ref = _check(f"K5 {name}", got, want, FWD_TOL)
        dense = da.decode_cross_attention_int8_reference(q, k8, ks, v8, vs,
                                                         bias)
        dense_err, _, _ = _check(f"K5 {name} vs dense", got, dense,
                                 (3e-2, 3e-3))
        spb, n_blocks = da.split_plan(B, 12, Lk, dev)
        split_err, _, _ = _check(
            f"K5 {name} vs its own order of sums", got,
            da.decode_cross_attention_int8_split_reference(
                q, k8, ks, v8, vs, bias, spb, stage_keys, layout.warps),
            FWD_TOL)
        if not torch.equal(da.decode_cross_attention_int8(q, k8, ks, v8, vs,
                                                          bias), got):
            raise AssertionError(f"K5 {name} is not deterministic")
        if masked and got[0].abs().max().item() > 2 * ref:
            raise AssertionError("K5: a fully masked example blew up")
        row = dict(shape=name, R=R, Lk=Lk, max_abs_err=max_err)
        line = (f"K5 decode_cross_attention_int8 {name} [{B}, {R}, 12, {Lk}, "
                f"64]: max_abs_err {max_err:.3e} mean {mean_err:.3e} (tol "
                f"{FWD_TOL} x max|ref| {ref:.3e}), vs dense reference "
                f"{dense_err:.3e}, vs the plain form of its own order of "
                f"sums {split_err:.3e}, repeat bit-identical; {n_blocks} "
                f"blocks a (head, example) of {spb} stages of {stage_keys} "
                f"keys")
        if name in ("greedy", "beam5"):
            # one call between two events (the figure every kernel's row
            # carries) takes the wrapper's host time when that is the longer;
            # ten calls queued back to back take the kernels' time
            ms = time_ms(lambda: da.decode_cross_attention_int8(
                q, k8, ks, v8, vs, bias), reps=20)

            def ten_calls():
                for _ in range(10):
                    da.decode_cross_attention_int8(q, k8, ks, v8, vs, bias)
            queued_ms = time_ms(ten_calls, reps=10) / 10
            plain_ms = time_ms(lambda: da.decode_cross_attention_int8_plain(
                q, k8, ks, v8, vs, bias), reps=3, warmup=1)
            moved = nbytes(q, k8, ks, v8, vs, bias, got)
            flop = 4 * B * R * 12 * Lk * 64
            bound_ms, bound_by = bound(moved, flop)
            # the same call on the slab dequantized to bf16: twice the bytes
            kb = (k8.float() * ks[..., None]).to(torch.bfloat16)
            vb = (v8.float() * vs[..., None]).to(torch.bfloat16)
            qh = q.transpose(1, 2)
            with torch.no_grad():
                sdpa_bf16_ms = time_ms(lambda: sdpa(qh, kb, vb, bias),
                                       reps=20)
            del kb, vb
            # what a multiprocessor keeps in flight: the blocks the runtime's
            # occupancy query says it holds, each with slots - 1 stages (K
            # and V) asked for ahead of the one it computes
            resident = layout.resident_blocks[R - 1]
            ahead = resident * (slots - 1) * 2 * stage_keys * 64
            line += (f" | kernel {ms:.4f} ms for one call between two events, "
                     f"{queued_ms:.4f} ms a call of ten queued back to back "
                     f"({moved / queued_ms / 1e6:.1f} GB/s of 3350) "
                     f"| plain {plain_ms:.4f} ms | SDPA on the bf16 "
                     f"slab (twice the bytes) {sdpa_bf16_ms:.4f} ms | bound "
                     f"{bound_ms:.4f} ms by {bound_by} ({moved / 1e6:.1f} "
                     f"MB, {flop / 1e9:.2f} GFLOP) | grid "
                     f"({n_blocks}, 12, {B}) = {n_blocks * 12 * B} blocks on "
                     f"{sms} multiprocessors, {layout.smem_bytes[R - 1]} "
                     f"bytes of shared memory a block: {resident} resident a "
                     f"multiprocessor (occupancy query), so {ahead} bytes "
                     f"asked for ahead")
            row.update(ms=ms, queued_ms=queued_ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       sdpa_bf16_ms=sdpa_bf16_ms)
        log(line)
        rows.append(row)
        del q, kf, vf, k8, ks, v8, vs, bias, got, want, dense
        torch.cuda.empty_cache()
    return rows


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


def make_corpus(cfg, tmpdir, n_docs=20_000):
    """Tokenizer with the published vocab sizes (its vocabulary written to
    ``<tmpdir>/vocab.txt``) and a synthetic corpus of ``n_docs`` passages
    at ``<tmpdir>/wiki_{text,title}``, the files the command-line tools
    read."""
    from emdr2_tpu_torch.data.evidence import EvidenceCorpus
    from emdr2_tpu_torch.data.indexed_dataset import (
        MMapIndexedDataset, MMapIndexedDatasetBuilder)
    from emdr2_tpu_torch.data.tokenizer import BertWordPieceTokenizer, toy_vocab

    words = ["what", "is", "the", "color", "of", "item"]
    base = len(toy_vocab(words))
    # fill the vocab to 70 below the retriever's padded vocab (BERT's 30522
    # entries for the published 30592), so the T5 tokenizer (+2 specials,
    # +100 sentinel ids) pads to the reader's published 30720
    n_words = cfg.retriever.encoder.vocab_size - 70 - base
    vocab = toy_vocab(words + [f"w{i}" for i in range(n_words)])
    with open(os.path.join(tmpdir, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")
    tok = BertWordPieceTokenizer(vocab, vocab_extra_ids=100)
    rng = np.random.RandomState(SEED)
    lo, hi = base, len(vocab)
    text_p = os.path.join(tmpdir, "wiki_text")
    title_p = os.path.join(tmpdir, "wiki_title")
    with MMapIndexedDatasetBuilder(text_p) as b:
        for n in rng.randint(90, 140, size=n_docs):
            b.add_item(rng.randint(lo, hi, size=n).tolist())
    with MMapIndexedDatasetBuilder(title_p) as b:
        for i in range(n_docs):      # three passages per title
            b.add_item([lo + (i // 3) % (hi - lo), lo + 7])
    corpus = EvidenceCorpus(MMapIndexedDataset(text_p),
                            MMapIndexedDataset(title_p))
    return tok, corpus


def make_world(cfg, tmpdir, dev, gen, n_docs=20_000, n_rows=N_INDEX):
    """``make_corpus`` and an ``n_rows`` index made on ``dev``."""
    from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex

    tok, corpus = make_corpus(cfg, tmpdir, n_docs)
    emb = torch.randn(n_rows, cfg.index.embed_dim, device=dev, generator=gen)
    pids = 1 + np.arange(n_rows) % n_docs
    index = ShardedEvidenceIndex(cfg.index, emb, passage_ids=pids,
                                 device=dev)
    return tok, corpus, index


def exact_ids(index, q_emb, k):
    """Exact top-k rows over the stored (dequantized) index, fp32."""
    from emdr2_tpu_torch.ops import mips
    emb, scales = index.embeddings, index.scales
    rows = (mips.dequantize_int8(emb, scales, index.cfg.group_size)
            if scales is not None else emb.float())
    q = q_emb.float() if scales is not None else q_emb.to(emb.dtype).float()
    return torch.topk(torch.matmul(q, rows[:index.n_real].T), k,
                      dim=1).indices


def _counters():
    """name -> wrapper whose ``.launches`` counts its kernel's launches."""
    from emdr2_tpu_torch.ops import decode_attention as da
    from emdr2_tpu_torch.ops import fid_attention as fa
    from emdr2_tpu_torch.ops import mips
    return {"flash_self_attention": fa.flash_self_attention,
            "flash_self_attention_backward": fa.flash_self_attention_backward,
            "flash_cross_attention": fa.flash_cross_attention,
            "flash_cross_attention_backward":
                fa.flash_cross_attention_backward,
            "candidate_scan": mips.candidate_scan,
            "fid_cross_attention": fa.fid_cross_attention,
            "fid_cross_attention_backward": fa.fid_cross_attention_backward,
            "decode_cross_attention_int8": da.decode_cross_attention_int8}


def _reset_counts():
    from emdr2_tpu_torch.ops import mips
    for fn in _counters().values():
        fn.launches = 0
    mips.candidate_scan.tensor_core_launches = 0


def _read_counts(names):
    counters = _counters()
    return {name: counters[name].launches for name in names}


def log_profile(what, p):
    busy = p["device_ms"] / p["wall_ms"]
    log(f"profiled {what}: wall {p['wall_ms']:.1f} ms, device kernels "
        f"{p['device_ms']:.1f} ms (busy {busy:.3f})")
    for key, ms, count in p["top"]:
        log(f"  {ms:10.3f} ms  {count:6d}x  {key[:100]}")
    log(f"  by class of kernel ({what}):")
    for label, ms in sorted(p["classes"].items(), key=lambda kv: -kv[1]):
        log(f"  {ms:10.3f} ms  {ms / p['device_ms']:6.1%}  {label}")
    log(f"  by operator ({what}):")
    for key, ms, count in p["by_op"]:
        log(f"  {ms:10.3f} ms  {count:6d}x  {key[:100]}")


def generation_runs(cfg, model, tok, corpus, index, dev, questions, batch,
                    base_pipe, base_answers, profile=False):
    """The generation path on the serving phase's model and questions:
    greedy over the int8 cross K/V, then beam 5 over it; then, outside the
    counted runs, the slab's bytes in both forms and one decode step's
    log-probs of the int8 session against the bf16-path session's."""
    from emdr2_tpu_torch.serving import QAPipeline
    from emdr2_tpu_torch.utils.timing import StageTimer

    names = ("flash_self_attention", "candidate_scan",
             "decode_cross_attention_int8")
    runs = {}
    for name, kw in (("greedy_int8", dict(kv_quant="int8")),
                     ("beam5_int8", dict(beam_size=5, kv_quant="int8"))):
        timer = StageTimer(dev)
        pipe = QAPipeline(cfg, model, tok, corpus, index, batch_size=batch,
                          timer=timer, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
        _reset_counts()
        t0 = time.perf_counter()
        answers = pipe.ask(questions)
        ask_s = time.perf_counter() - t0
        launches = _read_counts(names)
        if len(answers) != len(questions) or not all(
                isinstance(a, str) for a in answers):
            raise AssertionError(f"{name}: bad answers {answers!r}")
        runs[name] = dict(
            answers=answers, launches=launches, stage_ms=dict(timer.ms),
            ask_s=ask_s, pipe=pipe,
            peak_bytes=(torch.cuda.max_memory_allocated(dev)
                        if dev.type == "cuda" else 0))
    if profile:        # one warm batch of each greedy form
        first = list(questions[:batch])
        runs["profiles"] = {
            "greedy, fp32-K slab": profile_call(
                lambda: base_pipe.ask(first), "greedy_bf16_profile.txt"),
            "greedy, int8 slab": profile_call(
                lambda: runs["greedy_int8"]["pipe"].ask(first),
                "greedy_int8_profile.txt")}
    same = sum(a == b for a, b in zip(runs["greedy_int8"]["answers"],
                                      base_answers))
    runs["greedy_int8"]["share_equal_bf16"] = same / len(questions)

    # one decode step from BOS, both sessions on the same encoder states
    dev_batch = base_pipe._build_batch(list(questions[:batch]))
    sessions = {"bf16": base_pipe.session,
                "int8": runs["greedy_int8"].pop("pipe").session}
    runs["beam5_int8"].pop("pipe")
    lps, slab_bytes = {}, {}
    for name, session in sessions.items():
        kvs, flat = session.encode(dev_batch)
        slab_bytes[name] = sum(nbytes(*kv) for kv in kvs)
        with torch.inference_mode():
            tok0 = torch.full((flat.shape[0], 1), tok.bos_id,
                              dtype=torch.long, device=dev)
            lps[name] = session._step_lp(
                tok0, flat, kvs, session.new_cache(flat.shape[0], dev), 0)
        del kvs
    diff = (lps["int8"] - lps["bf16"]).abs().max().item()
    if not (torch.isfinite(lps["int8"]).all() and diff < 0.1):
        raise AssertionError(f"int8 decode step log-probs differ from the "
                             f"bf16-path ones by {diff}")
    runs["step_logprob_max_diff"] = diff
    runs["slab_bytes"] = slab_bytes
    return runs


def slice_phase(cfg, dev, gen, n_rows=N_INDEX, n_docs=20_000, batch=8,
                n_questions=16, profile=False):
    """Drive QAPipeline.ask (greedy, the serving path), then the generation
    path (``generation_runs``) on the same model; returns {"launches",
    "stage_ms", ..., "generation"}."""
    from emdr2_tpu_torch.data.qa_dataset import encode_question
    from emdr2_tpu_torch.models import EMDR2Model
    from emdr2_tpu_torch.serving import QAPipeline
    from emdr2_tpu_torch.utils.timing import StageTimer

    with tempfile.TemporaryDirectory() as tmpdir:
        t0 = time.perf_counter()
        tok, corpus, index = make_world(cfg, tmpdir, dev, gen, n_docs,
                                        n_rows)
        model = EMDR2Model(cfg, device=dev, generator=gen)
        timer = StageTimer(dev)
        pipe = QAPipeline(cfg, model, tok, corpus, index, batch_size=batch,
                          timer=timer)
        log(f"slice set-up {time.perf_counter() - t0:.1f} s: "
            f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params, "
            f"index {tuple(index.embeddings.shape)} "
            f"{index.embeddings.dtype}, {len(corpus)} passages")
        questions = [f"what is the color of item w{7 * i}"
                     for i in range(n_questions)]
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
        _reset_counts()
        t0 = time.perf_counter()
        answers = pipe.ask(questions)
        ask_s = time.perf_counter() - t0
        launches = _read_counts(("flash_self_attention", "candidate_scan"))
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)

        if len(answers) != n_questions or not all(
                isinstance(a, str) for a in answers):
            raise AssertionError(f"bad answers: {answers!r}")
        # the retrieval of every batch of the run equals an exact search
        k = cfg.index.topk
        for s in range(0, n_questions, batch):
            ids = np.asarray([encode_question(q, tok,
                                              cfg.retriever.query_seq_len)[0]
                              for q in questions[s:s + batch]])
            with torch.inference_mode():
                q_emb = model.embed_query(torch.as_tensor(ids).to(dev))
                _, got = index.search(q_emb, k)
                want = exact_ids(index, q_emb, k)
            for r in range(got.shape[0]):
                if set(got[r].tolist()) != set(want[r].tolist()):
                    raise AssertionError(f"search ids differ from the exact "
                                         f"search, batch {s // batch} row {r}")
        generation = generation_runs(cfg, model, tok, corpus, index, dev,
                                     questions, batch, pipe, answers,
                                     profile)
    return dict(answers=answers, launches=launches, stage_ms=dict(timer.ms),
                ask_s=ask_s, peak_bytes=peak, generation=generation)


def eval_phase(cfg, dev, gen, n_rows=N_INDEX, n_docs=20_000, batch=8,
               n_examples=16, beam_size=5):
    """Drive ``E2EQATask.evaluate_em`` (greedy over the int8 K/V on all
    examples, then beam search on one batch) and ``validation_loss`` under
    ``cfg`` (whose ``flash_key_chunk`` sends the reader's rows through the
    general flash kernel); then hold one batch's losses against the same
    weights with the flash kernels off (materialized attention)."""
    from emdr2_tpu_torch.config import with_transformers
    from emdr2_tpu_torch.data.qa_dataset import OpenQADataset
    from emdr2_tpu_torch.models import EMDR2Model
    from emdr2_tpu_torch.tasks import E2EQATask
    from emdr2_tpu_torch.training import step as step_lib
    from emdr2_tpu_torch.utils.timing import StageTimer

    names = ("flash_self_attention", "flash_cross_attention",
             "candidate_scan", "fid_cross_attention",
             "decode_cross_attention_int8")
    with tempfile.TemporaryDirectory() as tmpdir:
        t0 = time.perf_counter()
        tok, corpus, index = make_world(cfg, tmpdir, dev, gen, n_docs,
                                        n_rows)
        qa = os.path.join(tmpdir, "qa.tsv")
        with open(qa, "w") as f:
            for i in range(n_examples):
                f.write(f"what is the color of item w{7 * i}\t"
                        f"['w{3 * i} w{i}', 'w{5 * i}']\n")
        ds = OpenQADataset([qa], tok, cfg.retriever.query_seq_len,
                           cfg.reader.decoder_seq_len, seed=SEED)
        timer = StageTimer(dev)
        task = E2EQATask(cfg, tok, corpus, index, device=dev, timer=timer)
        state = task.init_state(SEED)
        log(f"eval set-up {time.perf_counter() - t0:.1f} s: flash_key_chunk "
            f"{cfg.reader.transformer.flash_key_chunk}, {n_examples} "
            f"examples, batch {batch}")
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
        _reset_counts()
        t0 = time.perf_counter()
        em, n = task.evaluate_em(ds, batch_size=batch, kv_quant="int8")
        t1 = time.perf_counter()
        em_beam, n_beam = task.evaluate_em(ds, batch_size=batch,
                                           beam_size=beam_size,
                                           max_batches=1)
        t2 = time.perf_counter()
        val = task.validation_loss(ds, batch_size=batch)
        t3 = time.perf_counter()
        launches = _read_counts(names)
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        if n != n_examples or n_beam != min(batch, n_examples):
            raise AssertionError(f"evaluate_em counted {n} and {n_beam}")
        if not (0.0 <= em <= 100.0 and 0.0 <= em_beam <= 100.0):
            raise AssertionError(f"EM out of range: {em}, {em_beam}")
        if set(val) != {"loss", "lm_loss", "retriever_loss"} or not all(
                np.isfinite(v) for v in val.values()):
            raise AssertionError(f"validation_loss: {val}")

        # the same weights with every flash kernel off, one batch
        off = {"fid_flash_attention": False}
        plain_cfg = with_transformers(cfg, off, off)
        plain = EMDR2Model(plain_cfg, device=dev)
        plain.load_state_dict(state.model.state_dict())
        qa_batch = next(ds.epoch_batches(batch, seed=0, shuffle=False))
        dev_batch = task.build_device_batch(qa_batch)
        got = task._eval_fn(state, dev_batch)
        want = step_lib.make_eval_forward(plain_cfg, tok.eos_id)(
            step_lib.TrainState(0, SEED, plain, None), dev_batch)
        agree = {}
        for key in ("loss", "lm_loss", "retriever_loss"):
            g, w = float(got[key]), float(want[key])
            agree[key] = (g, w)
            if key != "retriever_loss" and abs(g - w) > 5e-2 * abs(w):
                raise AssertionError(f"{key} with the kernels {g} against "
                                     f"materialized attention {w}")
        del plain
    return dict(em=em, n=n, em_beam=em_beam, n_beam=n_beam, val=val,
                launches=launches, stage_ms=dict(timer.ms), peak_bytes=peak,
                seconds=dict(evaluate_em=t1 - t0, evaluate_em_beam=t2 - t1,
                             validation_loss=t3 - t2), agree=agree)


def train_phase(cfg, dev, gen, n_rows=N_INDEX, n_docs=20_000, batch=8,
                steps=3, total_iters=1000, profile=False,
                profile_table="train_step_profile.txt"):
    """Drive ``E2EQATask.train_step``; returns {"metrics", "launches",
    "stage_ms", ...}. The flagship schedule warms up over 1% of
    ``total_iters``, so the first update's lr is 0 and the later ones are
    not."""
    from emdr2_tpu_torch.data.qa_dataset import OpenQADataset
    from emdr2_tpu_torch.tasks import E2EQATask
    from emdr2_tpu_torch.training.step import METRICS
    from emdr2_tpu_torch.utils.timing import StageTimer

    names = ("flash_self_attention", "flash_self_attention_backward",
             "flash_cross_attention", "flash_cross_attention_backward",
             "candidate_scan")
    with tempfile.TemporaryDirectory() as tmpdir:
        t0 = time.perf_counter()
        tok, corpus, index = make_world(cfg, tmpdir, dev, gen, n_docs,
                                        n_rows)
        qa = os.path.join(tmpdir, "qa.tsv")
        with open(qa, "w") as f:
            for i in range(batch * (steps + 1)):
                f.write(f"what is the color of item w{7 * i}\t"
                        f"['w{3 * i} w{i}', 'w{5 * i}']\n")
        ds = OpenQADataset([qa], tok, cfg.retriever.query_seq_len,
                           cfg.reader.decoder_seq_len, seed=SEED)
        timer = StageTimer(dev)
        task = E2EQATask(cfg, tok, corpus, index, total_train_iters=total_iters,
                         device=dev, timer=timer)
        state = task.init_state(SEED)
        n_params = sum(p.numel() for p in state.model.parameters())
        log(f"train set-up {time.perf_counter() - t0:.1f} s: "
            f"{n_params / 1e6:.1f}M params, batch {batch}, remat reader="
            f"{cfg.reader.transformer.remat} towers="
            f"{cfg.retriever.encoder.remat}, dropout "
            f"{cfg.reader.transformer.hidden_dropout}/"
            f"{cfg.reader.transformer.attention_dropout}")
        batches = ds.epoch_batches(batch, seed=SEED)
        probe = state.model.reader.decoder.layer(0).mlp.wi.kernel
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
        _reset_counts()
        rows = []
        for i in range(steps):
            lr = state.optimizer.schedule(state.optimizer.count)
            before = probe.detach().clone()
            t0 = time.perf_counter()
            m = task.train_step(next(batches))
            row = {k: float(m[k]) for k in METRICS}    # syncs the device
            wall = time.perf_counter() - t0
            row.update(lr=lr, wall_s=wall,
                       moved=not torch.equal(before, probe.detach()))
            rows.append(row)
            log(f"train step {i}: " + ", ".join(
                f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
                for k, v in row.items()))
        launches = _read_counts(names)
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        top = None
        if profile:
            batch_p = next(batches)
            top = profile_call(lambda: task.train_step(batch_p),
                               profile_table)
    for i, row in enumerate(rows):
        if not all(np.isfinite(row[k]) for k in METRICS):
            raise AssertionError(f"train step {i}: non-finite metrics {row}")
        if row["grad_norm"] <= 0:
            raise AssertionError(f"train step {i}: zero gradient norm")
        if row["lr"] > 0 and not row["moved"]:
            raise AssertionError(f"train step {i}: lr {row['lr']} but the "
                                 f"parameters did not move")
    if not any(row["lr"] > 0 for row in rows):
        raise AssertionError("no step ran with a non-zero learning rate")
    return dict(metrics=rows, launches=launches, stage_ms=dict(timer.ms),
                peak_bytes=peak, top=top)


def _host_state(state):
    """(parameters, AdamW moments and step counts, (step, seed, count)) of
    a TrainState as host copies."""
    def host(t):
        return t.detach().to("cpu", copy=True)

    params = {k: host(v) for k, v in state.model.state_dict().items()}
    adam = state.optimizer.adamw.state
    moments = {n: tuple(host(adam[p][key])
                        for key in ("exp_avg", "exp_avg_sq", "step"))
               for n, p in state.model.named_parameters()}
    return params, moments, (state.step, state.seed, state.optimizer.count)


def engine_phase(cfg, dev, gen, n_rows=N_INDEX, n_docs=20_000, batch=8,
                 iters=4, plain_iters=3, prefetch_depth=2, eval_examples=8,
                 total_iters=1000):
    """Drive ``training.engine.train`` under ``cfg`` (whose
    ``flash_key_chunk`` sends the reader's rows through the general flash
    kernel, forward and backward): ``iters`` iterations with the
    prefetcher, an interval checkpoint at ``iters // 2``, the final one and
    an evaluation callback at ``iters``; then ``plain_iters`` more without
    the prefetcher; then the final checkpoint restored into a fresh task
    and one more step from it; then the checkpoint's times."""
    import dataclasses
    import shutil
    import threading

    from emdr2_tpu_torch.data.qa_dataset import OpenQADataset
    from emdr2_tpu_torch.tasks import E2EQATask
    from emdr2_tpu_torch.training import checkpointing as ckpt
    from emdr2_tpu_torch.training import engine
    from emdr2_tpu_torch.training.step import METRICS
    from emdr2_tpu_torch.utils.timing import StageTimer

    def loop_cfg(train_iters):
        return cfg.replace(train=dataclasses.replace(
            cfg.train, batch_size=batch, train_iters=train_iters,
            log_interval=1, save_interval=max(iters // 2, 1),
            eval_interval=iters, async_save=True, seed=SEED))

    def qa_file(path, n, offset=0):
        with open(path, "w") as f:
            for i in range(offset, offset + n):
                f.write(f"what is the color of item w{7 * i}\t"
                        f"['w{3 * i} w{i}', 'w{5 * i}']\n")

    def dataset(path):
        return OpenQADataset([path], tok, cfg.retriever.query_seq_len,
                             cfg.reader.decoder_seq_len, seed=SEED)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    with tempfile.TemporaryDirectory() as tmpdir:
        t0 = time.perf_counter()
        tok, corpus, index = make_world(cfg, tmpdir, dev, gen, n_docs,
                                        n_rows)
        qa_file(os.path.join(tmpdir, "train.tsv"),
                batch * (iters + plain_iters + 1))
        qa_file(os.path.join(tmpdir, "valid.tsv"), eval_examples, 10_000)
        ds = dataset(os.path.join(tmpdir, "train.tsv"))
        valid = dataset(os.path.join(tmpdir, "valid.tsv"))
        timer = StageTimer(dev)
        task = E2EQATask(cfg, tok, corpus, index,
                         total_train_iters=total_iters, device=dev,
                         timer=timer)
        state = task.init_state(SEED)
        n_params = sum(p.numel() for p in state.model.parameters())
        log(f"engine set-up {time.perf_counter() - t0:.1f} s: "
            f"{n_params / 1e6:.1f}M params, batch {batch}, flash_key_chunk "
            f"{cfg.reader.transformer.flash_key_chunk}, prefetch_depth "
            f"{prefetch_depth}")
        probe = state.model.reader.decoder.layer(0).mlp.wi.kernel
        before = probe.detach().clone()
        root = os.path.join(tmpdir, "checkpoints")
        evals = []

        def eval_callback(iteration):
            t0 = time.perf_counter()
            val = task.validation_loss(valid, batch_size=batch, max_batches=1)
            em, n = task.evaluate_em(valid, batch_size=batch,
                                     kv_quant="int8", max_batches=1)
            out = {"valid_loss": val["loss"], "valid_lm_loss": val["lm_loss"],
                   "valid_em": em, "valid_n": n}
            evals.append(dict(out, iteration=iteration,
                              seconds=time.perf_counter() - t0))
            return out

        sync()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        _reset_counts()
        train_log = engine.TrainLog(1, log)
        t0 = time.perf_counter()
        final = engine.train(task, ds, loop_cfg(iters), save_dir=root,
                             eval_callback=eval_callback,
                             prefetch_depth=prefetch_depth, printer=log,
                             log=train_log)
        sync()
        train_s = time.perf_counter() - t0
        launches = _read_counts(tuple(_counters()))
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        stage_ms = {k: list(v) for k, v in timer.ms.items()}

        history = train_log.history
        if final != iters or state.step != iters or [
                h["iteration"] for h in history] != list(range(1, iters + 1)):
            raise AssertionError(f"engine ended at {final}, state step "
                                 f"{state.step}, history {history}")
        for h in history:
            if not all(np.isfinite(h[k]) for k in METRICS):
                raise AssertionError(f"non-finite metrics: {h}")
            if h["grad_norm"] <= 0:
                raise AssertionError(f"zero gradient norm: {h}")
        if torch.equal(before, probe.detach()):
            raise AssertionError("the parameters did not move")
        if [e["iteration"] for e in evals] != [iters] or not all(
                np.isfinite(evals[0][k]) for k in ("valid_loss",
                                                   "valid_lm_loss")) \
                or evals[0]["valid_n"] != min(eval_examples, batch) \
                or not 0.0 <= evals[0]["valid_em"] <= 100.0:
            raise AssertionError(f"evaluation callback: {evals}")
        want_dirs = sorted({f"iter_{max(iters // 2, 1):07d}",
                            f"iter_{iters:07d}", ckpt.TRACKER})
        if sorted(os.listdir(root)) != want_dirs \
                or ckpt.latest_iteration(root) != iters:
            raise AssertionError(f"checkpoints: {sorted(os.listdir(root))}, "
                                 f"tracker {ckpt.latest_iteration(root)}")
        alive = [t.name for t in threading.enumerate()
                 if t.name.startswith(("batch-prefetch", "ckpt-write"))]
        if alive:
            raise AssertionError(f"threads left alive: {alive}")
        want_state = _host_state(state)
        ckpt_bytes = os.path.getsize(os.path.join(
            ckpt.iter_dir(root, iters), ckpt.STATE_FILE))

        # the same task goes on without the prefetcher
        plain_log = engine.TrainLog(1, log)
        final = engine.train(task, ds, loop_cfg(iters + plain_iters),
                             prefetch_depth=0, printer=log, log=plain_log)
        sync()
        if final != iters + plain_iters or len(plain_log.history) != \
                plain_iters:
            raise AssertionError(f"plain run ended at {final}")

        # the final checkpoint into a fresh task, bit for bit; the first
        # task's state leaves the card first (two states and a step's
        # activations do not fit)
        del state, probe, before
        task.state = None
        task._retrieval_snapshot = None
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        fresh = E2EQATask(cfg, tok, corpus, index,
                          total_train_iters=total_iters, device=dev)
        fresh.init_state(SEED + 1)
        t0 = time.perf_counter()
        _, it = ckpt.load_checkpoint(root, fresh.state)
        sync()
        load_s = time.perf_counter() - t0
        got_state = _host_state(fresh.state)
        if it != iters or got_state[2] != want_state[2]:
            raise AssertionError(f"restored iteration {it}, counters "
                                 f"{got_state[2]} against {want_state[2]}")
        for name, w in want_state[0].items():
            if not torch.equal(got_state[0][name], w):
                raise AssertionError(f"restored parameter {name} differs")
        for name, w in want_state[1].items():
            if not all(torch.equal(g, x)
                       for g, x in zip(got_state[1][name], w)):
                raise AssertionError(f"restored moment of {name} differs")
        n_compared = len(want_state[0]) + 2 * len(want_state[1])
        del want_state, got_state
        m = fresh.train_step(next(ds.epoch_batches(batch, seed=SEED + 99)))
        resumed = {k: float(m[k]) for k in METRICS}
        if fresh.state.step != iters + 1 or not all(
                np.isfinite(v) for v in resumed.values()) \
                or resumed["grad_norm"] <= 0:
            raise AssertionError(f"step after the restore: {resumed}")

        # the checkpoint's times, on the restored task's state
        shutil.rmtree(root)
        t0 = time.perf_counter()
        ckpt.save_checkpoint(root, fresh.state, 1, async_save=True)
        t1 = time.perf_counter()
        ckpt.finalize_async_saves()
        t2 = time.perf_counter()
        ckpt.save_checkpoint(root, fresh.state, 1)
        t3 = time.perf_counter()
    return dict(history=history, plain_history=plain_log.history,
                evals=evals, launches=launches, stage_ms=stage_ms,
                peak_bytes=peak, train_s=train_s, resumed=resumed,
                n_compared=n_compared, checkpoint=dict(
                    bytes=ckpt_bytes, async_stage_s=t1 - t0,
                    background_write_s=t2 - t1, sync_save_s=t3 - t2,
                    load_s=load_s))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)


def _peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _empty_cache(dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def index_phase(cfg, dev, gen, n_docs=32_768, n_rows=N_INDEX, batch=128,
                n_check=64):
    """The evidence-index build at the flagship widths:
    ``EvidenceIndexBuilder`` embeds ``n_docs`` passages at
    Lc=``cfg.retriever.seq_len`` in batches of ``batch``, by the host path
    (fp16 rows in host RAM) and by the device path (rows in
    ``cfg.index.dtype`` on the card): passages/s, peak memory and K1-fwd's
    launches of each; the two paths' rows agree, and ``n_check`` sampled
    rows equal ``retriever.embed_context`` on the same passages. Then the
    swap's stall: ``ShardedEvidenceIndex.update`` of an int8 index of
    ``n_rows`` rows (the reference's shard a GPU) from a host fp16 array and
    from a device tensor."""
    from emdr2_tpu_torch.models import EMDR2Model
    from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex
    from emdr2_tpu_torch.retrieval.builder import EvidenceIndexBuilder

    res = {}
    with tempfile.TemporaryDirectory() as tmpdir:
        t0 = time.perf_counter()
        tok, corpus = make_corpus(cfg, tmpdir, n_docs)
        model = EMDR2Model(cfg, device=dev, generator=gen)
        builder = EvidenceIndexBuilder(cfg, model, corpus, tok.cls_id,
                                       tok.sep_id, tok.pad_id,
                                       batch_size=batch)
        with torch.inference_mode():              # warm-up: one batch
            builder._embed(model, np.arange(1, batch + 1))
        log(f"index set-up {time.perf_counter() - t0:.1f} s: {n_docs} "
            f"passages, batch {batch}, Lc {cfg.retriever.seq_len}")
        paths = {}
        for name in ("host", "device"):
            _reset_peak(dev)
            _reset_counts()
            t0 = time.perf_counter()
            rows = (builder.embed_corpus() if name == "host"
                    else builder.embed_corpus_device(None, n_docs))
            _sync(dev)
            sec = time.perf_counter() - t0
            paths[name] = dict(
                rows=rows, seconds=sec, per_s=n_docs / sec,
                peak_bytes=_peak(dev),
                launches=_read_counts(("flash_self_attention",))[
                    "flash_self_attention"])
            # 12 a batch on the card; the plain version on the CPU
            want = (-(-n_docs // batch) * cfg.retriever.encoder.num_layers
                    if dev.type == "cuda" else 0)
            if paths[name]["launches"] != want:
                raise AssertionError(f"index {name} path: K1-fwd launched "
                                     f"{paths[name]['launches']} times, "
                                     f"want {want}")
            log(f"index {name} path: {n_docs} passages in {sec:.3f} s = "
                f"{n_docs / sec:.1f} passages/s, peak memory "
                f"{paths[name]['peak_bytes'] / 2**30:.2f} GiB, K1-fwd "
                f"launches {paths[name]['launches']}")
        host = torch.from_numpy(paths["host"]["rows"]).to(dev)
        dev_rows = paths["device"].pop("rows")
        if dev_rows.dtype != cfg.index.dtype or tuple(dev_rows.shape) != (
                n_docs, cfg.index.embed_dim):
            raise AssertionError(f"device path rows {dev_rows.dtype} "
                                 f"{tuple(dev_rows.shape)}")
        # fp16 against cfg.index.dtype (bf16) roundings of the same fp32
        agree = _check("index: device path against host path", dev_rows,
                       host, FWD_TOL)
        doc_ids = np.sort(np.random.RandomState(SEED).choice(
            n_docs, n_check, replace=False)) + 1
        ids, types = builder._format_rows(doc_ids)
        with torch.inference_mode():
            want = model.retriever.embed_context(
                torch.as_tensor(ids).long().to(dev),
                torch.as_tensor(types).long().to(dev))
        sampled = _check("index: sampled rows against embed_context",
                         host[doc_ids - 1], want, FWD_TOL)
        log(f"index: device rows against host rows: max abs err "
            f"{agree[0]:.3e}, mean {agree[1]:.3e} (tol {FWD_TOL} x max|ref| "
            f"{agree[2]:.3e}); {n_check} sampled host rows against "
            f"retriever.embed_context: max abs err {sampled[0]:.3e}, mean "
            f"{sampled[1]:.3e} (same tol, max|ref| {sampled[2]:.3e})")
        del host, dev_rows, want, model, builder
        for name in paths:
            paths[name].pop("rows", None)
        res.update(paths, agree=agree[:2], sampled=sampled[:2])
    _empty_cache(dev)

    # the swap's stall at the reference's shard a GPU
    emb = torch.randn(n_rows, cfg.index.embed_dim, device=dev, generator=gen)
    index = ShardedEvidenceIndex(cfg.index, emb, device=dev)
    host_rows = emb.to(torch.float16).cpu().numpy()
    dev_rows = emb.to(cfg.index.dtype)
    del emb
    stalls = {"host": [], "device": []}
    for name, rows, reps in (("host", host_rows, 2), ("device", dev_rows, 3)):
        for _ in range(reps):
            _sync(dev)
            t0 = time.perf_counter()
            index.update(rows)
            t1 = time.perf_counter()
            _sync(dev)
            stalls[name].append(((t1 - t0) * 1e3,
                                 (time.perf_counter() - t0) * 1e3))
        log(f"index: update of the {n_rows}-row int8 index from the {name} "
            f"({tuple(rows.shape)} {rows.dtype}): " + ", ".join(
                f"{h:.1f} ms on the host thread, {t:.1f} ms until the card "
                f"is done" for h, t in stalls[name]))
    del index, host_rows, dev_rows
    _empty_cache(dev)
    res["stalls"] = stalls
    res["full_shard_s"] = {name: n_rows / res[name]["per_s"]
                           for name in ("host", "device")}
    log(f"index: one full-shard pass of {n_rows} passages at these rates: "
        + ", ".join(f"{name} path {s:.1f} s"
                    for name, s in res["full_shard_s"].items()))
    return res


def refresh_phase(cfg, dev, gen, n_docs=16_384, batch=8, iters=8,
                  plain_iters=3, reload_interval=2, n_check=64,
                  total_iters=1000):
    """``training.engine.train`` at full width with a live
    ``AsyncIndexRefresher`` over an ``n_docs``-passage corpus and int8
    index (``reload_interval``, prefetch 0), ``iters`` iterations; then
    ``plain_iters`` more without a refresher. The instrumentation wraps the
    refresher's ``maybe_swap`` (each swap's stall on the trainer thread)
    and its builder's ``embed_corpus`` (each completed pass's window), and
    the loop's printer (each iteration's end); ``on_refresh`` samples
    ``n_check`` rows of the index after the first swap, which are held to
    an embedding made with a copy of the tower taken at the hand-off."""
    import copy
    import dataclasses
    import threading

    from emdr2_tpu_torch.data.qa_dataset import OpenQADataset
    from emdr2_tpu_torch.ops import mips
    from emdr2_tpu_torch.retrieval.builder import (EvidenceIndexBuilder,
                                                   context_tower)
    from emdr2_tpu_torch.tasks import E2EQATask
    from emdr2_tpu_torch.training import engine
    from emdr2_tpu_torch.training.async_refresh import AsyncIndexRefresher
    from emdr2_tpu_torch.training.step import METRICS

    def loop_cfg(train_iters):
        return cfg.replace(train=dataclasses.replace(
            cfg.train, batch_size=batch, train_iters=train_iters,
            log_interval=1, save_interval=10 ** 6, eval_interval=10 ** 6,
            index_reload_interval=reload_interval, seed=SEED))

    with tempfile.TemporaryDirectory() as tmpdir:
        t0 = time.perf_counter()
        tok, corpus, index = make_world(cfg, tmpdir, dev, gen, n_docs,
                                        n_docs)
        qa = os.path.join(tmpdir, "qa.tsv")
        with open(qa, "w") as f:
            for i in range(batch * (iters + plain_iters + 1)):
                f.write(f"what is the color of item w{7 * i}\t"
                        f"['w{3 * i} w{i}', 'w{5 * i}']\n")
        ds = OpenQADataset([qa], tok, cfg.retriever.query_seq_len,
                           cfg.reader.decoder_seq_len, seed=SEED)
        task = E2EQATask(cfg, tok, corpus, index,
                         total_train_iters=total_iters, device=dev)
        model = task.init_state(SEED).model
        start_weights = {k: v.detach().to("cpu", copy=True) for k, v in
                         context_tower(model).state_dict().items()}
        builder = EvidenceIndexBuilder(cfg, model, corpus, tok.cls_id,
                                       tok.sep_id, tok.pad_id)
        check_rows = np.sort(np.random.RandomState(SEED + 1).choice(
            n_docs, n_check, replace=False))
        first = {}

        def on_refresh(step):
            if not first:
                rows = mips.dequantize_int8(index.embeddings, index.scales,
                                            cfg.index.group_size)
                first.update(step=step, rows=rows[check_rows].clone(),
                             scales=index.scales[check_rows //
                                                 cfg.index.group_size])

        refresher = AsyncIndexRefresher(builder, index, reload_interval,
                                        on_refresh=on_refresh)
        passes, swaps, ends = [], [], []
        embed = builder.embed_corpus

        def timed_embed(*args, **kw):
            t0 = time.perf_counter()
            out = embed(*args, **kw)
            passes.append((t0, time.perf_counter()))
            return out

        builder.embed_corpus = timed_embed
        maybe_swap = refresher.maybe_swap

        def timed_swap(step, model):
            t0 = time.perf_counter()
            swapped = maybe_swap(step, model)
            if swapped:
                swaps.append((step, (time.perf_counter() - t0) * 1e3))
            return swapped

        refresher.maybe_swap = timed_swap

        def printer(line):
            if "ms_per_iter" in line:
                ends.append(time.perf_counter())
            log(line)

        log(f"refresh set-up {time.perf_counter() - t0:.1f} s: {n_docs} "
            f"passages, int8 index, batch {batch}, reload interval "
            f"{reload_interval}")
        _reset_peak(dev)
        _reset_counts()
        train_log = engine.TrainLog(1, printer)
        t_start = time.perf_counter()
        final = engine.train(task, ds, loop_cfg(iters), refresher=refresher,
                             printer=printer, log=train_log)
        _sync(dev)
        train_s = time.perf_counter() - t_start
        launches = _read_counts(tuple(_counters()))
        peak = _peak(dev)
        alive = [t.name for t in threading.enumerate() if t.name.startswith(
            ("index-refresh", "batch-prefetch", "ckpt-write"))]
        history = train_log.history
        if final != iters or [h["iteration"] for h in history] != list(
                range(1, iters + 1)) or alive:
            raise AssertionError(f"refresh run ended at {final}, history "
                                 f"{history}, threads left {alive}")
        for h in history:
            if not all(np.isfinite(h[k]) for k in METRICS):
                raise AssertionError(f"non-finite metrics: {h}")
        if refresher.refresh_count < 1 or refresher.error is not None \
                or len(swaps) != refresher.refresh_count or not first:
            raise AssertionError(f"refresh_count "
                                 f"{refresher.refresh_count}, swaps {swaps}, "
                                 f"error {refresher.error!r}")

        # iterations whose window overlaps a completed embed pass by half
        starts = [t_start] + ends[:-1]
        busy = []
        for s, e in zip(starts, ends):
            overlap = sum(max(0.0, min(e, pe) - max(s, ps))
                          for ps, pe in passes)
            busy.append(overlap >= 0.5 * (e - s))
        with_embed = [h["ms_per_iter"] for h, b in zip(history, busy) if b]
        without = [h["ms_per_iter"] for h, b in zip(history, busy)
                   if not b]

        plain_log = engine.TrainLog(1, log)
        engine.train(task, ds, loop_cfg(iters + plain_iters), printer=log,
                     log=plain_log)
        _sync(dev)

        # the first swapped index against the tower at the hand-off
        tower = copy.deepcopy(context_tower(model)).requires_grad_(False)
        tower.load_state_dict(start_weights)
        ids, types = builder._format_rows(check_rows + 1)
        with torch.inference_mode():
            want = tower.embed(torch.as_tensor(ids).long().to(dev),
                               torch.as_tensor(types).long().to(dev)).float()
        err = (first["rows"] - want).abs()
        # one int8 step of the row's group, plus the bf16 forward tolerance
        limit = first["scales"][:, None] + FWD_TOL[0] * want.abs().max()
        steps_err = (err / first["scales"][:, None]).max().item()
        if not bool((err <= limit).all()):
            raise AssertionError(f"swapped rows differ from the hand-off "
                                 f"tower's embedding by {err.max().item()}")
        del tower, want, task, model
    _empty_cache(dev)
    pass_s = [pe - ps for ps, pe in passes]
    return dict(history=history, plain_history=plain_log.history,
                with_embed=with_embed, without=without, swaps=swaps,
                refresh_count=refresher.refresh_count, pass_s=pass_s,
                per_s=[n_docs / s for s in pass_s], launches=launches,
                peak_bytes=peak, train_s=train_s, first_swap=first["step"],
                check_err=err.max().item(), check_steps=steps_err)


class _Tee:
    """A stdout that also keeps what was written."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s):
        self.parts.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def cli_phase(cfg, dev, n_docs=16_384, batch=8, iters=4, n_valid=8,
              model_args=()):
    """The command line on one corpus: the offline index
    (``tools.create_doc_index.main``), then ``tasks.run.main`` with the
    flagship flags, the async indexer at interval 2, an int8 index, an
    interval checkpoint at 2 and a valid set of ``n_valid``; then
    ``QAPipeline.load`` from that save, with the run's configuration,
    answers ``n_valid`` questions. ``model_args`` (none: the published
    widths) go to both tools; ``cfg`` sizes the vocabulary."""
    import contextlib

    from emdr2_tpu_torch.serving import QAPipeline
    from emdr2_tpu_torch.tasks import run as run_cli
    from emdr2_tpu_torch.tools import create_doc_index
    from emdr2_tpu_torch.training import checkpointing as ckpt

    with tempfile.TemporaryDirectory() as tmpdir:
        t0 = time.perf_counter()
        make_corpus(cfg, tmpdir, n_docs)
        vocab = os.path.join(tmpdir, "vocab.txt")
        prefix = os.path.join(tmpdir, "wiki")
        emb = os.path.join(tmpdir, "emb")
        save = os.path.join(tmpdir, "run")
        files = {}
        for name, n, offset in (("train", batch * iters, 0),
                                ("valid", n_valid, 10_000)):
            files[name] = os.path.join(tmpdir, f"{name}.tsv")
            with open(files[name], "w") as f:
                for i in range(offset, offset + n):
                    f.write(f"what is the color of item w{7 * i}\t"
                            f"['w{3 * i} w{i}', 'w{5 * i}']\n")
        log(f"cli set-up {time.perf_counter() - t0:.1f} s: {n_docs} "
            f"passages")
        tee = _Tee(sys.stdout)
        seconds = {}
        _reset_counts()
        with contextlib.redirect_stdout(tee):
            t0 = time.perf_counter()
            rc_index = create_doc_index.main([
                "--evidence-data-path", prefix, "--vocab-file", vocab,
                "--embedding-path", emb, "--batch-size", "128",
                "--fid-flash-attention", "--device", dev.type,
                *model_args])
            _sync(dev)
            seconds["create_doc_index"] = time.perf_counter() - t0
            index_launches = _read_counts(("flash_self_attention",))
            _reset_counts()
            t0 = time.perf_counter()
            argv = [
                "--task", "OPENQA", "--vocab-file", vocab,
                "--train-data", files["train"],
                "--valid-data", files["valid"],
                "--evidence-data-path", prefix, "--embedding-path", emb,
                "--save", save, "--fid-flash-attention", "--remat",
                "--no-remat-towers", "--async-indexer",
                "--index-reload-interval", "2", "--index-quantize", "int8",
                "--train-iters", str(iters), "--save-interval", "2",
                "--batch-size", str(batch), "--log-interval", "1",
                "--device", dev.type, *model_args]
            rc_run = run_cli.main(argv)
            _sync(dev)
            seconds["run"] = time.perf_counter() - t0
        launches = _read_counts(tuple(_counters()))
        out = "".join(tee.parts)
        if rc_index != 0 or rc_run != 0 or "valid EM" not in out \
                or ckpt.latest_iteration(save) != iters \
                or f"wrote {n_docs} embeddings" not in out:
            raise AssertionError(f"cli: create_doc_index rc {rc_index}, "
                                 f"run rc {rc_run}, latest iteration "
                                 f"{ckpt.latest_iteration(save)}")
        _empty_cache(dev)
        t0 = time.perf_counter()
        run_cfg = run_cli.make_config(run_cli.build_parser().parse_args(argv))
        pipe = QAPipeline.load(save, vocab, prefix, emb, cfg=run_cfg,
                               device=dev, batch_size=batch, kv_quant="int8")
        seconds["load"] = time.perf_counter() - t0
        questions = [f"what is the color of item w{7 * i}"
                     for i in range(n_valid)]
        t0 = time.perf_counter()
        answers = pipe.ask(questions)
        seconds["ask"] = time.perf_counter() - t0
        if len(answers) != n_valid or not all(isinstance(a, str)
                                              for a in answers):
            raise AssertionError(f"cli: QAPipeline.load answers {answers!r}")
        del pipe
    _empty_cache(dev)
    valid = [line.strip() for line in out.splitlines() if "valid EM" in line]
    return dict(seconds=seconds, launches=launches,
                index_launches=index_launches, valid=valid, answers=answers)


def _words(cfg):
    """The synthetic vocabulary's filler words (``make_corpus``)."""
    from emdr2_tpu_torch.data.tokenizer import toy_vocab
    base = len(toy_vocab(["what", "is", "the", "color", "of", "item"]))
    return cfg.retriever.encoder.vocab_size - 70 - base


def make_dpr_json(path, n, n_words, rng, offset=0, easy=0, hard=1):
    """``n`` DPR-format examples about item w<7i>: a positive of 90-140
    filler words (a context of about Lc = 256 tokens once formatted), and
    ``hard`` hard and ``easy`` easy negatives likewise."""
    def ctx(i):
        words = " ".join(f"w{j}" for j in rng.randint(
            0, n_words, size=rng.randint(90, 140)))
        return {"title": f"w{i % n_words}", "text": words}

    rows = [{"question": f"what is the color of item w{7 * i}",
             "answers": [f"w{3 * i}"], "positive_ctxs": [ctx(i)],
             "hard_negative_ctxs": [ctx(i + 1) for _ in range(hard)],
             "negative_ctxs": [ctx(i + 2) for _ in range(easy)]}
            for i in range(offset, offset + n)]
    with open(path, "w") as f:
        json.dump(rows, f)
    return path


# the three per-layer checkpoint layouts of a stack
REMAT_LAYOUTS = (("no remat", {"remat": False}),
                 ("nothing", {"remat": True, "remat_policy": "nothing"}),
                 ("dots_no_batch", {"remat": True,
                                    "remat_policy": "dots_no_batch"}))


def dpr_phase(cfg, dev, batch=128, hard_negs=1, steps=3, valid_batches=2,
              valid_batch=16, profile=False):
    """``DPRTask.train_step`` at BERT-base x 2 (``cfg.retriever``), global
    batch ``batch`` with ``hard_negs`` hard negatives (2 x batch contexts),
    Lq 64, Lc 256, dropout 0.1, AdamW 2e-5 / wd 0.1 / clip 1.0, score
    scaling: one warm-up step and ``steps`` timed ones under each layout of
    REMAT_LAYOUTS (ms per step, peak memory, K1 launches during the timed
    steps); then ``validate`` on ``valid_batches`` batches of
    ``valid_batch`` in the 30+30 layout (976 context rows a batch).
    ``profile`` adds one more step of each layout under torch.profiler
    (device time against wall time)."""
    import dataclasses

    from emdr2_tpu_torch.config import OptimizerConfig
    from emdr2_tpu_torch.tasks.dense_retriever import DPRDataset, DPRTask

    res = {"layouts": {}}
    with tempfile.TemporaryDirectory() as tmpdir:
        t0 = time.perf_counter()
        tok, _ = make_corpus(cfg, tmpdir, n_docs=16)
        rng = np.random.RandomState(SEED)
        n_words = _words(cfg)
        train = make_dpr_json(os.path.join(tmpdir, "train.json"),
                              batch * (steps + 1), n_words, rng,
                              hard=hard_negs)
        valid = make_dpr_json(os.path.join(tmpdir, "valid.json"),
                              valid_batch * valid_batches, n_words, rng,
                              offset=10_000, easy=30, hard=30)
        rc = cfg.retriever
        ds = DPRDataset(train, tok, rc.query_seq_len, rc.seq_len,
                        hard_negs=hard_negs, seed=SEED)
        batches = list(ds.epoch_batches(batch, seed=SEED))
        vds = DPRDataset(valid, tok, rc.query_seq_len, rc.seq_len,
                         evaluate=True)
        vbatches = list(vds.epoch_batches(valid_batch, seed=0,
                                          shuffle=False))
        log(f"dpr set-up {time.perf_counter() - t0:.1f} s: {len(batches)} "
            f"batches of {batch} questions x {1 + hard_negs} contexts "
            f"(Lq {rc.query_seq_len}, Lc {rc.seq_len}), {len(vbatches)} "
            f"validation batches of {vbatches[0].ctx_ids.shape[0]} context "
            f"rows")
    opt = OptimizerConfig(lr=2e-5, weight_decay=0.1, clip_grad=1.0)
    for name, fields in REMAT_LAYOUTS:
        lcfg = dataclasses.replace(rc, encoder=dataclasses.replace(
            rc.encoder, **fields))
        task = DPRTask(lcfg, opt, total_train_iters=1000, score_scaling=True,
                       device=dev)
        state = task.init_state(SEED)
        probe = state.model.retriever.context_model.encoder.layer(
            0).mlp.wi.kernel
        float(task.train_step(batches[0])["loss"])         # warm-up
        _reset_peak(dev)
        _reset_counts()
        runs = []
        for b in batches[1:steps + 1]:
            lr = state.optimizer.schedule(state.optimizer.count)
            before = probe.detach().clone()
            t0 = time.perf_counter()
            m = task.train_step(b)
            row = {k: float(v) for k, v in m.items()}      # syncs the card
            row.update(ms=(time.perf_counter() - t0) * 1e3, lr=lr,
                       moved=not torch.equal(before, probe.detach()))
            runs.append(row)
        launches = _read_counts(("flash_self_attention",
                                 "flash_self_attention_backward"))
        peak = _peak(dev)
        for i, row in enumerate(runs):
            if not (np.isfinite(row["loss"]) and row["grad_norm"] > 0
                    and (row["lr"] == 0 or row["moved"])):
                raise AssertionError(f"dpr {name} step {i}: {row}")
        if not any(r["lr"] > 0 for r in runs):
            raise AssertionError("dpr: no step with a non-zero lr")
        for k, n in launches.items():
            if n <= 0 and dev.type == "cuda":
                raise AssertionError(f"dpr {name}: {k} never launched")
        res["layouts"][name] = dict(steps=runs, peak_bytes=peak,
                                    launches=launches)
        if profile:
            log_profile(f"warm DPR step, {name}", profile_call(
                lambda: float(task.train_step(batches[1])["loss"]),
                f"dpr_step_profile_{name.replace(' ', '_')}.txt"))
        log(f"dpr {name}: ms per step " + ", ".join(
            f"{r['ms']:.1f}" for r in runs) + f"; peak memory "
            f"{peak / 2**30:.2f} GiB; launches during {len(runs)} steps "
            f"{launches}; loss " + ", ".join(f"{r['loss']:.4f}" for r in runs)
            + "; correct " + ", ".join(
                f"{r['correct_prediction_count']:.0f}/{batch}" for r in runs)
            + "; grad_norm " + ", ".join(f"{r['grad_norm']:.4f}"
                                        for r in runs))
        if name == REMAT_LAYOUTS[-1][0]:
            _sync(dev)
            t0 = time.perf_counter()
            v = task.validate(vbatches)
            _sync(dev)
            res["validate"] = dict(metrics=v,
                                   seconds=time.perf_counter() - t0)
            if not all(np.isfinite(x) for x in v.values()):
                raise AssertionError(f"dpr validate: {v}")
            log(f"dpr validate: {len(vbatches)} batches of {valid_batch} x "
                f"{vbatches[0].ctx_ids.shape[0]} context rows in "
                f"{res['validate']['seconds']:.3f} s: " + ", ".join(
                    f"{k} {x:.4f}" for k, x in v.items()))
        del task, state, probe
        _empty_cache(dev)
    return res


def retrieval_eval_phase(cfg, dev, gen, n_docs=16_384, n_rows=N_INDEX,
                         n_questions=3610, k=100):
    """The retrieval evaluation at NQ-test's size: ``EvidenceIndexBuilder``
    embeds ``n_docs`` synthetic passages with a DPR context tower (seeded
    weights), the index is padded with random rows to ``n_rows`` (bf16,
    then int8), and ``OpenRetrievalEvaluator.evaluate_recall`` scores
    ``n_questions`` synthetic questions at ``k``: one search of all of them
    (the tensor-core K3). Prints the search's ms and the evaluation's
    seconds; the retrieved rows must equal an exact search on the card
    (the collision rule; boundary ties counted apart) and the recall dict
    the one computed from the exact rows."""
    import dataclasses
    import functools

    from emdr2_tpu_torch.data.qa_dataset import QAExample
    from emdr2_tpu_torch.models.bert import DualEncoder
    from emdr2_tpu_torch.ops import mips
    from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex
    from emdr2_tpu_torch.retrieval.builder import EvidenceIndexBuilder
    from emdr2_tpu_torch.retrieval.evaluate import OpenRetrievalEvaluator
    from emdr2_tpu_torch.retrieval.qa_validation import (SimpleTokenizer,
                                                         has_answer)
    from emdr2_tpu_torch.tasks.dense_retriever import DPRModel

    res = {}
    with tempfile.TemporaryDirectory() as tmpdir:
        t0 = time.perf_counter()
        tok, corpus = make_corpus(cfg, tmpdir, n_docs)
        model = DPRModel(cfg.retriever, dev, gen).eval()
        builder = EvidenceIndexBuilder(cfg, model, corpus, tok.cls_id,
                                       tok.sep_id, tok.pad_id,
                                       batch_size=128)
        _reset_counts()
        t1 = time.perf_counter()
        rows = builder.embed_corpus()
        _sync(dev)
        res["embed_s"] = time.perf_counter() - t1
        res["embed_launches"] = _read_counts(("flash_self_attention",))
        emb = torch.cat([torch.from_numpy(rows).to(dev).float(),
                         torch.randn(n_rows - n_docs, cfg.index.embed_dim,
                                     device=dev, generator=gen)])
        pids = 1 + np.arange(n_rows) % n_docs
        n_words = _words(cfg)
        examples = [QAExample(i, f"what is the color of item w{7 * i}",
                              [f"w{(3 * i) % n_words} w{i % n_words}",
                               f"w{(5 * i) % n_words}"])
                    for i in range(n_questions)]

        @functools.lru_cache(maxsize=None)
        def doc_text(pid):
            return tok.detokenize(corpus.doc_tokens(int(pid)))

        log(f"retrieval eval set-up {time.perf_counter() - t0:.1f} s: "
            f"{n_docs} passages embedded in {res['embed_s']:.3f} s "
            f"(K1-fwd launches {res['embed_launches']}), index padded with "
            f"random rows to {n_rows}, {n_questions} questions, k={k}")
        for name in ("bf16", "int8"):
            icfg = dataclasses.replace(
                cfg.index, topk=k, dtype=torch.bfloat16,
                quantize="int8" if name == "int8" else "none")
            index = ShardedEvidenceIndex(icfg, emb, passage_ids=pids,
                                         device=dev)
            ev = OpenRetrievalEvaluator(
                model.retriever, index, tok, cfg.retriever.query_seq_len,
                embed_method=DualEncoder.embed_query)
            dump = os.path.join(tmpdir, f"dump_{name}.json")
            _reset_counts()
            _sync(dev)
            t0 = time.perf_counter()
            recall = ev.evaluate_recall(examples, k=k, doc_text_fn=doc_text,
                                        dump_path=dump)
            total_s = time.perf_counter() - t0
            launches = _read_counts(("flash_self_attention",
                                     "candidate_scan"))
            launches["candidate_scan_tensor_core"] = \
                mips.candidate_scan.tensor_core_launches
            if dev.type == "cuda" and (
                    launches["candidate_scan_tensor_core"] <= 0
                    or launches["flash_self_attention"] <= 0):
                raise AssertionError(f"retrieval eval {name}: launches "
                                     f"{launches}")
            q = ev.encode_queries([e.question for e in examples])
            search_ms = (time_ms(lambda: index.search(q, k), reps=3,
                                 warmup=1) if dev.type == "cuda"
                         else float("nan"))
            _, got = index.search(q, k)
            stored = (mips.dequantize_int8(index.embeddings, index.scales,
                                           icfg.group_size)
                      if name == "int8" else index.embeddings.float())
            oracle_vals, oracle = _exact_top(
                q, stored, n_rows, k,
                None if name == "int8" else torch.bfloat16)
            del stored
            hit, _ = recall_at(got, oracle[:, :k])
            ex = explain_misses(got, oracle, oracle_vals, k, ties=True)
            # the recall of the exact rows, from the evaluation's own hits
            # where the passage lists agree
            with open(dump) as f:
                hits = [d["hits"] for d in json.load(f)]
            exact_pids = index.lookup_passage_ids(
                oracle[:, :k].cpu().numpy())
            got_pids = index.lookup_passage_ids(got.cpu().numpy())
            tk = SimpleTokenizer()
            top = [0] * k
            differ = 0
            for i, e in enumerate(examples):
                h = hits[i]
                if not np.array_equal(exact_pids[i], got_pids[i]):
                    differ += 1
                    h = [has_answer(e.answers, doc_text(p), tk)
                         for p in exact_pids[i]]
                first = next((j for j, x in enumerate(h) if x), None)
                if first is not None:
                    for j in range(first, k):
                        top[j] += 1
            exact_recall = {key: top[int(key.split("@")[1]) - 1]
                            / n_questions for key in recall}
            res[name] = dict(recall=recall, exact_recall=exact_recall,
                             seconds=total_s, search_ms=search_ms,
                             launches=launches, id_recall=hit,
                             misses=ex["misses"], ties=ex["ties"],
                             tie_eps=ex["tie_eps"], lists_differ=differ)
            log(f"retrieval eval {name}: evaluate_recall over {n_questions} "
                f"questions at k={k} in {total_s:.3f} s; one search of all "
                f"of them {search_ms:.4f} ms; launches {launches}; recall "
                f"{recall}; against an exact search on the card: row recall "
                f"{hit:.6f}, {misses_text(ex, k)}; {differ} questions with "
                f"another passage list; recall of the exact rows "
                f"{exact_recall}")
            if ex["unexplained"] or exact_recall != recall:
                raise AssertionError(f"retrieval eval {name}: "
                                     f"{misses_text(ex, k)}; recall {recall} "
                                     f"against {exact_recall}")
            if name == "bf16":
                # the widest boundary tie with the random rows past the
                # passages drawn from more seeds (the same questions)
                ties = [ex["tie_eps"]]
                pad0 = emb[n_docs:].clone()
                for seed in K3_TIE_SEEDS:
                    del index
                    g = torch.Generator(device=dev)
                    g.manual_seed(seed)
                    emb[n_docs:] = torch.randn(n_rows - n_docs,
                                               cfg.index.embed_dim,
                                               device=dev, generator=g)
                    index = ShardedEvidenceIndex(icfg, emb, passage_ids=pids,
                                                 device=dev)
                    _, got = index.search(q, k)
                    oracle_vals, oracle = _exact_top(
                        q, index.embeddings.float(), n_rows, k,
                        torch.bfloat16)
                    sx = explain_misses(got, oracle, oracle_vals, k,
                                        ties=True)
                    log(f"retrieval eval bf16, rows past the passages from "
                        f"seed {seed}: {misses_text(sx, k)}")
                    if sx["unexplained"]:
                        raise AssertionError(f"retrieval eval bf16 seed "
                                             f"{seed}: {misses_text(sx, k)}")
                    ties.append(sx["tie_eps"])
                emb[n_docs:] = pad0
                del pad0
                res[name]["tie_eps_seeds"] = max(ties)
                log(f"retrieval eval bf16: the widest boundary tie over "
                    f"{1 + len(K3_TIE_SEEDS)} seeds {max(ties):.3f} fp32 "
                    f"eps of |k-th score| (TIE_EPS {TIE_EPS})")
            del index, ev, q, got, oracle, oracle_vals
            _empty_cache(dev)
        del emb, model, builder
    _empty_cache(dev)
    return res


def retriever_cli_phase(cfg, dev, n_docs=16_384, batch=16, iters=4,
                        n_dev=64, model_args=()):
    """The RETRIEVER command line on one corpus: ``tasks.run.main`` with
    ``--task RETRIEVER`` for ``iters`` iterations at ``batch``, an interval
    save at 2, validation in the 30+30 layout and the post-train recall on
    ``n_dev`` questions; ``tools.checkpoint_surgery extract --submodel
    retriever`` of the save, loaded by ``load_retriever_params`` into an
    OPENQA model; ``tools.evaluate_retrieval`` on the store the run built,
    whose recall must equal the run's."""
    import contextlib

    from emdr2_tpu_torch.data.tokenizer import build_tokenizers
    from emdr2_tpu_torch.models import EMDR2Model
    from emdr2_tpu_torch.tasks import run as run_cli
    from emdr2_tpu_torch.tasks.openqa_main import padded_vocab_cfg
    from emdr2_tpu_torch.tools import checkpoint_surgery, evaluate_retrieval
    from emdr2_tpu_torch.training import checkpointing as ckpt

    seconds = {}
    with tempfile.TemporaryDirectory() as tmpdir:
        t0 = time.perf_counter()
        make_corpus(cfg, tmpdir, n_docs)
        vocab = os.path.join(tmpdir, "vocab.txt")
        prefix = os.path.join(tmpdir, "wiki")
        emb = os.path.join(tmpdir, "emb")
        save = os.path.join(tmpdir, "dpr")
        rng = np.random.RandomState(SEED)
        n_words = _words(cfg)
        train = make_dpr_json(os.path.join(tmpdir, "train.json"),
                              batch * iters, n_words, rng)
        valid = make_dpr_json(os.path.join(tmpdir, "valid.json"), batch,
                              n_words, rng, offset=10_000, easy=30, hard=30)
        dev_csv = os.path.join(tmpdir, "dev.csv")
        with open(dev_csv, "w") as f:
            for i in range(n_dev):
                f.write(f"what is the color of item w{7 * i}\t"
                        f"['w{3 * i} w{i}', 'w{5 * i}']\n")
        log(f"retriever cli set-up {time.perf_counter() - t0:.1f} s")
        tee = _Tee(sys.stdout)
        _reset_counts()
        with contextlib.redirect_stdout(tee):
            t0 = time.perf_counter()
            rc = run_cli.main([
                "--task", "RETRIEVER", "--vocab-file", vocab,
                "--train-data", train, "--valid-data", valid,
                "--evidence-data-path", prefix, "--embedding-path", emb,
                "--qa-file-dev", dev_csv, "--save", save,
                "--fid-flash-attention", "--train-iters", str(iters),
                "--epochs", "1", "--save-interval", "2",
                "--batch-size", str(batch), "--log-interval", "1",
                "--device", dev.type, *model_args])
            _sync(dev)
            seconds["run"] = time.perf_counter() - t0
            launches = _read_counts(("flash_self_attention",
                                     "flash_self_attention_backward",
                                     "candidate_scan"))
            out = "".join(tee.parts)
            t0 = time.perf_counter()
            extracted = os.path.join(tmpdir, "extracted")
            rc_ext = checkpoint_surgery.main([
                "extract", "--load", save, "--submodel", "retriever",
                "--save", extracted])
            seconds["extract"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            tee.parts.clear()
            rc_eval = evaluate_retrieval.main([
                "--qa-data", dev_csv, "--evidence-data-path", prefix,
                "--embedding-path", emb, "--vocab-file", vocab,
                "--load", extracted, "--fid-flash-attention",
                "--device", dev.type, *model_args])
            _sync(dev)
            seconds["evaluate_retrieval"] = time.perf_counter() - t0
            eval_out = "".join(tee.parts)
        dev_line = [line for line in out.splitlines()
                    if "DEV retrieval" in line]
        eval_line = [line for line in eval_out.splitlines()
                     if line.startswith(dev_csv)]
        if rc != 0 or rc_ext != 0 or rc_eval != 0 \
                or ckpt.latest_iteration(save) != iters \
                or len(dev_line) != 1 or len(eval_line) != 1 \
                or " epoch 0 |" not in out:
            raise AssertionError(f"retriever cli: rc {rc} / {rc_ext} / "
                                 f"{rc_eval}, latest "
                                 f"{ckpt.latest_iteration(save)}, lines "
                                 f"{dev_line} {eval_line}")
        run_recall = {kv.split()[0]: float(kv.split()[1])
                      for kv in dev_line[0].split("|")[1:]}
        tool_recall = {kv.split("=")[0]: float(kv.split("=")[1])
                       for kv in eval_line[0].split()[2:]}
        if run_recall != tool_recall:
            raise AssertionError(f"retriever cli: the run's DEV recall "
                                 f"{run_recall} against evaluate_retrieval's "
                                 f"{tool_recall}")
        for name in ("flash_self_attention",
                     "flash_self_attention_backward", "candidate_scan"):
            if launches[name] <= 0 and dev.type == "cuda":
                raise AssertionError(f"retriever cli: {name} never "
                                     f"launched")
        # the DPR save's retriever into an OPENQA model of the run's flags
        t0 = time.perf_counter()
        bert_tok, t5_tok = build_tokenizers(vocab)
        run_cfg = padded_vocab_cfg(run_cli.make_config(
            run_cli.build_parser().parse_args(
                ["--task", "OPENQA", "--vocab-file", vocab,
                 "--fid-flash-attention", *model_args])), bert_tok, t5_tok)
        model = EMDR2Model(run_cfg, device=dev)
        ckpt.load_retriever_params(extracted, model.retriever)
        seconds["load_into_openqa"] = time.perf_counter() - t0
        saved, _ = ckpt.read_payload(save)
        for key, v in model.retriever.state_dict().items():
            if not torch.equal(v.cpu(), saved["model"]["retriever." + key]):
                raise AssertionError(f"retriever cli: {key} differs after "
                                     f"the extract")
        del model, saved
    _empty_cache(dev)
    log(f"retriever cli: seconds {seconds}; launches {launches}; "
        f"{[line.strip() for line in out.splitlines() if 'epoch' in line]}"
        f"; {dev_line[0].strip()}; evaluate_retrieval: "
        f"{eval_line[0].strip()}")
    return dict(seconds=seconds, launches=launches, recall=run_recall)


# classes of device kernels in a profile, by the first substring of the
# kernel's name that matches (in this order)
# ---------------------------------------------------------------------------
# C5: one step repeats bit for bit; data parallelism (torch.distributed)
# ---------------------------------------------------------------------------

def _dpr_batches(cfg, tmpdir, batch, n_batches, rank=0, world=1,
                 seed=SEED):
    """Global DPR batches of ``batch`` questions with one hard negative
    each (so no negative is drawn at random), this rank's slice of each."""
    from emdr2_tpu_torch.tasks.dense_retriever import DPRDataset
    tmpdir = tempfile.mkdtemp(dir=tmpdir)       # beside another corpus
    tok, _ = make_corpus(cfg, tmpdir, n_docs=16)
    rng = np.random.RandomState(seed)
    path = make_dpr_json(os.path.join(tmpdir, "dpr.json"),
                         batch * n_batches, _words(cfg), rng, hard=1)
    rc = cfg.retriever
    ds = DPRDataset(path, tok, rc.query_seq_len, rc.seq_len, hard_negs=1,
                    seed=seed)
    return list(ds.epoch_batches(batch, seed=seed, rank=rank,
                                 world_size=world))


def _qa_dataset(cfg, tok, tmpdir, n):
    """``n`` questions with one reference each (no answer is drawn at
    random, so a rank's slice samples what one process samples)."""
    from emdr2_tpu_torch.data.qa_dataset import OpenQADataset
    path = os.path.join(tmpdir, f"qa_{n}.tsv")
    with open(path, "w") as f:
        for i in range(n):
            f.write(f"what is the color of item w{7 * i}\t['w{3 * i}']\n")
    return OpenQADataset([path], tok, cfg.retriever.query_seq_len,
                         cfg.reader.decoder_seq_len, seed=SEED)


def _diff_text(result):
    if result["first_difference"] is None:
        return "bit-equal"
    i, a, b = result["first_difference"]
    return (f"{result['differing']} of {result['entries']} entries differ; "
            f"the first at {i}: {a} against {b}")


def _lookup_backward_check(cfg, dev, reps=5):
    """The embedding lookups of a step (a tower's tokentype and word
    tables under 65,536 lookups, the reader's shared table under 204,800)
    by ``F.embedding`` and by ``layers.embedding``: does each weight
    gradient repeat over ``reps`` runs, and what does its backward cost
    (ms, CUDA events)."""
    import torch.nn.functional as F

    from emdr2_tpu_torch.models.layers import embedding
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 5)
    h = cfg.retriever.encoder.hidden_size
    out = {}
    for name, rows, n in (
            ("tokentype", 2, 65_536),
            ("word", cfg.retriever.encoder.vocab_size, 65_536),
            ("reader", cfg.reader.transformer.vocab_size, 204_800)):
        u = torch.rand(n, device=dev, generator=g)
        ids = (u ** 4 * rows).long().clamp_(max=rows - 1)   # skewed ids
        dout = torch.randn(n, h, device=dev, generator=g)
        for how, fn in (("F.embedding", F.embedding),
                        ("layers.embedding", embedding)):
            w = torch.zeros(rows, h, device=dev, requires_grad=True)

            def run():
                w.grad = None
                fn(ids, w).backward(dout)
                return w.grad

            grads = [run().clone() for _ in range(reps)]
            repeats = all(torch.equal(grads[0], x) for x in grads)
            out[f"{name} {how}"] = dict(
                repeats=repeats,
                ms=time_ms(run) if dev.type == "cuda" else float("nan"))
    log("c5 lookup backward (rows x lookups: tokentype 2 x 65,536, word "
        f"{cfg.retriever.encoder.vocab_size} x 65,536, reader "
        f"{cfg.reader.transformer.vocab_size} x 204,800; {reps} runs): "
        + "; ".join(f"{k} repeats={v['repeats']} {v['ms']:.4f} ms"
                    for k, v in out.items()))
    for key, v in out.items():
        if "layers" in key and not v["repeats"]:
            raise AssertionError(f"c5: {key} does not repeat")
    return out


def c5_phase(cfg, tcfg, dev, gen, dpr_batch=128, qa_batch=8,
             n_rows=N_INDEX, n_docs=20_000):
    """A DPR step (global batch ``dpr_batch``, dropout 0.1) and an OPENQA
    step (``qa_batch``, ``tcfg``: --remat --no-remat-towers) each run twice
    from one saved state (``utils.repeat.repeat_step``: every module
    output, incoming gradient, parameter gradient, metric and updated
    parameter fingerprinted bit for bit). Fails with the first differing
    module."""
    from emdr2_tpu_torch.config import OptimizerConfig
    from emdr2_tpu_torch.tasks import E2EQATask
    from emdr2_tpu_torch.tasks.dense_retriever import DPRTask
    from emdr2_tpu_torch.utils.repeat import repeat_step

    res = {"lookup": _lookup_backward_check(cfg, dev)}
    _reset_counts()
    with tempfile.TemporaryDirectory() as tmpdir:
        batches = _dpr_batches(cfg, tmpdir, dpr_batch, 2)
    task = DPRTask(cfg.retriever, OptimizerConfig(lr=2e-5), 1000,
                   device=dev)
    task.init_state(SEED)
    task.train_step(batches[0])
    t0 = time.perf_counter()
    r = repeat_step(task, batches[1])
    res["dpr"] = dict(equal=r["equal"], entries=r["entries"],
                      text=_diff_text(r),
                      loss=[float(m["loss"]) for m in r["metrics"]],
                      seconds=time.perf_counter() - t0)
    log(f"c5 DPR step at {dpr_batch}, twice from one state: "
        f"{res['dpr']['text']} over {r['entries']} fingerprints; loss "
        f"{res['dpr']['loss'][0]:.8f} / {res['dpr']['loss'][1]:.8f}")
    del task, batches, r
    _empty_cache(dev)
    with tempfile.TemporaryDirectory() as tmpdir:
        tok, corpus, index = make_world(tcfg, tmpdir, dev, gen, n_docs,
                                        n_rows)
        ds = _qa_dataset(tcfg, tok, tmpdir, 2 * qa_batch)
        task = E2EQATask(tcfg, tok, corpus, index, total_train_iters=1000,
                         device=dev)
        task.init_state(SEED)
        qbatches = list(ds.epoch_batches(qa_batch, seed=SEED))
        task.train_step(qbatches[0])
        t0 = time.perf_counter()
        r = repeat_step(task, qbatches[1])
        res["openqa"] = dict(equal=r["equal"], entries=r["entries"],
                             text=_diff_text(r),
                             loss=[float(m["loss"]) for m in r["metrics"]],
                             seconds=time.perf_counter() - t0)
        del task, index
    res["launches"] = _read_counts(tuple(_counters()))
    log(f"c5 OPENQA step at B={qa_batch}, twice from one state: "
        f"{res['openqa']['text']} over {res['openqa']['entries']} "
        f"fingerprints; loss {res['openqa']['loss'][0]:.8f} / "
        f"{res['openqa']['loss'][1]:.8f}; launches {res['launches']}")
    _empty_cache(dev)
    for name in ("dpr", "openqa"):
        if not res[name]["equal"]:
            raise AssertionError(f"c5: the {name} step does not repeat: "
                                 f"{res[name]['text']}")
    return res


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dp_rows(cfg, dev, n_rows, seed):
    """The dp phase's index rows: [n_rows, d] fp32 from ``seed``."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randn(n_rows, cfg.index.embed_dim, device=dev, generator=g)


def _dp_cfgs(cfg, rate):
    """(OPENQA under --remat --remat-policy nothing, DPR retriever) at
    dropout ``rate``."""
    from emdr2_tpu_torch.config import with_transformers
    fields = {"hidden_dropout": rate, "attention_dropout": rate,
              "remat": True, "remat_policy": "nothing"}
    qcfg = with_transformers(cfg, fields, fields)
    rc = cfg.retriever
    rcfg = dataclasses.replace(rc, encoder=dataclasses.replace(
        rc.encoder, hidden_dropout=rate, attention_dropout=rate))
    return qcfg, rcfg


def _fingerprint_params(model) -> str:
    from emdr2_tpu_torch.utils.repeat import fingerprint
    return repr([fingerprint(p) for p in model.parameters()])


def _same_or_tie(ids, vals, want_ids, want_vals, k):
    """Rows of each query equal as sets, or traded only at a boundary tie
    (scores within TIE_EPS fp32 eps of |k-th score|); -> (equal share,
    ties, unexplained)."""
    eps = TIE_EPS * float(np.finfo(np.float32).eps)
    equal = ties = bad = 0
    for i in range(ids.shape[0]):
        a, b = set(ids[i].tolist()), set(want_ids[i].tolist())
        if a == b:
            equal += 1
            continue
        kth = abs(float(want_vals[i, k - 1]))
        lo = float(want_vals[i, k - 1]) - eps * max(kth, 1.0)
        va = dict(zip(ids[i].tolist(), vals[i].tolist()))
        vb = dict(zip(want_ids[i].tolist(), want_vals[i].tolist()))
        if all(va[x] >= lo for x in a - b) and all(vb[x] >= lo
                                                   for x in b - a):
            ties += 1
        else:
            bad += 1
    return equal / ids.shape[0], ties, bad


def dp_one_rank_phase(cfg, dev, dpr_batch=128, n_rows=N_INDEX,
                      backend="nccl"):
    """(a) One rank over ``backend`` (NCCL on the card), world size 1,
    rendezvous over TCP on localhost: the DPR step through the
    distributed path (the gathered loss, the bucketed gradient all-reduce)
    against the plain step from the same state, and the sharded search
    (int8, nq 8 and 512) against the plain search: bit for bit."""
    from emdr2_tpu_torch.config import OptimizerConfig
    from emdr2_tpu_torch.parallel import DataParallel
    from emdr2_tpu_torch.parallel import distributed as dist_lib
    from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex
    from emdr2_tpu_torch.tasks.dense_retriever import DPRTask
    from emdr2_tpu_torch.utils.repeat import first_difference, recorded_step

    dist_lib.init_process_group(f"127.0.0.1:{_free_port()}", 1, 0, backend,
                                timeout_s=120,
                                device=dev if backend == "nccl" else None)
    res = {}
    try:
        dp = DataParallel.from_process_group()
        with tempfile.TemporaryDirectory() as tmpdir:
            batches = _dpr_batches(cfg, tmpdir, dpr_batch, 1)
        opt = OptimizerConfig(lr=2e-5)
        entries = []
        for group in (None, dp):
            task = DPRTask(cfg.retriever, opt, 1000, device=dev, dp=group)
            task.init_state(SEED)
            if group is not None:
                # the counts of the distributed path alone
                _reset_counts()
            _, e = recorded_step(task, batches[0])
            if group is not None:
                launches = _read_counts(tuple(_counters()))
            entries.append(e)
            del task
        diff = first_difference(*entries)
        res["dpr"] = dict(equal=diff is None, entries=len(entries[0]),
                          diff=None if diff is None else repr(diff)[:600])
        _empty_cache(dev)
        icfg = dataclasses.replace(cfg.index, quantize="int8")
        rows = _dp_rows(cfg, dev, n_rows, SEED + 17)
        plain = ShardedEvidenceIndex(icfg, rows, device=dev)
        sharded = ShardedEvidenceIndex(icfg, rows, device=dev, dp=dp)
        del rows
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + 18)
        search = {}
        for nq in (8, 512):
            q = torch.randn(nq, cfg.index.embed_dim, device=dev, generator=g)
            want = plain.search(q, k=50)
            _reset_counts()
            got = sharded.search(q, k=50)
            launches_nq = _read_counts(("candidate_scan",))
            search[nq] = dict(equal=bool(torch.equal(got[0], want[0])
                                         and torch.equal(got[1], want[1])),
                              launches=launches_nq["candidate_scan"])
        res["search"] = search
        res["launches"] = launches
        res["bytes_moved"] = dict(dp.bytes_moved)
        del plain, sharded
    finally:
        dist_lib.shutdown()
    _empty_cache(dev)
    log(f"dp (a) one rank over {backend}: DPR step at {dpr_batch} through "
        f"the distributed path against the plain one: "
        f"{'bit-equal' if res['dpr']['equal'] else res['dpr']['diff']} over "
        f"{res['dpr']['entries']} fingerprints; sharded int8 search nq 8 / "
        f"512: " + ", ".join(f"{'bit-equal' if s['equal'] else 'DIFFERS'} "
                             f"({s['launches']} K3 launches)"
                             for s in search.values())
        + f"; launches {res['launches']}; bytes moved "
        f"{res['bytes_moved']}")
    if not res["dpr"]["equal"] or not all(s["equal"] for s in
                                          search.values()):
        raise AssertionError("dp (a): the one-rank distributed path is not "
                             "bit-equal to the plain path")
    return res


# the ranks phase: two ranks sharing the card (global batches DP_SIZES: 2
# / 64 / 4 a rank), or --dp-cards N ranks on cards of their own
# (DP_CARD_SIZES a rank, timed against one card at the same batch; the
# checks at DP_CARD_CHECK_SIZES a rank, against one card at their global
# batch, which fits on it)
DP_WORLD = 2
DP_SIZES = {"qa": 4, "dpr": 128, "eval": 8}
DP_CARD_SIZES = {"qa": 8, "dpr": 128, "eval": 8}
DP_CARD_CHECK_SIZES = {"qa": 2, "dpr": 32}
DP_QA_STEPS = 3
DP_CHECK_STEPS = 2
DP_EVAL_QUESTIONS = 16
DP_SEARCH_NQ = (8, 512)
DP_LOSS_RTOL = 1e-2
# the global gradient norm of a check step against one process: a sum in
# place of the mean over the ranks, or a share not scaled to the global
# batch, moves it by a factor of the world size (>= 50 times this limit)
DP_GRAD_RTOL = 1e-2


def _dp_world(cfg, tmpdir, dev, n_rows, n_docs, dp=None):
    """Tokenizer, corpus and the dp phase's index (every rank holds its
    block of the same rows)."""
    from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex
    tok, corpus = make_corpus(cfg, tmpdir, n_docs)
    rows = _dp_rows(cfg, dev, n_rows, SEED + 19)
    pids = 1 + np.arange(n_rows) % n_docs
    index = ShardedEvidenceIndex(cfg.index, rows, passage_ids=pids,
                                 device=dev, dp=dp)
    del rows
    return tok, corpus, index


def _dp_searches(cfg, dev, n_rows, dp=None):
    """Per dtype and nq: this rank's (vals, ids) of the dp phase's
    queries (every rank holds its block of one index)."""
    from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex
    rank, world = (dp.rank, dp.world_size) if dp is not None else (0, 1)
    out = {}
    rows = _dp_rows(cfg, dev, n_rows, SEED + 17)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 18)
    queries = {nq: torch.randn(nq, cfg.index.embed_dim, device=dev,
                               generator=g)
               for nq in DP_SEARCH_NQ}
    for quant in ("none", "int8"):
        index = ShardedEvidenceIndex(
            dataclasses.replace(cfg.index, quantize=quant), rows,
            device=dev, dp=dp)
        for nq, q in queries.items():
            per = nq // world
            vals, ids = index.search(q[rank * per:(rank + 1) * per], k=50)
            out[f"{quant}_{nq}"] = (vals.cpu().numpy(), ids.cpu().numpy())
        del index
    del rows
    return out


def _dp_runs(cfg, dev, tmpdir, n_rows, n_docs, n_questions, dp=None,
             sizes=DP_SIZES, checks=DP_SIZES, eval_batch=None, dpr=True):
    """What the ranks phase runs, on one rank of ``dp`` (or in one process):
    the searches; ``evaluate_em`` of the initial state, greedy over int8
    K/V, at the global batch ``eval_batch`` (default ``sizes["eval"]``);
    ``DP_CHECK_STEPS`` OPENQA and DPR steps at dropout 0 at the global
    batches ``checks`` (each step's loss and global gradient norm; the
    learning rate has no warmup, so the second step follows an update);
    ``DP_QA_STEPS`` OPENQA and DPR steps at dropout 0.1 at the global
    batches ``sizes`` (their times, and the parameters' fingerprints).
    The training questions are ``n_questions`` (one set for the ranks and
    for one process: the shuffled order depends on it). ``dpr=False``
    leaves out the DPR steps. Returns the results and the stage times."""
    from emdr2_tpu_torch.config import OptimizerConfig
    from emdr2_tpu_torch.tasks import E2EQATask
    from emdr2_tpu_torch.tasks.dense_retriever import DPRTask
    from emdr2_tpu_torch.tasks import e2eqa
    from emdr2_tpu_torch.utils.timing import StageTimer

    rank, world = (dp.rank, dp.world_size) if dp is not None else (0, 1)
    ranks = {"rank": rank, "world_size": world}
    out = {"ms": {}}
    out["search"] = _dp_searches(cfg, dev, n_rows, dp)
    _empty_cache(dev)
    tok, corpus, index = _dp_world(cfg, tmpdir, dev, n_rows, n_docs, dp)
    ds = _qa_dataset(cfg, tok, tmpdir, n_questions)
    opt = OptimizerConfig(lr=2e-5, weight_decay=0.1, clip_grad=1.0,
                          warmup=0.0)

    def run_steps(name, task, batches):
        losses, norms, ms = [], [], []
        _reset_peak(dev)
        for batch in batches:
            _sync(dev)
            t0 = time.perf_counter()
            m = task.train_step(batch)
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
            norms.append(float(m["grad_norm"]))
        out[name] = dict(loss=losses, grad_norm=norms, ms=ms,
                         peak=_peak(dev), stage_ms=dict(task.timer.ms))

    for rate in (0.0, 0.1):
        qcfg, _ = _dp_cfgs(cfg, rate)
        bs = checks["qa"] if rate == 0.0 else sizes["qa"]
        qcfg = qcfg.replace(train=dataclasses.replace(
            qcfg.train, batch_size=bs, optimizer=opt))
        task = E2EQATask(qcfg, tok, corpus, index, total_train_iters=1000,
                         device=dev, dp=dp, timer=StageTimer(dev))
        task.init_state(SEED)
        if rate == 0.0:
            rec = []
            metric = e2eqa.metric_max_over_ground_truths

            def recording(m, text, refs):
                rec.append(text)
                return metric(m, text, refs)

            e2eqa.metric_max_over_ground_truths = recording
            try:
                t0 = time.perf_counter()
                em = task.evaluate_em(
                    _qa_dataset(cfg, tok, tmpdir, DP_EVAL_QUESTIONS),
                    batch_size=eval_batch or sizes["eval"], kv_quant="int8")
                out["ms"]["evaluate_em"] = (time.perf_counter() - t0) * 1e3
            finally:
                e2eqa.metric_max_over_ground_truths = metric
            out["em"] = dict(em=em, texts=rec)
        steps = DP_CHECK_STEPS if rate == 0.0 else DP_QA_STEPS
        run_steps(f"openqa_{rate}", task,
                  list(ds.epoch_batches(bs, seed=SEED, **ranks))[:steps])
        if rate > 0:
            out["openqa_params"] = _fingerprint_params(task.state.model)
        del task
        _empty_cache(dev)
    del index
    _empty_cache(dev)
    for rate in (0.0, 0.1) if dpr else ():
        _, rcfg = _dp_cfgs(cfg, rate)
        bs = checks["dpr"] if rate == 0.0 else sizes["dpr"]
        steps = DP_CHECK_STEPS if rate == 0.0 else DP_QA_STEPS
        task = DPRTask(rcfg, opt, 1000, device=dev, dp=dp,
                       timer=StageTimer(dev))
        task.init_state(SEED)
        run_steps(f"dpr_{rate}", task, _dpr_batches(
            cfg, tmpdir, bs, steps, rank=rank, world=world))
        if rate > 0:
            out["dpr_params"] = _fingerprint_params(task.state.model)
        del task
        _empty_cache(dev)
    return out


def _stages_text(stage_ms) -> str:
    return ", ".join(f"{k} " + "/".join(f"{m:.1f}" for m in v)
                     for k, v in stage_ms.items())


def dp_rank_main(spec_path: str, rank: int) -> int:
    """One rank of the ranks phase (``chip_smoke.py --dp-rank R --dp-spec
    PATH``) on the spec's device for it, over the spec's backend; a rank
    of an emulated host (``kind`` "hosts") joins by torchrun's variables
    instead (``parallel.init_distributed``), on the card of its local rank
    among the cards its host sees."""
    from emdr2_tpu_torch.ops import build
    from emdr2_tpu_torch.parallel import DataParallel, rank_device
    from emdr2_tpu_torch.parallel import distributed as dist_lib
    with open(spec_path) as f:
        spec = json.load(f)
    layout = None
    if spec.get("kind") == "hosts":
        layout = dist_lib.init_distributed(
            device=spec["device"], backend=spec["backend"],
            timeout_s=spec["timeout"])
        dev = rank_device(spec["device"], layout)
    else:
        dev = torch.device(spec["devices"][rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        build.load()
    cfg = torch.load(spec["cfg"], weights_only=False)
    if layout is None:
        dist_lib.init_process_group(spec["address"], spec["world"], rank,
                                    spec["backend"],
                                    timeout_s=spec["timeout"], device=dev)
    try:
        dp = DataParallel.from_process_group(tp=spec.get("tp", 1))
        _reset_counts()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmpdir:
            if spec.get("kind") == "embedder" or spec.get("mode") == \
                    "embedder":
                out = _embedder_run(cfg, dev, tmpdir, spec, dp, layout)
            elif spec.get("kind") == "tp":
                out = _tp_runs(cfg, dev, tmpdir, spec["sizes"],
                               spec["n_questions"], dp)
                out["launches"] = _read_counts(tuple(_counters()))
                out["dp_rank"], out["tp_rank"] = dp.rank, dp.tp.rank
            else:
                out = _dp_runs(cfg, dev, tmpdir, spec["n_rows"],
                               spec["n_docs"], spec["n_questions"], dp,
                               spec["sizes"], spec["checks"],
                               dpr=spec.get("dpr", True))
                out["launches"] = _read_counts(tuple(_counters()))
                for key, v in out["search"].items():
                    out["search"][key] = (v[0].tolist(), v[1].tolist())
            if layout is not None:
                out["host"] = _host_cards(layout, dev, spec)
        out["seconds"] = time.perf_counter() - t0
        out["bytes_moved"] = dict(dp.bytes_moved)
        with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist_lib.shutdown()
    return 0


def _run_ranks(cfg, what: str, timeout: float, spec: dict,
               envs=None) -> list:
    """Run the ranks of ``spec`` (its ``devices``, ``world`` and
    ``backend``; ``kind`` "dp", "embedder", "tp" or "hosts") as
    subprocesses of this script (``--dp-rank R --dp-spec PATH``), rank r
    with the variables ``envs[r]`` added to this process's, with
    ``timeout``, every one killed on the way out; -> each rank's results,
    by rank."""
    world = spec["world"]
    envs = envs or [{}] * world
    with tempfile.TemporaryDirectory() as tmpdir:
        torch.save(cfg, os.path.join(tmpdir, "cfg.pt"))
        spec = dict(spec, cfg=os.path.join(tmpdir, "cfg.pt"), out=tmpdir,
                    timeout=timeout / 2,
                    address=f"file://{os.path.join(tmpdir, 'store')}")
        path = os.path.join(tmpdir, "spec.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(REPO, "chip_smoke.py"),
             "--dp-rank", str(r), "--dp-spec", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=REPO,
            env=dict(os.environ, **envs[r])) for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0].decode())
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, text) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"{what} rank {r} failed "
                                     f"(rc {p.returncode}):\n{text[-6000:]}")
        got = []
        for r in range(world):
            with open(os.path.join(tmpdir, f"rank{r}.json")) as f:
                got.append(json.load(f))
    return got


def dp_ranks_phase(cfg, dev, n_rows=N_INDEX, n_docs=20_000, timeout=900,
                   world=DP_WORLD, cards=False):
    """The ranks as subprocesses of this script with a timeout, each with
    its block of the same index, against one process. (b)
    ``cards=False``: two ranks sharing ``dev`` over gloo, at the global
    batches ``DP_SIZES``, against one process at them. ``cards=True``
    (``--dp-cards N``): ``world`` ranks over NCCL, rank r on card r, at
    ``DP_CARD_SIZES`` a rank, timed against one card at those sizes, with
    the check steps at ``DP_CARD_CHECK_SIZES`` a rank. Held in both: the
    searches (bf16 and int8, nq 8 and 512) give one process's rows under
    the recall rule; the losses of the two check steps at dropout 0
    (OPENQA at 2 a rank, DPR at 64 a rank in (b)) lie within
    ``DP_LOSS_RTOL`` of one process at the global batch, their global
    gradient norms within ``DP_GRAD_RTOL``; at dropout 0.1 the ranks'
    parameters are bit-equal after 3 steps; ``evaluate_em`` over 16
    questions, greedy over int8 K/V (K5), generates one process's texts
    (one process at the batch of a rank: the same rows a batch) and its
    EM."""
    what = (f"(cards: {world} over "
            f"{'NCCL' if dev.type == 'cuda' else 'gloo'})" if cards
            else "(b)")
    per_rank = DP_CARD_SIZES if cards else {
        k: v // world for k, v in DP_SIZES.items()}
    sizes = {k: v * world for k, v in per_rank.items()}
    checks_at = ({k: v * world for k, v in DP_CARD_CHECK_SIZES.items()}
                 if cards else sizes)
    n_questions = max(DP_EVAL_QUESTIONS, sizes["qa"] * DP_QA_STEPS,
                      checks_at["qa"] * DP_CHECK_STEPS)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmpdir:
        ref = _dp_runs(cfg, dev, tmpdir, n_rows, n_docs, n_questions,
                       sizes=per_rank if cards else sizes, checks=checks_at,
                       eval_batch=per_rank["eval"])
    ref_s = time.perf_counter() - t0
    _empty_cache(dev)
    # one card each over NCCL; on the CPU (a rehearsal) gloo
    own = cards and dev.type == "cuda"
    t0 = time.perf_counter()
    got = _run_ranks(cfg, f"dp {what}", timeout, {
        "devices": ([f"cuda:{r}" for r in range(world)] if own
                    else [str(dev)] * world),
        "world": world, "backend": "nccl" if own else "gloo",
        "sizes": sizes, "checks": checks_at, "n_questions": n_questions,
        "n_rows": n_rows, "n_docs": n_docs})
    ranks_s = time.perf_counter() - t0
    res = {"ref_seconds": ref_s, "ranks_seconds": ranks_s, "ranks": got,
           "ref": ref, "plan": {"per_rank": per_rank, "sizes": sizes,
                                "checks": checks_at,
                                "n_questions": n_questions,
                                "n_rows": n_rows, "n_docs": n_docs}}
    search, checks, limits, failures = _dp_checks(
        ref, got, world, per_rank["eval"], sizes["eval"], ("openqa", "dpr"))
    res["search"], res["checks"] = search, checks
    res["launches"] = {k: sum(g["launches"][k] for g in got)
                       for k in got[0]["launches"]}
    for r, g in enumerate(got):
        log(f"dp {what} rank {r}: OPENQA step ms at dropout 0.1 "
            + ", ".join(f"{m:.1f}" for m in g["openqa_0.1"]["ms"])
            + f" (peak {g['openqa_0.1']['peak'] / 2**30:.2f} GiB); DPR "
            "step ms " + ", ".join(f"{m:.1f}" for m in g["dpr_0.1"]["ms"])
            + f" (peak {g['dpr_0.1']['peak'] / 2**30:.2f} GiB); stages "
            f"(the optimizer's holds the gradient all-reduce): OPENQA "
            + _stages_text(g["openqa_0.1"]["stage_ms"]) + "; DPR "
            + _stages_text(g["dpr_0.1"]["stage_ms"]) + "; "
            f"evaluate_em {g['ms']['evaluate_em']:.1f} ms; bytes moved "
            f"{g['bytes_moved']}; {g['seconds']:.1f} s; launches "
            f"{g['launches']}")
    ref_sizes = per_rank if cards else sizes
    log(f"dp {what} one process (references, {ref_s:.1f} s): OPENQA B="
        f"{ref_sizes['qa']} step ms {ref['openqa_0.1']['ms']} peak "
        f"{ref['openqa_0.1']['peak'] / 2**30:.2f} GiB ("
        + _stages_text(ref["openqa_0.1"]["stage_ms"]) + f"); DPR "
        f"{ref_sizes['dpr']} step ms {ref['dpr_0.1']['ms']} peak "
        f"{ref['dpr_0.1']['peak'] / 2**30:.2f} GiB ("
        + _stages_text(ref["dpr_0.1"]["stage_ms"]) + "); evaluate_em "
        f"{ref['ms']['evaluate_em']:.1f} ms")
    log(f"dp {what} {world} ranks ({ranks_s:.1f} s): "
        f"searches {search}; the {DP_CHECK_STEPS} check steps at dropout "
        f"0 (global batches {checks_at}) relative to one process: "
        + ", ".join(f"{k} {checks[k]:.3e}" for k in limits)
        + f" (limits: loss {DP_LOSS_RTOL}, grad_norm {DP_GRAD_RTOL}); "
        f"values one process / rank 0: " + ", ".join(
            f"{name}_{key} {ref[f'{name}_0.0'][key]} / "
            f"{got[0][f'{name}_0.0'][key]}" for name in ("openqa", "dpr")
            for key in ("loss", "grad_norm"))
        + f"; replicas bit-equal after {DP_QA_STEPS} steps at dropout "
        f"0.1: OPENQA {checks['openqa_replicas_equal']}, DPR "
        f"{checks['dpr_replicas_equal']}; EM one process / ranks "
        f"{checks['em']}; generated texts equal to one process's "
        f"{checks['texts_equal_share']:.4f}")
    if failures:
        raise AssertionError(f"dp {what} failed: {failures}")
    return res


def _dp_checks(ref, got, world, per_eval, global_eval, names):
    """The ranks' results ``got`` held to one process's ``ref`` by the dp
    phase's rules: each search's rows those of one process under the
    recall rule (``TIE_EPS``); for each of ``names`` ("openqa", "dpr") the
    losses and global gradient norms of the check steps at dropout 0
    within ``DP_LOSS_RTOL`` / ``DP_GRAD_RTOL``, the replicas bit-equal
    after the steps at dropout 0.1; ``evaluate_em``'s texts (``per_eval``
    rows a rank of every global batch of ``global_eval``) and EM those of
    one process. -> (search, checks, limits, failures)."""
    search = {}
    for key, (want_vals, want_ids) in ref["search"].items():
        nq = want_ids.shape[0]
        assert nq % world == 0
        ids = np.concatenate([np.asarray(g["search"][key][1]) for g in got])
        vals = np.concatenate([np.asarray(g["search"][key][0])
                               for g in got])
        share, ties, bad = _same_or_tie(ids, vals, want_ids, want_vals, 50)
        search[key] = dict(equal_share=share, ties=ties, unexplained=bad,
                           exact=bool(np.array_equal(ids, want_ids)))
    checks = {}
    limits = {}
    for name in names:
        for key, limit in (("loss", DP_LOSS_RTOL),
                           ("grad_norm", DP_GRAD_RTOL)):
            for step in range(DP_CHECK_STEPS):
                want = ref[f"{name}_0.0"][key][step]
                rel = max(abs(g[f"{name}_0.0"][key][step] - want)
                          / abs(want) for g in got)
                checks[f"{name}_{key}_{step + 1}_rel"] = rel
                limits[f"{name}_{key}_{step + 1}_rel"] = limit
        checks[f"{name}_replicas_equal"] = all(
            g[f"{name}_params"] == got[0][f"{name}_params"] for g in got)
    checks["em"] = (list(ref["em"]["em"]), [list(g["em"]["em"])
                                            for g in got])
    texts = []
    for i in range(-(-DP_EVAL_QUESTIONS // global_eval)):
        for g in got:
            texts += g["em"]["texts"][i * per_eval:(i + 1) * per_eval]
    want_texts = dict(zip(range(DP_EVAL_QUESTIONS), ref["em"]["texts"]))
    checks["texts_equal_share"] = (
        sum(t == want_texts.get(i) for i, t in
            enumerate(texts[:DP_EVAL_QUESTIONS])) / DP_EVAL_QUESTIONS)
    failures = [k for k, s in search.items() if s["unexplained"]]
    failures += [k for k, limit in limits.items() if not checks[k] <= limit]
    failures += [k for k in [f"{n}_replicas_equal" for n in names]
                 + ["texts_equal_share"] if checks[k] != 1]
    if any(e != checks["em"][0] for e in checks["em"][1]):
        failures.append("em")
    return search, checks, limits, failures


# the embedder phase: every rank trains under the flagship recipe's
# asynchronous refresher and prefetch at depth 1, its embedder on its own
# card (EMB_SHARED: two ranks sharing the card over gloo, embed-devices 0)
# or on a card of its own (EMB_CARDS, ``--dp-cards``: two trainers over
# NCCL beside two embedder cards); sizes a rank
EMB_WORLD = 2
EMB_SHARED = {"docs": 16_384, "qa": 2, "iters": 6, "plain_iters": 1}
EMB_CARDS = {"docs": 32_768, "qa": 8, "iters": 8, "plain_iters": 3}
EMB_RELOAD = 2
EMB_CHECK_ROWS = 64
EMB_BUILDER_SHAPE = (128, 256)      # K1's batch of passages in the builder
EMB_SWAP_REPS = 3


def _embedder_run(cfg, dev, tmpdir, spec, dp, layout=None):
    """One rank of the embedder phase: ``engine.train`` over an int8 index
    of ``sizes["docs"]`` passages (this rank holding its block) with an
    ``AsyncIndexRefresher`` (reload interval ``EMB_RELOAD``) whose builder
    runs on the rank's embedder devices (``parallel.embed_devices``),
    ``prefetch_depth=1``, ``iters`` iterations at ``sizes["qa"]`` questions
    a rank; then ``plain_iters`` more without the refresher (``layout``:
    the rank's ``HostLayout`` in a launch across hosts, whose embedder
    cards are its own host's). Records each
    iteration's ms and whether an embed pass overlapped it by half, each
    pass's window, each ``maybe_swap`` that swapped (iteration, ms of the
    trainer thread's stall: the agreement all-reduce and the swap, the
    card synchronized on both sides), the launches (counts set to 0 just
    before the refreshed run and read just after; K1's by card at the
    builder's shape), peak memory per device, and after the first swap
    ``EMB_CHECK_ROWS`` of the rank's rows against a copy of the tower
    taken at the hand-off. Last, the swap of a block of ``swap_rows`` /
    W int8 rows made and quantized on the embedder's device, timed
    ``EMB_SWAP_REPS`` times, and held bit for bit to the rows moved first
    and quantized on the trainer's device."""
    import copy
    import threading

    from emdr2_tpu_torch.config import MeshConfig
    from emdr2_tpu_torch.ops import fid_attention as fa
    from emdr2_tpu_torch.ops import mips
    from emdr2_tpu_torch.parallel import check_mesh_config, embed_devices
    from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex
    from emdr2_tpu_torch.retrieval.builder import (EvidenceIndexBuilder,
                                                   context_tower)
    from emdr2_tpu_torch.tasks import E2EQATask
    from emdr2_tpu_torch.training import engine
    from emdr2_tpu_torch.training.step import METRICS
    from emdr2_tpu_torch.training.async_refresh import AsyncIndexRefresher

    cuda = dev.type == "cuda"
    mesh = MeshConfig(dp=dp.world_size, embed_devices=spec["embed_devices"])
    check_mesh_config(mesh, dp.world_size,
                      torch.cuda.device_count() if cuda else None,
                      layout=layout)
    edevs = embed_devices(mesh, dp.rank, dev, layout)
    edev = edevs[0]
    devices = [dev] + [d for d in edevs if d != dev]
    sizes = spec["sizes"]
    n_docs, batch = sizes["docs"], sizes["qa"] * dp.world_size
    iters, plain_iters = sizes["iters"], sizes["plain_iters"]

    def sync():
        if cuda:
            for d in devices:
                torch.cuda.synchronize(d)

    def sync_trainer():
        # the trainer's stream alone: the embedder's keeps running (a
        # copy from its card is on a stream the trainer's waits for)
        if cuda:
            torch.cuda.current_stream(dev).synchronize()

    def loop_cfg(train_iters):
        return cfg.replace(train=dataclasses.replace(
            cfg.train, batch_size=batch, train_iters=train_iters,
            log_interval=1, save_interval=10 ** 6, eval_interval=10 ** 6,
            index_reload_interval=EMB_RELOAD, seed=SEED))

    tok, corpus = make_corpus(cfg, tmpdir, n_docs)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 23)
    index = ShardedEvidenceIndex(
        cfg.index, torch.randn(n_docs, cfg.index.embed_dim, device=dev,
                               generator=g), device=dev, dp=dp)
    ds = _qa_dataset(cfg, tok, tmpdir, batch * (iters + plain_iters + 2))
    task = E2EQATask(loop_cfg(iters), tok, corpus, index,
                     total_train_iters=1000, device=dev, dp=dp)
    model = task.init_state(SEED).model
    start_weights = {k: v.detach().to("cpu", copy=True) for k, v in
                     context_tower(model).state_dict().items()}
    builder = EvidenceIndexBuilder(cfg, model, corpus, tok.cls_id,
                                   tok.sep_id, tok.pad_id, devices=edevs)
    lo, hi = index.process_row_range()
    real = max(0, min(hi, n_docs) - lo)
    scans = index.shard_rows > cfg.index.chunk_rows
    check_rows = np.sort(np.random.RandomState(SEED + 1 + dp.rank).choice(
        real, EMB_CHECK_ROWS, replace=False))
    first = {}

    def on_refresh(step):
        if not first:
            rows = mips.dequantize_int8(index.embeddings, index.scales,
                                        cfg.index.group_size)
            first.update(step=step, rows=rows[check_rows].cpu(),
                         scales=index.scales[
                             check_rows // cfg.index.group_size].cpu())

    refresher = AsyncIndexRefresher(builder, index, EMB_RELOAD,
                                    on_refresh=on_refresh,
                                    zero_copy=spec["embed_devices"] > 0)
    passes, swaps, agree_ms, ends = [], [], [], []
    for name in ("embed_corpus", "embed_corpus_device"):
        def timed(*args, _fn=getattr(builder, name), **kw):
            t0 = time.perf_counter()
            out = _fn(*args, **kw)
            if isinstance(out, torch.Tensor) and out.is_cuda:
                # the rows are queued on this thread's stream: the pass
                # ends when they are written
                torch.cuda.current_stream(out.device).synchronize()
            passes.append((t0, time.perf_counter()))
            return out
        setattr(builder, name, timed)
    maybe_swap = refresher.maybe_swap

    def timed_swap(step, model):
        boundary = step - refresher._last_reload_step >= EMB_RELOAD
        if boundary:
            sync_trainer()
        t0 = time.perf_counter()
        swapped = maybe_swap(step, model)
        if boundary:
            sync_trainer()
            ms = (time.perf_counter() - t0) * 1e3
            (swaps.append((step, ms)) if swapped else agree_ms.append(ms))
        return swapped

    refresher.maybe_swap = timed_swap

    def printer(line):
        if "ms_per_iter" in line:
            ends.append(time.perf_counter())

    for d in devices:
        _reset_peak(d)
    _reset_counts()
    train_log = engine.TrainLog(1, printer)
    t_start = time.perf_counter()
    final = engine.train(task, ds, loop_cfg(iters), refresher=refresher,
                         prefetch_depth=1, dp=dp, printer=printer,
                         log=train_log)
    sync()
    train_s = time.perf_counter() - t_start
    launches = _read_counts(tuple(_counters()))
    by_shape = dict(fa.flash_self_attention.launches_by_shape)
    peaks = {str(d): _peak(d) for d in devices}
    alive = [t.name for t in threading.enumerate() if t.name.startswith(
        ("index-refresh", "batch-prefetch"))]
    history = train_log.history
    if final != iters or len(history) != iters or alive:
        raise AssertionError(f"embedder run ended at {final}, history "
                             f"{history}, threads left {alive}")
    if refresher.error is not None or not first:
        raise AssertionError(f"refresh_count {refresher.refresh_count}, "
                             f"swaps {swaps}, error {refresher.error!r}")
    starts = [t_start] + ends[:-1]
    busy = [sum(max(0.0, min(e, pe) - max(s, ps)) for ps, pe in passes)
            >= 0.5 * (e - s) for s, e in zip(starts, ends)]
    plain_log = engine.TrainLog(1, lambda line: None)
    engine.train(task, ds, loop_cfg(iters + plain_iters), prefetch_depth=1,
                 dp=dp, printer=lambda line: None, log=plain_log)
    sync()
    fingerprint = _fingerprint_params(task.state.model)

    # the first swapped block against the tower handed over at start
    tower = copy.deepcopy(context_tower(model)).requires_grad_(False)
    tower.load_state_dict(start_weights)
    tower = tower.to(edev)
    ids, types = builder._format_rows(check_rows + lo + 1)
    with torch.inference_mode():
        want = tower.embed(torch.as_tensor(ids).long().to(edev),
                           torch.as_tensor(types).long().to(edev)
                           ).float().cpu()
    err = (first["rows"] - want).abs()
    limit = first["scales"][:, None] + FWD_TOL[0] * want.abs().max()
    check = dict(err=err.max().item(),
                 steps=(err / first["scales"][:, None]).max().item(),
                 ok=bool((err <= limit).all()))
    losses_finite = all(np.isfinite(h[k]) for h in history
                        + plain_log.history for k in METRICS)
    del tower, want, task, model, builder, refresher, index
    for d in devices:
        _empty_cache(d)

    # a block of a full shard's rows, made and quantized where the
    # embedder runs, swapped in card to card
    block_ms, block_equal = [], True
    n_rows = spec["swap_rows"]
    icfg = dataclasses.replace(cfg.index, quantize="int8")
    index = ShardedEvidenceIndex(
        icfg, torch.zeros(n_rows // dp.world_size, icfg.embed_dim,
                          device=dev), device=dev, dp=dp, local=True,
        n_real=n_rows)
    g = torch.Generator(device=edev)
    g.manual_seed(SEED + 29 + dp.rank)
    for _ in range(EMB_SWAP_REPS):
        rows = torch.randn(index.shard_rows, icfg.embed_dim, device=edev,
                           generator=g).to(icfg.dtype)
        block = index.local_block(rows)
        ready = torch.cuda.Event() if cuda else None
        if cuda:
            ready.record(torch.cuda.current_stream(edev))
        sync()
        t0 = time.perf_counter()
        index.update_from_process_local(block, ready=ready)
        sync()
        block_ms.append((time.perf_counter() - t0) * 1e3)
        want_rows, want_scales = index.local_block(rows.to(dev))
        block_equal &= bool(torch.equal(index.embeddings, want_rows)
                            and torch.equal(index.scales, want_scales))
        del rows, block, want_rows, want_scales
    del index
    for d in devices:
        _empty_cache(d)
    pass_s = [pe - ps for ps, pe in passes]
    return dict(
        devices=[str(d) for d in devices], embedder=[str(d) for d in edevs],
        ms=[h["ms_per_iter"] for h in history],
        with_embed=[h["ms_per_iter"] for h, b in zip(history, busy) if b],
        without=[h["ms_per_iter"] for h, b in zip(history, busy) if not b],
        plain=[h["ms_per_iter"] for h in plain_log.history],
        pass_s=pass_s, per_s=[real / s for s in pass_s], block_rows=real,
        swaps=swaps, agree_ms=agree_ms, first_step=first["step"],
        refresh_count=len(swaps), check=check, scans=scans,
        losses_finite=losses_finite, fingerprint=fingerprint,
        launches=launches,
        builder_launches={dev_name: n for (dev_name, B, L), n in
                          by_shape.items() if (B, L) == EMB_BUILDER_SHAPE},
        peaks=peaks, train_s=train_s, block_ms=block_ms,
        block_equal=block_equal, block_shard_rows=n_rows // dp.world_size)


def embedder_phase(cfg, dev, cards=False, timeout=900, sizes=None):
    """Two ranks with their embedders (``_embedder_run``) as subprocesses.
    ``cards=False``: sharing ``dev`` over gloo, ``--embed-devices 0``, at
    ``EMB_SHARED``. ``cards=True`` (``--dp-cards``): trainers on cards 0-1
    over NCCL, their embedders on cards 2-3 (``--embed-devices 2``), at
    ``EMB_CARDS``; on the CPU a rehearsal of the same layout over gloo.
    Held: the ranks swap at the same iterations, at least once; after the
    first swap each rank's sampled rows equal the hand-off tower's
    embedding within one int8 step of their group plus the bf16 forward
    tolerance (``refresh_phase``'s rule); the replicas are bit-equal after
    the runs; the losses finite; K1, K2 and K3 launched; the block swapped
    card to card bit-equal to the one quantized on the trainer's card;
    with cards, no K1 launch at the builder's shape on a trainer card.
    ``sizes`` replaces the sizes a rank (a rehearsal on the CPU)."""
    on_cards = cards and dev.type == "cuda"
    sizes = sizes or (EMB_CARDS if cards else EMB_SHARED)
    what = (f"embedder (cards: {EMB_WORLD} trainers over "
            f"{'NCCL' if on_cards else 'gloo'} beside {EMB_WORLD} "
            f"embedders)" if cards else "embedder (shared card, gloo)")
    t0 = time.perf_counter()
    got = _run_ranks(cfg, what, timeout, {
        "kind": "embedder",
        "devices": ([f"cuda:{r}" for r in range(EMB_WORLD)] if on_cards
                    else [str(dev)] * EMB_WORLD),
        "world": EMB_WORLD, "backend": "nccl" if on_cards else "gloo",
        "embed_devices": EMB_WORLD if cards else 0, "sizes": sizes,
        "swap_rows": N_INDEX if dev.type == "cuda" else 4096})
    seconds = time.perf_counter() - t0
    failures, launches, steps = _embedder_checks(what, got, dev, on_cards)
    log(f"{what}: {seconds:.1f} s; swap iterations {steps}")
    if failures:
        raise AssertionError(f"{what} failed: {failures}")
    return dict(ranks=got, launches=launches, seconds=seconds)


def _embedder_checks(what, got, dev, on_cards):
    """Log each rank of the embedder phase and hold them to its rules
    (``embedder_phase``) -> (failures, launches summed over the ranks,
    each rank's swap iterations)."""
    for r, g in enumerate(got):
        log(f"{what} rank {r} on {g['devices']} (embedder {g['embedder']}):"
            f" ms per iteration with an embed pass in flight "
            + ", ".join(f"{m:.1f}" for m in g["with_embed"]) + "; without "
            + ", ".join(f"{m:.1f}" for m in g["without"])
            + "; with no refresher " + ", ".join(f"{m:.1f}"
                                                 for m in g["plain"])
            + f"; passes of {g['block_rows']} passages: "
            + ", ".join(f"{s:.3f} s ({p:.1f} passages/s)"
                        for s, p in zip(g["pass_s"], g["per_s"]))
            + "; swaps (iteration, ms of the stall) "
            + ", ".join(f"({i}, {ms:.1f})" for i, ms in g["swaps"])
            + "; agreements that did not swap (ms) "
            + ", ".join(f"{ms:.1f}" for ms in g["agree_ms"])
            + f"; the block of {g['block_shard_rows']} int8 rows card to "
            f"card: " + ", ".join(f"{ms:.2f}" for ms in g["block_ms"])
            + f" ms, bit-equal {g['block_equal']}; peaks "
            + ", ".join(f"{d} {b / 2**30:.2f} GiB"
                        for d, b in g["peaks"].items())
            + f"; K1 at the builder's {EMB_BUILDER_SHAPE} by card "
            f"{g['builder_launches']}; K3 scans a block "
            f"({'yes' if g['scans'] else 'no: the exact product'}); launches "
            f"{g['launches']}; first swap "
            f"at {g['first_step']}: max abs err {g['check']['err']:.3e} = "
            f"{g['check']['steps']:.3f} int8 steps; {g['seconds']:.1f} s")
    failures = []
    steps = [[i for i, _ in g["swaps"]] for g in got]
    if not steps[0] or any(s != steps[0] for s in steps):
        failures.append(f"swap iterations {steps}")
    if any(g["first_step"] != got[0]["first_step"] for g in got):
        failures.append("first swap")
    failures += [f"rank {r} rows" for r, g in enumerate(got)
                 if not g["check"]["ok"]]
    if any(g["fingerprint"] != got[0]["fingerprint"] for g in got):
        failures.append("replicas")
    failures += [f"rank {r} losses" for r, g in enumerate(got)
                 if not g["losses_finite"]]
    failures += [f"rank {r} block swap" for r, g in enumerate(got)
                 if not g["block_equal"]]
    launches = {k: sum(g["launches"][k] for g in got)
                for k in got[0]["launches"]}
    # K3 scans a rank's block only above chunk_rows (smaller blocks take
    # the exact product, as the JAX search does)
    needed = ["flash_self_attention", "flash_self_attention_backward",
              "flash_cross_attention", "flash_cross_attention_backward"]
    if all(g["scans"] for g in got):
        needed.append("candidate_scan")
    failures += [f"{k} never launched" for k in needed
                 if dev.type == "cuda" and launches[k] <= 0]
    if on_cards:
        for g in got:
            trainer = g["devices"][0]
            if g["builder_launches"].get(trainer, 0) != 0:
                failures.append(f"K1 at the builder's shape on {trainer}")
            if not all(g["builder_launches"].get(d, 0) > 0
                       for d in g["embedder"]):
                failures.append(f"no builder launch on {g['embedder']}")
    return failures, launches, steps


# the two-host phase: a launch across hosts, each emulated host a group of
# this script's subprocesses with its own CUDA_VISIBLE_DEVICES and
# torchrun's variables (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT,
# LOCAL_RANK, LOCAL_WORLD_SIZE, GROUP_RANK), one rank a host, each joining
# through parallel.init_distributed. Default: both hosts see card 0 and the
# two ranks share it over gloo, doing the dp phase (b)'s OPENQA work held
# to its one-process references; --dp-cards 4: hosts of cards 0,1 and 2,3,
# each a trainer on its card 0 beside its embedder on its card 1, NCCL
HOSTS_VISIBLE = ("0", "0")
HOSTS_CARDS_VISIBLE = ("0,1", "2,3")


def _host_envs(visible, port):
    """torchrun's variables of one rank a host, host h seeing the cards
    ``visible[h]``, the rendezvous at 127.0.0.1:``port``."""
    return [{"CUDA_VISIBLE_DEVICES": v, "RANK": str(h),
             "WORLD_SIZE": str(len(visible)), "MASTER_ADDR": "127.0.0.1",
             "MASTER_PORT": str(port), "LOCAL_RANK": "0",
             "LOCAL_WORLD_SIZE": "1", "GROUP_RANK": str(h)}
            for h, v in enumerate(visible)]


def _host_cards(layout, dev, spec):
    """A rank's place in a launch across hosts: its host and local rank,
    and the UUIDs (``torch.cuda.get_device_properties(i).uuid``; None on
    the CPU) of its trainer card, its embedder cards
    (``parallel.embed_devices``) and every card its host shows it."""
    from emdr2_tpu_torch.config import MeshConfig
    from emdr2_tpu_torch.parallel import embed_devices

    def uuid(d):
        return (str(torch.cuda.get_device_properties(d).uuid)
                if d.type == "cuda" else None)

    mesh = MeshConfig(dp=len(layout.rank_hosts),
                      embed_devices=spec.get("embed_devices", 0))
    edevs = embed_devices(mesh, torch.distributed.get_rank(), dev, layout)
    visible = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if dev.type == "cuda" else [])
    return dict(host=layout.host, name=layout.name,
                local_rank=layout.local_rank,
                visible_env=os.environ.get("CUDA_VISIBLE_DEVICES"),
                trainer=str(dev), trainer_uuid=uuid(dev),
                embedder=[str(d) for d in edevs],
                embedder_uuids=[uuid(d) for d in edevs],
                visible_uuids=[uuid(d) for d in visible])


def _card_failures(got, own_cards):
    """Each rank on its own host; with ``own_cards`` (the hosts' cards
    apart) no two ranks on one trainer card, and each embedder card one of
    its own host's, no trainer's and no other host's. UUIDs are None on
    the CPU, where only the hosts are held."""
    hosts = [g["host"] for g in got]
    failures = []
    if sorted(h["host"] for h in hosts) != list(range(len(got))):
        failures.append(f"hosts {[h['host'] for h in hosts]}")
    if not own_cards or hosts[0]["trainer_uuid"] is None:
        return failures
    trainers = [h["trainer_uuid"] for h in hosts]
    if len(set(trainers)) != len(trainers):
        failures.append(f"ranks share a trainer card: {trainers}")
    for r, h in enumerate(hosts):
        others = {u for o in hosts if o["host"] != h["host"]
                  for u in o["visible_uuids"]}
        for u in h["embedder_uuids"]:
            if u not in h["visible_uuids"] or u in others:
                failures.append(f"rank {r}'s embedder card {u} is not its "
                                f"host's alone")
            if u in trainers:
                failures.append(f"rank {r}'s embedder card {u} trains")
    return failures


def hosts_phase(cfg, dev, dpb=None, cards=False, timeout=900, sizes=None):
    """Two emulated hosts of one rank each (``HOSTS_VISIBLE``: both see
    card 0; ``cards=True``: ``HOSTS_CARDS_VISIBLE``), the ranks placed by
    torchrun's variables at the rendezvous (``host_layout``): each takes
    the card of its local rank among the cards its host sees. Default
    (``dpb``: the dp phase (b)'s result): over gloo, the dp phase's work
    without the DPR steps (``_dp_runs(dpr=False)``: the K3 searches on
    each rank's block, the OPENQA check steps at dropout 0, three steps at
    dropout 0.1, ``evaluate_em`` over int8 K/V) at (b)'s global batches,
    held to (b)'s one-process references by ``_dp_checks``; every kernel
    of the path launched. ``cards=True`` (``--dp-cards 4``): over NCCL,
    ``engine.train`` with each rank's refresher on its host's embedder
    card (``--embed-devices 2``: one a host) and prefetch 1 at
    ``EMB_CARDS`` (8 questions a rank), held by the embedder phase's
    rules (``_embedder_checks``); no two ranks on one trainer card, no
    embedder card on another host. Each rank prints its cards' UUIDs; a
    rank's step time, passages/s and swap time are printed with the
    card's name and power limit. On the CPU a rehearsal over gloo
    (``sizes`` replaces the embedder's sizes there)."""
    on_cards = cards and dev.type == "cuda"
    visible = HOSTS_CARDS_VISIBLE if cards else HOSTS_VISIBLE
    world = len(visible)
    what = (f"two hosts (cards {' and '.join(visible)}: a trainer beside "
            f"its embedder a host, {'NCCL' if on_cards else 'gloo'})"
            if cards else "two hosts (both see card 0, gloo)")
    spec = {"kind": "hosts", "world": world, "device": dev.type,
            "backend": "nccl" if on_cards else "gloo"}
    if cards:
        spec.update(mode="embedder", embed_devices=world,
                    sizes=sizes or EMB_CARDS,
                    swap_rows=N_INDEX if dev.type == "cuda" else 4096)
    else:
        plan = dpb["plan"]
        spec.update(mode="dp", dpr=False, sizes=plan["sizes"],
                    checks=plan["checks"], n_questions=plan["n_questions"],
                    n_rows=plan["n_rows"], n_docs=plan["n_docs"])
    t0 = time.perf_counter()
    got = _run_ranks(cfg, what, timeout, spec,
                     _host_envs(visible, _free_port()))
    seconds = time.perf_counter() - t0
    res = dict(ranks=got, seconds=seconds)
    if cards:
        failures, launches, steps = _embedder_checks(what, got, dev,
                                                     on_cards)
        times = [f"rank {r}: ms per iteration with a pass in flight "
                 + ", ".join(f"{m:.1f}" for m in g["with_embed"])
                 + ", without " + ", ".join(f"{m:.1f}" for m in g["without"])
                 + ", with no refresher "
                 + ", ".join(f"{m:.1f}" for m in g["plain"])
                 + "; passages/s " + ", ".join(f"{p:.1f}"
                                               for p in g["per_s"])
                 + "; swaps (iteration, ms) " + ", ".join(
                     f"({i}, {ms:.1f})" for i, ms in g["swaps"])
                 for r, g in enumerate(got)]
        res["swap_iterations"] = steps
    else:
        plan = dpb["plan"]
        search, checks, limits, failures = _dp_checks(
            dpb["ref"], got, world, plan["per_rank"]["eval"],
            plan["sizes"]["eval"], ("openqa",))
        launches = {k: sum(g["launches"][k] for g in got)
                    for k in got[0]["launches"]}
        # the OPENQA path's kernels, as in the tp phase (K4 is off it)
        failures += [f"{k} never launched" for k in TP_COUNTED
                     if dev.type == "cuda" and launches[k] <= 0]
        times = [f"rank {r}: OPENQA step ms at dropout 0.1 "
                 + ", ".join(f"{m:.1f}" for m in g["openqa_0.1"]["ms"])
                 + f" at {plan['per_rank']['qa']} questions (peak "
                 f"{g['openqa_0.1']['peak'] / 2**30:.2f} GiB; stages "
                 + _stages_text(g["openqa_0.1"]["stage_ms"])
                 + f"); evaluate_em {g['ms']['evaluate_em']:.1f} ms; bytes "
                 f"moved {g['bytes_moved']}; launches {g['launches']}"
                 for r, g in enumerate(got)]
        log(f"{what}: searches {search}; the {DP_CHECK_STEPS} check steps "
            f"at dropout 0 relative to one process: "
            + ", ".join(f"{k} {checks[k]:.3e}" for k in limits)
            + f" (limits: loss {DP_LOSS_RTOL}, grad_norm {DP_GRAD_RTOL}); "
            f"replicas bit-equal after {DP_QA_STEPS} steps at dropout 0.1: "
            f"{checks['openqa_replicas_equal']}; EM one process / ranks "
            f"{checks['em']}; generated texts equal to one process's "
            f"{checks['texts_equal_share']:.4f}")
        res.update(search=search, checks=checks)
    for r, g in enumerate(got):
        h = g["host"]
        log(f"{what} rank {r}: host {h['host']} ({h['name']}, "
            f"CUDA_VISIBLE_DEVICES={h['visible_env']}), local rank "
            f"{h['local_rank']}: trainer {h['trainer']} "
            f"{h['trainer_uuid']}, embedder {h['embedder']} "
            f"{h['embedder_uuids']}; {g['seconds']:.1f} s")
    failures += _card_failures(got, on_cards)
    res["launches"] = launches
    log(f"{what}: " + "; ".join(times) + f"; {seconds:.1f} s in all; "
        + (gpu_name_and_power() if dev.type == "cuda" else "the CPU"))
    if failures:
        raise AssertionError(f"{what} failed: {failures}")
    return res


def dp_cards_main(world: int, dev, card: str, t_start: float) -> int:
    """``chip_smoke.py --dp-cards N``: the ranks phase over NCCL, rank r on
    card r, at the flagship widths; prints its results as one JSON line
    and the ``{"ok": ...}`` line."""
    if torch.cuda.device_count() < world:
        raise AssertionError(f"--dp-cards {world} needs {world} cards, "
                             f"{torch.cuda.device_count()} visible")
    _reset_counts()
    res = dp_ranks_phase(_flagship_cfg(), dev, world=world, cards=True)
    emb = None
    if world >= 2 * EMB_WORLD:
        # the disjoint embedder layout: two trainers beside two embedders
        from emdr2_tpu_torch.config import with_transformers
        _empty_cache(dev)
        emb = embedder_phase(with_transformers(
            _flagship_cfg(), {"remat": False}, {"remat": True}), dev,
            cards=True)
    hosts = None
    if world >= 2 * len(HOSTS_CARDS_VISIBLE):
        # a launch across two hosts of two cards each: a trainer beside
        # its embedder on each host
        from emdr2_tpu_torch.config import with_transformers
        _empty_cache(dev)
        hosts = hosts_phase(with_transformers(
            _flagship_cfg(), {"remat": False}, {"remat": True}), dev,
            cards=True)
    tps = []
    if world >= 4:
        # tensor parallelism over NCCL: --tp 2 on cards 0-1 at the
        # flagship step's B=8, then --dp 2 --tp 2 on four cards
        for layout in TP_CARDS:
            _empty_cache(dev)
            t0 = time.perf_counter()
            r = tp_phase(_flagship_cfg(), dev, cards=True, layout=layout)
            log(f"tp phase dp {layout['dp']} x tp {layout['tp']}: "
                f"{time.perf_counter() - t0:.1f} s")
            tps.append({"sizes": r["sizes"], "checks": r["checks"],
                        "launches_by_rank": r["launches_by_rank"],
                        "one_card": {k: r["ref"][k] for k in (
                            "openqa_0.0", "openqa_0.1", "dpr_0.0")},
                        "ranks": [{k: g[k] for k in (
                            "dp_rank", "tp_rank", "openqa_0.0",
                            "openqa_0.1", "dpr_0.0", "seconds")}
                            for g in r["ranks"]]})
    summary = {"dp_cards": world, "checks": res["checks"], "tp": tps,
               "search": res["search"], "launches": res["launches"],
               "ranks": [{k: g[k] for k in ("openqa_0.1", "dpr_0.1",
                                            "bytes_moved", "seconds")}
                         for g in res["ranks"]],
               "one_card": {k: res["ref"][k] for k in ("openqa_0.1",
                                                       "dpr_0.1")},
               "embedder": emb and [
                   {k: g[k] for k in (
                       "devices", "embedder", "with_embed", "without",
                       "plain", "pass_s", "per_s", "swaps", "agree_ms",
                       "block_ms", "peaks", "builder_launches", "check",
                       "seconds")} for g in emb["ranks"]],
               "hosts": hosts and {
                   "launches": hosts["launches"],
                   "swap_iterations": hosts["swap_iterations"],
                   "ranks": [{k: g[k] for k in (
                       "host", "with_embed", "without", "plain", "pass_s",
                       "per_s", "swaps", "agree_ms", "block_ms", "peaks",
                       "builder_launches", "check", "seconds")}
                       for g in hosts["ranks"]]}}
    log(f"chip_smoke --dp-cards {world} total "
        f"{time.perf_counter() - t_start:.1f} s")
    log(json.dumps(summary))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# the tensor-parallel phase: the ranks of a [dp, tp] grid (world rank
# dp_idx * tp + tp_idx), each replica's heads, MLP columns and vocabulary
# split over its tp ranks, the index's blocks over all of them. Sizes are
# global batches; "check_qa" the check steps' batch (against one process
# at the same batch), "qa" the timed steps' at dropout 0.1
TP_SHARED = {"dp": 1, "tp": 2, "check_qa": 2, "qa": 2, "dpr": 32,
             "eval": 2}
TP_CARDS = ({"dp": 1, "tp": 2, "check_qa": 8, "qa": 8, "dpr": 64,
             "eval": 8},
            {"dp": 2, "tp": 2, "check_qa": 4, "qa": 16, "dpr": 64,
             "eval": 8})
TP_CHECK_STEPS = 2
TP_DROP_STEPS = 2
TP_EVAL_QUESTIONS = 4
TP_N_ROWS = 131_072         # a block of 65,536 / 32,768 rows: the K3 scan
TP_N_DOCS = 8_192
TP_COUNTED = ("flash_self_attention", "flash_self_attention_backward",
              "flash_cross_attention", "flash_cross_attention_backward",
              "candidate_scan", "decode_cross_attention_int8")


def _tp_cfg(cfg, rate):
    """The flagship recipe (--remat --no-remat-towers) at dropout
    ``rate``."""
    from emdr2_tpu_torch.config import with_transformers
    drop = {"hidden_dropout": rate, "attention_dropout": rate}
    qcfg = with_transformers(cfg, dict(drop, remat=False),
                             dict(drop, remat=True, remat_policy="nothing"))
    rc = cfg.retriever
    rcfg = dataclasses.replace(rc, encoder=dataclasses.replace(
        rc.encoder, remat=False, **drop))
    return qcfg, rcfg


def _split_fingerprints(model):
    """(fingerprint of the parameters every tp rank holds whole, of all
    of this rank's parameters)."""
    from emdr2_tpu_torch.parallel.tensor import split_of
    from emdr2_tpu_torch.utils.repeat import fingerprint
    named = list(model.named_parameters())
    return (repr([fingerprint(p) for n, p in named if split_of(n) is None]),
            repr([fingerprint(p) for _, p in named]))


def _tp_runs(cfg, dev, tmpdir, sizes, n_questions, dp=None):
    """What one rank of the tp phase runs (or one process, ``dp=None``):
    ``evaluate_em`` of the initial state over ``TP_EVAL_QUESTIONS``
    questions, greedy over int8 K/V (K5 on the rank's heads);
    ``TP_CHECK_STEPS`` OPENQA steps at dropout 0 at ``sizes["check_qa"]``
    (loss and global gradient norm); ``TP_DROP_STEPS`` at dropout 0.1 at
    ``sizes["qa"]`` (their times, the peak, the bytes each tp collective
    moved, the fingerprints); one DPR step at dropout 0 at
    ``sizes["dpr"]``. Batches are global: each replica feeds its slice of
    the ``n_questions`` training questions (one set for the ranks and one
    process: the shuffled order depends on it)."""
    from emdr2_tpu_torch.config import OptimizerConfig
    from emdr2_tpu_torch.tasks import E2EQATask, e2eqa
    from emdr2_tpu_torch.tasks.dense_retriever import DPRTask
    from emdr2_tpu_torch.utils.timing import StageTimer

    rank, world = (dp.rank, dp.world_size) if dp is not None else (0, 1)
    ranks = {"rank": rank, "world_size": world}
    out = {"ms": {}}
    tok, corpus, index = _dp_world(cfg, tmpdir, dev, TP_N_ROWS, TP_N_DOCS,
                                   dp)
    ds = _qa_dataset(cfg, tok, tmpdir, n_questions)
    opt = OptimizerConfig(lr=2e-5, weight_decay=0.1, clip_grad=1.0,
                          warmup=0.0)

    def moved():
        if dp is None:
            return {}
        return {f"tp_{k}": v for k, v in dp.tp.bytes_moved.items()} | {
            f"dp_{k}": v for k, v in dp.bytes_moved.items()} | {
            f"world_{k}": v for k, v in dp.world.bytes_moved.items()}

    def run_steps(name, task, batches):
        losses, norms, ms = [], [], []
        before = moved()
        _reset_peak(dev)
        for batch in batches:
            _sync(dev)
            t0 = time.perf_counter()
            m = task.train_step(batch)
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
            norms.append(float(m["grad_norm"]))
        after = moved()
        out[name] = dict(loss=losses, grad_norm=norms, ms=ms,
                         peak=_peak(dev), stage_ms=dict(task.timer.ms),
                         bytes_per_step={k: (after[k] - before.get(k, 0))
                                         / len(batches) for k in after})

    for rate in (0.0, 0.1):
        qcfg, _ = _tp_cfg(cfg, rate)
        bs = sizes["check_qa"] if rate == 0.0 else sizes["qa"]
        qcfg = qcfg.replace(train=dataclasses.replace(
            qcfg.train, batch_size=bs, optimizer=opt))
        task = E2EQATask(qcfg, tok, corpus, index, total_train_iters=1000,
                         device=dev, dp=dp, timer=StageTimer(dev))
        task.init_state(SEED)
        if rate == 0.0:
            rec = []
            metric = e2eqa.metric_max_over_ground_truths

            def recording(m, text, refs):
                rec.append(text)
                return metric(m, text, refs)

            e2eqa.metric_max_over_ground_truths = recording
            try:
                t0 = time.perf_counter()
                em = task.evaluate_em(
                    _qa_dataset(cfg, tok, tmpdir, TP_EVAL_QUESTIONS),
                    batch_size=sizes["eval"], kv_quant="int8")
                out["ms"]["evaluate_em"] = (time.perf_counter() - t0) * 1e3
            finally:
                e2eqa.metric_max_over_ground_truths = metric
            out["em"] = dict(em=em, texts=rec)
        steps = TP_CHECK_STEPS if rate == 0.0 else TP_DROP_STEPS
        run_steps(f"openqa_{rate}", task,
                  list(ds.epoch_batches(bs, seed=SEED, **ranks))[:steps])
        if rate > 0:
            out["whole_params"], out["all_params"] = _split_fingerprints(
                task.state.model)
        del task
        _empty_cache(dev)
    del index
    _empty_cache(dev)
    _, rcfg = _tp_cfg(cfg, 0.0)
    task = DPRTask(rcfg, opt, 1000, device=dev, dp=dp, timer=StageTimer(dev))
    task.init_state(SEED)
    run_steps("dpr_0.0", task, _dpr_batches(cfg, tmpdir, sizes["dpr"], 1,
                                             rank=rank, world=world))
    del task
    _empty_cache(dev)
    return out


def tp_kernel_checks(dev, gen):
    """K1 (forward, backward), K2 (forward, backward) and K5 on a tp
    rank's 6 heads (a [B, L, 3H/2] slab, H/2 = 384) at the shapes the tp
    path gives them, each against its plain version on the same inputs."""
    from emdr2_tpu_torch.ops import decode_attention as da
    from emdr2_tpu_torch.ops import fid_attention as fa
    nh, H = 6, 384
    out = {}
    qkv = torch.randn(8, 512, 3 * H, device=dev, generator=gen
                      ).to(torch.bfloat16)
    lens = torch.randint(1, 513, (8,), device=dev, generator=gen)
    bias = torch.where(torch.arange(512, device=dev)[None] < lens[:, None],
                       0.0, -1e9).float()
    dout = torch.randn(8, 512, H, device=dev, generator=gen
                       ).to(torch.bfloat16)
    got, stats = fa.flash_self_attention_forward(qkv, bias, nh, DROP_SEED,
                                                 RATE)
    want = fa.flash_self_attention_reference(qkv, bias, nh, DROP_SEED, RATE)
    out["k1_fwd"] = _check("K1-fwd at 6 heads", got, want, FWD_TOL)
    dq = fa.flash_self_attention_backward(qkv, bias, got, dout, nh,
                                          DROP_SEED, RATE, stats)
    dwant = fa.flash_self_attention_bwd_reference(qkv, bias, got, dout, nh,
                                                  DROP_SEED, RATE)
    out["k1_bwd"] = _check("K1-bwd at 6 heads", dq, dwant)
    del qkv, dout, dq, dwant
    q = torch.randn(2, 32, H, device=dev, generator=gen).to(torch.bfloat16)
    kv = torch.randn(2, 25_600, 2 * H, device=dev, generator=gen
                     ).to(torch.bfloat16)
    kb = torch.zeros(2, 25_600, device=dev)
    kb[:, 24_000:] = -1e9
    dout = torch.randn(2, 32, H, device=dev, generator=gen
                       ).to(torch.bfloat16)
    o, lse = fa.flash_cross_attention_forward(q, kv, kb, nh, 512, DROP_SEED,
                                              RATE)
    ow, lw = fa.flash_cross_attention_reference(q, kv, kb, nh, 512,
                                                DROP_SEED, RATE)
    out["k2_fwd"] = _check("K2-fwd at 6 heads", o, ow, FWD_TOL)
    g = fa.flash_cross_attention_backward(q, kv, kb, lse, o, dout, nh, 512,
                                          DROP_SEED, RATE)
    gw = fa.flash_cross_attention_bwd_reference(q, kv, kb, lse, o, dout, nh,
                                                512, DROP_SEED, RATE)
    out["k2_bwd_dq"] = _check("K2-bwd dq at 6 heads", g[0], gw[0])
    out["k2_bwd_dkv"] = _check("K2-bwd dkv at 6 heads", g[1], gw[1])
    del kv, g, gw
    qd = torch.randn(8, 1, nh, 64, device=dev, generator=gen
                     ).to(torch.bfloat16)
    kf = torch.randn(8, nh, 25_600, 64, device=dev, generator=gen)
    vf = torch.randn(8, nh, 25_600, 64, device=dev, generator=gen)
    k8, ks = da.quantize_kv_rows(kf)
    v8, vs = da.quantize_kv_rows(vf)
    db = torch.zeros(8, 25_600, device=dev)
    got = da.decode_cross_attention_int8(qd, k8, ks, v8, vs, db)
    want = da.decode_cross_attention_int8_plain(qd, k8, ks, v8, vs, db)
    out["k5"] = _check("K5 at 6 heads", got, want, FWD_TOL)
    _empty_cache(dev)
    log("tp kernel checks at a rank's 6 heads (max abs err, mean, max "
        "|ref|): " + ", ".join(f"{k} {v[0]:.3e}/{v[1]:.3e}/{v[2]:.3e}"
                               for k, v in out.items()))
    return out


def tp_phase(cfg, dev, cards=False, layout=None, timeout=900):
    """The ranks of a ``[dp, tp]`` grid as subprocesses of this script
    against one process from the same state. Default (one card): two
    gloo ranks share ``dev`` at ``--tp 2`` (``TP_SHARED``); ``cards=True``
    (``--dp-cards 4``): NCCL, rank r on card r, at ``layout`` (one of
    ``TP_CARDS``). Held: the losses and global gradient norms of the
    check steps at dropout 0 within ``DP_LOSS_RTOL`` / ``DP_GRAD_RTOL``
    of one process at the same global batch; after the steps at dropout
    0.1 the parameters every tp rank holds whole bit-equal on the tp
    ranks of a replica, and each rank's parameters bit-equal to its
    counterpart's in another replica; K1, K2, K3 and K5 launched on every
    rank; the DPR step's loss and norm within the same limits."""
    sizes = dict(layout or TP_SHARED)
    dp_n, tp_n = sizes["dp"], sizes["tp"]
    world = dp_n * tp_n
    what = (f"(cards: dp {dp_n} x tp {tp_n} over "
            f"{'NCCL' if dev.type == 'cuda' else 'gloo'})" if cards
            else f"(one card: tp {tp_n} over gloo)")
    # one process: the check steps at the same global batch, the timed
    # steps at a replica's batch (what one card holds)
    ref_sizes = dict(sizes, qa=sizes["qa"] // dp_n)
    n_questions = max(TP_EVAL_QUESTIONS, sizes["qa"] * TP_DROP_STEPS,
                      sizes["check_qa"] * TP_CHECK_STEPS)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmpdir:
        ref = _tp_runs(cfg, dev, tmpdir, ref_sizes, n_questions)
    ref_s = time.perf_counter() - t0
    _empty_cache(dev)
    own = cards and dev.type == "cuda"
    t0 = time.perf_counter()
    got = _run_ranks(cfg, f"tp {what}", timeout, {
        "kind": "tp", "tp": tp_n,
        "devices": ([f"cuda:{r}" for r in range(world)] if own
                    else [str(dev)] * world),
        "world": world, "backend": "nccl" if own else "gloo",
        "sizes": sizes, "n_questions": n_questions})
    ranks_s = time.perf_counter() - t0
    checks, limits = {}, {}
    for name, steps in (("openqa", TP_CHECK_STEPS), ("dpr", 1)):
        for key, limit in (("loss", DP_LOSS_RTOL),
                           ("grad_norm", DP_GRAD_RTOL)):
            for step in range(steps):
                want = ref[f"{name}_0.0"][key][step]
                checks[f"{name}_{key}_{step + 1}_rel"] = max(
                    abs(g[f"{name}_0.0"][key][step] - want) / abs(want)
                    for g in got)
                limits[f"{name}_{key}_{step + 1}_rel"] = limit
    grid = {(g["dp_rank"], g["tp_rank"]): g for g in got}
    checks["whole_params_equal_over_tp"] = all(
        g["whole_params"] == grid[(d, 0)]["whole_params"]
        for (d, _), g in grid.items())
    checks["replicas_equal_over_dp"] = all(
        g["all_params"] == grid[(0, t)]["all_params"]
        for (_, t), g in grid.items())
    # the kernels launch on a card only (the plain versions run on the
    # CPU, where this phase rehearses)
    missing = [(r, k) for r, g in enumerate(got) for k in TP_COUNTED
               if g["launches"][k] <= 0 and dev.type == "cuda"]
    # a replica's texts: its rows of each evaluation batch
    per, n_eval = sizes["eval"] // dp_n, len(ref["em"]["texts"])
    checks["texts_equal_share"] = []
    for g in got:
        d = g["dp_rank"]
        want = [t for i in range(0, n_eval, sizes["eval"])
                for t in ref["em"]["texts"][i + d * per:i + (d + 1) * per]]
        checks["texts_equal_share"].append(
            sum(a == b for a, b in zip(g["em"]["texts"], want))
            / max(len(want), 1))
    for r, g in enumerate(got):
        o = g["openqa_0.1"]
        log(f"tp {what} rank {r} (dp {g['dp_rank']}, tp {g['tp_rank']}): "
            f"OPENQA step ms at dropout 0.1 (B={sizes['qa']} global) "
            + ", ".join(f"{m:.1f}" for m in o["ms"])
            + f"; peak {o['peak'] / 2**30:.2f} GiB; bytes a step "
            f"{o['bytes_per_step']}; stages " + _stages_text(o["stage_ms"])
            + f"; check steps {g['openqa_0.0']['ms']} ms; DPR B="
            f"{sizes['dpr']} {g['dpr_0.0']['ms']} ms (peak "
            f"{g['dpr_0.0']['peak'] / 2**30:.2f} GiB); evaluate_em "
            f"{g['ms']['evaluate_em']:.1f} ms EM {g['em']['em']}; "
            f"{g['seconds']:.1f} s; launches {g['launches']}")
    log(f"tp {what} one process (references, {ref_s:.1f} s): OPENQA B="
        f"{ref_sizes['qa']} step ms {ref['openqa_0.1']['ms']} peak "
        f"{ref['openqa_0.1']['peak'] / 2**30:.2f} GiB; check steps B="
        f"{sizes['check_qa']} {ref['openqa_0.0']['ms']} ms peak "
        f"{ref['openqa_0.0']['peak'] / 2**30:.2f} GiB; DPR "
        f"{ref['dpr_0.0']['ms']} ms; EM {ref['em']['em']}")
    log(f"tp {what} {world} ranks ({ranks_s:.1f} s): the check steps "
        f"relative to one process: "
        + ", ".join(f"{k} {checks[k]:.3e}" for k in limits)
        + f" (limits: loss {DP_LOSS_RTOL}, grad_norm {DP_GRAD_RTOL}); "
        f"values one process / rank 0: " + ", ".join(
            f"{name}_{key} {ref[f'{name}_0.0'][key]} / "
            f"{got[0][f'{name}_0.0'][key]}" for name in ("openqa", "dpr")
            for key in ("loss", "grad_norm"))
        + f"; whole parameters bit-equal over tp after {TP_DROP_STEPS} "
        f"steps at dropout 0.1: {checks['whole_params_equal_over_tp']}; "
        f"replicas bit-equal over dp: {checks['replicas_equal_over_dp']}; "
        f"generated texts equal to one process's (greedy int8, a share "
        f"by rank) {checks['texts_equal_share']}")
    failures = [k for k, limit in limits.items() if not checks[k] <= limit]
    failures += [k for k in ("whole_params_equal_over_tp",
                             "replicas_equal_over_dp") if not checks[k]]
    failures += [f"{k} never launched on rank {r}" for r, k in missing]
    if failures:
        raise AssertionError(f"tp {what} failed: {failures}")
    return {"ref_seconds": ref_s, "ranks_seconds": ranks_s, "ranks": got,
            "ref": ref, "checks": checks, "sizes": sizes,
            "launches_by_rank": [dict(g["launches"]) for g in got]}


# the measurement tools' phase: every tool of emdr2_tpu_torch/tools/bench_*
# through its main(argv), at EMDR2Config() widths and full depth, grids and
# iterations cut to fit TOOLS_BUDGET_S
TOOLS_BUDGET_S = 360
TOOLS_SWEEP_ROWS = (["--bs", "8,16", "--policies", "full", "--residency",
                     "int8"],
                    ["--bs", "8", "--policies", "towers", "--residency",
                     "none"])
TOOLS_EMBED_DOCS = 16_384


def _share_ok(x) -> bool:
    return x is not None and 0.0 < x <= 1.0


def tools_phase(dev):
    """18. The port's measurement tools (``emdr2_tpu_torch/tools/bench_*``),
    each through ``main(argv)`` on the card: the rescore tool (its two
    window selections at k 20 and 51 give the same rows, the default
    window's rows equal an exact search up to the k3 phase's ties, and the
    recall of ``rescore=0`` beside it), the kernel sweep (K4 on the cross
    shape: chunks 256 and 512 give times), the step breakdown (every
    pass's share of the peak in (0, 1], and the whole step's), the dropout
    breakdown, a cut train sweep (each row's share in (0, 1] or an
    out-of-memory row), and the pipeline's stages A and B, ``--refresh``,
    ``--embed``, ``--overlap``, ``--decode`` and one decode-sweep row."""
    from emdr2_tpu_torch.ops import mips
    from emdr2_tpu_torch.tools import (bench_dropout_breakdown,
                                       bench_kernel_sweep, bench_mips_rescore,
                                       bench_pipeline, bench_step_breakdown,
                                       bench_train_sweep, flagship)
    t_phase = time.perf_counter()
    seconds = {}
    on = ["--device", str(dev)]
    icfg = flagship.base_config().index
    group = icfg.group_size

    def timed(name, fn):
        t0 = time.perf_counter()
        r = fn()
        seconds[name] = time.perf_counter() - t0
        log(f"tools: {name} in {seconds[name]:.1f} s")
        return r

    _reset_counts()
    # rescore: the two selections agree; the default window against an
    # exact search (float64 sums), misses only where the k3 phase allows
    res = timed("bench_mips_rescore",
                lambda: bench_mips_rescore.main(["--iters", "5"] + on))
    qf, q8, scales = res[0]["inputs"]
    n = q8.shape[0]
    rows_f = mips.dequantize_int8(q8, scales, group)
    oracle_vals, oracle = _exact_top(qf, rows_f, n, max(bench_mips_rescore.KS))
    del rows_f
    for k in bench_mips_rescore.KS:
        by = {r["row"]["window_select"]: r for r in res if r["row"]["k"] == k}
        blocked, exact = by["blocked"]["ids"], by["exact_topk"]["ids"]
        if not np.array_equal(np.sort(blocked, 1), np.sort(exact, 1)):
            raise AssertionError(f"tools rescore k={k}: the blocked window "
                                 f"and the exact top-M give other rows")
        ex = explain_misses(blocked, oracle[:, :k + K3_EXTRA],
                            oracle_vals[:, :k + K3_EXTRA], k, ties=True,
                            group=group)
        _, ids0 = mips.mips_topk(qf, q8, k, chunk_rows=icfg.chunk_rows,
                                 group_size=group, shard_scales=scales,
                                 rescore=0)
        recall0 = bench_mips_rescore.recall(ids0.cpu().numpy(),
                                            by["blocked"]["ref"])
        log(f"tools rescore k={k}: {by['blocked']['row']} / "
            f"{by['exact_topk']['row']}; against an exact search: "
            f"{misses_text(ex, k)}; recall with rescore=0 {recall0:.6f}")
        if ex["unexplained"]:
            raise AssertionError(f"tools rescore k={k}: {misses_text(ex, k)}")
    del res, qf, q8, scales, oracle, oracle_vals
    _empty_cache(dev)

    sweep = timed("bench_kernel_sweep", lambda: bench_kernel_sweep.main(
        ["--batch", "8", "--iters", "5"] + on))
    for chunk in (256, 512):
        row = next(r for r in sweep if r.get("key_chunk") == chunk)
        if "fwd_bwd_ms" not in row:
            raise AssertionError(f"tools kernel sweep chunk {chunk}: {row}")
    _empty_cache(dev)

    bd = timed("bench_step_breakdown", lambda: bench_step_breakdown.main(
        ["--batch", "8", "--iters", "3"] + on))
    rows = bd["breakdown"]
    cfg = flagship.flagship_step_config(8, 50)
    step_flops = flagship.model_flops_per_step(cfg, 8, 50)
    full_share = flagship.share_of_peak(
        step_flops, rows["full_step"]["ms"] / 1e3, flagship.peak_flops(dev))
    log(f"tools step breakdown: {json.dumps(bd)}; the whole step "
        f"{step_flops / 1e12:.1f} model TFLOP in {rows['full_step']['ms']} "
        f"ms: {full_share} of the peak")
    for name in ("retriever_fwdbwd", "reader_fwdbwd", "teacher_fwd"):
        if not _share_ok(rows[name]["util_vs_peak"]):
            raise AssertionError(f"tools step breakdown {name}: "
                                 f"{rows[name]}")
    if not _share_ok(full_share):
        raise AssertionError(f"tools step breakdown: step share {full_share}")
    _empty_cache(dev)

    drop = timed("bench_dropout_breakdown",
                 lambda: bench_dropout_breakdown.main(["--iters", "3"]
                                                      + on))
    for r in drop:
        if "ms_per_step" not in r:
            raise AssertionError(f"tools dropout breakdown: {r}")

    train = []
    for argv in TOOLS_SWEEP_ROWS:
        train += timed("bench_train_sweep " + " ".join(argv),
                       lambda a=argv: bench_train_sweep.main(
                           a + ["--iters", "2"] + on))
    for r in train:
        oom = "OutOfMemoryError" in r.get("error", "")
        if not (oom or _share_ok(r.get("model_flops_util"))):
            raise AssertionError(f"tools train sweep: {r}")

    for argv in (["--iters", "5", "--decode"], ["--iters", "3", "--refresh"],
                 ["--embed", "--n-docs", str(TOOLS_EMBED_DOCS)],
                 ["--iters", "3", "--overlap"]):
        timed("bench_pipeline " + " ".join(argv),
              lambda a=argv: bench_pipeline.main(a + on))
        _empty_cache(dev)
    row = timed("bench_pipeline --decode-sweep-row 8:1:int8", lambda:
                bench_pipeline.main(["--iters", "3", "--decode-sweep-row",
                                     "8:1:int8"] + on))
    if "error" in row:
        raise AssertionError(f"tools decode sweep row: {row}")
    launches = _read_counts(list(_counters()))
    phase_s = time.perf_counter() - t_phase
    log(f"tools phase: {phase_s:.1f} s (budget {TOOLS_BUDGET_S} s); "
        f"launches {launches}")
    _empty_cache(dev)
    return dict(launches=launches, seconds=seconds, phase_s=phase_s)


def _flagship_cfg():
    from emdr2_tpu_torch.config import EMDR2Config, IndexConfig
    from emdr2_tpu_torch.config import with_flash_attention
    return with_flash_attention(EMDR2Config(index=IndexConfig(
        quantize="int8")))


KERNEL_CLASSES = (
    ("K1 flash self-attention", ("RowMaxInv",)),
    ("K4 general flash attention", ("aflash::Lse",)),
    ("K2 flash cross-attention", ("::cross_",)),
    ("K3, K5", ("candidate_scan", "::decode_")),
    ("matrix products (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma",
                                  "cublas")),
    ("integer elementwise (the plain dropout hash)",
     ("<int, int, int", "Bitwise", "bitwise", "shift")),
    ("reductions", ("reduce_kernel",)),
    ("copies and casts", ("copy_kernel", "Memcpy", "Memset")),
    ("other elementwise", ("elementwise_kernel",)),
)


def kernel_class(name: str) -> str:
    for label, words in KERNEL_CLASSES:
        if any(w in name for w in words):
            return label
    return "other"


def profile_call(fn, table_name, n_top=15):
    """One warm call of ``fn`` under torch.profiler: (device ms summed over
    kernels, wall ms, the top kernels by device time); the operator table
    goes to ``chiprun_out/<table_name>``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # kernels only: an operator's row repeats the device time of the
    # kernels it launched; a kernel's own row has no CPU time
    averages = prof.key_averages()
    events = [e for e in averages
              if dev_us(e) > 0 and e.self_cpu_time_total == 0]
    events.sort(key=dev_us, reverse=True)
    total_ms = sum(dev_us(e) for e in events) / 1e3
    top = [(e.key, dev_us(e) / 1e3, e.count) for e in events[:n_top]]
    # the same device time by the operator that launched the kernels
    ops = sorted((e for e in averages
                  if dev_us(e) > 0 and e.self_cpu_time_total > 0),
                 key=dev_us, reverse=True)
    by_op = [(e.key, dev_us(e) / 1e3, e.count) for e in ops[:2 * n_top]]
    classes = {}
    for e in events:
        label = kernel_class(e.key)
        classes[label] = classes.get(label, 0.0) + dev_us(e) / 1e3
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", table_name), "w") as f:
        f.write(averages.table(sort_by="self_cuda_time_total", row_limit=60))
    return dict(device_ms=total_ms, wall_ms=wall_ms, top=top, by_op=by_op,
                classes=classes)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="profile one more warm train step (also at B=4 "
                         "under each remat policy, and a DPR step under "
                         "each layout), one warm "
                         "greedy batch with each cross-K/V form, K4-fwd "
                         "beside SDPA, K4's backward through autograd by "
                         "both routes, and K1's kernels at each shape")
    ap.add_argument("--dp-cards", type=int, default=None,
                    help="run only the data-parallel phase, over NCCL with "
                         "this many ranks, one a card, against one card at "
                         "the same batch a rank")
    ap.add_argument("--dp-rank", type=int, default=None,
                    help=argparse.SUPPRESS)   # a rank of the ranks phase
    ap.add_argument("--dp-spec", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.dp_rank is not None:
        sys.path.insert(0, REPO)
        return dp_rank_main(args.dp_spec, args.dp_rank)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from emdr2_tpu_torch.config import with_transformers
    from emdr2_tpu_torch.ops import build, mips

    card = gpu_name_and_power()
    log(f"nvidia-smi name, power.limit: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    # reference products in true fp32 (stated and set, for matmul and conv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t_start = time.perf_counter()

    info = build.build(extra_flags=("-Xptxas", "-v"))
    log(f"kernel build: {info['seconds']:.1f} s (built={info['built']}) "
        f"-> {os.path.relpath(info['path'], REPO)}")
    if args.dp_cards is not None:
        return dp_cards_main(args.dp_cards, dev, card, t_start)
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log("  ptxas:", line.strip())
    flash_kernel_report(info["log"])

    k1 = k1_phase(dev, gen)
    k1_drop = k1_dropout_phase(dev, gen)
    k1_bwd = k1_bwd_phase(dev, gen, profile=args.profile)
    k2 = k2_phase(dev, gen)
    k2_split = k2_split_phase(dev, gen)
    k3 = k3_phase(dev, gen)
    k4 = k4_phase(dev, gen, profile=args.profile)
    k4_bwd = k4_bwd_phase(dev, gen, profile=args.profile)
    k5 = k5_phase(dev, gen)
    torch.cuda.empty_cache()

    cfg = _flagship_cfg()
    res = slice_phase(cfg, dev, gen, profile=args.profile)
    for name, ms in res["stage_ms"].items():
        log(f"slice stage {name}: " + ", ".join(f"{m:.2f}" for m in ms)
            + " ms per batch")
    log(f"slice ask: {len(res['answers'])} answers in {res['ask_s']:.3f} s, "
        f"peak memory {res['peak_bytes'] / 2**30:.2f} GiB, launches "
        f"{res['launches']}; first answers {res['answers'][:2]!r}")
    for name, n in res["launches"].items():
        if n <= 0:
            raise AssertionError(f"{name} never launched during ask")
    gn = res["generation"]
    for run in ("greedy_int8", "beam5_int8"):
        r = gn[run]
        for name, ms in r["stage_ms"].items():
            log(f"generation {run} stage {name}: "
                + ", ".join(f"{m:.2f}" for m in ms) + " ms per batch")
        log(f"generation {run}: {len(r['answers'])} answers in "
            f"{r['ask_s']:.3f} s, peak memory "
            f"{r['peak_bytes'] / 2**30:.2f} GiB, launches {r['launches']}; "
            f"first answers {r['answers'][:2]!r}")
        for name, n in r["launches"].items():
            if n <= 0:
                raise AssertionError(f"{name} never launched during the "
                                     f"{run} generation run")
    log(f"generation: cross K/V slab of a batch of 8, 12 layers: "
        f"{gn['slab_bytes']['bf16'] / 1e9:.3f} GB as fp32 K + bf16 V, "
        f"{gn['slab_bytes']['int8'] / 1e9:.3f} GB as int8 + scales; int8 "
        f"greedy answers equal to the bf16-path ones: "
        f"{gn['greedy_int8']['share_equal_bf16']:.4f}; first decode step "
        f"log-probs, int8 against bf16 path: max abs diff "
        f"{gn['step_logprob_max_diff']:.3e}")
    for what, prof in gn.get("profiles", {}).items():
        log_profile(f"warm batch of 8, {what}", prof)
    del gn
    gc.collect()
    torch.cuda.empty_cache()

    # the flagship recipe: --remat --no-remat-towers (reader stacks
    # checkpointed, towers stored), dropout 0.1 (the config defaults)
    tcfg = with_transformers(cfg, {"remat": False}, {"remat": True})
    tr = train_phase(tcfg, dev, gen, batch=8, profile=args.profile)
    for name, ms in tr["stage_ms"].items():
        log(f"train stage {name}: " + ", ".join(f"{m:.2f}" for m in ms)
            + " ms per step")
    log(f"train: peak memory {tr['peak_bytes'] / 2**30:.2f} GiB, launches "
        f"during {len(tr['metrics'])} steps {tr['launches']}")
    for name, n in tr["launches"].items():
        if n <= 0:
            raise AssertionError(f"{name} never launched during the steps")
    gc.collect()
    torch.cuda.empty_cache()

    # evaluation under --flash-key-chunk 256: rows longer than the chunk
    # (the reader's 512 tokens) run the general flash kernel
    chunked = {"flash_key_chunk": 256}
    ev = eval_phase(with_transformers(cfg, chunked, chunked), dev, gen)
    evl = ev["launches"]
    for name, ms in ev["stage_ms"].items():
        log(f"eval stage {name}: " + ", ".join(f"{m:.2f}" for m in ms)
            + " ms")
    log(f"eval: evaluate_em greedy int8 EM {ev['em']:.4f} n {ev['n']} in "
        f"{ev['seconds']['evaluate_em']:.3f} s; beam 5 EM "
        f"{ev['em_beam']:.4f} n {ev['n_beam']} in "
        f"{ev['seconds']['evaluate_em_beam']:.3f} s; validation_loss "
        f"{ev['val']} in {ev['seconds']['validation_loss']:.3f} s; peak "
        f"memory {ev['peak_bytes'] / 2**30:.2f} GiB, launches "
        f"{ev['launches']}")
    log("eval: one batch's losses, flash kernels against materialized "
        "attention: " + ", ".join(f"{k} {g:.6f} / {w:.6f}"
                                  for k, (g, w) in ev["agree"].items()))
    for name, n in ev["launches"].items():
        if n <= 0:
            raise AssertionError(f"{name} never launched during evaluation")

    del ev
    gc.collect()
    torch.cuda.empty_cache()

    # the training loop under --flash-key-chunk 256, --remat
    # --no-remat-towers: prefetcher, checkpoints, evaluation callback
    eg = engine_phase(with_transformers(tcfg, chunked, chunked), dev, gen)
    for name, ms in eg["stage_ms"].items():
        log(f"engine stage {name}: " + ", ".join(f"{m:.2f}" for m in ms)
            + " ms")
    log("engine: ms per iteration with prefetch "
        + ", ".join(f"{h['ms_per_iter']:.1f}" for h in eg["history"])
        + " (the third also stages the interval checkpoint, the fourth "
        "runs beside its write); without prefetch "
        + ", ".join(f"{h['ms_per_iter']:.1f}" for h in eg["plain_history"])
        + f"; {len(eg['history'])} iterations, saves and the evaluation in "
        f"{eg['train_s']:.3f} s; peak memory "
        f"{eg['peak_bytes'] / 2**30:.2f} GiB")
    log(f"engine: evaluation callback {eg['evals']}")
    ck = eg["checkpoint"]
    log(f"engine: checkpoint {ck['bytes'] / 1e9:.3f} GB; async stage "
        f"{ck['async_stage_s']:.3f} s, background write "
        f"{ck['background_write_s']:.3f} s, synchronous save "
        f"{ck['sync_save_s']:.3f} s, load into a fresh task "
        f"{ck['load_s']:.3f} s; {eg['n_compared']} restored tensors equal "
        f"bit for bit; the step after the restore: {eg['resumed']}")
    log(f"engine: launches {eg['launches']} (one step should launch K4-bwd "
        f"12, K4-fwd 36, K1-fwd 36, K1-bwd 24, K2-fwd 36, K2-bwd 12, K3 1)")
    for name, n in eg["launches"].items():
        if n <= 0:
            raise AssertionError(f"{name} never launched in the engine phase")

    gc.collect()
    torch.cuda.empty_cache()

    # the evidence-index build, its live refresh in the loop, and the
    # command line around them
    ix = index_phase(cfg, dev, gen)
    rf = refresh_phase(tcfg, dev, gen)
    log("refresh: ms per iteration with an embed pass in flight "
        + ", ".join(f"{m:.1f}" for m in rf["with_embed"])
        + "; without " + ", ".join(f"{m:.1f}" for m in rf["without"])
        + "; with no refresher " + ", ".join(
            f"{h['ms_per_iter']:.1f}" for h in rf["plain_history"])
        + f"; {len(rf['history'])} iterations in {rf['train_s']:.3f} s")
    log(f"refresh: {len(rf['pass_s'])} completed embed passes while "
        f"training: " + ", ".join(f"{s:.3f} s ({p:.1f} passages/s)"
                                  for s, p in zip(rf["pass_s"],
                                                  rf["per_s"]))
        + "; swaps (iteration, ms of maybe_swap on the trainer thread) "
        + ", ".join(f"({i}, {ms:.1f})" for i, ms in rf["swaps"])
        + f"; refresh_count {rf['refresh_count']}; peak memory "
        f"{rf['peak_bytes'] / 2**30:.2f} GiB; launches {rf['launches']}")
    log(f"refresh: the index swapped at iteration {rf['first_swap']} "
        f"against the hand-off tower's embedding: max abs err "
        f"{rf['check_err']:.3e} = {rf['check_steps']:.3f} int8 steps of "
        f"its group (limit: one step + {FWD_TOL[0]} x max|ref|)")
    for name in ("flash_self_attention", "candidate_scan"):
        if rf["launches"][name] <= 0:
            raise AssertionError(f"{name} never launched in the refresh "
                                 f"phase")
    cl = cli_phase(cfg, dev)
    log(f"cli: seconds {cl['seconds']}; {cl['valid']}; create_doc_index "
        f"launches {cl['index_launches']}; run launches {cl['launches']}; "
        f"QAPipeline.load answers {cl['answers'][:2]!r}")
    for name in ("flash_self_attention", "flash_self_attention_backward",
                 "flash_cross_attention", "flash_cross_attention_backward",
                 "candidate_scan"):
        if cl["launches"][name] <= 0:
            raise AssertionError(f"{name} never launched by the command line")
    if cl["index_launches"]["flash_self_attention"] <= 0:
        raise AssertionError("create_doc_index never launched K1-fwd")

    # the RETRIEVER task (DPR training under the three remat layouts), the
    # retrieval evaluation at NQ-test's size, the OPENQA step under
    # dots_no_batch, and the RETRIEVER command line with its tools
    dp = dpr_phase(cfg, dev, profile=args.profile)
    _empty_cache(dev)
    rv = retrieval_eval_phase(cfg, dev, gen)
    remat_b4 = {}
    for policy in ("nothing", "dots_no_batch"):
        pcfg = with_transformers(cfg, {"remat": False},
                                 {"remat": True, "remat_policy": policy})
        r = train_phase(pcfg, dev, gen, batch=4, steps=2,
                        profile=args.profile,
                        profile_table=f"train_step_profile_b4_{policy}.txt")
        remat_b4[policy] = r
        if r["top"] is not None:
            log_profile(f"warm train step at B=4, {policy}", r["top"])
        log(f"train B=4 --remat-policy {policy}: " + "; ".join(
            f"{name} " + ", ".join(f"{m:.2f}" for m in ms)
            for name, ms in r["stage_ms"].items())
            + f" ms; peak memory {r['peak_bytes'] / 2**30:.2f} GiB; "
            f"launches {r['launches']}")
        for name, n in r["launches"].items():
            if n <= 0:
                raise AssertionError(f"{name} never launched in the B=4 "
                                     f"{policy} steps")
        _empty_cache(dev)
    rcl = retriever_cli_phase(cfg, dev)
    _empty_cache(dev)

    # C5: a DPR step and an OPENQA step, each twice from one state, bit
    # for bit; then data parallelism: one rank over NCCL against the plain
    # path, two ranks sharing the card over gloo against one process
    c5 = c5_phase(cfg, tcfg, dev, gen)
    dpa = dp_one_rank_phase(cfg, dev)
    dpb = dp_ranks_phase(cfg, dev)
    # a launch across hosts: two emulated hosts of one rank each, both
    # seeing card 0, placed by torchrun's variables, held to (b)'s
    # one-process references
    _empty_cache(dev)
    hs = hosts_phase(cfg, dev, dpb)
    # the asynchronous refresh and prefetch across ranks: two ranks share
    # the card over gloo, each with its embedder on it (--embed-devices 0)
    _empty_cache(dev)
    emb = embedder_phase(tcfg, dev)
    eml = emb["launches"]
    # tensor parallelism: two gloo ranks share the card at --tp 2, each on
    # its 6 of the 12 heads (the kernels checked at those shapes first)
    _empty_cache(dev)
    tpk = tp_kernel_checks(dev, gen)
    t0 = time.perf_counter()
    tp = tp_phase(_flagship_cfg(), dev)
    log(f"tp phase: {time.perf_counter() - t0:.1f} s (one process "
        f"{tp['ref_seconds']:.1f} s, the ranks {tp['ranks_seconds']:.1f} s)")
    # the measurement tools, each through its main(argv)
    _empty_cache(dev)
    tools = tools_phase(dev)
    c5l, dpl = c5["launches"], dict(dpb["launches"])
    for name, n in dpa["launches"].items():
        dpl[name] = dpl.get(name, 0) + n
    dpl["candidate_scan"] += sum(s["launches"]
                                 for s in dpa["search"].values())
    for name in ("flash_self_attention", "flash_self_attention_backward",
                 "flash_cross_attention", "flash_cross_attention_backward",
                 "candidate_scan", "decode_cross_attention_int8"):
        if dpl[name] <= 0:
            raise AssertionError(f"{name} never launched on the "
                                 f"data-parallel path")

    if tr["top"] is not None:
        log_profile("warm train step", tr["top"])

    k1_main = k1[-1]                                   # [400, 512, 2304]
    k1_embed = next(r for r in k1 if (r["B"], r["L"]) == (128, 256))
    k1_dpr = {f"{B}x{L}": next(r for r in k1 if (r["B"], r["L"]) == (B, L))
              for B, L in ((128, 64), (256, 256))}
    k1_bwd_dpr = {f"{B}x{L}": next(r for r in k1_bwd
                                   if (r["B"], r["L"]) == (B, L))
                  for B, L in ((128, 64), (256, 256))}
    k1_bwd_main = k1_bwd[-1]                           # [400, 512]
    k2_main = next(r for r in k2 if r["shape"] == "reader"
                   and r["chunk"] == 512 and r["rate"] == RATE)
    k2_bwd256 = next(r for r in k2 if r["shape"] == "reader"
                     and r["chunk"] == 256 and r["rate"] == RATE)
    k2_teacher = next(r for r in k2 if r["shape"] == "teacher"
                      and r["rate"] == RATE)
    k2_chunk256 = next(r for r in k2_split if r["shape"] == "reader256"
                       and r["rate"] == RATE)
    k3_main = next(r for r in k3["rows"] if r["dtype"] == "int8"
                   and r["nq"] == 8)
    k3_tc = {f"{r['dtype']}_nq{r['nq']}": r for r in k3["rows"]
             if r["route"] == "tensor_core"}
    dpr_launches = {name: lay["launches"]
                    for name, lay in dp["layouts"].items()}
    k4_main = next(r for r in k4 if r["shape"] == "reader"
                   and r["rate"] == 0.0)
    k4_drop = next(r for r in k4 if r["shape"] == "reader"
                   and r["rate"] == RATE)
    k5_greedy = next(r for r in k5 if r["shape"] == "greedy")
    k5_beam = next(r for r in k5 if r["shape"] == "beam5")
    serve, train, eng = res["launches"], tr["launches"], eg["launches"]
    k4_bwd_main = next(r for r in k4_bwd if r["shape"] == "reader"
                       and r["rate"] == RATE)
    gen_greedy = res["generation"]["greedy_int8"]["launches"]
    gen_beam = res["generation"]["beam5_int8"]["launches"]
    csrc = "emdr2_tpu_torch/ops/csrc/"
    # "launches": the count on the first path that runs the kernel (serving
    # for K1-fwd and K3, training for K1-bwd and K2, generation with beam 5
    # for K5, evaluation for K4-fwd, the engine for K4-bwd); the other
    # paths' counts beside it
    summary = {"kernels": [
        {"name": "flash_self_attention", "route": "cuda",
         "launches_c5": c5l["flash_self_attention"],
         "launches_dp": dpl["flash_self_attention"],
         "launches_embedder": eml["flash_self_attention"],
         "launches_engine": eng["flash_self_attention"],
         "source": csrc + "flash_self_attention.cu",
         "replaces": "emdr2_tpu/ops/fid_attention.py:383",
         "launches": serve["flash_self_attention"],
         "launches_train": train["flash_self_attention"],
         "launches_generation": gen_beam["flash_self_attention"],
         "launches_eval": evl["flash_self_attention"],
         "max_abs_err": max(r["max_abs_err"] for r in k1 + [k1_drop]),
         "ms": k1_main["ms"], "plain_ms": k1_main["plain_ms"],
         "bound_ms": k1_main["bound_ms"], "bound_by": k1_main["bound_by"],
         "library_ms": k1_main["library_ms"],
         "ms_dropout": k1_drop["ms"], "plain_ms_dropout": k1_drop["plain_ms"],
         "launches_refresh": rf["launches"]["flash_self_attention"],
         "launches_index_build": ix["host"]["launches"],
         "launches_dpr": {name: n["flash_self_attention"]
                          for name, n in dpr_launches.items()},
         "launches_retrieval_eval":
             rv["int8"]["launches"]["flash_self_attention"],
         "dpr_shapes": {key: {f: r[f] for f in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
             for key, r in k1_dpr.items()},
         "ms_embedder": k1_embed["ms"],
         "plain_ms_embedder": k1_embed["plain_ms"],
         "bound_ms_embedder": k1_embed["bound_ms"],
         "library_ms_embedder": k1_embed["library_ms"]},
        {"name": "flash_self_attention_backward", "route": "cuda",
         "launches_c5": c5l["flash_self_attention_backward"],
         "launches_dp": dpl["flash_self_attention_backward"],
         "launches_embedder": eml["flash_self_attention_backward"],
         "launches_engine": eng["flash_self_attention_backward"],
         "source": csrc + "flash_self_attention.cu",
         "replaces": "emdr2_tpu/ops/fid_attention.py:414",
         "launches": train["flash_self_attention_backward"],
         "launches_dpr": {name: n["flash_self_attention_backward"]
                          for name, n in dpr_launches.items()},
         "dpr_shapes": {key: {f: r[f] for f in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
             for key, r in k1_bwd_dpr.items()},
         "max_abs_err": max(r["max_abs_err"] for r in k1_bwd),
         "ms": k1_bwd_main["ms"], "plain_ms": k1_bwd_main["plain_ms"],
         "bound_ms": k1_bwd_main["bound_ms"],
         "bound_by": k1_bwd_main["bound_by"],
         "library_ms": k1_bwd_main["library_ms"]},
        {"name": "flash_cross_attention", "route": "cuda",
         "launches_c5": c5l["flash_cross_attention"],
         "launches_dp": dpl["flash_cross_attention"],
         "launches_embedder": eml["flash_cross_attention"],
         "launches_engine": eng["flash_cross_attention"],
         "source": csrc + "flash_cross_attention.cu",
         "replaces": "emdr2_tpu/ops/fid_attention.py:562",
         "launches": train["flash_cross_attention"],
         "launches_eval": evl["flash_cross_attention"],
         "max_abs_err": max(r["max_abs_err"] for r in k2 + k2_split),
         "ms": k2_main["ms"], "plain_ms": k2_main["plain_ms"],
         "bound_ms": k2_main["bound_ms"], "bound_by": k2_main["bound_by"],
         "library_ms": k2_main["library_ms"],
         "ms_teacher": k2_teacher["ms"],
         "library_ms_teacher": k2_teacher["library_ms"],
         "ms_key_chunk_256": k2_chunk256["ms"]},
        {"name": "flash_cross_attention_backward", "route": "cuda",
         "launches_c5": c5l["flash_cross_attention_backward"],
         "launches_dp": dpl["flash_cross_attention_backward"],
         "launches_embedder": eml["flash_cross_attention_backward"],
         "launches_engine": eng["flash_cross_attention_backward"],
         "source": csrc + "flash_cross_attention.cu",
         "replaces": "emdr2_tpu/ops/fid_attention.py:612",
         "launches": train["flash_cross_attention_backward"],
         "max_abs_err": max(r["bwd_max_abs_err"] for r in k2 + k2_split
                            if "bwd_max_abs_err" in r),
         "ms": k2_main["bwd_ms"], "plain_ms": k2_main["bwd_plain_ms"],
         "bound_ms": k2_main["bwd_bound_ms"],
         "bound_by": k2_main["bwd_bound_by"],
         "library_ms": k2_main["bwd_library_ms"],
         "ms_key_chunk_256": k2_bwd256["bwd_ms"],
         "plain_ms_key_chunk_256": k2_bwd256["bwd_plain_ms"],
         "bound_ms_key_chunk_256": k2_bwd256["bwd_bound_ms"],
         "library_ms_key_chunk_256": k2_bwd256["bwd_library_ms"],
         "ms_teacher": k2_teacher["bwd_ms"],
         "ms_by_runs": {str(n): t for n, t
                        in k2_main["bwd_ms_by_runs"].items()}},
        {"name": "candidate_scan", "route": "cuda",
         "launches_c5": c5l["candidate_scan"],
         "launches_dp": dpl["candidate_scan"],
         "launches_embedder": eml["candidate_scan"],
         "launches_engine": eng["candidate_scan"],
         "source": csrc + "candidate_scan.cu",
         "replaces": "emdr2_tpu/ops/mips.py:116",
         "launches": serve["candidate_scan"],
         "launches_train": train["candidate_scan"],
         "launches_generation": gen_beam["candidate_scan"],
         "launches_eval": evl["candidate_scan"],
         "launches_refresh": rf["launches"]["candidate_scan"],
         "max_abs_err": max(r["max_abs_err"]
                            for r in k3["rows"] + k3["sweep"]),
         "ms": k3_main["ms"], "plain_ms": k3_main["plain_ms"],
         "bound_ms": k3_main["bound_ms"], "bound_by": k3_main["bound_by"],
         "library_ms": None,
         # the tensor-core route (candidate_scan.cu's mma.sync kernel)
         "launches_tensor_core_retrieval_eval":
             rv["int8"]["launches"]["candidate_scan_tensor_core"]
             + rv["bf16"]["launches"]["candidate_scan_tensor_core"],
         "tensor_core": {key: {f: r[f] for f in (
             "ms", "plain_ms", "matmul_ms", "bound_ms", "bound_by",
             "max_abs_err")} for key, r in k3_tc.items()},
         "crossover_nq": k3["crossover"],
         "tensor_core_min_nq": {str(t).replace("torch.", ""): n for t, n
                                in mips.TENSOR_CORE_MIN_NQ.items()},
         "kernels": k3["kernels"], "sass": k3["sass"],
         "topk_split_ms": k3["split"],
         "bf16_widest_tie_eps": k3["bf16_ties"],
         "crossover_sweep_ms": k3["sweep"]},
        {"name": "decode_cross_attention_int8", "route": "cuda",
         "launches_c5": c5l["decode_cross_attention_int8"],
         "launches_dp": dpl["decode_cross_attention_int8"],
         "launches_embedder": eml["decode_cross_attention_int8"],
         "launches_engine": eng["decode_cross_attention_int8"],
         "source": csrc + "decode_attention.cu",
         "replaces": "emdr2_tpu/ops/decode_attention.py:105",
         "launches": gen_beam["decode_cross_attention_int8"],
         "launches_generation_greedy":
             gen_greedy["decode_cross_attention_int8"],
         "launches_eval": evl["decode_cross_attention_int8"],
         "max_abs_err": max(r["max_abs_err"] for r in k5),
         "ms": k5_beam["ms"], "plain_ms": k5_beam["plain_ms"],
         "bound_ms": k5_beam["bound_ms"], "bound_by": k5_beam["bound_by"],
         "library_ms": None,            # no PyTorch call reads the int8 slab
         "sdpa_bf16_slab_ms": k5_beam["sdpa_bf16_ms"],
         "ms_queued": k5_beam["queued_ms"],
         "ms_one_row": k5_greedy["ms"],
         "ms_queued_one_row": k5_greedy["queued_ms"],
         "plain_ms_one_row": k5_greedy["plain_ms"],
         "bound_ms_one_row": k5_greedy["bound_ms"],
         "sdpa_bf16_slab_ms_one_row": k5_greedy["sdpa_bf16_ms"]},
        {"name": "fid_cross_attention", "route": "cuda",
         "launches_c5": c5l["fid_cross_attention"],
         "launches_dp": dpl["fid_cross_attention"],
         "launches_embedder": eml["fid_cross_attention"],
         "launches_engine": eng["fid_cross_attention"],
         "source": csrc + "fid_attention.cu",
         "replaces": "emdr2_tpu/ops/fid_attention.py:68",
         "launches": evl["fid_cross_attention"],
         "max_abs_err": max(r["max_abs_err"] for r in k4),
         "ms": k4_main["ms"], "plain_ms": k4_main["plain_ms"],
         "bound_ms": k4_main["bound_ms"], "bound_by": k4_main["bound_by"],
         "library_ms": k4_main["library_ms"],
         "ms_dropout": k4_drop["ms"], "plain_ms_dropout": k4_drop["plain_ms"]},
        {"name": "fid_cross_attention_backward", "route": "cuda",
         "launches_c5": c5l["fid_cross_attention_backward"],
         "launches_dp": dpl["fid_cross_attention_backward"],
         "launches_embedder": eml["fid_cross_attention_backward"],
         "source": csrc + "fid_attention.cu",
         "replaces": "emdr2_tpu/ops/fid_attention.py:120",
         "launches": eng["fid_cross_attention_backward"],
         "max_abs_err": max(r["max_abs_err"] for r in k4_bwd),
         "ms": k4_bwd_main["ms"], "plain_ms": k4_bwd_main["plain_ms"],
         "bound_ms": k4_bwd_main["bound_ms"],
         "bound_by": k4_bwd_main["bound_by"],
         "library_ms": k4_bwd_main["library_ms"],
         "ms_rate_0": next(r["ms"] for r in k4_bwd if r["shape"] == "reader"
                           and r["rate"] == 0.0),
         "slab_route_backward_ms": k4_bwd_main["slab_route_ms"],
         "three_tensor_route_backward_ms":
             k4_bwd_main["three_tensor_route_ms"],
         "slab_route_backward_bytes": k4_bwd_main["slab_route_bytes"],
         "three_tensor_route_backward_bytes":
             k4_bwd_main["three_tensor_route_bytes"]},
    ]}
    # each kernel's launches on the tp path, by rank, and its error at a
    # rank's 6 heads where it was checked there
    tp_err = {"flash_self_attention": "k1_fwd",
              "flash_self_attention_backward": "k1_bwd",
              "flash_cross_attention": "k2_fwd",
              "flash_cross_attention_backward": "k2_bwd_dq",
              "decode_cross_attention_int8": "k5"}
    for row in summary["kernels"]:
        row["launches_tp"] = [n.get(row["name"], 0)
                              for n in tp["launches_by_rank"]]
        if row["name"] in tp_err:
            row["max_abs_err_6_heads"] = tpk[tp_err[row["name"]]][0]
        row["launches_hosts"] = hs["launches"].get(row["name"], 0)
        row["launches_tools"] = tools["launches"][row["name"]]
    log(f"chip_smoke total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps(summary))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
