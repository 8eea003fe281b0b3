"""What the measurement tools (``tools/bench_*.py``) share: the port's own
copy of the parts of the JAX package's root ``bench.py`` that its tools
import (``flagship_step_config``, ``make_flagship_step``, the FLOP
formulas), and the card's peak rates.

- :func:`flagship_step_config` / :func:`make_flagship_step`: the flagship
  NQ recipe's train step (BERT-base towers, T5-base FiD reader, K=50,
  sequence lengths 512/256/64/32, flash attention everywhere, the reader
  rematerialised, the towers only when asked), with weights from a seed
  and a batch of ids drawn from ``np.random.RandomState(0)``.
- :func:`layer_self_flops`, :func:`decoder_stack_flops`,
  :func:`model_flops_per_step`: analytic matmul FLOPs of the model's
  useful work, ``bench.py``'s formulas; :func:`pass_flops` splits a step's
  by pass as ``bench_step_breakdown`` times them.
- :data:`PEAK_OPS_PER_S`, :data:`MEMORY_BYTES_PER_S`: peak rates and the
  device memory's rate by ``torch.cuda.get_device_name()``; a card not in
  the tables has no peak (shares print as ``null``). :func:`bound_ms`: the
  least time the card could take for a kernel's bytes and operations.
- :func:`seconds_per_call`: the tools' host-clock timer around whole calls;
  :func:`event_ms`: the one kernel timer (CUDA events around one call, or
  around calls queued back to back); :func:`card_name_and_power`: the line
  every on-card run prints beside its numbers.
- :data:`SHARD_ROWS`: the index rows a card holds in the reference's
  layout (21M passages over 16 GPUs), the size of every tool's index.

Every tool starts from :func:`base_config` (``EMDR2Config()``; the CPU
tests put ``tiny_config()`` in its place) and times on the host clock
around work that ends in a synchronize of the card.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from emdr2_tpu_torch.config import EMDR2Config

# the reference's shard a GPU (21,015,324 passages over 16 GPUs, in whole
# 128-row groups): the index every tool searches or holds
SHARD_ROWS = 1_310_720

# dense peak rates (NVIDIA's data sheet, SXM part at its 700 W limit), by
# the name torch.cuda.get_device_name() gives; no entry for other cards
PEAK_OPS_PER_S = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "int8": 1979e12},
}
# the device memory's rate, same data sheet
MEMORY_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

EOS_ID = 102        # bench.py's eos id for the train step

REPO = pathlib.Path(__file__).resolve().parents[2]


def base_config() -> EMDR2Config:
    """The configuration every tool starts from."""
    return EMDR2Config()


def device_kind(device: torch.device) -> str:
    """The card's name (``torch.cuda.get_device_name``), or ``"cpu"``."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def peak_flops(device: torch.device, op_type: str = "bf16"
               ) -> Optional[float]:
    """The card's peak rate for ``op_type`` from :data:`PEAK_OPS_PER_S`, or
    None (the CPU, or a card not in the table)."""
    if device.type != "cuda":
        return None
    return PEAK_OPS_PER_S.get(device_kind(device), {}).get(op_type)


def share_of_peak(flops: float, seconds: float, peak: Optional[float]
                  ) -> Optional[float]:
    """``flops / seconds / peak`` rounded as the JAX tools print it, or
    None without a peak (or without work)."""
    if not peak or not flops:
        return None
    return round(flops / seconds / peak, 3)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def seconds_per_call(fn: Callable[[], object], iters: int,
                     device: torch.device, warmup: int = 1) -> float:
    """Mean host seconds of ``fn()`` over ``iters`` calls after ``warmup``
    calls, between synchronizes of ``device``."""
    for _ in range(warmup):
        fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync(device)
    return (time.perf_counter() - t0) / iters


def event_ms(fn: Callable[[], object], reps: int = 10, warmup: int = 2,
             calls: int = 1) -> float:
    """Median ms a call of ``fn`` over ``reps`` runs after ``warmup``
    calls, each run ``calls`` calls queued back to back on the current CUDA
    stream between two events. One call holds the wrapper's host work where
    that outlasts its kernels; ten queued calls hide it under the device's
    time and give the kernels' own."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float, device: torch.device,
             op_type: str = "bf16") -> Tuple[Optional[float], Optional[str]]:
    """(ms, ``"bytes"`` or ``"operations"``): the least time ``device``
    could take to move ``n_bytes`` (each input read once, each output
    written once) and to do ``n_ops`` operations of ``op_type``, by its
    data sheet; (None, None) for a card not in the tables."""
    kind = device_kind(device)
    rate, peak = MEMORY_BYTES_PER_S.get(kind), peak_flops(device, op_type)
    if rate is None or peak is None:
        return None, None
    by_bytes, by_ops = n_bytes / rate * 1e3, n_ops / peak * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def card_name_and_power() -> str:
    """``nvidia-smi``'s name and power limit of the cards, one line each:
    a card set below its maximum runs slower under load."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def child_row(module: str, args: List[str]
              ) -> Tuple[Optional[dict], str]:
    """Run ``python -m module *args`` in a process of its own, from the
    repository's root (a row that fails leaves nothing behind in the next
    row's process: its memory, its allocator's cache, its kernels' state).
    Returns (the last line of its standard output as JSON, or None, and
    what went wrong: its exit code and the last line of its errors). Its
    errors are copied to this process's."""
    r = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                       capture_output=True, text=True)
    sys.stderr.write(r.stderr)
    lines = [ln for ln in r.stdout.splitlines() if ln.strip()]
    try:
        return json.loads(lines[-1]), ""
    except (IndexError, json.JSONDecodeError):
        tail = r.stderr.strip().splitlines()[-1:]
        return None, f"rc={r.returncode}: {tail}"


def append_row(path: Optional[str], row: dict) -> None:
    """Append ``row`` as a JSON line to ``path`` (nothing without one)."""
    if path:
        with open(path, "a") as f:
            f.write(json.dumps(row) + "\n")


def read_rows(path: Optional[str]) -> List[dict]:
    """The JSON rows of ``path`` (none when it is not given or absent)."""
    if not path or not pathlib.Path(path).exists():
        return []
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def flagship_step_config(B: int = 4, K: int = 50,
                         remat_policy: str = "nothing",
                         remat_towers: bool = False,
                         hidden_dropout: Optional[float] = None,
                         attention_dropout: Optional[float] = None
                         ) -> EMDR2Config:
    """The flagship NQ recipe (``examples/openqa/emdr2_nq.sh``): flash
    attention in the towers and the reader, the reader's layers
    rematerialised (``--remat``), the towers storing their activations
    (``--no-remat-towers``) unless ``remat_towers``; ``topk=K``. The
    dropout rates replace the configuration's where given. ``B`` sizes
    nothing in the configuration (the JAX signature)."""
    del B
    cfg = base_config()
    drops = {}
    if hidden_dropout is not None:
        drops["hidden_dropout"] = hidden_dropout
    if attention_dropout is not None:
        drops["attention_dropout"] = attention_dropout
    enc = dataclasses.replace(cfg.retriever.encoder, remat=remat_towers,
                              remat_policy=remat_policy,
                              fid_flash_attention=True, **drops)
    t5 = dataclasses.replace(cfg.reader.transformer, remat=True,
                             remat_policy=remat_policy,
                             fid_flash_attention=True, **drops)
    return cfg.replace(
        retriever=dataclasses.replace(cfg.retriever, encoder=enc),
        reader=dataclasses.replace(cfg.reader, transformer=t5),
        index=dataclasses.replace(cfg.index, topk=K))


def flagship_batch(cfg: EMDR2Config, B: int, K: int, device: torch.device,
                   seed: int = 0):
    """``bench.py``'s batch: ids from ``np.random.RandomState(seed)`` in
    [2, 30000) (below the smallest vocabulary when that is smaller), in its
    order of draws; context types 0, loss mask 1."""
    from emdr2_tpu_torch.models.emdr2 import EMDR2Batch
    rng = np.random.RandomState(seed)
    high = min(30000, cfg.retriever.encoder.vocab_size,
               cfg.reader.transformer.vocab_size)

    def ids(*shape):
        return torch.as_tensor(rng.randint(2, high, size=shape),
                               dtype=torch.long).to(device)

    Lq, Lc = cfg.retriever.query_seq_len, cfg.retriever.seq_len
    Lr, Ld = cfg.reader.seq_len, cfg.reader.decoder_seq_len
    return EMDR2Batch(
        query_bert_ids=ids(B, Lq),
        context_bert_ids=ids(B, K, Lc),
        context_bert_types=torch.zeros((B, K, Lc), dtype=torch.long,
                                       device=device),
        reader_ids=ids(B, K, Lr),
        reader_one_ctx_ids=ids(B, K, Lr),
        dec_ids=ids(B, Ld),
        labels=ids(B, Ld),
        loss_mask=torch.ones((B, Ld), dtype=torch.float32, device=device))


def make_flagship_step(B: int = 4, K: int = 50,
                       remat_policy: str = "nothing",
                       remat_towers: bool = False,
                       hidden_dropout: Optional[float] = None,
                       attention_dropout: Optional[float] = None,
                       device="cuda"):
    """(step_fn, state, batch) for the flagship shape on ``device``:
    ``training.step.make_train_step``'s step, a ``TrainState`` with weights
    from seed 0 and the AdamW of the recipe over 10,000 iterations, and
    :func:`flagship_batch`. ``step_fn(state, batch) -> (state, metrics)``
    updates the state in place."""
    from emdr2_tpu_torch.models.emdr2 import EMDR2Model
    from emdr2_tpu_torch.training import step as step_lib
    from emdr2_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    cfg = flagship_step_config(B, K, remat_policy, remat_towers,
                               hidden_dropout, attention_dropout)
    batch = flagship_batch(cfg, B, K, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    model = EMDR2Model(cfg, device=device, generator=gen)
    optimizer = step_lib.make_optimizer(model, cfg.train.optimizer, 10000)
    state = step_lib.TrainState(step=0, seed=0, model=model,
                                optimizer=optimizer)
    return step_lib.make_train_step(cfg, eos_id=EOS_ID), state, batch


def layer_self_flops(S, H, F):
    """Matmul FLOPs of one self-attention transformer layer over S tokens:
    qkv + scores(QK) + mix(PV) + out + mlp(in+out)."""
    return 8 * S * H * H + 4 * S * S * H + 4 * S * H * F


def decoder_stack_flops(S, Lk, H, F, n_layers):
    """Self + cross-attention decoder stack over S tokens and Lk keys:
    cross = q/out projections + fused kv projection over Lk + QK/PV."""
    cross = (4 * S * H * H + 4 * Lk * H * H + 4 * S * Lk * H)
    return n_layers * (layer_self_flops(S, H, F) + cross)


def pass_flops(cfg: EMDR2Config, B: int, K: int) -> Dict[str, float]:
    """Analytic FLOPs of each pass of a step: the retriever's forward and
    backward (query and context towers, x3), the reader's (FiD encoder,
    student decoder and LM head, x3) and the stop-gradient teacher's
    forward (encoder over B*K rows, decoder over B*K x Ld, LM head). They
    sum to :func:`model_flops_per_step`."""
    enc, t5 = cfg.retriever.encoder, cfg.reader.transformer
    Lq, Lc = cfg.retriever.query_seq_len, cfg.retriever.seq_len
    Lr, Ld = cfg.reader.seq_len, cfg.reader.decoder_seq_len
    V = t5.vocab_size
    ret = 3 * (B * enc.num_layers * layer_self_flops(Lq, enc.hidden_size,
                                                     enc.ffn_size)
               + B * K * enc.num_layers * layer_self_flops(
                   Lc, enc.hidden_size, enc.ffn_size))
    reader = 3 * (B * K * t5.num_layers * layer_self_flops(
        Lr, t5.hidden_size, t5.ffn_size)
        + B * decoder_stack_flops(Ld, K * Lr, t5.hidden_size, t5.ffn_size,
                                  t5.num_layers)
        + 2 * B * Ld * t5.hidden_size * V)
    teacher = (B * K * t5.num_layers * layer_self_flops(Lr, t5.hidden_size,
                                                        t5.ffn_size)
               + B * K * decoder_stack_flops(Ld, Lr, t5.hidden_size,
                                             t5.ffn_size, t5.num_layers)
               + 2 * B * K * Ld * t5.hidden_size * V)
    return {"retriever": ret, "reader": reader, "teacher": teacher}


def model_flops_per_step(cfg: EMDR2Config, B: int, K: int) -> float:
    """Analytic matmul FLOPs of one train step, the model's useful work
    (classic MFU is measured against it; remat's recompute is not counted):
    forward + 2x backward for the gradient-carrying passes (query and
    context towers, FiD encoder, student decoder + LM head), forward only
    for the stop-gradient teacher. Attention scores, projections, MLPs and
    LM heads; embedding lookups, layernorms and softmaxes excluded."""
    enc = cfg.retriever.encoder
    t5 = cfg.reader.transformer
    Lq = cfg.retriever.query_seq_len
    Lc = cfg.retriever.seq_len
    Lr = cfg.reader.seq_len
    Ld = cfg.reader.decoder_seq_len

    def stack_self(S, H, F, n_layers):
        return n_layers * layer_self_flops(S, H, F)

    He, Fe = enc.hidden_size, enc.ffn_size
    Ht, Ft = t5.hidden_size, t5.ffn_size
    V = t5.vocab_size

    query_tower = B * stack_self(Lq, He, Fe, enc.num_layers)
    ctx_tower = B * K * stack_self(Lc, He, Fe, enc.num_layers)
    fid_encoder = B * K * stack_self(Lr, Ht, Ft, t5.num_layers)
    student_dec = (B * decoder_stack_flops(Ld, K * Lr, Ht, Ft, t5.num_layers)
                   + 2 * B * Ld * Ht * V)              # LM head
    teacher = (B * K * stack_self(Lr, Ht, Ft, t5.num_layers)      # encoder
               + B * K * decoder_stack_flops(Ld, Lr, Ht, Ft, t5.num_layers)
               + 2 * B * K * Ld * Ht * V)
    grad_carrying = query_tower + ctx_tower + fid_encoder + student_dec
    return 3.0 * grad_carrying + 1.0 * teacher
