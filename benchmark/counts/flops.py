"""The benchmark's yardstick of work: frozen copies of the port's FLOP
formulas (``emdr2_tpu_torch/tools/flagship.py``: ``layer_self_flops``,
``decoder_stack_flops``, ``model_flops_per_step``), of its peak table and
of ``chip_smoke.py:bound()``, with the embedder's forward FLOPs and the
attention work of each cell's shapes added. Later changes to the program
do not move this yardstick.

Counts are of the useful work: matmul FLOPs of one forward (x3 for the
passes that carry a gradient, forward and backward; recompute is not
counted), and for attention the bytes of each input read once and each
output written once.
"""

from __future__ import annotations

from typing import List, Tuple

# NVIDIA's data sheet, H100 SXM at its 700 W limit, dense rates
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "int8": 1979e12,
                              "hbm_bytes_per_s": 3.35e12},
}


def layer_self_flops(S, H, F):
    """One self-attention layer over S tokens: qkv, QK, PV, out, MLP."""
    return 8 * S * H * H + 4 * S * S * H + 4 * S * H * F


def decoder_stack_flops(S, Lk, H, F, n_layers):
    """Self + cross-attention decoder stack over S tokens and Lk keys."""
    cross = (4 * S * H * H + 4 * Lk * H * H + 4 * S * Lk * H)
    return n_layers * (layer_self_flops(S, H, F) + cross)


def model_flops_per_step(r: dict, t: dict, B: int, K: int, Lq: int, Lc: int,
                         Lr: int, Ld: int) -> float:
    """One OPENQA train step: forward + 2x backward for the passes that
    carry a gradient (query and context towers, FiD encoder, student
    decoder and LM head), forward only for the stop-gradient teacher.
    ``r`` / ``t``: the retriever's and the reader's widths."""
    He, Fe, Le = r["hidden_size"], r["ffn_size"], r["num_layers"]
    Ht, Ft, Lt = t["hidden_size"], t["ffn_size"], t["num_layers"]
    V = t["vocab_size"]
    query_tower = B * Le * layer_self_flops(Lq, He, Fe)
    ctx_tower = B * K * Le * layer_self_flops(Lc, He, Fe)
    fid_encoder = B * K * Lt * layer_self_flops(Lr, Ht, Ft)
    student_dec = (B * decoder_stack_flops(Ld, K * Lr, Ht, Ft, Lt)
                   + 2 * B * Ld * Ht * V)
    teacher = (B * K * Lt * layer_self_flops(Lr, Ht, Ft)
               + B * K * decoder_stack_flops(Ld, Lr, Ht, Ft, Lt)
               + 2 * B * K * Ld * Ht * V)
    grad_carrying = query_tower + ctx_tower + fid_encoder + student_dec
    return 3.0 * grad_carrying + 1.0 * teacher


def embed_flops_per_passage(r: dict, Lc: int) -> float:
    """The context tower's forward over one passage of Lc tokens."""
    return r["num_layers"] * layer_self_flops(Lc, r["hidden_size"],
                                              r["ffn_size"])


def bound(n_bytes: float, n_ops: float, peak: dict,
          op_type: str = "bf16") -> Tuple[float, str]:
    """(seconds, "bytes" | "operations"): the least time the card could
    take to move ``n_bytes`` and do ``n_ops`` operations of ``op_type``."""
    by_bytes = n_bytes / peak["hbm_bytes_per_s"]
    by_ops = n_ops / peak[op_type]
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


# ------------------------------------------------------ attention's work

def self_attention_fwd(rows, L, H, nh, stats: bool) -> Tuple[float, float]:
    """(FLOPs, bytes) of one flash self-attention forward over ``rows``
    sequences of L tokens: bf16 q, k, v read, the fp32 key bias read, the
    bf16 output written, and with ``stats`` (a backward follows) two fp32
    statistics a row and head written."""
    act = rows * L * H * 2
    nbytes = 4 * act + rows * L * 4 + (rows * nh * L * 8 if stats else 0)
    return 4.0 * rows * L * L * H, nbytes


def self_attention_bwd(rows, L, H, nh) -> Tuple[float, float]:
    """Its backward: twice the forward's products; q, k, v, out, dout, the
    bias and the statistics read, dq, dk, dv written."""
    act = rows * L * H * 2
    return (8.0 * rows * L * L * H,
            8 * act + rows * L * 4 + rows * nh * L * 8)


def cross_attention_fwd(rows, Lq, Lk, H, nh) -> Tuple[float, float]:
    """One flash cross-attention forward: ``rows`` examples of Lq queries
    over Lk keys of a [k | v] slab; q, kv and the bias read, the output
    and the fp32 log-sum-exp written."""
    q, kv = rows * Lq * H * 2, rows * Lk * 2 * H * 2
    return (4.0 * rows * Lq * Lk * H,
            2 * q + kv + rows * Lk * 4 + rows * Lq * nh * 4)


def cross_attention_bwd(rows, Lq, Lk, H, nh) -> Tuple[float, float]:
    """Its backward: q, kv, out, dout, the bias and the log-sum-exp read,
    dq and dkv written."""
    q, kv = rows * Lq * H * 2, rows * Lk * 2 * H * 2
    return (8.0 * rows * Lq * Lk * H,
            5 * q + 2 * kv + rows * Lk * 4 + rows * Lq * nh * 4)


def least_seconds(calls: List[Tuple[float, float, int]], peak: dict) -> float:
    """Sum over (FLOPs, bytes, count) of count x the kernel call's bound."""
    return sum(n * bound(b, f, peak)[0] for f, b, n in calls)


def train_step_attention(r: dict, t: dict, B: int, K: int, Lq: int, Lc: int,
                         Lr: int, Ld: int) -> List[Tuple[float, float, int]]:
    """The flash attention calls one OPENQA step needs, counted once:
    stage A's query tower (forward); stage C's query and context towers,
    FiD encoder and student cross-attention (forward and backward); the
    teacher's encoder and cross-attention (forward). The decoder's causal
    self-attention is materialized, no flash call."""
    He, nhe, Le = r["hidden_size"], r["num_heads"], r["num_layers"]
    Ht, nht, Lt = t["hidden_size"], t["num_heads"], t["num_layers"]
    return [
        (*self_attention_fwd(B, Lq, He, nhe, False), Le),
        (*self_attention_fwd(B, Lq, He, nhe, True), Le),
        (*self_attention_bwd(B, Lq, He, nhe), Le),
        (*self_attention_fwd(B * K, Lc, He, nhe, True), Le),
        (*self_attention_bwd(B * K, Lc, He, nhe), Le),
        (*self_attention_fwd(B * K, Lr, Ht, nht, True), Lt),
        (*self_attention_bwd(B * K, Lr, Ht, nht), Lt),
        (*cross_attention_fwd(B, Ld, K * Lr, Ht, nht), Lt),
        (*cross_attention_bwd(B, Ld, K * Lr, Ht, nht), Lt),
        (*self_attention_fwd(B * K, Lr, Ht, nht, False), Lt),
        (*cross_attention_fwd(B * K, Ld, Lr, Ht, nht), Lt),
    ]


def embed_batch_attention(r: dict, batch: int, Lc: int
                          ) -> List[Tuple[float, float, int]]:
    """The context tower's flash self-attention over one batch (no
    gradient: no statistics)."""
    return [(*self_attention_fwd(batch, Lc, r["hidden_size"],
                                 r["num_heads"], False), r["num_layers"])]
