"""The yardstick of work of an OPENQA step whose reader is T5 v1.1
(``atlas-large-nq``): matmul FLOPs of one forward, x3 for the passes that
carry a gradient and x1 for the stop-gradient teacher, as
``flops.model_flops_per_step`` counts them for the Megatron reader, with
T5 v1.1's layers: the gated FFN's three matrices, the relative-position
bias and the norms not counted (no product). Recompute is not counted."""

from __future__ import annotations

from benchmark.counts.flops import layer_self_flops


def t5_self_flops(S, H, F):
    """One T5 v1.1 encoder layer over S tokens: qkv, QK, PV, out, and the
    gated FFN (two input matrices, one output)."""
    return 8 * S * H * H + 4 * S * S * H + 6 * S * H * F


def t5_decoder_flops(S, Lk, H, F, n_layers):
    """Self + cross-attention decoder stack over S tokens and Lk keys."""
    cross = 4 * S * H * H + 4 * Lk * H * H + 4 * S * Lk * H
    return n_layers * (t5_self_flops(S, H, F) + cross)


def model_flops_per_step(r: dict, t: dict, B: int, K: int, Lq: int, Lc: int,
                         Lr: int, Ld: int) -> float:
    """One train step: the BERT towers of ``r`` (the retriever's widths)
    and the T5 v1.1 reader of ``t`` (HF's keys)."""
    He, Fe, Le = r["hidden_size"], r["ffn_size"], r["num_layers"]
    Ht, Ft, V = t["d_model"], t["d_ff"], t["vocab_size"]
    Lenc, Ldec = t["num_layers"], t["num_decoder_layers"]
    query_tower = B * Le * layer_self_flops(Lq, He, Fe)
    ctx_tower = B * K * Le * layer_self_flops(Lc, He, Fe)
    fid_encoder = B * K * Lenc * t5_self_flops(Lr, Ht, Ft)
    student_dec = (B * t5_decoder_flops(Ld, K * Lr, Ht, Ft, Ldec)
                   + 2 * B * Ld * Ht * V)
    teacher = (B * K * Lenc * t5_self_flops(Lr, Ht, Ft)
               + B * K * t5_decoder_flops(Ld, Lr, Ht, Ft, Ldec)
               + 2 * B * K * Ld * Ht * V)
    grad_carrying = query_tower + ctx_tower + fid_encoder + student_dec
    return 3.0 * grad_carrying + 1.0 * teacher
