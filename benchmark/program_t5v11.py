"""What the T5 v1.1 cells take from the program under test
(``emdr2_tpu_torch``): its configuration built from a configuration file
whose reader is given by HF's T5 keys (``d_model``, ``d_ff``, ...), as
``benchmark/configs/atlas-large-nq.json`` gives it. A program without T5
v1.1's block fails here, at once."""

from __future__ import annotations

import dataclasses

from benchmark.program import DTYPES, emdr2_config as megatron_config


def reader(t: dict):
    """The program's ``TransformerConfig`` of a T5 v1.1 reader."""
    from emdr2_tpu_torch.config import t5_v11
    if t["num_decoder_layers"] != t["num_layers"] \
            or t["feed_forward_proj"] != "gated-gelu" \
            or t["tie_word_embeddings"] \
            or t["d_model"] != t["num_heads"] * t["d_kv"]:
        raise ValueError("the program's T5 v1.1 block has as many decoder "
                         "as encoder layers, a gated-gelu FFN, an untied "
                         "head and d_model = num_heads * d_kv")
    return t5_v11(
        vocab_size=t["vocab_size"], hidden_size=t["d_model"],
        num_layers=t["num_layers"], num_heads=t["num_heads"],
        ffn_size=t["d_ff"], layernorm_epsilon=t["layer_norm_epsilon"],
        hidden_dropout=t["dropout_rate"], attention_dropout=t["dropout_rate"],
        relative_buckets=t["relative_attention_num_buckets"],
        relative_max_distance=t["relative_attention_max_distance"],
        init_std=t["initializer_factor"], dtype=DTYPES[t["compute_dtype"]],
        remat=t["remat"], remat_policy="nothing",
        fid_flash_attention=t["flash_attention"],
        flash_key_chunk=t["flash_key_chunk"])


def emdr2_config(cfg: dict):
    """The program's ``EMDR2Config`` of a configuration file with a T5
    v1.1 reader: ``program.emdr2_config``'s, the reader's block replaced."""
    out = megatron_config(dict(cfg, reader=cfg["retriever"]))
    return out.replace(reader=dataclasses.replace(
        out.reader, transformer=reader(cfg["reader"])))
