"""What the drivers take from the program under test (``emdr2_tpu_torch``):
its configuration built from a configuration file's numbers, and the ids
its tokenizer would give the world's special tokens. Nothing of the JAX
package."""

from __future__ import annotations

import types

import torch

from benchmark.world import special_ids

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def transformer(c: dict):
    from emdr2_tpu_torch.config import TransformerConfig
    return TransformerConfig(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        num_layers=c["num_layers"], num_heads=c["num_heads"],
        ffn_size=c["ffn_size"],
        max_position_embeddings=c["max_position_embeddings"],
        num_tokentypes=c["num_tokentypes"],
        hidden_dropout=c["hidden_dropout"],
        attention_dropout=c["attention_dropout"],
        layernorm_epsilon=c["layernorm_epsilon"], init_std=c["init_std"],
        gelu_variant=c["gelu"], dtype=DTYPES[c["compute_dtype"]],
        remat=c["remat"], remat_policy="nothing",
        fid_flash_attention=c["flash_attention"],
        flash_key_chunk=c["flash_key_chunk"])


def emdr2_config(cfg: dict):
    """The program's ``EMDR2Config`` of a configuration file."""
    from emdr2_tpu_torch import config as C
    retr = C.RetrieverConfig(encoder=transformer(cfg["retriever"]),
                             embed_dim=cfg["embed_dim"],
                             seq_len=cfg["context_seq_len"],
                             query_seq_len=cfg["query_seq_len"])
    out = C.EMDR2Config(retriever=retr,
                        index=C.IndexConfig(embed_dim=cfg["embed_dim"]))
    if "reader" in cfg:
        o = cfg["optimizer"]
        out = out.replace(
            reader=C.ReaderConfig(transformer=transformer(cfg["reader"]),
                                  seq_len=cfg["reader_seq_len"],
                                  decoder_seq_len=cfg["decoder_seq_len"]),
            index=C.IndexConfig(embed_dim=cfg["embed_dim"],
                                topk=cfg["topk"],
                                group_size=cfg["index_group_size"],
                                quantize=cfg["index_quantize"],
                                chunk_rows=cfg.get("index_chunk_rows", 8192)),
            train=C.TrainConfig(
                optimizer=C.OptimizerConfig(
                    lr=o["lr"], min_lr=o["min_lr"],
                    weight_decay=o["weight_decay"],
                    adam_beta1=o["adam_beta1"], adam_beta2=o["adam_beta2"],
                    adam_eps=o["adam_eps"], clip_grad=o["clip_grad"],
                    lr_decay_style="linear", warmup=o["warmup"]),
                batch_size=cfg["batch_size"], train_iters=o["train_iters"]),
            retriever_score_scaling=cfg["retriever_score_scaling"])
    return out


def tokenizer_ids(cfg: dict):
    """The special ids the program's tasks read off a tokenizer."""
    ids = special_ids(cfg)
    return types.SimpleNamespace(cls_id=ids["cls"], sep_id=ids["sep"],
                                 pad_id=ids["pad"], bos_id=ids["bos"],
                                 eos_id=ids["eos"])
