"""OPENQA task wiring: datasets, model, index, refresh, train loop, EM eval
(port of ``emdr2_tpu/tasks/openqa_main.py:run_openqa``), on one device or
over a ``[dp, tp]`` grid of ranks (``dp``, whose ``.tp`` splits the
model): each rank holds its block of the index rows, each replica feeds
its slice of every global batch and evaluates its slice; world rank 0
writes the checkpoints and prints. With ``--async-indexer`` each rank's
embedder re-embeds its block on the rank's embedder cards
(``--embed-devices``) or on its own card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def padded_vocab_cfg(cfg, bert_tok, t5_tok):
    """``cfg`` with the model vocabs padded to the tokenizers' sizes."""
    enc = dataclasses.replace(cfg.retriever.encoder,
                              vocab_size=bert_tok.padded_vocab_size)
    t5c = dataclasses.replace(cfg.reader.transformer,
                              vocab_size=t5_tok.padded_vocab_size)
    return cfg.replace(
        retriever=dataclasses.replace(cfg.retriever, encoder=enc),
        reader=dataclasses.replace(cfg.reader, transformer=t5c))


def load_store(embedding_path: str):
    """An ``EmbeddingStore`` prefix, or the reference's ``.pkl``."""
    from emdr2_tpu_torch.retrieval import EmbeddingStore

    if embedding_path.endswith(".pkl"):
        return EmbeddingStore.load_reference_pickle(embedding_path)
    return EmbeddingStore.load(embedding_path)


def run_openqa(args, cfg, dp=None) -> int:
    from emdr2_tpu_torch.data.evidence import EvidenceCorpus
    from emdr2_tpu_torch.data.qa_dataset import OpenQADataset
    from emdr2_tpu_torch.data.tokenizer import build_tokenizers
    from emdr2_tpu_torch.models.decoding import bf16_eval_params
    from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex
    from emdr2_tpu_torch.retrieval.builder import EvidenceIndexBuilder
    from emdr2_tpu_torch.tasks.e2eqa import E2EQATask
    from emdr2_tpu_torch.training import checkpointing as ck
    from emdr2_tpu_torch.training import engine
    from emdr2_tpu_torch.training.async_refresh import AsyncIndexRefresher
    from emdr2_tpu_torch.utils.device import resolve_device

    if not (args.train_data and args.evidence_data_path):
        raise SystemExit("--train-data and --evidence-data-path are "
                         "required for OPENQA")
    if args.embedding_path is None:
        raise SystemExit("--embedding-path required (precomputed evidence "
                         "embeddings; build one with tools.create_doc_index)")
    device = resolve_device(args.device)

    bert_tok, t5_tok = build_tokenizers(args.vocab_file)
    cfg = padded_vocab_cfg(cfg, bert_tok, t5_tok)
    corpus = EvidenceCorpus.load(args.evidence_data_path + "_text",
                                 args.evidence_data_path + "_title")
    train_ds = OpenQADataset(args.train_data, t5_tok,
                             max_seq_length=cfg.retriever.query_seq_len,
                             decoder_seq_length=cfg.reader.decoder_seq_len,
                             seed=cfg.train.seed)
    valid_ds = (OpenQADataset(args.valid_data, t5_tok,
                              max_seq_length=cfg.retriever.query_seq_len,
                              decoder_seq_length=cfg.reader.decoder_seq_len)
                if args.valid_data else None)

    store = load_store(args.embedding_path)
    index = ShardedEvidenceIndex(cfg.index,
                                 np.asarray(store.embeddings, np.float32),
                                 passage_ids=np.asarray(store.ids),
                                 device=device, dp=dp)
    dp = index.dp                     # DataParallel.local() without dp
    coordinator = dp.world.rank == 0
    say = print if coordinator else (lambda *a, **k: None)

    B = cfg.train.batch_size
    total_iters = (cfg.train.train_iters if cfg.train.train_iters
                   else cfg.train.epochs * (len(train_ds) // B))
    task = E2EQATask(cfg, t5_tok, corpus, index,
                     total_train_iters=total_iters, device=device, dp=dp)
    task.init_state(cfg.train.seed)
    model = task.state.model

    resumed = False
    if args.load and ck.latest_iteration(args.load) is not None:
        _, it = ck.load_checkpoint(args.load, task.state, dp=dp)
        resumed = True
        say(f"resumed from {args.load} at iteration {it}")
    if not resumed and args.pretrained_dpr_load:
        ck.load_retriever_params(args.pretrained_dpr_load, model.retriever)
        say(f"initialized retriever from {args.pretrained_dpr_load}")
    if not resumed and args.pretrained_t5_load:
        ck.load_reader_params(args.pretrained_t5_load, model.reader)
        say(f"initialized reader from {args.pretrained_t5_load}")

    def evaluate():
        return task.evaluate_em(
            valid_ds, batch_size=args.eval_batch_size,
            beam_size=args.beam_size, max_decode_len=args.max_decode_len,
            sample=args.sampling,
            kv_quant="int8" if args.decode_kv_int8 else None)

    if args.eval_only:
        if valid_ds is None:
            raise SystemExit("--eval-only needs --valid-data")
        # no training follows: bf16 storage of the dense kernels gives the
        # same outputs when the compute is bf16 (bf16_eval_params)
        if cfg.reader.transformer.dtype == torch.bfloat16:
            bf16_eval_params(model)
        em, n = evaluate()
        say(f" eval-only | EM {em:.2f} over {n}")
        return 0

    refresher = None
    if args.async_indexer:
        # the embedder's tower lives on the rank's embedder cards, on its
        # own host (--embed-devices; placed there by the refresher at
        # start), or on its own card without them
        disjoint = args.embed_devices > 0
        builder = EvidenceIndexBuilder(
            cfg, model, corpus, t5_tok.cls_id, t5_tok.sep_id, t5_tok.pad_id,
            devices=getattr(args, "embedder_devices", None) or [device])
        # the JAX rule: zero-copy only with a disjoint embedder, whose fresh
        # block waits on its own card; on a card it shares with the
        # trainer it would sit beside the live index and the step for a
        # whole pass, so the rows wait in host RAM and are uploaded at the
        # swap
        refresher = AsyncIndexRefresher(
            builder, index, reload_interval=cfg.train.index_reload_interval,
            zero_copy=disjoint,
            on_refresh=lambda it: say(f" index refreshed at iteration {it}"))

    def eval_cb(iteration):
        if valid_ds is None:
            return None
        em, n = evaluate()
        say(f" iteration {iteration} | valid EM {em:.2f} over {n}")
        return {"valid_em": em, "valid_n": n}

    final = engine.train(task, train_ds, cfg, refresher=refresher,
                         save_dir=args.save, eval_callback=eval_cb,
                         prefetch_depth=args.prefetch_depth,
                         timeout_minutes=args.timeout_minutes, dp=dp)
    if valid_ds is not None:
        em, n = evaluate()
        say(f" final ({final} iters) | valid EM {em:.2f} over {n}")
    return 0
