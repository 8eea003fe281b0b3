"""RETRIEVER task wiring (port of ``emdr2_tpu/tasks/retriever_main.py``) on
one device: DPR training by epochs with interval and end-of-epoch
checkpoints, resume from ``--load`` (the batches already taken are skipped),
the 30+30-negative average-rank / top-k validation after each epoch, and,
after training (or alone with ``--eval-only``), the evidence index built
with the trained context tower and recall@k on ``--qa-file-dev`` /
``--qa-file-test``.

Over a ``[dp, tp]`` grid (``dp``, whose ``.tp`` splits the towers) each
replica trains on its slice of every global batch (its own positives and
hard negatives; the in-batch loss gathers every replica's contexts) and
validates its slice, each rank embeds its block of the evidence rows for
the recall evaluation (with the tower gathered whole), and world rank 0
writes the checkpoints, the embedding store and the log.

Checkpoints hold the dual encoder under ``retriever.``, so
``tools.checkpoint_surgery`` and OPENQA's ``--pretrained-dpr-load`` take
them as they take an EMDR2 checkpoint (the two-stage DPR -> EMDR2 recipe).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


def run_retriever(args, cfg, dp=None) -> int:
    """``dp``: the data-parallel group (default one rank)."""
    from emdr2_tpu_torch.data.tokenizer import build_tokenizers
    from emdr2_tpu_torch.parallel import DataParallel
    from emdr2_tpu_torch.tasks.dense_retriever import DPRDataset, DPRTask
    from emdr2_tpu_torch.training import checkpointing as ck
    from emdr2_tpu_torch.utils.device import resolve_device

    if not args.train_data and not args.eval_only:
        raise SystemExit("--train-data (DPR json) required for RETRIEVER")
    dp = dp if dp is not None else DataParallel.local()
    device = resolve_device(args.device)
    bert_tok, _ = build_tokenizers(args.vocab_file)
    enc = dataclasses.replace(cfg.retriever.encoder,
                              vocab_size=bert_tok.padded_vocab_size)
    rcfg = dataclasses.replace(cfg.retriever, encoder=enc)

    def dataset(path, **kw):
        return DPRDataset(path, bert_tok,
                          query_seq_len=rcfg.query_seq_len,
                          ctx_seq_len=rcfg.seq_len, **kw)

    train_ds = (dataset(args.train_data[0], hard_negs=args.train_hard_neg,
                        seed=cfg.train.seed) if args.train_data else None)
    valid_ds = (dataset(args.valid_data[0], evaluate=True,
                        val_av_rank_other_neg=args.val_av_rank_other_neg,
                        val_av_rank_hard_neg=args.val_av_rank_hard_neg)
                if args.valid_data else None)

    B = cfg.train.batch_size
    steps_per_epoch = len(train_ds) // B if train_ds is not None else 0
    total = cfg.train.train_iters or cfg.train.epochs * steps_per_epoch
    task = DPRTask(rcfg, cfg.train.optimizer, total_train_iters=max(total, 1),
                   score_scaling=cfg.retriever_score_scaling, device=device,
                   dp=dp)
    task.init_state(cfg.train.seed)
    coordinator = dp.world.rank == 0
    say = print if coordinator else (lambda *a, **k: None)
    ranks = {"rank": dp.rank, "world_size": dp.world_size}

    if args.load and ck.latest_iteration(args.load) is not None:
        _, it = ck.load_checkpoint(args.load, task.get_state(), dp=dp)
        say(f"resumed retriever from {args.load} at iteration {it}")

    def save(iteration, async_save: bool = False):
        if args.save:
            # interval saves stage to the host and write in the background;
            # the end-of-epoch save is synchronous, so a resume or the
            # post-train evaluation always finds a durable checkpoint
            ck.save_checkpoint(args.save, task.get_state(), iteration,
                               async_save=async_save and cfg.train.async_save,
                               dp=dp)
            if coordinator:
                ck.remove_stale_checkpoints(args.save, keep_last=2)

    if not args.eval_only:
        it = task.state.step
        start_epoch = it // max(steps_per_epoch, 1)
        start_offset = it % max(steps_per_epoch, 1)
        try:
            for epoch in range(start_epoch, cfg.train.epochs):
                if it >= total:
                    break
                for bi, batch in enumerate(train_ds.epoch_batches(
                        B, seed=cfg.train.seed + epoch, **ranks)):
                    if epoch == start_epoch and bi < start_offset:
                        continue  # taken before the resume
                    m = task.train_step(batch)
                    it += 1
                    if it % cfg.train.log_interval == 0:
                        say(f" iteration {it:8d}/{total} | loss "
                              f"{float(m['loss']):.4f} | correct "
                              f"{float(m['correct_prediction_count']):.0f}"
                              f"/{B}")
                    if it % cfg.train.save_interval == 0:
                        save(it, async_save=True)
                    if it >= total:
                        break
                if valid_ds is not None:
                    v = task.validate(
                        valid_ds.epoch_batches(B, seed=0, shuffle=False,
                                               drop_last=False, **ranks),
                        report_topk=args.report_topk_accuracies)
                    stats = " | ".join(f"{k} {val:.4f}"
                                       for k, val in v.items())
                    say(f" epoch {epoch} | {stats}")
                save(it)
        finally:
            ck.finalize_async_saves()

    if args.evidence_data_path and (args.qa_file_dev or args.qa_file_test):
        post_train_eval(args, cfg, rcfg, bert_tok, task, dp)
    return 0


def post_train_eval(args, cfg, rcfg, bert_tok, task, dp) -> None:
    """Embed the evidence with the task's context tower, index it, and
    print recall@k of the query tower on the QA files. Each rank of ``dp``
    embeds its block of rows; rank 0 gathers them for the store."""
    from emdr2_tpu_torch.data.evidence import EvidenceCorpus
    from emdr2_tpu_torch.data.qa_dataset import read_qa_csv
    from emdr2_tpu_torch.models.bert import DualEncoder
    from emdr2_tpu_torch.retrieval import EmbeddingStore, ShardedEvidenceIndex
    from emdr2_tpu_torch.retrieval.builder import EvidenceIndexBuilder
    from emdr2_tpu_torch.retrieval.evaluate import OpenRetrievalEvaluator

    corpus = EvidenceCorpus.load(args.evidence_data_path + "_text",
                                 args.evidence_data_path + "_title")
    builder = EvidenceIndexBuilder(
        cfg.replace(retriever=rcfg), task.model, corpus, bert_tok.cls_id,
        bert_tok.sep_id, bert_tok.pad_id)
    coordinator = dp.world.rank == 0
    say = print if coordinator else (lambda *a, **k: None)
    say(f" building evidence index over {len(corpus)} passages ...")
    icfg = dataclasses.replace(
        cfg.index, embed_dim=rcfg.embed_dim,
        topk=max(cfg.index.topk, args.report_topk_accuracies[-1]))
    n = len(corpus)
    index = ShardedEvidenceIndex(
        icfg, np.zeros((0, icfg.embed_dim), np.float32),
        passage_ids=np.arange(1, n + 1, dtype=np.int64), device=task.device,
        dp=dp, local=True, n_real=n)
    start, stop = index.process_row_range()
    rows = builder.embed_corpus(row_partition=(start, stop))
    index.update_from_process_local(rows)
    if args.embedding_path:
        block = np.zeros((stop - start, icfg.embed_dim), np.float16)
        block[:len(rows)] = rows
        every = index.blocks.all_gather_rows(torch.from_numpy(block))[:n]
        if coordinator:
            EmbeddingStore.of_rows(every.numpy()).save(args.embedding_path)
        index.blocks.barrier()
    evaluator = OpenRetrievalEvaluator(
        task.model.retriever, index, bert_tok,
        query_seq_len=rcfg.query_seq_len,
        embed_method=DualEncoder.embed_query)

    @functools.lru_cache(maxsize=1 << 16)
    def doc_text(pid: int) -> str:
        return bert_tok.detokenize(corpus.doc_tokens(int(pid)))

    for name, path in (("DEV", args.qa_file_dev), ("TEST", args.qa_file_test)):
        if not path:
            continue
        result = evaluator.evaluate_recall(
            read_qa_csv(path), k=icfg.topk, doc_text_fn=doc_text,
            match_type=args.match, report_at=args.report_topk_accuracies)
        stats = " | ".join(f"{k} {v:.4f}" for k, v in result.items())
        say(f" {name} retrieval | {stats}")

