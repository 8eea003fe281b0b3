"""Standalone recall@k evaluation over QA files (port of
``emdr2_tpu/tools/evaluate_retrieval.py``): load precomputed evidence
embeddings (an ``EmbeddingStore`` prefix, or the reference's ``.pkl``),
index them on the device, embed the questions with the query tower (seeded
weights, or a checkpoint's retriever with ``--load``: EMDR2 or DPR), search
all of them at once and print recall@k per QA file, with string or regex
answer matching against the passage text. Runs on the card unless
``--device cpu``.

Usage:
  python -m emdr2_tpu_torch.tools.evaluate_retrieval \\
      --qa-data 'nq-*.csv' --evidence-data-path wiki --embedding-path emb \\
      --vocab-file vocab.txt [--load ckpt_dir] [--topk 100] [--device cuda]
"""

from __future__ import annotations

import argparse
import functools
import glob as globlib
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--qa-data", nargs="+", required=True,
                   help="QA csv path(s) or globs")
    p.add_argument("--evidence-data-path", required=True)
    p.add_argument("--embedding-path", required=True)
    p.add_argument("--vocab-file", required=True)
    p.add_argument("--load", default=None, help="retriever checkpoint dir")
    p.add_argument("--topk", type=int, default=100)
    p.add_argument("--report-topk-accuracies", type=int, nargs="+",
                   default=[1, 5, 20, 100])
    p.add_argument("--match", choices=["string", "regex"], default="string")
    p.add_argument("--hidden-size", type=int, default=768)
    p.add_argument("--num-layers", type=int, default=12)
    p.add_argument("--num-attention-heads", type=int, default=12)
    p.add_argument("--ffn-hidden-size", type=int, default=3072)
    p.add_argument("--seq-length-ret", type=int, default=256)
    p.add_argument("--seq-length-query", type=int, default=64)
    p.add_argument("--fid-flash-attention", action="store_true",
                   help="the query tower's self-attention through the flash "
                        "kernel")
    p.add_argument("--dump-path", default=None)
    p.add_argument("--device", default="cuda",
                   help="where to search (default the card; 'cpu' to run "
                        "without one)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from emdr2_tpu_torch import config as C
    from emdr2_tpu_torch.data.evidence import EvidenceCorpus
    from emdr2_tpu_torch.data.qa_dataset import read_qa_csv
    from emdr2_tpu_torch.data.tokenizer import build_tokenizers
    from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex
    from emdr2_tpu_torch.retrieval.evaluate import OpenRetrievalEvaluator
    from emdr2_tpu_torch.tasks.dense_retriever import DPRModel
    from emdr2_tpu_torch.tasks.openqa_main import load_store
    from emdr2_tpu_torch.training import checkpointing as ck
    from emdr2_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    bert_tok, t5_tok = build_tokenizers(args.vocab_file)
    enc = C.TransformerConfig(
        hidden_size=args.hidden_size, num_layers=args.num_layers,
        num_heads=args.num_attention_heads, ffn_size=args.ffn_hidden_size,
        num_tokentypes=2, vocab_size=bert_tok.padded_vocab_size,
        fid_flash_attention=args.fid_flash_attention)
    rcfg = C.RetrieverConfig(encoder=enc, embed_dim=args.hidden_size,
                             seq_len=args.seq_length_ret,
                             query_seq_len=args.seq_length_query)
    icfg = C.IndexConfig(embed_dim=args.hidden_size, topk=args.topk)

    corpus = EvidenceCorpus.load(args.evidence_data_path + "_text",
                                 args.evidence_data_path + "_title")
    store = load_store(args.embedding_path)
    index = ShardedEvidenceIndex(icfg,
                                 np.asarray(store.embeddings, np.float32),
                                 passage_ids=np.asarray(store.ids),
                                 device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)               # the weights when no --load is given
    model = DPRModel(rcfg, device, gen).eval()
    if args.load:
        ck.load_retriever_params(args.load, model.retriever)
        print(f"loaded retriever weights from {args.load}")

    evaluator = OpenRetrievalEvaluator(model, index, t5_tok,
                                       rcfg.query_seq_len)

    @functools.lru_cache(maxsize=1 << 16)
    def doc_text(pid: int) -> str:
        return t5_tok.detokenize(corpus.doc_tokens(pid))

    for pattern in args.qa_data:
        for path in sorted(globlib.glob(pattern)) or [pattern]:
            examples = read_qa_csv(path)
            result = evaluator.evaluate_recall(
                examples, k=args.topk, doc_text_fn=doc_text,
                match_type=args.match,
                report_at=args.report_topk_accuracies,
                dump_path=args.dump_path)
            pretty = " ".join(f"{k}={v:.4f}" for k, v in result.items())
            print(f"{path}: n={len(examples)} {pretty}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
