"""Offline evidence index build (port of
``emdr2_tpu/tools/create_doc_index.py``).

Embeds the whole corpus with a context tower, from seeded weights or from a
checkpoint of the port (``--load``: its retriever only), and writes an
``EmbeddingStore``. Runs on the card unless ``--device cpu``.

Usage:
  python -m emdr2_tpu_torch.tools.create_doc_index \\
      --evidence-data-path wiki --vocab-file vocab.txt \\
      --embedding-path out/emb [--load ckpt_dir] [--batch-size 256] \\
      [--fid-flash-attention] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--evidence-data-path", required=True)
    p.add_argument("--vocab-file", required=True)
    p.add_argument("--embedding-path", required=True)
    p.add_argument("--load", default=None,
                   help="checkpoint dir holding retriever weights")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--hidden-size", type=int, default=768)
    p.add_argument("--num-layers", type=int, default=12)
    p.add_argument("--num-attention-heads", type=int, default=12)
    p.add_argument("--ffn-hidden-size", type=int, default=3072)
    p.add_argument("--seq-length-ret", type=int, default=256)
    p.add_argument("--seq-length-query", type=int, default=64)  # unused here
    p.add_argument("--fid-flash-attention", action="store_true",
                   help="the towers' self-attention through the flash kernel")
    p.add_argument("--device", default="cuda",
                   help="where to embed (default the card; 'cpu' to run "
                        "without one)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from emdr2_tpu_torch import config as C
    from emdr2_tpu_torch.data.evidence import EvidenceCorpus
    from emdr2_tpu_torch.data.tokenizer import build_tokenizers
    from emdr2_tpu_torch.models.emdr2 import EMDR2Model
    from emdr2_tpu_torch.retrieval.builder import EvidenceIndexBuilder
    from emdr2_tpu_torch.training import checkpointing as ck
    from emdr2_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    bert_tok, t5_tok = build_tokenizers(args.vocab_file)
    enc = C.TransformerConfig(
        hidden_size=args.hidden_size, num_layers=args.num_layers,
        num_heads=args.num_attention_heads, ffn_size=args.ffn_hidden_size,
        num_tokentypes=2, vocab_size=bert_tok.padded_vocab_size,
        fid_flash_attention=args.fid_flash_attention)
    t5c = dataclasses.replace(enc, num_tokentypes=0,
                              vocab_size=t5_tok.padded_vocab_size)
    cfg = C.EMDR2Config(
        retriever=C.RetrieverConfig(encoder=enc, embed_dim=args.hidden_size,
                                    seq_len=args.seq_length_ret),
        reader=C.ReaderConfig(transformer=t5c),
        index=C.IndexConfig(embed_dim=args.hidden_size))

    corpus = EvidenceCorpus.load(args.evidence_data_path + "_text",
                                 args.evidence_data_path + "_title")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)               # the weights when no --load is given
    model = EMDR2Model(cfg, device=device, generator=gen)
    if args.load:
        ck.load_retriever_params(args.load, model.retriever)
        print(f"loaded retriever weights from {args.load}")

    builder = EvidenceIndexBuilder(
        cfg, model, corpus, t5_tok.cls_id, t5_tok.sep_id, t5_tok.pad_id,
        batch_size=args.batch_size)
    store = builder.build_store(path=args.embedding_path)
    print(f"wrote {len(store.ids)} embeddings to {args.embedding_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
