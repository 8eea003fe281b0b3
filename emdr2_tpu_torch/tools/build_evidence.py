"""Pre-tokenize the evidence TSV into mmap datasets (a copy of
``emdr2_tpu/tools/build_evidence.py``, framework-free; its worker pool
starts by spawn).

Parity with the reference's ``tools/create_evidence_indexed_dataset.py:
91-147``: psgs_w100.tsv (``doc_id\\ttext\\ttitle``, with header) becomes
``<out>_text`` and ``<out>_title`` MMIDIDX datasets via a multiprocessing
tokenizer pool. Row r holds doc_id r+1 (ids are contiguous 1-based, as in
the reference corpus).

Usage:
  python -m emdr2_tpu_torch.tools.build_evidence \\
      --input psgs_w100.tsv --output-prefix wiki --vocab-file vocab.txt \\
      [--workers 16]
"""

from __future__ import annotations

import argparse
import csv
import multiprocessing
import sys
import time

from emdr2_tpu_torch.data.indexed_dataset import (MMapIndexedDatasetBuilder,
                                                  best_dtype)
from emdr2_tpu_torch.data.tokenizer import BertWordPieceTokenizer, load_vocab

_tok = None


def _init_worker(vocab_file: str):
    global _tok
    _tok = BertWordPieceTokenizer.from_file(vocab_file)


def _encode(row):
    doc_id, text, title = row
    return int(doc_id), _tok.tokenize(text), _tok.tokenize(title)


def build(input_path: str, output_prefix: str, vocab_file: str,
          workers: int = 8, log_every: int = 100_000) -> int:
    csv.field_size_limit(sys.maxsize)
    vocab_size = len(load_vocab(vocab_file)) + 128
    dtype = best_dtype(vocab_size)
    text_b = MMapIndexedDatasetBuilder(output_prefix + "_text", dtype)
    title_b = MMapIndexedDatasetBuilder(output_prefix + "_title", dtype)

    def rows():
        with open(input_path) as f:
            reader = csv.reader(f, delimiter="\t")
            next(reader, None)  # header
            for row in reader:
                yield row[0], row[1], row[2]

    t0 = time.time()
    n = 0
    expected = 1
    # spawn, not fork: the parent holds torch's threads
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers, _init_worker, (vocab_file,)) as pool:
        for doc_id, text_ids, title_ids in pool.imap(
                _encode, rows(), chunksize=256):
            assert doc_id == expected, (
                f"doc ids must be contiguous 1-based; got {doc_id}, "
                f"expected {expected}")
            expected += 1
            text_b.add_item(text_ids)
            title_b.add_item(title_ids)
            n += 1
            if n % log_every == 0:
                rate = n / (time.time() - t0)
                print(f"  processed {n} rows ({rate:,.0f}/s)", flush=True)
    text_b.finalize()
    title_b.finalize()
    print(f"done: {n} passages -> {output_prefix}_text/_title")
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", required=True)
    p.add_argument("--output-prefix", required=True)
    p.add_argument("--vocab-file", required=True)
    p.add_argument("--workers", type=int, default=8)
    args = p.parse_args(argv)
    build(args.input, args.output_prefix, args.vocab_file, args.workers)


if __name__ == "__main__":
    main()
