"""The inputs of a run, made from its seed: one generator for every cell,
driven by the numbers of the cell's traffic file
(``benchmark/workloads/<traffic>.json``) and of its configuration file.

- token ids: pad 0, [UNK] 100, [CLS] 101, [SEP] 102 (BERT's), words from
  999 (a quarter of a small vocabulary) up to the BERT vocabulary, [BOS]
  and [EOS] right after it (the T5 reader's vocabulary extends BERT's);
- a corpus of ``num_passages`` passages of ``passage_tokens`` words, each
  titled by ``title_tokens`` words shared by a title group of
  ``title_group`` consecutive passages, written in the evidence store's
  format (``.idx`` / ``.bin``: the reference's mmap token files) under a
  directory the caller gives;
- questions of ``question_tokens`` words as ``[CLS] q [SEP]`` padded to
  the query length, answers of ``answer_tokens`` words as decoder input
  ``[BOS] a``, labels ``a [EOS]`` and a loss mask;
- index rows N(0, 1), made on the card by a generator there.

Every seed draws the same sizes: only which words, which lengths and which
rows differ, and every row the program sees is padded to the configured
lengths, so every seed gives the same work.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, NamedTuple

import numpy as np
import torch

PAD, UNK, CLS, SEP = 0, 100, 101, 102
FIRST_WORD = 999
MAGIC = b"MMIDIDX\x00\x00"


def special_ids(cfg: dict) -> Dict[str, int]:
    words_end = cfg["retriever"]["vocab_size"] - 70    # BERT's 30522
    return {"pad": PAD, "unk": UNK, "cls": CLS, "sep": SEP,
            "bos": words_end, "eos": words_end + 1, "words_end": words_end,
            "first_word": min(FIRST_WORD, words_end // 4)}


def streams(seed: int, n: int) -> List[int]:
    """``n`` independent 63-bit seeds derived from the run's seed."""
    ss = np.random.SeedSequence(int(seed) & (2 ** 64 - 1))
    return [int(s) >> 1 for s in ss.generate_state(n, np.uint64)]


class Corpus(NamedTuple):
    texts: List[np.ndarray]
    titles: List[np.ndarray]
    group_of: np.ndarray            # title group of passage i + 1
    text_prefix: str
    title_prefix: str


def _write_store(prefix: str, items: List[np.ndarray]) -> None:
    """The evidence store's token file pair, int32 tokens."""
    sizes = np.asarray([len(t) for t in items], np.int32)
    pointers = np.zeros(len(items), np.int64)
    np.cumsum(sizes[:-1].astype(np.int64) * 4, out=pointers[1:])
    with open(prefix + ".bin", "wb") as f:
        f.write(np.concatenate(items).astype(np.int32).tobytes())
    with open(prefix + ".idx", "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<B", 4))                 # int32
        f.write(struct.pack("<Q", len(items)))
        f.write(struct.pack("<Q", 2))
        f.write(sizes.tobytes())
        f.write(pointers.tobytes())
        f.write(np.asarray([0, len(items)], np.int64).tobytes())


def make_corpus(cfg: dict, traffic: dict, seed: int, directory: str
                ) -> Corpus:
    rng = np.random.default_rng(seed)
    n = cfg["num_passages"]
    ids = special_ids(cfg)
    first, words_end = ids["first_word"], ids["words_end"]
    lo, hi = traffic["passage_tokens"]
    lengths = rng.integers(lo, hi + 1, size=n)
    flat = rng.integers(first, words_end, size=int(lengths.sum()))
    texts = np.split(flat, np.cumsum(lengths)[:-1])
    glo, ghi = traffic["title_group"]
    sizes = rng.integers(glo, ghi + 1, size=n)
    group_of = np.repeat(np.arange(n), sizes)[:n]
    n_groups = int(group_of[-1]) + 1
    tlo, thi = traffic["title_tokens"]
    tlens = rng.integers(tlo, thi + 1, size=n_groups)
    tflat = rng.integers(first, words_end, size=int(tlens.sum()))
    group_titles = np.split(tflat, np.cumsum(tlens)[:-1])
    titles = [group_titles[g] for g in group_of]
    os.makedirs(directory, exist_ok=True)
    text_prefix = os.path.join(directory, "evidence_text")
    title_prefix = os.path.join(directory, "evidence_title")
    _write_store(text_prefix, texts)
    _write_store(title_prefix, titles)
    return Corpus(texts, titles, group_of, text_prefix, title_prefix)


class Questions(NamedTuple):
    """A batch of questions as the program's QA batches hold them."""

    uid: np.ndarray           # [B] int64, negative
    ids: np.ndarray           # [B, Lq] int32
    length: np.ndarray        # [B] int32, [CLS] and [SEP] included
    dec_ids: np.ndarray       # [B, Ld] int32
    labels: np.ndarray        # [B, Ld] int32
    loss_mask: np.ndarray     # [B, Ld] float32


def make_questions(cfg: dict, traffic: dict, seed: int, batch_index: int
                   ) -> Questions:
    """Batch ``batch_index`` of the run's questions."""
    ids_ = special_ids(cfg)
    rng = np.random.default_rng([seed, batch_index])
    B = traffic["questions_per_step"]
    Lq, Ld = cfg["query_seq_len"], cfg["decoder_seq_len"]
    q = np.full((B, Lq), PAD, np.int32)
    qlen = np.zeros(B, np.int32)
    dec = np.full((B, Ld), PAD, np.int32)
    lab = np.full((B, Ld), PAD, np.int32)
    mask = np.zeros((B, Ld), np.float32)
    for b in range(B):
        n = int(rng.integers(traffic["question_tokens"][0],
                             traffic["question_tokens"][1] + 1))
        words = rng.integers(ids_["first_word"], ids_["words_end"], size=n)
        row = [CLS] + words.tolist()[:Lq - 2] + [SEP]
        q[b, :len(row)] = row
        qlen[b] = len(row)
        a = int(rng.integers(traffic["answer_tokens"][0],
                             traffic["answer_tokens"][1] + 1))
        ans = rng.integers(ids_["first_word"], ids_["words_end"],
                           size=a).tolist()
        din = ([ids_["bos"]] + ans)[:Ld]
        dout = ans[:len(din) - 1] + [ids_["eos"]]
        dec[b, :len(din)] = din
        lab[b, :len(dout)] = dout
        mask[b, :len(din)] = 1.0
    uid = -(1 + batch_index * B + np.arange(B, dtype=np.int64))
    return Questions(uid, q, qlen, dec, lab, mask)


def make_index_rows(cfg: dict, seed: int, device) -> torch.Tensor:
    """[index_rows, embed_dim] float32 N(0, 1), made on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn(cfg["index_rows"], cfg["embed_dim"], generator=gen,
                       device=device)


def passage_of_row(cfg: dict, rows) -> np.ndarray:
    """Index row r holds passage 1 + r mod num_passages."""
    return 1 + np.asarray(rows, np.int64) % cfg["num_passages"]
