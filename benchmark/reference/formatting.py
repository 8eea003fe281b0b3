"""Plain reference of the passage formatting (EMDR2's ``postprocess`` and
the ORQA evidence format, ``megatron/model/emdr2_model.py:250-376`` and
``megatron/data/orqa_wiki_dataset.py:85-120`` of DevSinghSachan/emdr2).

Passages are 1-based ids. A passage's neighbours are the window of three
passages of its title group around it (the group's first three when it
opens the group, the last three when it closes it), and its position in
that window: 0 first, -1 last, 1 in the middle.

- the retriever's row: ``[CLS] title [SEP] text [SEP]``, cut to Lc, pad;
  token types 0 over the tokens and ``pad`` over the padding;
- the reader's row: ``question title [SEP] context [SEP]`` padded to Lr,
  where the context is the passage whole (or cut to what is left) and what
  is left is filled from its neighbours: forward when it opens the
  window, the end of the left ones when it closes it, the left one's end
  and then the right one when in the middle;
- the teacher's row: ``question title [SEP] text``, cut to Lr - 1, then
  ``[SEP]``, pad.

A passage whose id equals the question's uid is skipped (never here:
question uids are negative).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


class Corpus:
    """Passages and titles as token arrays; ``group_of[doc - 1]`` is the
    title group of passage ``doc``."""

    def __init__(self, texts: Sequence[np.ndarray],
                 titles: Sequence[np.ndarray], group_of: np.ndarray):
        self.texts, self.titles, self.group_of = texts, titles, group_of
        self.groups: dict = {}
        for doc in range(1, len(texts) + 1):
            self.groups.setdefault(int(group_of[doc - 1]), []).append(doc)

    def text(self, doc: int) -> List[int]:
        return self.texts[doc - 1].tolist()

    def title(self, doc: int) -> List[int]:
        return self.titles[doc - 1].tolist()

    def neighbours(self, doc: int):
        """``get_neighbour_paragraphs`` of the reference's title index,
        Python slices and all (the last of a group of two gets a window of
        itself alone)."""
        group = self.groups[int(self.group_of[doc - 1])]
        i = group.index(doc)
        if i == 0:
            return group[i:i + 3], 0
        if i == len(group) - 1:
            return group[i - 2:i + 1], -1
        return group[i - 1:i + 2], 1


def context_row(title, text, max_len, cls, sep, pad):
    ids = [cls] + list(title) + [sep] + list(text)
    ids = ids[:max_len - 1] + [sep]
    n = len(ids)
    return ids + [pad] * (max_len - n), [0] * n + [pad] * (max_len - n)


def reader_row(query, title, docs, main, max_len, sep, pad):
    prefix = list(query) + list(title) + [sep]
    budget = max(0, max_len - len(prefix) - 1)
    hit = list(docs[main])
    if len(hit) > budget or len(docs) == 1:
        ctx = hit[:budget]
    else:
        extra = budget - len(hit)
        if main == 0:
            right = [t for d in docs[1:] for t in d]
            ctx = hit + right[:extra]
        elif main == -1:
            left = [t for d in docs[:-1] for t in d]
            if len(left) > extra:
                left = left[len(left) - extra + 1:]
            ctx = left + hit
        else:
            left = list(docs[0])
            if len(left) > extra:
                ctx = left[len(left) - extra + 1:] + hit
            else:
                ctx = left + hit
                if len(docs) == 3:
                    ctx += list(docs[2])[:extra - len(left)]
    ids = prefix + ctx + [sep]
    return ids + [pad] * (max_len - len(ids))


def teacher_row(query, title, text, max_len, sep, pad):
    ids = list(query) + list(title) + [sep] + list(text)
    ids = ids[:max_len - 1] + [sep]
    return ids + [pad] * (max_len - len(ids))


def format_step(corpus: Corpus, queries, query_lens, uids, passages,
                topk: int, Lc: int, Lr: int, cls: int, sep: int, pad: int):
    """The four [B, K, L] arrays of a step from its retrieved passage ids
    [B, >= K]: retriever ids and types, reader rows, teacher rows."""
    B = len(queries)
    ctx = np.full((B, topk, Lc), pad, np.int64)
    types = np.full((B, topk, Lc), pad, np.int64)
    reader = np.full((B, topk, Lr), pad, np.int64)
    teacher = np.full((B, topk, Lr), pad, np.int64)
    for b in range(B):
        query = list(queries[b][:int(query_lens[b])])
        k = 0
        for doc in passages[b]:
            doc = int(doc)
            if doc == int(uids[b]) or k >= topk:
                continue
            docs, main = corpus.neighbours(doc)
            texts = [corpus.text(d) for d in docs]
            title = corpus.title(doc)
            ids, tt = context_row(title, texts[main], Lc, cls, sep, pad)
            ctx[b, k], types[b, k] = ids, tt
            reader[b, k] = reader_row(query, title, texts, main, Lr, sep, pad)
            teacher[b, k] = teacher_row(query, title, texts[main], Lr, sep,
                                        pad)
            k += 1
    return ctx, types, reader, teacher


def embedder_rows(corpus: Corpus, docs, Lc, cls, sep, pad):
    """The retriever rows of passages ``docs`` (ids and types)."""
    rows = [context_row(corpus.title(int(d)), corpus.text(int(d)), Lc, cls,
                        sep, pad) for d in docs]
    return (np.asarray([r[0] for r in rows], np.int64),
            np.asarray([r[1] for r in rows], np.int64))
