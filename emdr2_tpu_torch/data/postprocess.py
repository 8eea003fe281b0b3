"""Host-side token surgery between retrieval and the reader forward.

Behavioral parity with the reference ``postprocess`` and its format helpers
(``megatron/model/emdr2_model.py:250-376`` and
``megatron/data/orqa_wiki_dataset.py:85-120``): given the top-K retrieved
doc ids for each query, build

1. BERT-format context ids/types  [B, K, Lc]  — ``[CLS] title [SEP] text [SEP]``
2. T5 reader ids                  [B, K, Lr]  — query ++ title [SEP] ++
   *extended* context (the hit plus neighbor paragraphs filling the window,
   direction depending on the hit's position in its title group) ++ [SEP]
3. T5 teacher ids                 [B, K, Lr]  — query ++ title [SEP] ++ the
   single hit context ++ [SEP]

plus the skip-own-source-document rule: a hit whose id equals the query uid
is dropped (uids are negative for QA queries so this only triggers for
corpus-sourced queries); when ``allow_trivial_doc`` is off the caller must
retrieve K+1 so K survive (emdr2_model.py:389-391).

This runs on host between the two jitted stages; the C++ extension
(``emdr2_tpu.native``) accelerates the batched mmap gather underneath.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np

from emdr2_tpu_torch.data.evidence import EvidenceCorpus
from emdr2_tpu_torch.utils.timing import count


def context_bert_format(token_ids: Sequence[int], max_len: int,
                        cls_id: int, sep_id: int, pad_id: int
                        ) -> Tuple[List[int], List[int]]:
    """[CLS] tokens(capped) [SEP] pad... with all-zero tokentypes until the
    pad region (orqa_wiki_dataset.py:85-120: pad positions get type=pad_id)."""
    ids = [cls_id] + list(token_ids)
    if len(ids) > max_len - 1:
        ids = ids[: max_len - 1]
    ids.append(sep_id)
    n = len(ids)
    types = [0] * n
    if n < max_len:
        ids += [pad_id] * (max_len - n)
        types += [pad_id] * (max_len - n)
    return ids, types


def query_extended_context_t5_format(query_ids: Sequence[int],
                                     title_ids: Sequence[int],
                                     context_doc_list: Sequence[Sequence[int]],
                                     main_doc_idx: int,
                                     max_len: int, sep_id: int, pad_id: int
                                     ) -> List[int]:
    """query ++ title [SEP] ++ extended context ++ [SEP] ++ pad.

    Extension semantics (emdr2_model.py:306-359): the hit paragraph is kept
    whole (or truncated to the remaining budget); leftover budget is filled
    from its neighbors — forward when the hit is first in its title group
    (idx 0), backward-tail when last (idx -1, keeping the *end* of the left
    context), and left-tail-then-right when in the middle (idx 1).
    """
    prefix = list(query_ids) + list(title_ids) + [sep_id]
    budget = max(0, max_len - len(prefix) - 1)

    main = list(context_doc_list[main_doc_idx])
    if len(main) > budget or len(context_doc_list) == 1:
        ctx = main[:budget]
    else:
        extra = budget - len(main)
        if main_doc_idx == 0:
            right: List[int] = []
            for doc in context_doc_list[1:]:
                right.extend(doc)
            ctx = main + right[:extra]
        elif main_doc_idx == -1:
            left: List[int] = []
            for doc in context_doc_list[:-1]:
                left.extend(doc)
            if len(left) > extra:
                left = left[len(left) - extra + 1:]
            ctx = left + main
        else:  # main_doc_idx == 1 (middle of a 3-window)
            left = list(context_doc_list[0])
            if len(left) > extra:
                left = left[len(left) - extra + 1:]
                ctx = left + main
            else:
                ctx = left + main
                if len(context_doc_list) == 3:
                    remaining = extra - len(left)
                    ctx = ctx + list(context_doc_list[2])[:remaining]

    ids = prefix + ctx + [sep_id]
    if len(ids) < max_len:
        ids += [pad_id] * (max_len - len(ids))
    return ids


def query_single_context_t5_format(query_ids: Sequence[int],
                                   title_ids: Sequence[int],
                                   context_ids: Sequence[int],
                                   max_len: int, sep_id: int, pad_id: int
                                   ) -> List[int]:
    """query ++ title [SEP] ++ context, capped at max_len-1, ++ [SEP] ++ pad
    (emdr2_model.py:362-376)."""
    ids = list(query_ids) + list(title_ids) + [sep_id] + list(context_ids)
    if len(ids) > max_len - 1:
        ids = ids[: max_len - 1]
    ids.append(sep_id)
    if len(ids) < max_len:
        ids += [pad_id] * (max_len - len(ids))
    return ids


class PostprocessedBatch(NamedTuple):
    context_bert_ids: np.ndarray    # [B, K, Lc] int32
    context_bert_types: np.ndarray  # [B, K, Lc] int32
    reader_ids: np.ndarray          # [B, K, Lr] int32
    reader_one_ctx_ids: np.ndarray  # [B, K, Lr] int32


def postprocess_retrieved(query_uids: Sequence[int],
                          query_t5_ids: np.ndarray,
                          query_t5_lens: Sequence[int],
                          topk_passage_ids: np.ndarray,
                          corpus: EvidenceCorpus,
                          topk: int,
                          retriever_seq_len: int,
                          reader_seq_len: int,
                          cls_id: int, sep_id: int, pad_id: int
                          ) -> PostprocessedBatch:
    """Parity with ``postprocess`` (emdr2_model.py:250-303).

    topk_passage_ids is [B, K'] with K' >= topk (K'=topk+1 when trivial docs
    are excluded). Extra hits beyond ``topk`` survivors are dropped.

    The C++ extension runs the whole B*K row build in one call (~3,200 rows
    per step at the flagship shape — SURVEY §7 hard-part 3); this Python
    loop is the golden reference it is tested against, and the fallback.

    Either way, the token positions (those not ``pad_id``) and the slots
    of each kind of row are added to ``postprocess_retrieved.tokens`` and
    ``.slots`` under ``"context"``, ``"reader"`` and ``"teacher"`` (the
    one-passage rows).
    """
    native = None
    try:  # fall back to pure Python only if the extension can't build/load
        from emdr2_tpu_torch.native import batch_postprocess as native
        win, pos, wlen = corpus.neighbour_table()
    except Exception:
        native = None
    if native is not None:
        ctx_ids, ctx_types, reader, reader_one, k_out = native(
            corpus.titles, corpus.passages, win, pos, wlen,
            np.asarray(query_t5_ids), np.asarray(query_t5_lens),
            np.asarray(query_uids, np.int64),
            np.asarray(topk_passage_ids, np.int64), topk,
            retriever_seq_len, reader_seq_len, cls_id, sep_id, pad_id)
        assert (k_out == topk).all(), (
            f"only {k_out.min()} usable docs for some query; retrieve "
            f"topk+1 when allow_trivial_doc is off")
        out = PostprocessedBatch(ctx_ids, ctx_types, reader, reader_one)
    else:
        out = postprocess_retrieved_python(
            query_uids, query_t5_ids, query_t5_lens, topk_passage_ids,
            corpus, topk, retriever_seq_len, reader_seq_len, cls_id, sep_id,
            pad_id)
    for key, rows in (("context", out.context_bert_ids),
                      ("reader", out.reader_ids),
                      ("teacher", out.reader_one_ctx_ids)):
        count(postprocess_retrieved, "tokens", key,
              int(np.count_nonzero(rows != pad_id)))
        count(postprocess_retrieved, "slots", key, rows.size)
    return out


postprocess_retrieved.tokens = {}
postprocess_retrieved.slots = {}


def postprocess_retrieved_python(query_uids, query_t5_ids, query_t5_lens,
                                 topk_passage_ids, corpus, topk,
                                 retriever_seq_len, reader_seq_len,
                                 cls_id, sep_id, pad_id
                                 ) -> PostprocessedBatch:
    """The pure-Python golden implementation (see parity test in
    tests/test_native.py)."""
    B = len(query_uids)
    ctx_ids = np.full((B, topk, retriever_seq_len), pad_id, np.int32)
    ctx_types = np.full((B, topk, retriever_seq_len), pad_id, np.int32)
    reader = np.full((B, topk, reader_seq_len), pad_id, np.int32)
    reader_one = np.full((B, topk, reader_seq_len), pad_id, np.int32)

    for b in range(B):
        quid = int(query_uids[b])
        query = query_t5_ids[b][: int(query_t5_lens[b])].tolist()
        k = 0
        for eid in topk_passage_ids[b].tolist():
            if eid == quid or k >= topk:
                continue
            doc_ids, main_idx = corpus.neighbours(eid)
            doc_list = [corpus.doc_tokens(d) for d in doc_ids]
            title = corpus.title_tokens(eid)
            main_ctx = doc_list[main_idx]

            ids, types = context_bert_format(
                title + [sep_id] + main_ctx, retriever_seq_len,
                cls_id, sep_id, pad_id)
            ctx_ids[b, k] = ids
            ctx_types[b, k] = types
            reader[b, k] = query_extended_context_t5_format(
                query, title, doc_list, main_idx, reader_seq_len,
                sep_id, pad_id)
            reader_one[b, k] = query_single_context_t5_format(
                query, title, main_ctx, reader_seq_len, sep_id, pad_id)
            k += 1
        assert k == topk, (
            f"only {k} usable docs for query {quid}; retrieve topk+1 when "
            f"allow_trivial_doc is off")
    return PostprocessedBatch(ctx_ids, ctx_types, reader, reader_one)
