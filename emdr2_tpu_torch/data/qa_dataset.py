"""Question encoding for serving (``emdr2_tpu/data/qa_dataset.py``).

Only ``encode_question`` is carried over: the serving path needs it, and the
training datasets come with the training slice. The function is a verbatim
copy of the original.
"""

from __future__ import annotations

from emdr2_tpu_torch.data.tokenizer import BertWordPieceTokenizer


def encode_question(question: str, tok: BertWordPieceTokenizer,
                    max_len: int) -> tuple:
    """[CLS] question(capped) [SEP] pad...; returns (ids, true_len)."""
    ids = [tok.cls_id] + tok.tokenize(question)
    if len(ids) > max_len - 1:
        ids = ids[: max_len - 1]
    ids.append(tok.sep_id)
    n = len(ids)
    ids = ids + [tok.pad_id] * (max_len - n)
    return ids, n
