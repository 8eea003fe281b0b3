"""High-level tokenizers for the retriever (BERT) and reader (T5).

Parity with the reference wrapper (``megatron/tokenizer/
tokenizer.py:135-179``): both the retriever and the reader share one wordpiece
vocab; the T5 instance additionally registers ``[BOS]``/``[EOS]`` and 100
``<extra_id_k>`` sentinel tokens appended past the base vocab (reference
``global_vars.py:103-109``). Model vocab sizes are padded to a multiple of 128
(``tokenizer.py:57-70``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from .wordpiece import FullTokenizer, load_vocab


def pad_vocab_size(orig: int, multiple: int = 128) -> int:
    """Round the vocab size up to a hardware-friendly multiple (ref :57-70)."""
    return ((orig + multiple - 1) // multiple) * multiple


class BertWordPieceTokenizer:
    """BERT wordpiece tokenizer with the EMDR2 special-token extensions."""

    def __init__(self, vocab: Dict[str, int], lower_case: bool = True,
                 vocab_extra_ids: int = 0):
        self._full = FullTokenizer(dict(vocab), lower_case=lower_case)
        v = self._full.vocab
        self.cls_id = v["[CLS]"]
        self.sep_id = v["[SEP]"]
        self.pad_id = v["[PAD]"]
        self.mask_id = v["[MASK]"]
        self.unk_id = v["[UNK]"]
        self._add_token("[BOS]")
        self._add_token("[EOS]")
        self.bos_id = v["[BOS]"]
        self.eos_id = v["[EOS]"]
        self.additional_special_tokens = [f"<extra_id_{i}>" for i in range(vocab_extra_ids)]
        for tok in self.additional_special_tokens:
            self._add_token(tok)

    @classmethod
    def from_file(cls, vocab_file: str, lower_case: bool = True,
                  vocab_extra_ids: int = 0) -> "BertWordPieceTokenizer":
        return cls(load_vocab(vocab_file), lower_case=lower_case,
                   vocab_extra_ids=vocab_extra_ids)

    def _add_token(self, token: str) -> None:
        v = self._full.vocab
        if token not in v:
            new_id = len(v)
            v[token] = new_id
            self._full.inv_vocab[new_id] = token

    @property
    def vocab(self) -> Dict[str, int]:
        return self._full.vocab

    @property
    def inv_vocab(self) -> Dict[int, str]:
        return self._full.inv_vocab

    @property
    def vocab_size(self) -> int:
        return len(self._full.vocab)

    @property
    def padded_vocab_size(self) -> int:
        return pad_vocab_size(self.vocab_size)

    def tokenize(self, text: str) -> List[int]:
        return self._full.tokens_to_ids(self._full.tokenize(text))

    def detokenize(self, ids: Sequence[int]) -> str:
        """Join wordpieces, dropping [PAD]/[CLS], for EM answer scoring.

        Parity with ``decode_token_ids`` (reference tokenizer.py:201-213),
        including its leading-space/`##`-join behavior.
        """
        tokens = self._full.ids_to_tokens(list(ids))
        out = ""
        for t in tokens:
            if t in ("[PAD]", "[CLS]"):
                continue
            if t.startswith("##"):
                out += t[2:]
            else:
                out += " " + t
        return out


def build_tokenizers(vocab_file: str, lower_case: bool = True,
                     vocab_extra_ids: int = 100):
    """Build the (BERT, T5) tokenizer pair exactly as the reference does
    (``global_vars.py:84-109``): same wordpiece vocab, T5 gets the sentinels."""
    vocab = load_vocab(vocab_file)
    bert = BertWordPieceTokenizer(vocab, lower_case=lower_case, vocab_extra_ids=0)
    t5 = BertWordPieceTokenizer(vocab, lower_case=lower_case,
                                vocab_extra_ids=vocab_extra_ids)
    return bert, t5


# ---------------------------------------------------------------------------
# Test fixture support: a tiny synthetic vocab so unit tests need no 30k-line
# vocab file on disk.
# ---------------------------------------------------------------------------

_SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]


def toy_vocab(words: Optional[Sequence[str]] = None) -> Dict[str, int]:
    base = list(_SPECIALS)
    base += [chr(c) for c in range(ord("a"), ord("z") + 1)]
    base += [f"##{chr(c)}" for c in range(ord("a"), ord("z") + 1)]
    base += list("0123456789.,?!'\"-()")
    if words:
        base += [w for w in words if w not in base]
    return {tok: i for i, tok in enumerate(dict.fromkeys(base))}
