"""BERT-style WordPiece tokenization, implemented from scratch.

Behavioral parity target: the reference's Google-BERT tokenizer
(``megatron/tokenizer/bert_tokenization.py``) — unicode
cleanup, optional lowercasing + accent stripping, punctuation splitting,
CJK-character isolation, then greedy longest-match-first wordpiece with the
``##`` continuation prefix and ``[UNK]`` fallback for words longer than 200
chars or with no match.

This module is pure Python/CPU; tokenization happens in the input pipeline,
never on device.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, Iterable, List


def load_vocab(vocab_file: str) -> Dict[str, int]:
    """Load a one-token-per-line vocab file into an ordered {token: id} dict."""
    vocab: Dict[str, int] = {}
    with open(vocab_file, "r", encoding="utf-8") as f:
        for line in f:
            token = line.rstrip("\n")
            if token and token not in vocab:
                vocab[token] = len(vocab)
    return vocab


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges treated as punctuation even when unicode says otherwise
    # (e.g. '$', '`') — matches BERT semantics.
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


class BasicTokenizer:
    """Whitespace/punctuation/CJK splitting with optional lowercasing."""

    def __init__(self, lower_case: bool = True):
        self.lower_case = lower_case

    def tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        text = self._space_cjk(text)
        out: List[str] = []
        for word in text.split():
            if self.lower_case:
                word = word.lower()
                word = self._strip_accents(word)
            out.extend(self._split_punct(word))
        return out

    @staticmethod
    def _clean(text: str) -> str:
        chars = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            chars.append(" " if _is_whitespace(ch) else ch)
        return "".join(chars)

    @staticmethod
    def _space_cjk(text: str) -> str:
        chars = []
        for ch in text:
            if _is_cjk(ord(ch)):
                chars.append(f" {ch} ")
            else:
                chars.append(ch)
        return "".join(chars)

    @staticmethod
    def _strip_accents(word: str) -> str:
        return "".join(
            ch for ch in unicodedata.normalize("NFD", word)
            if unicodedata.category(ch) != "Mn"
        )

    @staticmethod
    def _split_punct(word: str) -> List[str]:
        pieces: List[str] = []
        current: List[str] = []
        for ch in word:
            if _is_punctuation(ch):
                if current:
                    pieces.append("".join(current))
                    current = []
                pieces.append(ch)
            else:
                current.append(ch)
        if current:
            pieces.append("".join(current))
        return pieces


class WordPieceTokenizer:
    """Greedy longest-match-first subword splitting over a fixed vocab."""

    def __init__(self, vocab: Dict[str, int], unk_token: str = "[UNK]",
                 max_word_chars: int = 200):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_word_chars = max_word_chars

    def tokenize(self, word: str) -> List[str]:
        if len(word) > self.max_word_chars:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        n = len(word)
        while start < n:
            end = n
            match = None
            while end > start:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    match = piece
                    break
                end -= 1
            if match is None:
                return [self.unk_token]
            pieces.append(match)
            start = end
        return pieces


class FullTokenizer:
    """Basic + wordpiece composition, mirroring BERT's two-stage pipeline."""

    def __init__(self, vocab: Dict[str, int], lower_case: bool = True):
        self.vocab = vocab
        self.inv_vocab = {v: k for k, v in vocab.items()}
        self.basic = BasicTokenizer(lower_case=lower_case)
        self.wordpiece = WordPieceTokenizer(vocab)

    @classmethod
    def from_file(cls, vocab_file: str, lower_case: bool = True) -> "FullTokenizer":
        return cls(load_vocab(vocab_file), lower_case=lower_case)

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self.basic.tokenize(text):
            out.extend(self.wordpiece.tokenize(word))
        return out

    def tokens_to_ids(self, tokens: Iterable[str]) -> List[int]:
        return [self.vocab[t] for t in tokens]

    def ids_to_tokens(self, ids: Iterable[int]) -> List[str]:
        """Unknown ids map to [UNK]: model vocabs are padded past the real
        vocab (tokenizer.py pad_vocab_size), so an untrained model can emit
        ids in the padding region during generation."""
        unk = "[UNK]" if "[UNK]" in self.vocab else ""
        return [self.inv_vocab.get(int(i), unk) for i in ids]
