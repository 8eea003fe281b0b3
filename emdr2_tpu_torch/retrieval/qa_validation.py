"""Answer-in-passage matching for retrieval recall@k (a copy of
``emdr2_tpu/retrieval/qa_validation.py``, framework-free).

``SimpleTokenizer`` splits text into runs of letters, digits and marks
(Unicode categories L*, N*, M*), and makes every other character that is
neither a separator (Z*) nor a control or unassigned one (C*) a token of
its own: the JAX module's ``[\\p{L}\\p{N}\\p{M}]+|[^\\p{Z}\\p{C}]`` pattern,
written with the standard library's ``unicodedata`` so that the port needs
no ``regex`` package. Matching is an uncased token-subsequence test after
NFD normalization ('string') or a full-text regular expression ('regex').

Two shortcuts keep a recall@100 over thousands of questions cheap on the
host, with the same results: ASCII text is split by one stdlib regular
expression (for ASCII the categories above are letters and digits, the
space, and the control characters), and an answer is looked for only where
its first word occurs (``list.index``).
"""

from __future__ import annotations

import re
import unicodedata
from multiprocessing.pool import ThreadPool
from typing import Callable, List, NamedTuple, Sequence, Tuple


# ASCII: words are [A-Za-z0-9] runs, the space (Zs) and the controls (Cc)
# are skipped, every other character is a token
_ASCII_TOKEN = re.compile(r"[A-Za-z0-9]+|[^A-Za-z0-9 \x00-\x1f\x7f]")


def _kind(ch: str) -> str:
    """'w' for a word character, 's' for a skipped one, 'o' otherwise."""
    cat = unicodedata.category(ch)[0]
    if cat in "LNM":
        return "w"
    return "s" if cat in "ZC" else "o"


class SimpleTokenizer:
    """Regex-free word tokenizer (DrQA-equivalent behavior for answer
    matching)."""

    def tokenize(self, text: str) -> List[str]:
        if text.isascii():
            return _ASCII_TOKEN.findall(text)
        tokens, start = [], None
        for i, ch in enumerate(text):
            kind = _kind(ch)
            if kind == "w":
                if start is None:
                    start = i
                continue
            if start is not None:
                tokens.append(text[start:i])
                start = None
            if kind == "o":
                tokens.append(ch)
        if start is not None:
            tokens.append(text[start:])
        return tokens

    def words(self, text: str, uncased: bool = True) -> List[str]:
        if uncased and text.isascii():
            return _ASCII_TOKEN.findall(text.lower())
        toks = self.tokenize(text)
        return [t.lower() for t in toks] if uncased else toks


def _normalize(text: str) -> str:
    return unicodedata.normalize("NFD", text)


def regex_match(text: str, pattern: str) -> bool:
    try:
        compiled = re.compile(pattern,
                              flags=re.IGNORECASE | re.UNICODE | re.MULTILINE)
    except re.error:
        return False
    return compiled.search(text) is not None


def has_answer(answers: Sequence[str], text: str,
               tokenizer: SimpleTokenizer, match_type: str = "string") -> bool:
    """True iff any answer occurs in the passage (token subsequence for
    'string', full-text regex for 'regex')."""
    text = _normalize(text)
    if match_type == "regex":
        return any(regex_match(text, _normalize(a)) for a in answers)

    words = tokenizer.words(text)
    for answer in answers:
        ans = tokenizer.words(_normalize(answer))
        if not ans:
            continue
        n, start = len(ans), 0
        while True:
            try:
                i = words.index(ans[0], start)
            except ValueError:
                break
            if words[i: i + n] == ans:
                return True
            start = i + 1
    return False


class QAMatchStats(NamedTuple):
    top_k_hits: List[int]            # cumulative hits at each rank
    questions_doc_hits: List[List[bool]]


def calculate_matches(doc_text_fn: Callable[[int], str],
                      answers: Sequence[Sequence[str]],
                      closest_docs: Sequence[Tuple[Sequence[int],
                                                   Sequence[float]]],
                      workers_num: int = 4,
                      match_type: str = "string") -> QAMatchStats:
    """Per-question top-k answer hits and the cumulative ``top_k_hits``
    vector. ``doc_text_fn`` maps a passage id to its text."""
    tokenizer = SimpleTokenizer()

    def check(args):
        ans, (doc_ids, _scores) = args
        return [has_answer(ans, doc_text_fn(int(d)), tokenizer, match_type)
                for d in doc_ids]

    items = list(zip(answers, closest_docs))
    if workers_num > 1:
        with ThreadPool(workers_num) as pool:
            scores = pool.map(check, items)
    else:
        scores = [check(it) for it in items]

    n_docs = len(closest_docs[0][0])
    top_k_hits = [0] * n_docs
    for hits in scores:
        best = next((i for i, x in enumerate(hits) if x), None)
        if best is not None:
            for j in range(best, n_docs):
                top_k_hits[j] += 1
    return QAMatchStats(top_k_hits, scores)
