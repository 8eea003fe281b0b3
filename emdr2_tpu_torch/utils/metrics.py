"""Answer-matching metrics, the standard SQuAD/DrQA formulations (a copy of
``emdr2_tpu/utils/metrics.py``, which imports no framework): exact match
over normalized answers, the maximum over the ground truths, and the regex
variant.
"""

from __future__ import annotations

import re
import string
import unicodedata
from typing import Callable, Iterable

_ARTICLES = re.compile(r"\b(a|an|the)\b")
_PUNCT = set(string.punctuation)


def normalize_answer(s: str) -> str:
    s = unicodedata.normalize("NFD", s)
    s = s.lower()
    s = "".join(ch for ch in s if ch not in _PUNCT)
    s = _ARTICLES.sub(" ", s)
    return " ".join(s.split())


def exact_match_score(prediction: str, ground_truth: str) -> bool:
    return normalize_answer(prediction) == normalize_answer(ground_truth)


def regex_match_score(prediction: str, ground_truth: str) -> bool:
    try:
        pattern = re.compile(ground_truth,
                             flags=re.IGNORECASE | re.UNICODE | re.MULTILINE)
    except re.error:
        return False
    return pattern.match(prediction) is not None


def metric_max_over_ground_truths(metric_fn: Callable[[str, str], bool],
                                  prediction: str,
                                  ground_truths: Iterable[str]) -> float:
    return float(max(metric_fn(prediction, gt) for gt in ground_truths))
