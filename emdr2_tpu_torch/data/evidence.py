"""Evidence corpus: pre-tokenized passage/title stores + title-neighbor map.

Replaces three reference pieces:

- ``OpenRetrievalEvidenceDataset`` (``megatron/data/
  orqa_wiki_dataset.py:140-209``) — which keeps all 21M TSV rows as Python
  strings in RAM and re-tokenizes per epoch. Here passages and titles are
  pre-tokenized mmap stores (built once by ``tools/build_evidence.py``),
  giving zero-copy token access.
- ``WikiTitleDocMap`` (``tools/inverted_title_index.py:
  14-64``) — title -> sorted doc-id list; ``neighbours(doc_id)`` returns the
  3-passage window around a hit and the hit's position (0 first / 1 middle /
  -1 last), used to extend reader contexts.
- the per-hit token fetch in ``get_topk`` (``model/emdr2_model.py:457-468``),
  including the 1-based doc-id -> 0-based row convention
  (``passages_map[doc_id-1]``).
"""

from __future__ import annotations

import bisect
import csv
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from emdr2_tpu_torch.data.indexed_dataset import MMapIndexedDataset


class TitleDocMap:
    """doc_id -> sorted list of doc ids sharing the same title."""

    def __init__(self, doc_groups: Dict[int, List[int]]):
        # doc_groups maps doc_id -> the (shared, sorted) group list
        self._groups = doc_groups

    @classmethod
    def from_keys(cls, keys: Sequence) -> "TitleDocMap":
        """Build from per-document grouping keys (e.g. title strings or
        title-token-bytes), where doc_id = position + 1 (1-based)."""
        by_key: Dict = {}
        for i, key in enumerate(keys):
            by_key.setdefault(key, []).append(i + 1)
        groups: Dict[int, List[int]] = {}
        for ids in by_key.values():
            ids.sort()
            for doc_id in ids:
                groups[doc_id] = ids
        return cls(groups)

    @classmethod
    def from_title_store(cls, titles: MMapIndexedDataset) -> "TitleDocMap":
        """Group by tokenized-title bytes — no TSV needed."""
        return cls.from_keys(titles[i].tobytes() for i in range(len(titles)))

    @classmethod
    def from_tsv(cls, path: str) -> "TitleDocMap":
        """Parity constructor for the reference's psgs_w100.tsv
        (inverted_title_index.py:39-64): columns doc_id, text, title."""
        csv.field_size_limit(sys.maxsize)
        keys = []
        with open(path) as f:
            reader = csv.reader(f, delimiter="\t")
            next(reader, None)
            for row in reader:
                keys.append(row[2])
        return cls.from_keys(keys)

    def neighbours(self, doc_id: int) -> Tuple[List[int], int]:
        """3-passage window around doc_id + its position (0/1/-1).

        Exact semantics of ``get_neighbour_paragraphs``
        (inverted_title_index.py:22-37)."""
        group = self._groups[doc_id]
        i = bisect.bisect_left(group, doc_id)
        assert i < len(group) and group[i] == doc_id
        if i == 0:
            return group[i: i + 3], 0
        if i == len(group) - 1:
            return group[i - 2: i + 1], -1
        return group[i - 1: i + 2], 1


class EvidenceCorpus:
    """Pre-tokenized evidence: passage tokens, title tokens, neighbor map.

    doc ids are 1-based (reference convention); row r stores doc_id r+1.
    """

    def __init__(self, passages: MMapIndexedDataset,
                 titles: MMapIndexedDataset,
                 title_map: Optional[TitleDocMap] = None):
        assert len(passages) == len(titles)
        self.passages = passages
        self.titles = titles
        self.title_map = title_map or TitleDocMap.from_title_store(titles)
        self._ntable = None

    def neighbour_table(self):
        """Dense per-row neighbour windows for the C++ postprocess:
        (win [N,3] int64 1-based ids 0-padded, pos [N] int8 in {0,1,-1},
        wlen [N] int8). Built once and cached."""
        if self._ntable is None:
            import numpy as np
            n = len(self)
            win = np.zeros((n, 3), np.int64)
            pos = np.zeros(n, np.int8)
            wlen = np.zeros(n, np.int8)
            for doc_id in range(1, n + 1):
                docs, p = self.neighbours(doc_id)
                win[doc_id - 1, : len(docs)] = docs
                pos[doc_id - 1] = p
                wlen[doc_id - 1] = len(docs)
            self._ntable = (win, pos, wlen)
        return self._ntable

    @classmethod
    def load(cls, text_prefix: str, title_prefix: str) -> "EvidenceCorpus":
        return cls(MMapIndexedDataset(text_prefix),
                   MMapIndexedDataset(title_prefix))

    def __len__(self) -> int:
        return len(self.passages)

    def doc_tokens(self, doc_id: int) -> List[int]:
        return self.passages[doc_id - 1].tolist()

    def title_tokens(self, doc_id: int) -> List[int]:
        return self.titles[doc_id - 1].tolist()

    def neighbours(self, doc_id: int) -> Tuple[List[int], int]:
        return self.title_map.neighbours(doc_id)
