"""Memory-mapped token store, format-compatible with the reference's
fairseq-derived ``.idx``/``.bin`` mmap datasets
(``megatron/data/indexed_dataset.py:335-489``).

Binary layout of the ``.idx`` file (little-endian):

    bytes 0-8   magic ``MMIDIDX\\x00\\x00``
    u64         version (=1)
    u8          dtype code (see DTYPES)
    u64         number of sequences
    u64         number of document-index entries
    int32[n]    per-sequence token counts
    int64[n]    per-sequence byte offsets into the .bin file
    int64[d]    document start indices

The ``.bin`` file is a flat concatenation of token arrays. Reads are zero-copy
``np.memmap`` views. Only the mmap variant is implemented — the reference's
lazy/cached variants exist solely for legacy fairseq files.

An optional C++ fast path (``emdr2_tpu.native``) accelerates batched gather of
many sequences into a padded matrix, which is the hot host-side operation when
assembling reader contexts each training step (the reference does this with
per-hit Python loops, ``emdr2_model.py:457-468``).
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Sequence, Union

import numpy as np

MAGIC = b"MMIDIDX\x00\x00"
VERSION = 1

DTYPES = {
    1: np.uint8,
    2: np.int8,
    3: np.int16,
    4: np.int32,
    5: np.int64,
    6: np.float32,
    7: np.float64,
    8: np.uint16,
}
_CODES = {np.dtype(v): k for k, v in DTYPES.items()}


def best_dtype(vocab_size: Optional[int]) -> np.dtype:
    """uint16 when the vocab fits, else int32 (reference :24-27)."""
    if vocab_size is not None and vocab_size < 65500:
        return np.dtype(np.uint16)
    return np.dtype(np.int32)


def index_path(prefix: str) -> str:
    return prefix + ".idx"


def data_path(prefix: str) -> str:
    return prefix + ".bin"


def exists(prefix: str) -> bool:
    return os.path.exists(index_path(prefix)) and os.path.exists(data_path(prefix))


class MMapIndexedDataset:
    """Zero-copy reader over the .idx/.bin pair."""

    def __init__(self, prefix: str):
        with open(index_path(prefix), "rb") as f:
            magic = f.read(9)
            if magic != MAGIC:
                raise ValueError(f"{prefix}.idx is not an MMIDIDX file")
            (version,) = struct.unpack("<Q", f.read(8))
            if version != VERSION:
                raise ValueError(f"unsupported index version {version}")
            (code,) = struct.unpack("<B", f.read(1))
            self.dtype = np.dtype(DTYPES[code])
            (self._len,) = struct.unpack("<Q", f.read(8))
            (doc_count,) = struct.unpack("<Q", f.read(8))
            header_end = f.tell()

        idx_buf = np.memmap(index_path(prefix), mode="r")
        self.sizes = np.frombuffer(idx_buf, np.int32, self._len, offset=header_end)
        self.pointers = np.frombuffer(
            idx_buf, np.int64, self._len, offset=header_end + self.sizes.nbytes
        )
        self.doc_idx = np.frombuffer(
            idx_buf, np.int64, doc_count,
            offset=header_end + self.sizes.nbytes + self.pointers.nbytes,
        )
        self._idx_buf = idx_buf
        self._bin = np.memmap(data_path(prefix), mode="r")
        self._prefix = prefix

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, idx: Union[int, slice]) -> Union[np.ndarray, List[np.ndarray]]:
        if isinstance(idx, slice):
            return [self[i] for i in range(*idx.indices(self._len))]
        if idx < 0:
            idx += self._len
        ptr, size = int(self.pointers[idx]), int(self.sizes[idx])
        return np.frombuffer(self._bin, self.dtype, size, offset=ptr)

    def get(self, idx: int, offset: int = 0, length: Optional[int] = None) -> np.ndarray:
        ptr, size = int(self.pointers[idx]), int(self.sizes[idx])
        if length is None:
            length = size - offset
        return np.frombuffer(
            self._bin, self.dtype, length, offset=ptr + offset * self.dtype.itemsize
        )

    def batch_padded(self, indices: Sequence[int], max_len: int,
                     pad_id: int = 0) -> np.ndarray:
        """Gather many sequences into an [n, max_len] int32 matrix, truncating
        or right-padding with ``pad_id``. Uses the C++ extension when built."""
        indices = np.ascontiguousarray(indices, dtype=np.int64)
        try:
            from emdr2_tpu_torch.native import batch_gather_padded
            return batch_gather_padded(
                self._bin, self.pointers, self.sizes, self.dtype, indices,
                max_len, pad_id,
            )
        except Exception:
            out = np.full((len(indices), max_len), pad_id, dtype=np.int32)
            for row, i in enumerate(indices):
                seq = self[int(i)]
                n = min(len(seq), max_len)
                out[row, :n] = seq[:n]
            return out


class MMapIndexedDatasetBuilder:
    """Streaming writer producing files the reference can also read."""

    def __init__(self, prefix: str, dtype: np.dtype = np.dtype(np.int32)):
        self._prefix = prefix
        self.dtype = np.dtype(dtype)
        self._data_file = open(data_path(prefix), "wb")
        self._sizes: List[int] = []
        self._doc_idx: List[int] = [0]

    def add_item(self, tokens: Sequence[int]) -> None:
        arr = np.asarray(tokens, dtype=self.dtype)
        self._data_file.write(arr.tobytes(order="C"))
        self._sizes.append(len(arr))

    def end_document(self) -> None:
        self._doc_idx.append(len(self._sizes))

    def finalize(self) -> None:
        self._data_file.close()
        with open(index_path(self._prefix), "wb") as f:
            f.write(MAGIC)
            f.write(struct.pack("<Q", VERSION))
            f.write(struct.pack("<B", _CODES[self.dtype]))
            f.write(struct.pack("<Q", len(self._sizes)))
            f.write(struct.pack("<Q", len(self._doc_idx)))
            sizes = np.asarray(self._sizes, dtype=np.int32)
            f.write(sizes.tobytes(order="C"))
            pointers = np.zeros(len(sizes), dtype=np.int64)
            if len(sizes) > 1:
                np.cumsum(sizes[:-1] * self.dtype.itemsize, out=pointers[1:])
            f.write(pointers.tobytes(order="C"))
            f.write(np.asarray(self._doc_idx, dtype=np.int64).tobytes(order="C"))

    def __enter__(self) -> "MMapIndexedDatasetBuilder":
        return self

    def __exit__(self, *exc) -> None:
        if not self._data_file.closed:
            self.finalize()


def make_dataset(prefix: str) -> MMapIndexedDataset:
    return MMapIndexedDataset(prefix)
