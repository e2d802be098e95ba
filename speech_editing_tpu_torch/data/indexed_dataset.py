"""Binarized record files, byte-compatible with the JAX package's and the
reference toolkit's: ``<path>.data`` concatenates pickled items and
``<path>.idx`` is an ``np.save``'d dict ``{"offsets": [0, o1, ...]}``.

Unpickling runs code from the file: read only corpora this project's
binarizer (or :class:`IndexedDatasetBuilder`) wrote.
"""

from __future__ import annotations

import pickle
from typing import Any

import numpy as np


class IndexedDataset:
    """Random access to the items of one split. The data file opens at the
    first read, so a dataset can be pickled into loader worker processes
    before any item is read."""

    def __init__(self, path: str):
        self.path = path
        self.data_offsets = np.load(f"{path}.idx", allow_pickle=True).item()["offsets"]
        self.data_file = None

    def __getstate__(self):
        return dict(self.__dict__, data_file=None)

    def close(self) -> None:
        if self.data_file is not None:
            self.data_file.close()
            self.data_file = None

    def __del__(self):
        self.close()

    def __getitem__(self, i: int) -> Any:
        if i < 0 or i >= len(self):
            raise IndexError("index out of range")
        if self.data_file is None:
            self.data_file = open(f"{self.path}.data", "rb", buffering=-1)
        self.data_file.seek(self.data_offsets[i])
        return pickle.loads(self.data_file.read(self.data_offsets[i + 1]
                                                - self.data_offsets[i]))

    def __len__(self) -> int:
        return len(self.data_offsets) - 1


class IndexedDatasetBuilder:
    def __init__(self, path: str):
        self.path = path
        self.out_file = open(f"{path}.data", "wb")
        self.byte_offsets = [0]

    def add_item(self, item: Any) -> None:
        n = self.out_file.write(pickle.dumps(item))
        self.byte_offsets.append(self.byte_offsets[-1] + n)

    def finalize(self) -> None:
        self.out_file.close()
        with open(f"{self.path}.idx", "wb") as f:
            np.save(f, {"offsets": self.byte_offsets})
