"""FASTQ reading with the reference's epoch/batch semantics.

Mirrors fastq_io.hpp: whole-file slurp, deterministic epoch shuffling with
an incrementing mt19937-style seed, batch windows, and phred-quality
positional weights with the trailing has-motif sentinel (qual 0 == '!').

Pure-Python parsing; the JAX package's native index is not carried over.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..alphabet import seq_to_ints


@dataclasses.dataclass
class Read:
    id: str
    seq: np.ndarray    # int codes
    qual: np.ndarray   # ints (phred, base subtracted)
    rss: str = ""


class FastqReader:
    """fastq_io.hpp:23-130 semantics (sanger base 33 by default)."""

    def __init__(self, fname: str = None, encoding: str = "sanger"):
        self._base = {"sanger": 33, "solexa": 64, "illumina1.3": 64,
                      "illumina1.5": 64, "illumina1.8": 33}[encoding]
        self._ids: List[str] = []
        self._seqs: List[np.ndarray] = []
        self._quals: List[np.ndarray] = []
        self._order: np.ndarray = np.zeros(0, np.int64)
        self._cnt = 0
        self._cnt_shf = 0
        if fname:
            self.open(fname)

    def open(self, fname: str):
        self._ids, self._seqs, self._quals = [], [], []
        with open(fname, "rb") as f:
            data = f.read()
        lines = data.decode("ascii").split("\n")
        for k in range(0, len(lines) - 3, 4):
            rid, seq, plus, qual = lines[k:k + 4]
            if not qual or not plus:
                break
            self._ids.append(rid)
            self._seqs.append(seq_to_ints(seq))
            self._quals.append(
                np.frombuffer(qual.encode("ascii"), np.uint8)
                .astype(np.int64) - self._base)
        self._order = np.arange(len(self._ids))
        self._cnt = 0
        self._cnt_shf = 0

    def N(self) -> int:
        return len(self._ids)

    def cnt(self) -> int:
        return self._cnt

    def is_end(self) -> bool:
        return self._cnt == self.N()

    def clear(self):
        self._cnt = 0

    def skip(self, n=1):
        self._cnt += n

    def shuffle(self):
        rng = np.random.RandomState(self._cnt_shf)
        rng.shuffle(self._order)
        self._cnt_shf += 1

    def get_read(self) -> Read:
        k = self._order[self._cnt]
        self._cnt += 1
        return Read(id=self._ids[k], seq=self._seqs[k],
                    qual=self._quals[k])

    def reads(self):
        while not self.is_end():
            yield self.get_read()


class FastqBatchReader:
    """fastq_io.hpp:132-167: batch windows over an epoch-shuffled reader."""

    def __init__(self, fname: str = None, encoding: str = "sanger"):
        self._qr = FastqReader(fname, encoding)
        self._N_batch = None
        self._cnt = 0
        self._cnt_epoc = 0

    def open(self, fname: str):
        self._qr.open(fname)
        self._cnt = 0
        self._cnt_epoc = 0

    def set_batch_size(self, n: int):
        self._N_batch = self._qr.N() if n < 0 else n

    def get_read(self) -> Read:
        self._cnt += 1
        return self._qr.get_read()

    def is_end(self) -> bool:
        return self._N_batch <= self._cnt or self._qr.is_end()

    def is_end_epoc(self) -> bool:
        return self._qr.is_end()

    def clear(self):
        if self.is_end_epoc():
            self._qr.shuffle()
            self._qr.clear()
            self._cnt_epoc += 1
        self._cnt = 0

    def skip(self, n=1):
        self._cnt += n
        self._qr.skip(n)

    def cnt(self):
        return self._cnt

    def cnt_epoc(self):
        return self._cnt_epoc

    def N(self):
        return self._qr.N()

    def N_batch(self):
        return self._N_batch

    def orig(self):
        return self._qr
