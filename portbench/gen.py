"""The traffic generator: the reads of a cell from its mix and the seed.

Every seed gets the same multiset of read lengths (a block of ``batch``
lengths spread evenly over [len_min, len_max], repeated; the whole mix
is one block where it has no batch), in an order drawn from the seed, and
uniform random bases: the seed changes which reads, not how much work."""
from __future__ import annotations

import os

import numpy as np

BASES = "ACGU"


def lengths(mix: dict, seed: int) -> np.ndarray:
    n, lo, hi = mix["reads"], mix["len_min"], mix["len_max"]
    block = mix.get("batch", n)
    tmpl = lo + (np.arange(block) * (hi - lo) + (block - 1) // 2) \
        // max(1, block - 1)
    rng = np.random.Generator(np.random.PCG64(seed))
    out = np.concatenate([rng.permutation(tmpl)
                          for _ in range(-(-n // block))])[:n]
    return out.astype(np.int64)


def reads(mix: dict, seed: int) -> list:
    """The mix's reads as strings of ACGU."""
    Ls = lengths(mix, seed)
    rng = np.random.Generator(np.random.PCG64([seed, 1]))
    codes = rng.integers(0, 4, int(Ls.sum()))
    out, k = [], 0
    for L in Ls:
        out.append("".join(BASES[c] for c in codes[k:k + L]))
        k += L
    return out


def write_fastq(path: str, seqs: list, quality: int, flagged: bool):
    """FASTQ with flat qualities and the has-motif sentinel ('!' flags a
    positive) as the quality line's last character."""
    q = chr(33 + quality)
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write("@r%d\n%s\n+\n%s%s\n" % (i, s, q * len(s),
                                             "!" if flagged else q))
    return os.path.getsize(path)
