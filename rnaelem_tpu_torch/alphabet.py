"""Nucleotide alphabet and base-pair encodings.

Reference semantics: RNAelem bio_sequence.hpp:17-62.
Bases are encoded N=0, A=1, C=2, G=3, U/T=4 (NCHAR=5).  Base-pair types are
0=none, 1=CG, 2=GC, 3=GU, 4=UG, 5=AU, 6=UA (NCHAR2=7, i.e. 6 pair kinds).
"""
from __future__ import annotations

import numpy as np

NCHAR = 5          # N A C G U
NCHAR2 = 7         # none + 6 pair types
NACGU = "NACGU"

# BP[a][b] = pair type of (a, b); 0 = not a canonical pair.
BP = np.array(
    [  # N  A  C  G  U
        [0, 0, 0, 0, 0],  # N
        [0, 0, 0, 0, 5],  # A
        [0, 0, 0, 1, 0],  # C
        [0, 0, 2, 0, 3],  # G
        [0, 6, 0, 4, 0],  # U
    ],
    dtype=np.int32,
)

_CODE = np.zeros(256, dtype=np.int32)
for _c, _v in (("Aa", 1), ("Cc", 2), ("Gg", 3), ("UuTt", 4)):
    for _ch in _c:
        _CODE[ord(_ch)] = _v


def seq_to_ints(s: str) -> np.ndarray:
    """Encode a sequence string to int codes (unknown chars -> N=0)."""
    b = np.frombuffer(s.encode("ascii"), dtype=np.uint8)
    return _CODE[b]


def ints_to_seq(a) -> str:
    return "".join(NACGU[int(x)] for x in a)


def is_au_type(t: int) -> bool:
    """GU/UG/AU/UA pairs carry the terminal-AU penalty (energy_param.hpp:92)."""
    return t > 2
