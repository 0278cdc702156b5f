"""The trainer's shuffled negatives: a k-let preserving shuffle (Euler
walk) of each read.

Reimplements the behavioral contract of the reference's ushuffle C
library (Jiang et al. uShuffle; RNAelem/ushuffle/ushuffle.c): a uniform
random shuffle of the sequence that exactly preserves all k-let
(substring of length k) counts, built from a random arborescence on the
(k-1)-let de Bruijn multigraph followed by an Euler walk.

``negative_for`` runs the native C++ walk (native/) and nothing else:
its mt19937_64 stream is the JAX package's, so both packages draw the
same negatives.
"""
from __future__ import annotations


def negative_for(seq: str, k: int, iter_cnt: int) -> str:
    """Deterministic shuffled negative for a read: seed =
    count(first base) + iteration, masked to 31 bits
    (motif_trainer.hpp:145-152), through the native walk."""
    if not seq:
        return seq
    from ..native import klet_shuffle_native
    seed = (seq.count(seq[0]) + iter_cnt) & 0x7FFFFFFF
    return klet_shuffle_native(seq, k, seed)
