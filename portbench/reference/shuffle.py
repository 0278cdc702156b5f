"""The trainer's shuffled negatives, in Python: a copy of the port's native
k-let shuffle (rnaelem_tpu_torch/native/rnaelem_native.cpp, the Euler walk
over a random arborescence on the (k-1)-let de Bruijn multigraph) on a
Python mt19937_64, so the reference draws the same negatives as the
program without building or loading its native library."""
from __future__ import annotations

_MASK = (1 << 64) - 1


class MT19937_64:
    """std::mt19937_64 (the C++ standard's parameters, seeded the way its
    one-integer constructor seeds it)."""

    def __init__(self, seed: int):
        mt = [0] * 312
        mt[0] = seed & _MASK
        for i in range(1, 312):
            mt[i] = (6364136223846793005 * (mt[i - 1] ^ (mt[i - 1] >> 62))
                     + i) & _MASK
        self.mt, self.i = mt, 312

    def _twist(self):
        mt = self.mt
        for i in range(312):
            x = (mt[i] & 0xFFFFFFFF80000000) | (mt[(i + 1) % 312]
                                                & 0x7FFFFFFF)
            xa = x >> 1
            if x & 1:
                xa ^= 0xB5026F5AA96619E9
            mt[i] = mt[(i + 156) % 312] ^ xa
        self.i = 0

    def __call__(self) -> int:
        if self.i >= 312:
            self._twist()
        y = self.mt[self.i]
        self.i += 1
        y ^= (y >> 29) & 0x5555555555555555
        y ^= (y << 17) & 0x71D67FFFEDA60000
        y ^= (y << 37) & 0xFFF7EEE000000000
        y ^= y >> 43
        return y & _MASK


def klet_shuffle(seq: str, k: int, seed: int) -> str:
    """rnaelem_native.cpp ``klet_shuffle``: a k-let-preserving shuffle of
    ``seq``, deterministic in ``seed``."""
    n = len(seq)
    if k >= n or n <= 0:
        return seq
    rng = MT19937_64(seed)
    if k <= 1:
        out = list(seq)
        for i in range(n - 1, 0, -1):
            j = rng() % (i + 1)
            out[i], out[j] = out[j], out[i]
        return "".join(out)
    km1 = k - 1
    ids, labels, sv = {}, [], []
    for i in range(n - km1 + 1):
        key = seq[i:i + km1]
        if key not in ids:
            ids[key] = len(labels)
            labels.append(key)
        sv.append(ids[key])
    nv = len(labels)
    adj = [[] for _ in range(nv)]
    for t in range(len(sv) - 1):
        adj[sv[t]].append(sv[t + 1])
    root = sv[-1]
    last_exit = [-1] * nv
    in_tree = [False] * nv
    in_tree[root] = True
    path = [-1] * nv
    for v0 in range(nv):
        v = v0
        while not in_tree[v]:
            a = adj[v]
            if not a:
                raise RuntimeError("klet_shuffle: a vertex with no edge")
            path[v] = a[rng() % len(a)]
            v = path[v]
        v = v0
        while not in_tree[v]:
            last_exit[v] = path[v]
            in_tree[v] = True
            v = path[v]
    out_edges = []
    for v in range(nv):
        rest = list(adj[v])
        if last_exit[v] >= 0 and last_exit[v] in rest:
            rest.remove(last_exit[v])
        for i in range(len(rest) - 1, 0, -1):
            j = rng() % (i + 1)
            rest[i], rest[j] = rest[j], rest[i]
        if last_exit[v] >= 0:
            rest.append(last_exit[v])
        out_edges.append(rest)
    ptr = [0] * nv
    v = sv[0]
    out = [labels[v]]
    for _ in range(len(sv) - 1):
        nxt = out_edges[v][ptr[v]]
        ptr[v] += 1
        out.append(labels[nxt][km1 - 1])
        v = nxt
    return "".join(out)


def negative_for(seq: str, k: int, iter_cnt: int) -> str:
    """The trainer's negative of a read at step ``iter_cnt``: seed =
    count(first base) + iteration, masked to 31 bits
    (motif_trainer.hpp:145-152)."""
    if not seq:
        return seq
    return klet_shuffle(seq, k, (seq.count(seq[0]) + iter_cnt) & 0x7FFFFFFF)
