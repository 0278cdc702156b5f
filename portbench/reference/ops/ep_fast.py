"""Frozen copy of rnaelem_tpu_torch/ops/ep_fast.py for the benchmark's plain
reference (portbench/reference): plain PyTorch and numpy only, the
CUDA kernel branches removed, imports kept inside this copy.

Factored internal-loop (TT_E_P) energy tables.

loop_energy (energy_param.hpp:744-795) is factorized by case:
    long loops:   misA[j,w] + misB[l,v] + internal[u1+u2] + ninio[|u1-u2|]
    bulges u>=2:  au_out[j,w] + au_in[l,v] + bulge[u]
with per-cell tables misA/misB/au precomputed once per sequence
(``seq_tables``) and the size term a small static matrix SZ[u1, u2]
(``build_ep_static``).  The six base-coupled cases — stack-adjacent
bulges (0,1)/(1,0) and short internals (1,1)/(1,2)/(2,1)/(2,2) — are
per-(j, w) ``spec_il`` energies.

Coordinates (cell (j, w) = span (i, j), i = j - w): inner pair P cell at
column l = j - dl, width v; left gap u1 = dk = w - r with r = dl + v;
right gap u2 = dl.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

MAXLOOP = 30


class EpStatic(NamedTuple):
    SZ: np.ndarray      # [n_class, Cp+1(u1), Cp+1(u2)] log sizes, -inf out
    grp: np.ndarray     # [n_class] -> misA/misB table row (0..3)


def build_ep_static(g, Cp: int, energy_np, no_ene: bool) -> EpStatic:
    """Static size/asymmetry classes of the long internal loops and
    bulges; ``grp`` names the misA/misB row each class multiplies."""
    u1 = np.arange(Cp + 1)[:, None]
    u2 = np.arange(Cp + 1)[None, :]
    usum = u1 + u2
    if no_ene:
        SZ = np.where(usum >= 1, 0.0, -np.inf)[None]
        grp = np.array([3])
    else:
        internal = np.asarray(energy_np["internal"])
        ninio = np.asarray(energy_np["ninio"])
        bulge = np.asarray(energy_np["bulge"])
        uc = np.clip(usum, 0, MAXLOOP)
        lg = internal[uc] + ninio[np.clip(np.abs(u1 - u2), 0, MAXLOOP)]
        longok = (u1 >= 1) & (u2 >= 1) & (np.maximum(u1, u2) >= 3) \
            & (usum <= MAXLOOP)
        is1n = longok & ((u1 == 1) | (u2 == 1))
        is23 = longok & (usum == 5) & ~((u1 == 1) | (u2 == 1))
        isi = longok & ~is1n & ~is23
        bR = (u1 == 0) & (u2 >= 2) & (u2 <= MAXLOOP)
        bL = (u2 == 0) & (u1 >= 2) & (u1 <= MAXLOOP)
        SZ = np.stack([
            np.where(is1n, lg, -np.inf),
            np.where(is23, lg, -np.inf),
            np.where(isi, lg, -np.inf),
            np.where(bR, bulge[np.clip(u2, 0, MAXLOOP)], -np.inf),
            np.where(bL, bulge[np.clip(u1, 0, MAXLOOP)], -np.inf),
        ])
        grp = np.array([0, 1, 2, 3, 3])
    return EpStatic(SZ=SZ, grp=grp)


def seq_tables(tab, seq, Lp: int, Wp: int, no_ene: bool, dtype):
    """Per-sequence [..., 4, Lp+1, Wp+1] mismatch/au tables, pair types
    and the six base-coupled internal-loop energies (plain version of the
    score-table kernel's row B).

    Outer cell (j, w): closing pair (i-1, j), i = j-w, mismatch bases
    (s[i], s[j-1]).  Inner cell (l, v): pair (k, l-1), k = l-v,
    type2 = bp(s[l-1], s[k]), mismatch bases (s[l], s[k-1]).
    seq is [..., Lp]; outputs carry the same leading shape.
    """
    dev = seq.device
    j = torch.arange(Lp + 1, device=dev)[:, None]
    w = torch.arange(Wp + 1, device=dev)[None, :]
    i = j - w
    lead = seq.shape[:-1]
    nd = len(lead)

    def sg(idx):
        return seq[..., torch.clamp(idx + 0 * w, 0, Lp - 1)]

    if no_ene:
        z = torch.zeros(lead + (4, Lp + 1, Wp + 1), dtype=dtype, device=dev)
        ti = torch.zeros(lead + (Lp + 1, Wp + 1), dtype=torch.int32,
                         device=dev)
        return dict(misA=z, misB=z.clone(), t_out=ti, t_in=ti.clone(),
                    spec_il=torch.zeros(lead + (6, Lp + 1, Wp + 1),
                                        dtype=dtype, device=dev))
    bp = tab["bp"]
    zero = torch.zeros((), dtype=dtype, device=dev)
    t_out = bp[sg(i - 1), sg(j)]
    b_i, b_jm = sg(i), sg(j - 1)
    misA = torch.stack([
        tab["mismatch_1n"][t_out, b_i, b_jm],
        tab["mismatch_23"][t_out, b_i, b_jm],
        tab["mismatch_i"][t_out, b_i, b_jm],
        torch.where(t_out > 2, tab["term_au"], zero),
    ], dim=nd).to(dtype)
    l, v = j, w
    t_in = bp[sg(l - 1), sg(l - v)]
    b_l, b_km = sg(l), sg(l - v - 1)
    misB = torch.stack([
        tab["mismatch_1n"][t_in, b_l, b_km],
        tab["mismatch_23"][t_in, b_l, b_km],
        tab["mismatch_i"][t_in, b_l, b_km],
        torch.where(t_in > 2, tab["term_au"], zero),
    ], dim=nd).to(dtype)

    # base-coupled specials: per-(j, w) energies for the six (dk, dl)
    # combos; out-of-band indices are clipped — those entries multiply
    # zero DP weights
    def idx2(joff, woff):
        return t_in[..., torch.clamp(j - joff, 0, Lp),
                    torch.clamp(w - woff, 0, Wp)]

    b_i1 = sg(i + 1)
    b_j2 = sg(j - 2)
    bulge1 = tab["bulge"][1]
    spec_il = torch.stack([
        bulge1 + tab["stack"][t_out, idx2(1, 1)],            # (0,1)
        bulge1 + tab["stack"][t_out, idx2(0, 1)],            # (1,0)
        tab["int11"][t_out, idx2(1, 2), b_i, b_jm],          # (1,1)
        tab["int21"][t_out, idx2(2, 3), b_i, b_j2, b_jm],    # (1,2)
        tab["int21"][idx2(1, 3), t_out, b_jm, b_i, b_i1],    # (2,1)
        tab["int22"][t_out, idx2(2, 4), b_i, b_i1, b_j2, b_jm],  # (2,2)
    ], dim=nd).to(dtype)
    return dict(misA=misA, misB=misB, t_out=t_out.to(torch.int32),
                t_in=t_in.to(torch.int32), spec_il=spec_il)
