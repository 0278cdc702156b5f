"""Frozen byte and operation counts of the port's DP stages, from the
shapes and masks of a batch: a copy of chip_smoke.py's score_work,
batch_counts and column_work (each input cell read once, each output cell
written once, only what the batch's masks admit), fed from the
reference's own grammar compile, factors and min-BPP masks
(portbench/reference), never from the program's state.  ``step_work``
and ``scan_call_work`` sum them over a training step and a scan call;
``least_s`` turns (bytes, operations) into the least time at the peaks
of ``peaks.json``."""
from __future__ import annotations

import dataclasses
import json
import os
from typing import NamedTuple

import numpy as np
import torch

from ..reference.energy.tables import FLOAT_TABLES
from ..reference.model import joint as J
from ..reference.shuffle import negative_for
from ..reference.alphabet import ints_to_seq, seq_to_ints

PEAKS = json.load(open(os.path.join(os.path.dirname(__file__),
                                    "peaks.json")))


def least_s(by, ops, dtype):
    """The least seconds of (bytes, operations): the larger of bytes over
    the memory rate and operations over the dtype's peak."""
    return max(by / PEAKS["mem_bytes_per_s"],
               ops / PEAKS["flops_per_s"][str(dtype)])


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class HostConsts(NamedTuple):
    """What the counts read of a batch's constant factors, as numpy."""
    okP: np.ndarray
    okB: np.ndarray
    okE: np.ndarray
    okM: np.ndarray
    ext: np.ndarray
    C: np.ndarray


def host_consts(c) -> HostConsts:
    return HostConsts(*[_np(getattr(c, k)) for k in HostConsts._fields])


def _band_cells(Wp, n):
    """Cells (row j - k, width v) with k = 0..n and k + v <= Wp: the
    triangle of a band window that a gap of at most n reaches."""
    n = np.minimum(n, Wp)
    return np.where(n >= 0, (n + 1) * (Wp + 1) - n * (n + 1) // 2, 0)


def score_work(cfg, c, tab, B, itemsize):
    """K1 (one batch): seq/L/bp_ok/dots_cum in; the energy tables, of
    which the loop key tables (tri/tetra/hexa) give at most one entry per
    (j, read); 19 float + 2 int32 + 4 bool planes out; ~40 operations per
    cell."""
    Lp, W1 = cfg.Lp, cfg.Wp + 1
    cells = (Lp + 1) * W1 * B
    tab_n = sum(min(tab[k].numel(), (Lp + 1) * B)
                if k in ("tri", "tetra", "hexa") else tab[k].numel()
                for k in FLOAT_TABLES)
    by = B * Lp * 8 + B * 8 + cells + B * (Lp + 1) * 4 + tab_n * itemsize \
        + cells * (19 * itemsize + 2 * 4 + 4)
    return by, 40.0 * cells


def batch_counts(cfg, st, c, B):
    """The column-independent quantities of a batch the column counts
    use: state sets and list sizes of the grammar, the per-read loop cap
    C_b = min(C, Cp) and the internal-loop cells it admits."""
    Wp, Cp, S = cfg.Wp, cfg.Cp, st.dims.S
    g = st.g
    kk = {k: _np(v) for k, v in st.k.items()}
    states = lambda *ks: set(np.concatenate([kk[k].ravel() for k in ks]))
    q = dict(Wp=Wp, S=S, W1=Wp + 1, C1=Cp + 1,
             B=B, CC=(Wp + 1) * S * B, WB=(Wp + 1) * B, SB=S * B,
             n_rt=len(states("rt_s")), n_b1=len(states("b12_a")),
             n_c=len(states("b12_c")), nb=len(g.b12_tuples),
             n_pt_src=int((kk["pt_code"] != -1).any(0).sum()),
             n_tab=len(set(kk["pt_code"][kk["pt_code"] >= 0].ravel())),
             pt_nnz=int((kk["pt_code"] != -1).sum()), rt_nnz=len(kk["rt_s"]),
             lt_nnz=len(kk["lt_s"]), n_op=len(g.op_tuples),
             n_opa=len(states("op_a")), n_opc=len(states("op_c")),
             n_opc_rt=len(states("op_c", "rt_s")),
             have_ep=st.have_ep)
    if st.have_ep:
        Cb = np.minimum(c.C.astype(np.int64), Cp)
        pc = _band_cells(Wp, Cb)                       # P cells per read
        x = np.arange(Wp + 1)[:, None, None]
        u1 = np.arange(Cp + 1)[None, :, None]
        dl = np.arange(Cp + 1)[None, None, :]
        geo = (x + u1 <= Wp) & (dl <= x)
        caps, n_caps = np.unique(Cb, return_counts=True)
        q.update(
            pc=int(pc.sum()), cb1=int((Cb + 1).clip(min=0).sum()),
            n_s1=len(states("p13_s1")), n_s2=len(states("k2_s2")),
            n_s3=len(states("p13_s3")),
            n_s3x=len(states("p13_s3") - states("k2_s2")),
            eszg=2 * 4 * (Cp + 1) * (Cp + 2) // 2,
            vterms=sum(int(n) * int((geo & (dl + u1 <= cb)).sum())
                       for cb, n in zip(caps, n_caps)),
            n_xu=int(_band_cells(Wp, Cp)),
            spec=(0 if cfg.no_ene else
                  6 * (Wp + 1) * st.n2 * (2 * st.n13 / st.n_ar + 3)))
    return q


def column_work(cfg, st, c, q, j, itemsize, need):
    """{kernel: (bytes, operations)} of K2-K7 at column j, each kernel
    counted as one function of what its stage needs: each input cell read
    once, in the states it reads, each output cell written once (a
    cotangent it adds to is read and written); where the extent depends
    on the data (the band masks, the per-read loop cap C, finite exterior
    energies) only what this batch needs is counted.  The scratch that
    the kernels' functions pass to one another (K3's and K6's partial
    sums of their blocks, K5's column cotangents of M and B and its
    eR/bg2 partials) is not counted: a fused kernel would not move it.
    Operations are the stage's arithmetic, summed over its functions.

    ``need`` names the groups of leaf cotangents the caller keeps besides
    the tables' own: "weights" (eR, eL, bg2, pv: the singles' and pairs'
    gradient), "lam" (lambda's per-cell partials DL, the size-weight
    partials GSZ and the hoisted exponentials emisA and emisB, which
    depend on lambda alone) and "alphaP" (the injected pair factor, whose
    cotangent is the pair posterior).  A group left out is not counted:
    its bytes, and the operations that only it needs (K5's eR/eL/pv, DL
    and alphaP adds, K6's emisA/emisB/GSZ spreads, K7's eR and DL
    sums)."""
    wts, lmb, alp = ("weights" in need, "lam" in need, "alphaP" in need)
    it = itemsize
    B, S, W1, Wp, C1 = q["B"], q["S"], q["W1"], q["Wp"], q["C1"]
    CC, WB, SB = q["CC"], q["WB"], q["SB"]
    okP = c.okP[j]                         # [W1, B]
    okB = c.okB[j]
    okE = c.okE[j]
    okM = c.okM[j]
    wv = np.arange(W1)[:, None]
    okP2 = int((okP & (wv >= 2)).sum())                 # cells reading E/P
    okB1 = int((okB & (wv >= 1)).sum())                 # cells reading T2
    tri1 = int((okB * wv).sum())                        # T1 (dk, w) cells
    nP, nE, nM, nB = (int(m.sum()) for m in (okP, okE, okM, okB))
    pvb = nP * q["n_tab"]                               # pair emissions
    out = {}

    # K2 (inside_band)
    by2 = it * (
        Wp * q["n_rt"] * B + okB1 * q["n_rt"] + 2 * okP2 * q["n_pt_src"]
        + tri1 * q["n_b1"] + pvb
        + 2 * W1 * S * B + S * B                        # eL rows, ep, eR
        + 8 * WB + B                                    # per-cell planes
        + 7 * CC) + 4 * WB                              # 7 rows out; masks
    ops2 = 2.0 * (tri1 * q["nb"] + okB1 * q["rt_nnz"] + WB * q["rt_nnz"]
                  + 2 * okP2 * q["pt_nnz"] + WB * q["lt_nnz"])
    out["inside_band"] = (by2, ops2)

    # K3 (inside_ep), per read with its cap C_b: P cells (j - dl, v) with
    # dl <= C_b, dl + v <= Wp; left-flank LL cells (j - x, u1) with
    # u1 <= C_b, x + u1 <= Wp (the right flank, LL row j up to width C_b,
    # lies in that set); emisB on the P cells; emisA, spec_il rows j; the
    # read-independent size weights eSZg; ep out
    if q["have_ep"]:
        by3 = it * (
            q["pc"] * (q["n_s1"] + q["n_s2"] + 2 * 4) + q["cb1"] * q["n_s3x"]
            + B * W1 * (2 * 4 + (0 if cfg.no_ene else 6)) + q["eszg"]
            + W1 * S * B) + 4 * B + (4 * (cfg.Lp + 1) * B if cfg.fix_rss
                                     else 0)
        ops3 = 2.0 * (q["vterms"] * (2 * st.n_ar + 12) + q["pc"] * (
            st.n13 + st.n2)) + 2.0 * B * q["spec"]
        out["inside_ep"] = (by3, ops3)
    else:
        out["inside_ep"] = (it * CC, 0.0)

    # K4 (inside_ext): for each w >= 1 with a finite exterior energy, P row
    # j at width w and O row j - w in the split tuples' states (row j - 1
    # also in the chain's sources); ext, eR rows; O row j out
    ext_ok = np.isfinite(c.ext[j]) & (wv >= 1)
    n_ext = int(ext_ok.sum())
    by4 = it * (n_ext * q["n_opa"] + int(ext_ok[2:].sum()) * q["n_opc"]
                + q["n_opc_rt"] * B + WB + SB + B + SB)
    ops4 = 2.0 * (n_ext * q["n_op"] + B * q["rt_nnz"])
    out["inside_ext"] = (by4, ops4)

    # K5 (outside_band): the adjoint of K2's E, M, B/T1 and L/P/T2 at
    # column j; liveX = the cells of table X its mask admits (E, M, B/T1/T2)
    # in all S states.  Forward cells: E, LL, M, ep at live E; M, Bt at
    # live M; T1, T2, Bt at live B; the T1 triangle and the T2 rows of the
    # splits; rows j of LL, P, T2 and j-1 of LL, E, P, T2; eL rows, eR row,
    # gates, per-cell planes, bg2, pv.  Cotangents: rows j of gE, gLL, gP,
    # gT1, gT2 read; rows j-1 of gLL, gE, gP, gT2, the triangle's and the
    # split rows' added to; gEP written (K6 reads it); DL row j, eL, eR row
    # j-1, bg2, pv and alphaP added to
    lE, lM, lB = nE * S, nM * S, nB * S
    split = tri1 * q["n_b1"] + Wp * q["n_c"] * B
    by5 = it * (
        4 * lE + 2 * nE + 2 * lM + W1 * S * B + WB + 3 * lB + split
        + 7 * CC + SB + B + 5 * WB + (W1 + 1) * B + pvb
        + 5 * CC + 2 * 4 * CC + 2 * split + CC
        + lmb * 2 * CC + alp * 2 * WB
        + wts * 2 * (W1 * S * B + SB + (W1 + 1) * B + pvb)) + WB
    ops5 = (6.0 * lE + 2.0 * nM * q["lt_nnz"] + 4.0 * lB
            + 4.0 * tri1 * q["nb"]
            + 2.0 * (WB * q["rt_nnz"] + okP2 * q["pt_nnz"])
            + 2.0 * (2 * WB * q["rt_nnz"] + 2 * okP2 * q["pt_nnz"])
            + wts * 2.0 * (CC + 2 * okP2 * st.n_pt)
            + float(lmb * CC + alp * WB))
    out["outside_band"] = (by5, ops5)

    # K6 (outside_ep): the adjoint of K3 at column j.  It reads what K3
    # reads (P cells, both LL flanks, emisB on the P cells, emisA and
    # spec_il rows j, eSZg), the ep row and its cotangent gEP; it adds to
    # the cotangents of the P and LL cells, emisB, emisA, the per-read
    # size-weight partials GSZ [2, 4, Cp+1, Cp+1, B] (its triangle) and DL
    # row j
    if q["have_ep"]:
        pc, n_xu, vt = q["pc"], q["n_xu"], q["vterms"]
        fwd_in = (pc * (q["n_s1"] + q["n_s2"] + 2 * 4) + q["cb1"] * q["n_s3x"]
                  + B * W1 * (2 * 4 + (0 if cfg.no_ene else 6)) + q["eszg"])
        by6 = it * (
            2 * CC + fwd_in
            + 2 * (pc * (q["n_s1"] + q["n_s2"]) + q["cb1"] * q["n_s3x"])
            + lmb * 2 * (pc * 2 * 4 + 2 * 4 * WB + q["eszg"] * B + CC)
        ) + 4 * B + (4 * (cfg.Lp + 1) * B if cfg.fix_rss else 0)
        ops6 = (2.0 * 6 * CC * st.n2 / S + 4.0 * n_xu * B * st.n2
                + vt * (8.0 * st.n_ar + 32) + lmb * 3 * 16.0 * vt
                + 2 * 2.0 * pc * st.n13)
        out["outside_ep"] = (by6, ops6)
    else:
        out["outside_ep"] = (0.0, 0.0)

    # K7 (outside_ext): O rows j-1 and j, eR, gate, gO row j, ext; at live
    # exterior widths the P column and O rows j-w (read, their cotangents
    # added to, and DL at those cells); eR's cotangent added to; gO row
    # j-1 added to
    by7 = it * (5 * SB + B + wts * 2 * SB + WB + (6 + lmb * 2) * n_ext * S
                + 2 * SB)
    ops7 = 2.0 * (wts * B * q["rt_nnz"] + (2 + lmb) * n_ext * q["n_op"]) \
        + 2.0 * B * q["rt_nnz"]
    out["outside_ext"] = (by7, ops7)
    return out


def _add(tot, name, by, ops):
    b0, o0 = tot.get(name, (0.0, 0.0))
    tot[name] = (b0 + by, o0 + ops)


def pass_work(cfg, st, hc, tab, B, itemsize, need, tot):
    """Add K1 and K2-K7 over every column of one forward and outside pass
    to ``tot`` {kernel: (bytes, operations)}; ``need`` as column_work."""
    q = batch_counts(cfg, st, hc, B)
    _add(tot, "score_tables", *score_work(cfg, hc, tab, B, itemsize))
    for j in range(1, cfg.Lp + 1):
        for name, (by, ops) in column_work(cfg, st, hc, q, j, itemsize,
                                           need).items():
            _add(tot, name, by, ops)


def mask_pass_work(cfg, sd, dev, itemsize, tot):
    """Row I: one S=1 forward and outside pass over the candidates of the
    batch ``sd``, whose output is alphaP's cotangent."""
    k = J.kernels(cfg, dev)
    bp0 = J._candidate_pairs(cfg, k, sd)
    _, c = J._null_batch_factors(cfg, k, sd, bp0)
    pass_work(cfg, k.dp_null.st, host_consts(c), k.tab, bp0.shape[0],
              itemsize, ("alphaP",), tot)


def cyk_work(cfg, st, hc, B, itemsize, tot):
    """K10-K12 over every column (the max DP: the cells and rows K2-K4
    count, K11 reading the log mismatch tables and the size classes' log
    energies per group instead of the exponentials per lambda bucket)."""
    q = batch_counts(cfg, st, hc, B)
    C1 = cfg.Cp + 1
    for j in range(1, cfg.Lp + 1):
        w = column_work(cfg, st, hc, q, j, itemsize, ())
        by3, ops3 = w["inside_ep"]
        if q["have_ep"]:
            by3 += itemsize * (-q["pc"] * 4 - B * (cfg.Wp + 1) * 4
                               - q["eszg"] + 4 * C1 * (C1 + 1) // 2 + 2)
        _add(tot, "inside_band_max", *w["inside_band"])
        _add(tot, "inside_ep_max", by3, ops3)
        _add(tot, "inside_ext_max", *w["inside_ext"])


def _rows_sd(cfg, rows, negs, dev):
    sds = [J.make_seqdata(cfg, s, q) for s, q in rows]
    sds += [J.make_seqdata(cfg, s, np.zeros(len(s) + 1, np.int64))
            for s in negs]
    return J.stack_seqdata(sds, dev)


def step_work(cfg, steps, dev):
    """{kernel: (bytes, operations)} summed over training steps, each
    given as (iteration, positives [(seq, qual)]): the negatives' masks
    (the positives' are cached), then fn+grad over positives and
    negatives, whose outside pass keeps the weights' and lambda's
    cotangents.  The masks of every row come from one reference pass per
    bucket; the negatives are the reference's k-let shuffle."""
    from ..reference.train_ref import bucket_cfg, step_masks
    itemsize = torch.tensor([], dtype=J.kernels(cfg, dev).dtype).itemsize
    rows_of = []
    for it, rows in steps:
        negs = [seq_to_ints(negative_for(ints_to_seq(s), 2, it))
                for s, _ in rows]
        rows_of.append((bucket_cfg(cfg, rows, negs), rows, negs))
    masks = step_masks(rows_of, dev)
    tot = {}
    for cfg_b, rows, negs in rows_of:
        k = J.kernels(cfg_b, dev)
        mask_pass_work(cfg_b, _rows_sd(cfg_b, [], negs, dev), dev, itemsize,
                       tot)
        sd = _rows_sd(cfg_b, rows, negs, dev)
        bp, _ = masks.lookup(cfg_b, sd, dev)
        c = J._const_factors(cfg_b, k, sd, bp)
        pass_work(cfg_b, k.dp.st, host_consts(c), k.tab, len(sd.L),
                  itemsize, ("weights", "lam"), tot)
    return tot


def scan_call_work(cfg, reads, dev, chunk=64):
    """{kernel: (bytes, operations)} of one Scanner.scan call over
    ``reads`` [(seq, qual)] in the driver's buckets and chunks: per chunk
    the masks (row I), the posterior pass (its outside pass keeping the
    singles' and pairs' cotangents, E[N]) and the end pass (the class
    sums alone), the pins read and the class sums written, and the CYK
    tables (K1 and K10-K12; K13's walk is not counted)."""
    from ..reference.scan_ref import bucket_of
    itemsize = torch.tensor([], dtype=J.kernels(cfg, dev).dtype).itemsize
    buckets = {}
    for s, q in reads:
        buckets.setdefault(bucket_of(len(s)), []).append((s, q))
    tot = {}
    for Lp in sorted(buckets):
        cfg_b = dataclasses.replace(cfg, Lp=Lp)
        k = J.kernels(cfg_b, dev)
        rows = buckets[Lp]
        sd_all = _rows_sd(cfg_b, rows, [], dev)
        bp_all, _ = J.effective_bp_mask_batch(cfg_b, sd_all, dev)
        for k0 in range(0, len(rows), chunk):
            part = rows[k0:k0 + chunk]
            B = len(part)
            sd = _rows_sd(cfg_b, part, [], dev)
            mask_pass_work(cfg_b, sd, dev, itemsize, tot)
            c = J._const_factors(cfg_b, k, sd, bp_all[k0:k0 + B])
            hc = host_consts(c)
            pass_work(cfg_b, k.dp.st, hc, k.tab, B, itemsize, ("weights",),
                      tot)
            pass_work(cfg_b, k.dp.st, hc, k.tab, B, itemsize, (), tot)
            _add(tot, "pins_and_class_sums",
                 4 * B + 2 * 4 * Lp * B * itemsize, 0.0)
            _add(tot, "score_tables", *score_work(cfg_b, hc, k.tab, B,
                                                  itemsize))
            cyk_work(cfg_b, k.dp.st, hc, B, itemsize, tot)
    return tot


def total(tot):
    """(bytes, operations) summed over the kernels of ``tot``."""
    return (sum(v[0] for v in tot.values()),
            sum(v[1] for v in tot.values()))
