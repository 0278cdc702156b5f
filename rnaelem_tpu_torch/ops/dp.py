"""Joint (energy x motif) banded inside DP, forward — batched (PyTorch).

One loop over sequence columns j computes the inside recursion of the
reference (energy_model.hpp:340-441 fanned out over motif states by
motif_model.hpp:230-423) for a whole batch of reads, sum semiring.
Every tensor carries the batch axis LAST (batch-minor), as in the JAX
package, and DP tables carry PAD = Wp+1 front rows of -inf: row j lives
at j + PAD, so band reads never leave the table.

A column is six stages, each a wrapper that launches a hand-written CUDA
kernel for CUDA tensors and runs its plain PyTorch version for CPU
tensors:

  ``band_front``  (K2, inside_band.cu)  L chain, P, T2
  ``band_bif``    (K2)                  B = 1 x 2 splits, T1
  ``band_m``      (K2)                  sequential multiloop M chain
  ``ep_stage``    (K3, inside_ep.cu)    TT_E_P internal-loop sum
  ``band_e``      (K2)                  E = hairpin + multiloop + ep
  ``ext_stage``   (K4, inside_ext.cu)   exterior O column

The plain versions mirror the JAX column body ``cols_fn`` (exp-space
contractions under per-read max shifts).  ``dp_parts`` is an autograd
Function whose backward (the outside pass) is not ported yet: it raises
rather than dropping gradients.

Cell conventions (span (i, j), i = j - w, bases i..j-1):
  LL: ST_L linear runs inside loops;   P: paired span (i, j-1);
  E:  interior of pair (i-1, j);       M/B/T1/T2: multiloop states;
  O:  exterior prefix [0, j).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .ep_fast import build_ep_static
from .semiring import NEG, lam_mul, lse, logadd, mask_neg, safe_log

SPEC_COMBOS = ((0, 1), (1, 0), (1, 1), (1, 2), (2, 1), (2, 2))


class Dims(NamedTuple):
    Lp: int      # padded sequence length
    Wp: int      # padded band width
    Cp: int      # padded internal-loop width
    S: int
    no_ene: bool
    fix_rss: bool
    ltau: float  # log self-transition penalty (static per config)


class DiffFactors(NamedTuple):
    """Differentiable log-space factors; trailing batch axis B."""
    eR: torch.Tensor      # [Lp, S, B] right emission + ws
    eL: torch.Tensor      # [Lp, S, B] left emission + ws, keyed by source
    bg2: torch.Tensor     # [Lp, B] background single emission
    pv: torch.Tensor      # [Lp+1, Wp+1, Tp, B] pair-table emissions
    lam: torch.Tensor     # [2] shared across the batch
    alphaP: torch.Tensor  # [Lp+1, Wp+1, B] injected P-cell factor


class ConstFactors(NamedTuple):
    """Non-differentiable per-sequence tensors, trailing batch axis."""
    wsp: torch.Tensor     # [Lp, B] positional weight at '('/')' nodes
    hp: torch.Tensor      # [Lp+1, Wp+1, B]
    stk: torch.Tensor
    ext: torch.Tensor
    ml2: torch.Tensor
    mlE: torch.Tensor
    okP: torch.Tensor     # [Lp+1, Wp+1, B] bool
    okE: torch.Tensor
    okM: torch.Tensor
    okB: torch.Tensor
    gate_O2: torch.Tensor  # [Lp, B] 0/-inf fix-rss gate for O_O / 2_2
    gate_M: torch.Tensor   # [Lp, B]
    seq: torch.Tensor      # [Lp, B] int codes
    C: torch.Tensor        # [B] max internal loop width (int32)
    L: torch.Tensor        # [B] true length (int64)
    dots_cum: torch.Tensor  # [Lp+1, B] int32
    ep: dict               # misA/misB [4, Lp+1, Wp+1, B], spec_il [6, ...]


# ------------------------------------------------------------ helpers

def _shift_w(A, k: int, fill=NEG):
    """src[w] = A[w-k] along the leading (band) axis."""
    if k == 0:
        return A
    pad = torch.full((k,) + tuple(A.shape[1:]), fill, dtype=A.dtype,
                     device=A.device)
    return torch.cat([pad, A[:-k]], dim=0)


def _shear(A, J: int, fill):
    """Y[d, j] = A[d, j - d] (fill where j - d is out of range)."""
    D, R = A.shape[0], A.shape[1]
    d = torch.arange(D, device=A.device)[:, None]
    jj = torch.arange(J, device=A.device)[None, :]
    src = jj - d
    ok = (src >= 0) & (src < R)
    idx = torch.clamp(src, 0, R - 1)
    tail = tuple(A.shape[2:])
    Y = A[d.expand(D, J), idx]
    okx = ok.reshape((D, J) + (1,) * len(tail))
    return torch.where(okx, Y, torch.full_like(Y, fill))


def _finmax(x, dims, keepdim=False):
    """Max over dims with -inf replaced by 0 (the shift base)."""
    m = torch.amax(x, dim=dims, keepdim=keepdim)
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def _flip(T, j: int, n: int, PAD: int):
    """rows j, j-1, ..., j-n+1 of a front-padded table."""
    return torch.flip(T[j + PAD - n + 1: j + PAD + 1], dims=(0,))


def _pem_combos(g, ltau: float):
    """Static exp-space pair-transition matrices, factored by emission
    kind (profile_hmm.hpp:113-135 via motif_model.hpp:271-299): one
    background matrix plus one matrix per (pair-table, ws-left, ws-right)
    combination present in the grammar."""
    tau = float(np.exp(ltau)) if np.isfinite(ltau) else 0.0
    tfac = np.where(g.pt_tau, tau, 1.0)
    mbg = np.where(g.pt & ~g.pt_isbp, tfac, 0.0)
    dense_tab = np.maximum(g.pair_table_index[g.pt_tab], 0)
    combos = []
    for t in range(max(1, g.n_pair_tables)):
        for a in (False, True):
            for b in (False, True):
                m = (g.pt & g.pt_isbp & (dense_tab == t)
                     & (g.pt_wl == a) & (g.pt_wr == b))
                if m.any():
                    combos.append((t, a, b, np.where(m, tfac, 0.0)))
    return mbg, combos


def _csr_by_target(tuples, S: int):
    """(t, a, c) tuples -> CSR offsets [S+1] and (a, c) lists sorted by t."""
    tuples = np.asarray(tuples, np.int64).reshape(-1, 3)
    order = np.argsort(tuples[:, 0], kind="stable")
    tt = tuples[order]
    off = np.zeros(S + 1, np.int64)
    np.add.at(off, tt[:, 0] + 1, 1)
    return np.cumsum(off), tt[:, 1], tt[:, 2]


def _csr_finite(mat):
    """Finite entries of a log matrix [target, source] as CSR by target:
    offsets [S+1], source ids, log weights."""
    tgt, src = np.nonzero(np.isfinite(mat))
    off = np.zeros(mat.shape[0] + 1, np.int64)
    np.add.at(off, tgt + 1, 1)
    return np.cumsum(off), src, mat[tgt, src]


# ------------------------------------------------------------ static

class DPStatic:
    """Grammar- and shape-derived constants on one device: the exp-space
    matrices the plain versions contract with, and the index lists the
    kernels walk."""

    def __init__(self, g, dims: Dims, energy_tab, dtype, device):
        S, Wp, Cp = dims.S, dims.Wp, dims.Cp
        ltau = dims.ltau
        self.g, self.dims, self.dtype, self.device = g, dims, dtype, device
        self.PAD = Wp + 1
        f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                      device=device)
        i32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                        device=device)
        self.bucket = torch.as_tensor(g.lam_bucket, device=device)
        self.end_states = torch.as_tensor(g.end_states, device=device)
        self.diag_col = f(np.where(g.diag_mask, 0.0, -np.inf))
        self.loopm = torch.as_tensor(g.loop_mask, device=device)
        tau = float(np.exp(ltau)) if np.isfinite(ltau) else 0.0
        self.E_TR = f(np.where(g.rt, np.where(g.rt_tau, tau, 1.0), 0.0))
        TRlog = np.where(g.rt, np.where(g.rt_tau, ltau, 0.0), -np.inf)
        TLlog = np.where(g.lt, np.where(g.lt_tau, ltau, 0.0), -np.inf)
        self.TL = f(TLlog)
        mbg, combos = _pem_combos(g, ltau)
        self.Mbg = f(mbg)
        self.combos = [(t, a, b, f(m)) for (t, a, b, m) in combos]
        Hb12 = np.zeros((S * S, S))
        for (t, a, c2) in g.b12_tuples:
            Hb12[a * S + c2, t] = 1.0
        self.Hb12 = f(Hb12)
        Hop = np.zeros((2, S * S, S))
        for (t, a, c2) in g.op_tuples:
            Hop[g.lam_bucket[t], a * S + c2, t] = 1.0
        self.Hop = [f(Hop[b]) for b in range(2)]

        energy_np = {k: np.asarray(energy_tab[k].cpu())
                     for k in ("internal", "ninio", "bulge")}
        est = build_ep_static(g, Cp, energy_np, dims.no_ene)
        self.SZ = est.SZ
        self.grp = est.grp
        self.n_cls = est.SZ.shape[0]
        ru = np.minimum(np.arange(Wp + 1)[:, None]
                        + np.arange(Cp + 1)[None, :], Wp)
        self.ru = torch.as_tensor(ru, device=device)
        self.ru_ok = f((np.arange(Wp + 1)[:, None]
                        + np.arange(Cp + 1)[None, :]) <= Wp)

        # TT_E_P chain factorization (motif_model.hpp:315-335): a
        # quadruple (tgt, s1, s2, s3) is a node path l -> a -> c -> r;
        # pairs13 = distinct (s1, s3) -> AR = distinct (a, r) ->
        # K2 = distinct (s2, AR) -> target state
        ep_all = g.ep_tuples if len(g.ep_tuples) else \
            np.zeros((0, 4), np.int64)
        l_, r_ = g.state_l, g.state_r
        pairs13 = sorted(set((int(q[1]), int(q[3])) for q in ep_all))
        ar_list = sorted(set((int(l_[q[1]]), int(r_[q[3]])) for q in ep_all))
        ar_of = {p: i for i, p in enumerate(ar_list)}
        k2_list = sorted(set(
            (int(q[2]), ar_of[(int(l_[q[1]]), int(r_[q[3]]))])
            for q in ep_all))
        self.n13, self.n_ar, self.n2 = len(pairs13), len(ar_list), \
            len(k2_list)
        self.have_ep = self.n13 > 0
        if self.have_ep:
            p13_s1 = np.array([p[0] for p in pairs13])
            p13_s3 = np.array([p[1] for p in pairs13])
            p13_ar = np.array([ar_of[(int(l_[p[0]]), int(r_[p[1]]))]
                               for p in pairs13])
            k2_s2 = np.array([k[0] for k in k2_list])
            k2_ar = np.array([k[1] for k in k2_list])
            k2_tgt = np.array([int(g.n2s[l_[s2], ar_list[ai][1]])
                               for s2, ai in k2_list])
            assert (k2_tgt >= 0).all()
            k2_bu = g.lam_bucket[k2_tgt]
            eyeS = np.eye(S)
            self.Hot_s1_13 = f(eyeS[p13_s1].T)             # [S, n13]
            self.Hot_s3_13 = f(eyeS[p13_s3].T)
            self.Hot_13_ar = f(np.eye(self.n_ar)[p13_ar])  # [n13, n_ar]
            self.Hot_s2_k2 = f(eyeS[k2_s2].T)              # [S, n2]
            self.Hot_ar_k2 = f(np.eye(self.n_ar)[k2_ar].T)
            self.Hot_arcat_k2 = f(
                np.eye(2 * self.n_ar)[k2_bu * self.n_ar + k2_ar].T)
            self.Hot_k2_tgt = f(eyeS[k2_tgt])              # [n2, S]
            self.lamk2_idx = torch.as_tensor(k2_bu, device=device)
            Ind = np.zeros((Wp + 1, Cp + 1, Wp + 1))
            for x_ in range(Wp + 1):
                for u_ in range(Cp + 1):
                    if x_ + u_ <= Wp:
                        Ind[x_, u_, x_ + u_] = 1.0
            self.Ind = f(Ind)

        # ---- kernel-side index lists (int32) and log-space matrices
        kk = {}
        for name, mat in (("rt", TRlog), ("lt", TLlog)):
            off, src, wt = _csr_finite(mat)
            kk[name + "_off"], kk[name + "_s"] = i32(off), i32(src)
            kk[name + "_w"] = f(wt)
        kk["diag"] = i32(g.diag_mask)
        kk["loopm"] = i32(g.loop_mask)
        kk["bucket"] = i32(g.lam_bucket)
        kk["end_states"] = i32(g.end_states)
        # pair transitions: code -1 none, -2 background, else dense table
        dense_tab = np.maximum(g.pair_table_index[g.pt_tab], 0)
        code = np.where(g.pt, np.where(g.pt_isbp, dense_tab, -2), -1)
        kk["pt_code"] = i32(code)
        kk["pt_wl"] = i32(g.pt_wl)
        kk["pt_wr"] = i32(g.pt_wr)
        kk["pt_lt"] = f(np.where(g.pt_tau, ltau, 0.0))
        off, a, c = _csr_by_target(g.b12_tuples, S)
        kk["b12_off"], kk["b12_a"], kk["b12_c"] = i32(off), i32(a), i32(c)
        off, a, c = _csr_by_target(g.op_tuples, S)
        kk["op_off"], kk["op_a"], kk["op_c"] = i32(off), i32(a), i32(c)
        if self.have_ep:
            kk["p13_s1"], kk["p13_s3"] = i32(p13_s1), i32(p13_s3)
            order = np.argsort(p13_ar, kind="stable")
            aoff = np.zeros(self.n_ar + 1, np.int64)
            np.add.at(aoff, p13_ar + 1, 1)
            kk["ar_off"], kk["ar_p"] = i32(np.cumsum(aoff)), i32(order)
            kk["k2_s2"], kk["k2_ar"] = i32(k2_s2), i32(k2_ar)
            kk["k2_bu"] = i32(k2_bu)
            order = np.argsort(k2_tgt, kind="stable")
            koff = np.zeros(S + 1, np.int64)
            np.add.at(koff, k2_tgt + 1, 1)
            kk["k2_off"], kk["k2_idx"] = i32(np.cumsum(koff)), i32(order)
        self.k = kk


def _lam2(lam):
    if lam.dim() != 1:
        raise NotImplementedError(
            "per-read lambda is not ported yet; pass lam of shape [2]")
    return lam[:, None]                          # [2, 1]


def hoisted(d: DiffFactors, c: ConstFactors, st: DPStatic):
    """Per-evaluation exp-space energy tensors (lambda flows here):
    eSZ [2, n_cls, Cp+1 (dl), Cp+1 (u1), B] with the per-read C cap
    (dl + u1 <= C) folded in, and eSZg [2, 4, Cp+1, Cp+1], the size
    weights without the cap summed per misA/misB group; emisA
    [2, 4, Lp+1, Wp+1, B]; emisB rows-leading [2, Lp+1+PAD, Wp+1, 4, B]
    with zero PAD rows."""
    lam = _lam2(d.lam)
    Cp, PAD = st.dims.Cp, st.PAD
    dt, dev = st.dtype, st.device
    dlarr = torch.arange(Cp + 1, device=dev)
    cmask = (dlarr[:, None, None] + dlarr[None, :, None]
             <= c.C[None, None, :])
    SZT = torch.as_tensor(np.ascontiguousarray(
        np.transpose(st.SZ, (0, 2, 1))), dtype=dt, device=dev)
    eSZs = torch.stack([torch.exp(lam_mul(lam[b], SZT))
                        for b in range(2)])        # [2, n_cls, dl, u1]
    eSZ = eSZs[..., None] * cmask
    grp = torch.as_tensor(st.grp, device=dev)
    eSZg = torch.zeros((2, 4) + tuple(eSZs.shape[2:]), dtype=dt,
                       device=dev).index_add_(1, grp, eSZs)
    misA, misB = c.ep["misA"], c.ep["misB"]
    emisA = torch.stack([torch.exp(lam_mul(lam[b], misA))
                         for b in range(2)])
    eB = torch.stack([torch.exp(lam_mul(lam[b], misB)).permute(1, 2, 0, 3)
                      for b in range(2)])                # [2, Lp+1, w, 4, B]
    pad = torch.zeros((2, PAD) + tuple(eB.shape[2:]), dtype=dt, device=dev)
    emisB = torch.cat([pad, eB], dim=1).contiguous()
    return dict(eSZ=eSZ.contiguous(), eSZg=eSZg, emisA=emisA.contiguous(),
                emisB=emisB)


def init_state(st: DPStatic, B: int):
    """Inside tables with PAD front rows of -inf: LL, P, E, M, Bt, T1, T2
    [Lp+1+PAD, Wp+1, S, B], O [Lp+1+PAD, S, B], plus the column's ep-term
    scratch [Wp+1, S, B].  LL at width 0 is the grammar diagonal; O
    starts at end_states[0]."""
    Lp, Wp, S = st.dims.Lp, st.dims.Wp, st.dims.S
    PAD, dt, dev = st.PAD, st.dtype, st.device
    R = Lp + 1 + PAD
    mk = lambda: torch.full((R, Wp + 1, S, B), NEG, dtype=dt, device=dev)
    state = {k: mk() for k in ("LL", "P", "E", "M", "Bt", "T1", "T2")}
    state["LL"][PAD:, 0] = st.diag_col[:, None]
    O = torch.full((R, S, B), NEG, dtype=dt, device=dev)
    O[PAD, int(st.g.end_states[0])] = 0.0
    state["O"] = O
    state["ep"] = torch.full((Wp + 1, S, B), NEG, dtype=dt, device=dev)
    return state


def clone_state(state):
    """Copy of the inside tables (scratch and validation marks dropped)."""
    return {k: v.clone() for k, v in state.items() if not k.startswith("_")}


# ------------------------------------------------- plain column stages

def _chain(src, eRrow, st):
    """Right-transition chain: [w,S,B] -> [w,S,B] target-indexed."""
    m = _finmax(src, 1, keepdim=True)
    t = torch.einsum("ts,wsb->wtb", st.E_TR, torch.exp(src - m))
    return safe_log(t) + m + eRrow[None]


def band_front_plain(state, j, d, c, h, st):
    """L chain (U1), P (U2: TT_P_E / TT_P_P) and T2 (U3) of column j."""
    Lp, Wp, PAD = st.dims.Lp, st.dims.Wp, st.PAD
    dev = st.device
    warr = torch.arange(Wp + 1, device=dev)
    iw = torch.clamp(j - warr, 0, Lp - 1)
    lamv = _lam2(d.lam)[st.bucket]                 # [S, 1]
    eRrow = d.eR[j - 1]
    g_o2 = c.gate_O2[j - 1]
    # U1: ST_L chain (motif_model.hpp:243-257); width 0 is the diagonal
    Lcol = _chain(_shift_w(state["LL"][j - 1 + PAD], 1), eRrow, st)
    Lcol[0] = st.diag_col[:, None]
    # U2: P <- pem * (E | P), factored into static-matrix contractions
    prevE2 = _shift_w(state["E"][j - 1 + PAD], 2)
    prevP2 = _shift_w(state["P"][j - 1 + PAD], 2)
    wl, wr = c.wsp[iw], c.wsp[j - 1]
    bgf = torch.exp(d.bg2[iw] + d.bg2[j - 1][None])
    pvj = d.pv[j]
    outs = []
    for src in (prevE2, prevP2):
        m = _finmax(src, 1, keepdim=True)
        ex = torch.exp(src - m)
        acc = torch.einsum("ts,wsb->wtb", st.Mbg, ex) * bgf[:, None, :]
        for (t, a, b2, mask) in st.combos:
            fac = pvj[:, t, :]
            if a:
                fac = fac + wl
            if b2:
                fac = fac + wr
            acc = acc + torch.einsum("ts,wsb->wtb", mask, ex) \
                * torch.exp(fac)[:, None, :]
        outs.append(safe_log(acc) + m)
    a_pe, a_pp = outs
    a_pp = a_pp + lam_mul(lamv[None], c.stk[j][:, None, :])
    Pcol = logadd(a_pe, a_pp) + d.alphaP[j][:, None, :]
    Pcol = mask_neg(Pcol, c.okP[j][:, None, :])
    # U3: 2 (TT_2_2 / TT_2_P)
    T2col = logadd(
        _chain(_shift_w(state["T2"][j - 1 + PAD], 1), eRrow, st)
        + g_o2[None, None, :],
        Pcol + lam_mul(lamv[None], c.ml2[j][:, None, :]))
    T2col = mask_neg(T2col, c.okB[j][:, None, :])
    state["LL"][j + PAD] = Lcol
    state["P"][j + PAD] = Pcol
    state["T2"][j + PAD] = T2col


def band_bif_plain(state, j, d, c, h, st):
    """B (U4: TT_B_12) as a dk contraction then the static tuple sum,
    and T1 (U5).  dk = 0 and 2-cells of width 0 are excluded."""
    Wp, S, PAD = st.dims.Wp, st.dims.S, st.PAD
    T2col = state["T2"][j + PAD]
    B = T2col.shape[-1]
    negcol = torch.full((1, Wp + 1, S, B), NEG, dtype=st.dtype,
                        device=st.device)
    T1F = torch.cat([negcol, _flip(state["T1"], j - 1, Wp, PAD)], dim=0)
    m1 = _finmax(T1F, (0, 1, 2))
    ex1 = torch.exp(T1F - m1)
    ex1[0] = 0.0                                 # dk >= 1 (k < j)
    X1 = _shear(ex1, Wp + 1, 0.0)                # [dk, w, S, B]
    m2 = _finmax(T2col, (0, 1))
    ex2 = torch.exp(T2col - m2)
    ex2[0] = 0.0                                 # width(2-cell) >= 1
    G = torch.einsum("dwab,dcb->wacb", X1, ex2)
    out = torch.einsum("wqb,qt->wtb", G.reshape(Wp + 1, S * S, B), st.Hb12)
    Bcol = mask_neg(safe_log(out) + m1 + m2, c.okB[j][:, None, :])
    T1col = mask_neg(logadd(T2col, Bcol), c.okB[j][:, None, :])
    state["Bt"][j + PAD] = Bcol
    state["T1"][j + PAD] = T1col


def band_m_plain(state, j, d, c, h, st):
    """M chain (U6: TT_M_M / TT_M_B), sequential over the band
    (motif_model.hpp:346-366)."""
    Lp, Wp, S, PAD = st.dims.Lp, st.dims.Wp, st.dims.S, st.PAD
    warr = torch.arange(Wp + 1, device=st.device)
    iw = torch.clamp(j - warr, 0, Lp - 1)
    eLrows = d.eL[iw]                            # [w, S, B] source-keyed
    gMs = c.gate_M[iw]                           # [w, B]
    okMj = c.okM[j]                              # [w, B]
    bvecs = mask_neg(state["Bt"][j + PAD], okMj[:, None, :])
    B = bvecs.shape[-1]
    x = torch.full((S, B), NEG, dtype=st.dtype, device=st.device)
    out = []
    for w in range(Wp + 1):
        t = x[None, :, :] + st.TL[:, :, None] + eLrows[w][None] \
            + gMs[w][None, None, :]
        x = mask_neg(logadd(bvecs[w], lse(t, axis=1)), okMj[w][None, :])
        out.append(x)
    state["M"][j + PAD] = torch.stack(out)


def _ep_specials(c, j, exPF, exLB, exL3, lam, h, st):
    """Base-coupled internal loops — stack-adjacent bulges (0,1)/(1,0)
    and 1x1/1x2/2x1/2x2 internals (energy_param.hpp:744-795) — in the
    chain-factored exp space; a [w, n2, B] contribution carrying the
    ep_stage shifts."""
    lamk2 = lam[st.lamk2_idx]                    # [n2, 1]
    il6 = c.ep["spec_il"][:, j]                  # [6, w, B]
    acc = None
    for ci, (dk, dl) in enumerate(SPEC_COMBOS):
        # lf[w] = LL(j-w+dk, dk);  pin[w] = P(j-dl, w-dk-dl)
        lf = _shift_w(exLB[:, dk], dk, fill=0.0)
        pin = _shift_w(exPF[dl], dk + dl, fill=0.0)
        tP = torch.einsum("wsb,sp->wpb", pin, st.Hot_s1_13)
        tL = torch.einsum("sb,sp->pb", exL3[dl], st.Hot_s3_13)
        tar = torch.einsum("wpb,pa->wab", tP * tL[None], st.Hot_13_ar)
        pL = torch.einsum("wsb,sk->wkb", lf, st.Hot_s2_k2)
        pV = torch.einsum("wab,ak->wkb", tar, st.Hot_ar_k2)
        eil = torch.exp(lam_mul(lamk2[None], il6[ci][:, None, :]))
        ok = ((dk + dl) <= c.C).to(pL.dtype)
        t = pL * pV * eil * ok[None, None, :]
        acc = t if acc is None else acc + t
    return acc


def ep_stage_plain(state, j, d, c, h, st):
    """U7 TT_E_P internal-loop sum (motif_model.hpp:329-335,
    energy_param.hpp:744-795), chain-factored through pairs13 -> AR -> K2
    with the five (u1, u2) energy classes fused into W[dl, x, u1] per
    lambda bucket; exp space under per-read max shifts."""
    Wp, Cp, S, PAD = st.dims.Wp, st.dims.Cp, st.dims.S, st.PAD
    dev, dt = st.device, st.dtype
    B = state["ep"].shape[-1]
    if not st.have_ep:
        state["ep"].fill_(NEG)
        return
    lam = _lam2(d.lam)
    Lcol = state["LL"][j + PAD]
    PF = torch.cat([state["P"][j + PAD][None],
                    _flip(state["P"], j - 1, Cp, PAD)], dim=0)
    LB = torch.cat([Lcol[None], _flip(state["LL"], j - 1, Wp, PAD)], dim=0)
    warr = torch.arange(Wp + 1, device=dev)
    dlarr = torch.arange(Cp + 1, device=dev)
    mPF = _finmax(PF, (0, 1, 2))
    exPF = torch.exp(PF - mPF)
    mL3 = _finmax(Lcol[: Cp + 1], (0, 1))
    exL3 = torch.exp(Lcol[: Cp + 1] - mL3)       # [dl, S, B]
    dcum = c.dots_cum
    if st.dims.fix_rss:
        rd = (dcum[j] - dcum[torch.clamp(j - dlarr, min=0)]
              ) == dlarr[:, None]               # [dl, B]
        exL3 = exL3 * rd[:, None, :]

    # T stage: inner pair x right flank -> AR = (a, r) pairs
    tP = torch.einsum("dvsb,sp->dvpb", exPF, st.Hot_s1_13)
    tL = torch.einsum("dsb,sp->dpb", exL3, st.Hot_s3_13)
    T = torch.einsum("dvpb,pa->dvab", tP * tL[:, None], st.Hot_13_ar)
    Tsh = _shear(T, Wp + 1, 0.0)                 # [dl, x=dl+v, n_ar, B]

    # fused energy weight W[bu][dl, x, u1, B]: misB (inner pair) x
    # size/asymmetry class x misA (outer pair), classes summed
    emisB = _flip(h["emisB"].transpose(0, 1), j, Cp + 1, PAD)  # [dl,2,..]
    V_bu = []
    for b in range(2):
        mBsh = _shear(emisB[:, b], Wp + 1, 0.0)  # [dl, x, 4, B]
        mArow = h["emisA"][b][:, j]              # [4, w, B]
        wA = [mArow[g_][st.ru] * st.ru_ok[:, :, None] for g_ in range(4)]
        Wall = None
        for x_ in range(st.n_cls):
            g_ = int(st.grp[x_])
            t = (mBsh[:, :, g_, None, :]
                 * h["eSZ"][b][x_][:, None, :, :]
                 * wA[g_][None, :, :, :])        # [dl, x, u1, B]
            Wall = t if Wall is None else Wall + t
        V_bu.append((Tsh[:, :, None, :, :]
                     * Wall[:, :, :, None, :]).sum(dim=0))

    # left flank LL(j-x, u1) and the K2 = (s2, AR) -> target stage
    LBc = LB[:, : Cp + 1]
    mLB = _finmax(LBc, (0, 1, 2))
    exLB = torch.exp(LBc - mLB)
    if st.dims.fix_rss:
        ld = (dcum[torch.clamp(j - warr[:, None], min=0)]
              - dcum[torch.clamp(j - warr[:, None] - dlarr[None, :], min=0)]
              ) == dlarr[None, :, None]
        exLB = exLB * ld[:, :, None, :]
    pickL = torch.einsum("xusb,sk->xukb", exLB, st.Hot_s2_k2)
    Vcat = torch.cat(V_bu, dim=2)
    pickV = torch.einsum("xuab,ak->xukb", Vcat, st.Hot_arcat_k2)
    outw = torch.einsum("xukb,xuw->wkb", pickL * pickV, st.Ind)
    if not st.dims.no_ene:
        outw = outw + _ep_specials(c, j, exPF, exLB, exL3, lam, h, st)
    out = torch.einsum("wkb,kt->wtb", outw, st.Hot_k2_tgt)
    state["ep"].copy_(safe_log(out) + (mPF + mL3 + mLB))


def band_e_plain(state, j, d, c, h, st):
    """E (U7: TT_E_H / TT_E_M / TT_E_P) of column j."""
    PAD = st.PAD
    lamv = _lam2(d.lam)[st.bucket]
    Lcol = state["LL"][j + PAD]
    hterm = torch.where(st.loopm[None, :, None],
                        Lcol + lam_mul(lamv[None], c.hp[j][:, None, :]),
                        torch.full_like(Lcol, NEG))
    mterm = state["M"][j + PAD] + lam_mul(lamv[None], c.mlE[j][:, None, :])
    Ecol = logadd(logadd(hterm, mterm), state["ep"])
    state["E"][j + PAD] = mask_neg(Ecol, c.okE[j][:, None, :])


def ext_stage_plain(state, j, d, c, h, st):
    """O column (U8: TT_O_O / TT_O_OP): O = O chain + O*P splits per
    lambda bucket.  Slot 0 (row j) is zero-weighted: okP kills w = 0."""
    Wp, S, PAD = st.dims.Wp, st.dims.S, st.PAD
    lam = _lam2(d.lam)
    Pcol = state["P"][j + PAD]
    eRrow = d.eR[j - 1]
    g_o2 = c.gate_O2[j - 1]
    B = Pcol.shape[-1]
    Orows = torch.cat([torch.full((1, S, B), NEG, dtype=st.dtype,
                                  device=st.device),
                       _flip(state["O"], j - 1, Wp, PAD)], dim=0)
    prevO = Orows[1]
    m = _finmax(prevO, 0, keepdim=True)
    t = torch.einsum("ts,sb->tb", st.E_TR, torch.exp(prevO - m))
    oo = safe_log(t) + m + eRrow + g_o2[None, :]
    mO = _finmax(Orows, (0, 1))
    exO = torch.exp(Orows - mO)
    mP = _finmax(Pcol, (0, 1))
    tot = None
    for b in range(2):
        eext = torch.exp(lam_mul(lam[b], c.ext[j]))   # [w, B]
        exP = torch.exp(Pcol - mP) * eext[:, None, :]
        Gb = torch.einsum("wab,wcb->acb", exP, exO)
        ob = torch.einsum("qb,qt->tb", Gb.reshape(S * S, B), st.Hop[b])
        tot = ob if tot is None else tot + ob
    op_term = safe_log(tot) + mP + mO
    state["O"][j + PAD] = logadd(oo, op_term)


# ---------------------------------------------- wrappers (kernel or plain)

def _stage(name: str, plain_fn):
    """Wrapper ``name``: the plain version for CPU tensors, the kernel
    wrapper ``ops.kernels.<name>`` (which launches or raises) otherwise."""
    def stage(state, j, d, c, h, st):
        if state["O"].device.type == "cpu":
            return plain_fn(state, j, d, c, h, st)
        from . import kernels as K
        return getattr(K, name)(state, j, d, c, h, st)
    stage.__name__ = stage.__qualname__ = name
    return stage


band_front = _stage("band_front", band_front_plain)
band_bif = _stage("band_bif", band_bif_plain)
band_m = _stage("band_m", band_m_plain)
ep_stage = _stage("ep_stage", ep_stage_plain)
band_e = _stage("band_e", band_e_plain)
ext_stage = _stage("ext_stage", ext_stage_plain)

# column stages in update order; each reads only finalized values
STAGES = (band_front, band_bif, band_m, ep_stage, band_e, ext_stage)
PLAIN_STAGES = (band_front_plain, band_bif_plain, band_m_plain,
                ep_stage_plain, band_e_plain, ext_stage_plain)


class _DPParts(torch.autograd.Function):
    """[B, 3] log partition parts; the outside pass is not ported yet."""

    @staticmethod
    def forward(ctx, dp, c, eR, eL, bg2, pv, lam, alphaP):
        d = DiffFactors(eR=eR, eL=eL, bg2=bg2, pv=pv, lam=lam,
                        alphaP=alphaP)
        state = dp.inside_tables(d, c)
        return dp.extract_parts(state["O"], c)

    @staticmethod
    def backward(ctx, gbar):
        raise NotImplementedError(
            "dp_parts backward (the outside pass, kernel row H) is not "
            "ported yet")


class InsideDP:
    """Forward joint inside DP for one compiled grammar + dims, on one
    device and dtype."""

    def __init__(self, g, dims: Dims, energy_tab, dtype, device):
        self.st = DPStatic(g, dims, energy_tab, dtype, device)
        self.dims = dims

    def start(self, d: DiffFactors, c: ConstFactors):
        """(hoisted tensors, fresh inside-table state) for one evaluation."""
        return hoisted(d, c, self.st), init_state(self.st, c.wsp.shape[-1])

    def run_columns(self, state, d, c, h, j0: int, j1: int):
        """Columns j0..j1-1, every stage in update order.  On the card the
        B/T1, M and O stages (which need only L, P and T2 of the column)
        run on a side stream, concurrently with the internal-loop stage;
        events order the two streams (E needs M; the next column's
        B needs this column's T2)."""
        st = self.st
        if state["O"].device.type != "cuda":
            for j in range(j0, j1):
                for stage in STAGES:
                    stage(state, j, d, c, h, st)
            return
        main = torch.cuda.current_stream()
        side = state.setdefault("_side_stream", torch.cuda.Stream())
        for j in range(j0, j1):
            band_front(state, j, d, c, h, st)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                band_bif(state, j, d, c, h, st)
                band_m(state, j, d, c, h, st)
                ext_stage(state, j, d, c, h, st)
            ep_stage(state, j, d, c, h, st)
            main.wait_stream(side)
            band_e(state, j, d, c, h, st)

    def inside_tables(self, d: DiffFactors, c: ConstFactors):
        """All inside tables (state dict, row j at j + PAD)."""
        h, state = self.start(d, c)
        self.run_columns(state, d, c, h, 1, self.dims.Lp + 1)
        return state

    def extract_parts(self, Ofin, c: ConstFactors):
        """parts[b, k] = O[L_b, end_states[k], b] (ragged lengths)."""
        B = Ofin.shape[-1]
        rows = Ofin[c.L + self.st.PAD, :, torch.arange(B, device=Ofin.device)]
        return rows[:, self.st.end_states]       # [B, 3]

    def dp_parts(self, d: DiffFactors, c: ConstFactors):
        return _DPParts.apply(self, c, d.eR, d.eL, d.bg2, d.pv,
                              d.lam, d.alphaP)


def build_dp(g, dims: Dims, energy_tab, dtype=torch.float64, device="cpu"):
    return InsideDP(g, dims, energy_tab, dtype, torch.device(device))
