"""Batched max-semiring (CYK / Viterbi) inside DP, batch-minor (PyTorch):
kernel rows L and M.

The CYK twin of ops/dp.py (JAX ops/dp_maxb.py ``build_max_tables``): one
loop over sequence columns computes the max-semiring recursion of the
reference scanner (CYKFun, motif_scanner.hpp:802-913) for a whole batch
of reads, on the same DiffFactors / ConstFactors as the sum DP
(model/joint.batch_factors) and the same padded table layout (row j at
j + PAD).  The scanner's Ys/Ye/tail pins enter as ConstFactors.pin, a pin
set (ops/dp.py Pin); dense aux factors (plain versions only) as in the
sum DP.

A column is six stages, each a wrapper that launches a hand-written CUDA
kernel for CUDA tensors and runs its plain PyTorch version for CPU
tensors:

  ``max_band_front``  (K10, inside_band.cu)  L chain, P, T2
  ``max_band_bif``    (K10)                  B = 1 x 2 splits, T1
  ``max_band_m``      (K10)                  sequential multiloop M chain
  ``max_ep_stage``    (K11, inside_ep.cu)    TT_E_P internal-loop max
  ``max_band_e``      (K10)                  E = max(hairpin, multiloop, ep)
  ``max_ext_stage``   (K12, inside_ext.cu)   exterior O column

The plain versions port the JAX column body (``chain``, ``p_col``,
``b_col``, ``m_col``, ``ep_col`` + ``_ep_specials``, ``o_col``,
``_segmax``): broadcast-add and max-reduce, the TT_E_P sum chain-factored
through pairs13 -> AR -> K2 as in ops/dp.py, and the internal-loop size
classes max-reduced BEFORE the lambda multiply (lam * max == max * lam
only for lam >= 0, which ``MaxDP.tables`` asserts).  Row M (JAX
ops/dp_max.py, the per-read CYK tables) is the same function sliced per
read, so these stages at any batch size compute it too.

The tables feed the traceback (scan/cyk.py, K13); there is no reverse
pass.
"""
from __future__ import annotations

import numpy as np
import torch

from .dp import (_csr_by, _flip, _pem_dense, _shear, _shift_w, aux_of,
                 col_rows, init_state)
from .semiring import NEG, lam_mul, mask_neg

# the padded tables of a max DP state, as the JAX tables name them
TABLES = (("LL", "LL"), ("P", "P"), ("E", "E"), ("M", "M"), ("Bt", "B"),
          ("T1", "T1"), ("T2", "T2"), ("O", "O"))
SPEC_COMBOS = ((0, 1), (1, 0), (1, 1), (1, 2), (2, 1), (2, 2))
# broadcast chunks of the plain version (tuple axes; JAX's sizes)
B12C, P13C, ARC, K2C = 128, 256, 8, 256


class MaxStatic:
    """Max-DP constants on top of the sum DP's DPStatic ``st``: index
    tensors of the plain version, the size classes' log energies maxed
    per misA/misB group (SZg [4, Cp+1 (dl), Cp+1 (u1)]: max_c (a + SZ_c)
    + b == (a + max_c SZ_c) + b exactly, rounding being monotonic) and
    the traceback's lists (``k``, int32)."""

    def __init__(self, st):
        g, dev, dt = st.g, st.device, st.dtype
        S, Cp = st.dims.S, st.dims.Cp
        self.st = st
        lng = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
        i32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                        device=dev)
        b12 = np.asarray(g.b12_tuples, np.int64).reshape(-1, 3)
        op = np.asarray(g.op_tuples, np.int64).reshape(-1, 3)
        self.b12 = [lng(b12[:, k]) for k in range(3)]          # t, a, c
        self.op = [lng(op[:, k]) for k in range(3)] + [
            lng(np.asarray(g.lam_bucket)[op[:, 0]])]             # t, a, c, bu
        if st.have_ep:
            kk = st.k
            self.p13_s1, self.p13_s3, self.p13_ar = [
                kk[n].long() for n in ("p13_s1", "p13_s3", "p13_ar")]
            self.k2_s2, self.k2_ar, self.k2_tgt, self.k2_bu = [
                kk[n].long() for n in ("k2_s2", "k2_ar", "k2_tgt", "k2_bu")]
        SZT = np.transpose(np.asarray(st.SZ), (0, 2, 1))   # [cls, dl, u1]
        szg = np.full((4, Cp + 1, Cp + 1), -np.inf)
        for x_, g_ in enumerate(st.grp):
            szg[g_] = np.maximum(szg[g_], SZT[x_])
        self.SZg = torch.as_tensor(szg, dtype=dt, device=dev).contiguous()
        ept = np.asarray(g.ep_tuples, np.int64).reshape(-1, 4)
        off, (s1, s2, s3) = _csr_by(ept[:, 0], S, ept[:, 1], ept[:, 2],
                                    ept[:, 3])
        self.k = dict(ept_off=i32(off), ept_s1=i32(s1), ept_s2=i32(s2),
                      ept_s3=i32(s3), state_l=i32(g.state_l),
                      state_r=i32(g.state_r))

    @staticmethod
    def of(st):
        """The MaxStatic of ``st``, built once and kept on it."""
        mst = st.__dict__.get("_max_static")
        if mst is None:
            mst = st.__dict__["_max_static"] = MaxStatic(st)
        return mst


def _segmax(x, seg, num: int, axis: int):
    """Segment max along ``axis``: out[n] = max of the entries whose
    ``seg`` is n (-inf for none)."""
    x = torch.movedim(x, axis, 0)
    idx = seg.reshape((-1,) + (1,) * (x.dim() - 1)).expand_as(x)
    out = torch.full((num,) + tuple(x.shape[1:]), NEG, dtype=x.dtype,
                     device=x.device)
    out = out.scatter_reduce(0, idx, x, reduce="amax", include_self=True)
    return torch.movedim(out, 0, axis)


def _chain(src, eRrow, st, aR=None):
    """out[w, t, b] = max_s src[w, s, b] + TR[t, s] (+ aux) + eR[t, b]."""
    TRx = st.TR[:, :, None] if aR is None else st.TR[:, :, None] + aR
    return torch.amax(src[:, None] + TRx[None], dim=2) + eRrow[None]


# ------------------------------------------- plain column (pure functions)

def front_col(win, j, rows, c, st):
    """L chain, P (TT_P_E / TT_P_P) and T2 of column j (JAX chain, p_col
    and the T2 maximum of cols_fn)."""
    lamv = rows["lam"][st.bucket]                 # [S, B]
    eRrow = rows["eR"]
    g_o2 = c.gate_O2[j - 1]
    ax = aux_of(rows, c, j, st, ("R", "PL", "PR"))
    aR = None if ax is None else ax["R"]
    Lcol = _chain(_shift_w(win["L"][0], 1), eRrow, st, aR)
    Lcol = torch.cat([st.diag_col[None, :, None].expand_as(Lcol[:1]),
                      Lcol[1:]])
    pem = _pem_dense(rows, c, j, st)              # [w, t, s, B]
    if ax is not None:
        pem = pem + ax["PL"] + ax["PR"][None]
    a_pe = torch.amax(pem + _shift_w(win["E"], 2)[:, None], dim=2)
    a_pp = torch.amax(pem + _shift_w(win["P"][0], 2)[:, None], dim=2) \
        + lam_mul(lamv[None], c.stk[j][:, None, :])
    Pcol = mask_neg(torch.maximum(a_pe, a_pp) + rows["alphaP"][:, None, :],
                    c.okP[j][:, None, :])
    T2col = torch.maximum(
        _chain(_shift_w(win["T2"], 1), eRrow, st, aR) + g_o2[None, None, :],
        Pcol + lam_mul(lamv[None], c.ml2[j][:, None, :]))
    return Lcol, Pcol, mask_neg(T2col, c.okB[j][:, None, :])


def bif_col(win, j, c, st, mst, T2col):
    """B(i, j) = max over TT_B_12 tuples (t, a, c) and dk of T1(i, j-dk)[a]
    + T2(j-dk, j)[c] (JAX b_col), and T1 = max(T2, B)."""
    Wp, S = st.dims.Wp, st.dims.S
    B = T2col.shape[-1]
    Bcol = torch.full((Wp + 1, S, B), NEG, dtype=st.dtype, device=st.device)
    tt, aa, cc = mst.b12
    if len(tt):
        T1F = torch.cat([torch.full_like(win["T1"][:1], NEG), win["T1"]])
        X1 = _shear(T1F, Wp + 1, NEG)             # [dk, w, S, B]
        T2m = torch.cat([torch.full_like(T2col[:1], NEG), T2col[1:]])
        for q0 in range(0, len(tt), B12C):
            q = slice(q0, q0 + B12C)
            Y = X1[:, :, aa[q]] + T2m[:, None, cc[q]]   # [dk, w, nc, B]
            Bcol = torch.maximum(Bcol, _segmax(torch.amax(Y, dim=0), tt[q],
                                               S, axis=1))
    okB = c.okB[j][:, None, :]
    Bcol = mask_neg(Bcol, okB)
    return Bcol, mask_neg(torch.maximum(T2col, Bcol), okB)


def m_col(j, rows, c, st, Bcol):
    """M chain (TT_M_M / TT_M_B), sequential over the band (JAX m_col)."""
    Lp, Wp, S = st.dims.Lp, st.dims.Wp, st.dims.S
    iw = torch.clamp(j - torch.arange(Wp + 1, device=st.device), 0, Lp - 1)
    okMj = c.okM[j]
    bvecs = mask_neg(Bcol, okMj[:, None, :])
    gMs = c.gate_M[iw]
    ax = aux_of(rows, c, j, st, ("L",))
    x = torch.full((S, Bcol.shape[-1]), NEG, dtype=st.dtype,
                   device=st.device)
    out = []
    for w in range(Wp + 1):
        t = x[None] + st.TL[:, :, None] + rows["eL"][w][None] \
            + gMs[w][None, None, :]
        if ax is not None:
            t = t + ax["L"][w]
        x = mask_neg(torch.maximum(bvecs[w], torch.amax(t, dim=1)),
                     okMj[w][None, :])
        out.append(x)
    return torch.stack(out)


def _flipB(misB, j: int, Cp: int):
    """Rows j, j-1, ..., j-Cp of misB [4, Lp+1, v, B] as [dl, v, 4, B]
    (rows before 0 are -inf)."""
    pad = torch.full((misB.shape[0], Cp + 1) + tuple(misB.shape[2:]), NEG,
                     dtype=misB.dtype, device=misB.device)
    blk = torch.cat([pad, misB], dim=1)[:, j + 1: j + Cp + 2]
    return torch.flip(blk, dims=(1,)).permute(1, 2, 0, 3)


def _ep_specials(c, j, PF, LBc, L3, lam, st, mst):
    """Base-coupled bulges and small internal loops at their per-(j, w)
    energies, in the K2 space: [w, n2, B] (JAX _ep_specials)."""
    W1, n_ar = st.dims.Wp + 1, st.n_ar
    lamk2 = lam[mst.k2_bu]                        # [n2, B]
    il6 = c.ep["spec_il"][:, j]                   # [6, w, B]
    acc = torch.full((W1, st.n2, lam.shape[-1]), NEG, dtype=st.dtype,
                     device=st.device)
    for ci, (dk, dl) in enumerate(SPEC_COMBOS):
        lf = _shift_w(LBc[:, dk], dk)             # [w, S, B]
        pin = _shift_w(PF[dl], dk + dl)
        tar = _segmax(pin[:, mst.p13_s1] + L3[dl, mst.p13_s3][None],
                      mst.p13_ar, n_ar, axis=1)   # [w, n_ar, B]
        eil = lam_mul(lamk2[None], il6[ci][:, None, :])
        t = lf[:, mst.k2_s2] + tar[:, mst.k2_ar] + eil
        ok = ((dk + dl) <= c.C)[None, None, :]
        acc = torch.maximum(acc, torch.where(ok, t, NEG))
    return acc


def ep_col(win, j, rows, c, st, mst, Lcol, Pcol):
    """TT_E_P internal-loop maximum (motif_scanner.hpp:875-905; JAX
    ep_col): chain-factored as the sum DP, with the size classes
    max-reduced before the lambda multiply (lam >= 0)."""
    Lp, Wp, Cp, S = st.dims.Lp, st.dims.Wp, st.dims.Cp, st.dims.S
    dev, dt = st.device, st.dtype
    B = Lcol.shape[-1]
    if not st.have_ep:
        return torch.full((Wp + 1, S, B), NEG, dtype=dt, device=dev)
    lam = rows["lam"]
    n_ar = st.n_ar
    warr = torch.arange(Wp + 1, device=dev)
    dlarr = torch.arange(Cp + 1, device=dev)
    PF = torch.cat([Pcol[None], win["P"]], dim=0)[: Cp + 1]
    LB = torch.cat([Lcol[None], win["L"]], dim=0)
    L3 = Lcol[: Cp + 1]                           # [dl, S, B]
    dcum = c.dots_cum
    if st.dims.fix_rss:
        rd = (dcum[j] - dcum[torch.clamp(j - dlarr, min=0)]) \
            == dlarr[:, None]
        L3 = torch.where(rd[:, None, :], L3, NEG)
    # T stage: inner pair x right flank -> AR
    T = torch.full((Cp + 1, Wp + 1, n_ar, B), NEG, dtype=dt, device=dev)
    for q0 in range(0, st.n13, P13C):
        q = slice(q0, q0 + P13C)
        T13 = PF[:, :, mst.p13_s1[q]] + L3[:, mst.p13_s3[q]][:, None]
        T = torch.maximum(T, _segmax(T13, mst.p13_ar[q], n_ar, axis=2))
    Tsh = _shear(T, Wp + 1, NEG)                  # [dl, x, n_ar, B]
    # W[dl, x, u1, B] = max over the size classes of misB(inner) + size +
    # misA(outer), taken per misA/misB group
    mA = c.ep["misA"][:, j]                       # [4, w, B]
    mBsh = _shear(_flipB(c.ep["misB"], j, Cp), Wp + 1, NEG)  # [dl, x, 4, B]
    ru_ok = st.ru_ok.bool()[:, :, None]
    wA = [torch.where(ru_ok, mA[g_][st.ru], NEG) for g_ in range(4)]
    Wall = None
    for g_ in range(4):
        t = mBsh[:, :, g_, None, :] + mst.SZg[g_][:, None, :, None] \
            + wA[g_][None]
        Wall = t if Wall is None else torch.maximum(Wall, t)
    cmask = (dlarr[:, None, None] + dlarr[None, :, None]
             <= c.C[None, None, :])               # [dl, u1, B]
    Wall = torch.where(cmask[:, None], Wall, NEG)
    # V_bu[x, u1, ar, B] = max_dl Tsh + lam_bu * W
    V_bu = []
    for b in range(2):
        Wl = lam_mul(lam[b], Wall)
        V_bu.append(torch.cat([
            torch.amax(Tsh[:, :, None, a0:a0 + ARC] + Wl[:, :, :, None],
                       dim=0) for a0 in range(0, n_ar, ARC)], dim=2))
    Vcat = torch.cat(V_bu, dim=2)                 # [x, u1, 2 n_ar, B]
    LBc = LB[:, : Cp + 1]                         # [x, u1, S, B]
    if st.dims.fix_rss:
        ld = (dcum[torch.clamp(j - warr[:, None], min=0)]
              - dcum[torch.clamp(j - warr[:, None] - dlarr[None, :], min=0)]
              ) == dlarr[None, :, None]
        LBc = torch.where(ld[:, :, None, :], LBc, NEG)
    arcat = mst.k2_bu * n_ar + mst.k2_ar
    out = torch.full((Wp + 1, S, B), NEG, dtype=dt, device=dev)
    for q0 in range(0, st.n2, K2C):
        q = slice(q0, q0 + K2C)
        G2 = LBc[:, :, mst.k2_s2[q]] + Vcat[:, :, arcat[q]]  # [x, u1, nc, B]
        G2sh = _shear(torch.movedim(G2, 1, 0), Wp + 1, NEG)  # [u1, w, nc, B]
        out = torch.maximum(out, _segmax(torch.amax(G2sh, dim=0),
                                         mst.k2_tgt[q], S, axis=1))
    if not st.dims.no_ene:
        spec = _ep_specials(c, j, PF, LBc, L3, lam, st, mst)
        out = torch.maximum(out, _segmax(spec, mst.k2_tgt, S, axis=1))
    return out


def e_col(j, rows, c, st, Lcol, Mcol, epcol):
    """E = max(hairpin, multiloop, internal loop) of column j."""
    lamv = rows["lam"][st.bucket]
    hterm = torch.where(st.loopm[None, :, None],
                        Lcol + lam_mul(lamv[None], c.hp[j][:, None, :]),
                        torch.full_like(Lcol, NEG))
    mterm = Mcol + lam_mul(lamv[None], c.mlE[j][:, None, :])
    Ecol = torch.maximum(torch.maximum(hterm, mterm), epcol)
    return mask_neg(Ecol, c.okE[j][:, None, :])


def o_col(win, j, rows, c, st, mst, Pcol):
    """O column: the O chain and the O * P splits per lambda bucket (JAX
    o_col); slot 0 (row j) is -inf."""
    S = st.dims.S
    B = Pcol.shape[-1]
    Orows = torch.cat([torch.full((1, S, B), NEG, dtype=st.dtype,
                                  device=st.device), win["O"]], dim=0)
    ax = aux_of(rows, c, j, st, ("R",))
    oo = _chain(Orows[1][None], rows["eR"], st,
                None if ax is None else ax["R"])[0] + c.gate_O2[j - 1][None]
    tt, aa, cc, bu = mst.op
    if not len(tt):
        return oo
    lam = rows["lam"]
    extw = torch.stack([lam_mul(lam[b], c.ext[j]) for b in range(2)])
    Y = Pcol[:, aa] + Orows[:, cc] + extw[bu].transpose(0, 1)  # [w, nop, B]
    return torch.maximum(oo, _segmax(torch.amax(Y, dim=0), tt, S, axis=0))


# ------------------------------------------------- plain column stages

def band_front_plain(state, j, d, c, mst):
    st = mst.st
    r = j + st.PAD
    win = {"L": _flip(state["LL"], j - 1, st.dims.Wp, st.PAD)[:1],
           "P": _flip(state["P"], j - 1, st.dims.Cp, st.PAD)[:1],
           "E": state["E"][r - 1], "T2": state["T2"][r - 1]}
    state["LL"][r], state["P"][r], state["T2"][r] = front_col(
        win, j, col_rows(d, None, j, st), c, st)


def band_bif_plain(state, j, d, c, mst):
    st = mst.st
    r = j + st.PAD
    win = {"T1": _flip(state["T1"], j - 1, st.dims.Wp, st.PAD)}
    state["Bt"][r], state["T1"][r] = bif_col(win, j, c, st, mst,
                                             state["T2"][r])


def band_m_plain(state, j, d, c, mst):
    st = mst.st
    r = j + st.PAD
    state["M"][r] = m_col(j, col_rows(d, None, j, st), c, st, state["Bt"][r])


def ep_stage_plain(state, j, d, c, mst):
    st = mst.st
    r = j + st.PAD
    win = {"L": _flip(state["LL"], j - 1, st.dims.Wp, st.PAD),
           "P": _flip(state["P"], j - 1, st.dims.Cp, st.PAD)}
    state["ep"][r] = ep_col(win, j, col_rows(d, None, j, st), c, st, mst,
                            state["LL"][r], state["P"][r])


def band_e_plain(state, j, d, c, mst):
    st = mst.st
    r = j + st.PAD
    state["E"][r] = e_col(j, col_rows(d, None, j, st), c, st, state["LL"][r],
                          state["M"][r], state["ep"][r])


def ext_stage_plain(state, j, d, c, mst):
    st = mst.st
    r = j + st.PAD
    win = {"O": _flip(state["O"], j - 1, st.dims.Wp, st.PAD)}
    state["O"][r] = o_col(win, j, col_rows(d, None, j, st), c, st, mst,
                          state["P"][r])


# ---------------------------------------------- wrappers (kernel or plain)

def _stage(name: str, plain_fn):
    """Wrapper ``name``: the plain version for CPU tensors, the kernel
    wrapper ``ops.kernels.<name>`` (which launches or raises) otherwise."""
    def stage(state, j, d, c, mst):
        if state["O"].device.type == "cpu":
            return plain_fn(state, j, d, c, mst)
        from . import kernels as K
        return getattr(K, name)(state, j, d, c, mst)
    stage.__name__ = stage.__qualname__ = name
    return stage


max_band_front = _stage("max_band_front", band_front_plain)
max_band_bif = _stage("max_band_bif", band_bif_plain)
max_band_m = _stage("max_band_m", band_m_plain)
max_ep_stage = _stage("max_ep_stage", ep_stage_plain)
max_band_e = _stage("max_band_e", band_e_plain)
max_ext_stage = _stage("max_ext_stage", ext_stage_plain)

# column stages in update order; each reads only finalized values
STAGES = (max_band_front, max_band_bif, max_band_m, max_ep_stage, max_band_e,
          max_ext_stage)
PLAIN_STAGES = (band_front_plain, band_bif_plain, band_m_plain,
                ep_stage_plain, band_e_plain, ext_stage_plain)


class MaxDP:
    """The CYK tables of one grammar + dims, on the device and dtype of
    the sum DP ``dp`` (ops/dp.InsideDP) whose constants it shares."""

    def __init__(self, dp):
        self.st = dp.st
        self.mst = MaxStatic.of(dp.st)

    def run_columns(self, state, d, c, j0: int, j1: int, plain=False):
        """Columns j0..j1-1, every stage in update order (``plain``: the
        plain versions whatever the device).  On the card B/T1, M and O
        run on a side stream of the state's device beside the
        internal-loop stage, as in the sum DP."""
        mst = self.mst
        if plain or state["O"].device.type != "cuda":
            stages = PLAIN_STAGES if plain else STAGES
            for j in range(j0, j1):
                for stage in stages:
                    stage(state, j, d, c, mst)
            return
        dev = state["O"].device
        main = torch.cuda.current_stream(dev)
        side = state.setdefault("_side_stream", torch.cuda.Stream(dev))
        for j in range(j0, j1):
            max_band_front(state, j, d, c, mst)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                max_band_bif(state, j, d, c, mst)
                max_band_m(state, j, d, c, mst)
                max_ext_stage(state, j, d, c, mst)
            max_ep_stage(state, j, d, c, mst)
            main.wait_stream(side)
            max_band_e(state, j, d, c, mst)

    def tables(self, d, c, plain=False):
        """The CYK tables of a batch (state dict, row j at j + PAD; the
        internal-loop term in 'ep').  The size classes are max-reduced
        before the lambda multiply: lambda must be >= 0."""
        if bool((d.lam < 0).any()):
            raise ValueError("the CYK tables need lambda >= 0 (the size "
                             "classes are maxed before the lambda multiply)")
        state = init_state(self.st, c.wsp.shape[-1])
        self.run_columns(state, d, c, 1, self.st.dims.Lp + 1, plain)
        return state


def row_layout(state, st):
    """The 8 tables of a state in JAX's dp_max row layout (row j at
    index j): {name: tensor}, names LL, P, E, M, B, T1, T2, O."""
    return {name: state[key][st.PAD:] for key, name in TABLES}
