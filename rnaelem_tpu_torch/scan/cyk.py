"""Viterbi/CYK alignment of structure + motif states, with traceback
(PyTorch; JAX scan/cyk.py).

The max-semiring twin of the inside DP (CYKFun, motif_scanner.hpp:802-913)
runs over a whole chunk of reads through ops/dp_maxb.py (K10-K12 on the
card) with the start/end pins (Ys, Ye) and the tail pin as a pin set
(ops/dp.py Pin); the traceback (motif_scanner.hpp:262-362) re-derives each
cell's choice from the tables: on the card the kernel K13
(csrc/cyk_traceback.cu), so the tables never leave it, on the CPU its
plain version ``traceback`` below.

Tie-breaking: the reference keeps the first strictly-greater candidate in
its sequential evaluation order.  Both versions enumerate candidates in
that order (P_E before P_P, split points in loop order, O_O last) and take
the FIRST candidate whose score is within ``eps * (1 + |stored|)`` of the
cell's stored table value: the reference's rule, robust to the last-bit
rounding of a score recomputed in another association order than the
DP's.  ``EPS``: 1e-9 at f64 (scores of ~1e2 carry ~1e-14 of rounding; a
real difference between two alignments is an energy or emission quantum,
far above 1e-7); 1e-5 at f32 (a few f32 roundings of ~1e2-sized terms
reach ~1e-4 absolute, so a tighter bar could find no candidate and fail
the read, while f32 cannot order paths closer than that anyway).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import device as DEV
from ..alphabet import BP
from ..energy import tables as ET
from ..model import joint as J
from ..ops import dp as DP
from ..ops import dp_maxb as DMB

NEG = -np.inf
# table ids of the traceback stack (K13's too)
LLs, Ps, Es, Ms, Bs, S1s, S2s, Os = range(8)
EPS = {torch.float64: 1e-9, torch.float32: 1e-5}


def cyk_pins(Ys, Ye, L):
    """CYKFun's vetoes (motif_scanner.hpp:839-873; JAX _pin_aux) as a pin
    set: at base Ys only start-class transitions survive, at base Ye only
    end-class ones, and when Ye == L at base L-1 only tail-class R and PR
    transitions.  Ys, Ye, L: [B] tensors on the DP's device."""
    Ys, Ye, L = (torch.as_tensor(x).long() for x in (Ys, Ye, L))
    tail = torch.where(Ye == L, L - 1, torch.full_like(L, -1))
    i32 = lambda x: x.to(torch.int32).contiguous()
    return (DP.Pin(i32(Ys), DP.CLS_START), DP.Pin(i32(Ye), DP.CLS_END),
            DP.Pin(i32(tail), DP.CLS_TAIL, DP.KINDS_RIGHT))


def _il_np(tab, seq, j, Wp, Cp, C, no_ene, dots_cum=None):
    """Internal-loop energies il[w, dk, dl] of the E cells of column j from
    the Turner tables (the numpy twin of energy.tables.iloop_scores,
    energy_param.hpp:744-795), for the host traceback."""
    w = np.arange(Wp + 1)[:, None, None]
    dk = np.arange(Cp + 1)[None, :, None]
    dl = np.arange(Cp + 1)[None, None, :]
    i = j - w
    k = i + dk
    l = j - dl
    u1, u2 = dk, dl
    usum = u1 + u2
    umax = np.maximum(u1, u2)
    sg = lambda a, idx: a[np.clip(idx, 0, a.shape[0] - 1)]

    valid = (usum >= 1) & (usum <= C) & (w - dk - dl >= 0) & (i >= 0)
    if dots_cum is not None:
        valid = valid & ((sg(dots_cum, k) - sg(dots_cum, i)) == dk) \
            & ((sg(dots_cum, j * np.ones_like(l)) - sg(dots_cum, l))
               == dl)
    if no_ene:
        return np.where(valid, 0.0, NEG)

    MAXLOOP = 30
    t = tab["bp"][sg(seq, i - 1), sg(seq, j + 0 * w)]
    t2 = tab["bp"][sg(seq, l - 1), sg(seq, k)]
    b_i = sg(seq, i)
    b_jm = sg(seq, (j - 1) + 0 * w)
    b_l = sg(seq, l)
    b_km = sg(seq, k - 1)

    uc = np.clip(umax, 0, MAXLOOP)
    usc = np.clip(usum, 0, MAXLOOP)
    au = np.where(t > 2, tab["term_au"], 0.0)
    au2 = np.where(t2 > 2, tab["term_au"], 0.0)
    bulge = np.where(umax == 1, tab["bulge"][uc] + tab["stack"][t, t2],
                     tab["bulge"][uc] + au + au2)
    int11 = tab["int11"][t, t2, b_i, b_jm]
    int21a = tab["int21"][t, t2, b_i, b_l, b_jm]
    int21b = tab["int21"][t2, t, b_l, b_i, b_km]
    int22 = tab["int22"][t, t2, b_i, b_km, b_l, b_jm]
    short = np.where(
        usum == 2, int11,
        np.where((u1 == 1) & (u2 == 2), int21a,
                 np.where((u1 == 2) & (u2 == 1), int21b, int22)))
    mis_long = np.where(
        (u1 == 1) | (u2 == 1),
        tab["mismatch_1n"][t, b_i, b_jm]
        + tab["mismatch_1n"][t2, b_l, b_km],
        np.where(
            usum == 5,
            tab["mismatch_23"][t, b_i, b_jm]
            + tab["mismatch_23"][t2, b_l, b_km],
            tab["mismatch_i"][t, b_i, b_jm]
            + tab["mismatch_i"][t2, b_l, b_km]))
    longi = tab["internal"][usc] \
        + tab["ninio"][np.clip(np.abs(u1 - u2), 0, MAXLOOP)] + mis_long
    z = np.where((u1 == 0) | (u2 == 0), bulge,
                 np.where(umax <= 2, short, longi))
    z = np.where(usum > MAXLOOP, NEG, z)
    return np.where(valid, z, NEG)


def _tab_np(energy: str):
    """The Turner tables _il_np reads, as host arrays."""
    host = ET._host_tables(energy)
    out = {key: host[key] for key in (
        "term_au", "bulge", "stack", "int11", "int21", "int22",
        "mismatch_1n", "mismatch_23", "mismatch_i", "internal", "ninio")}
    out["bp"] = np.asarray(BP)
    return out


class _Host:
    """Host-side candidate scorer over one read's numpy tables and factors
    (dp_max row layout: row j at index j)."""

    def __init__(self, cfg, g, tabs, fac, t, pins, codes):
        n = lambda x: x[..., t]
        (self.LL, self.P, self.E, self.M, self.B, self.T1, self.T2,
         self.O) = [n(tabs[k]) for k in ("LL", "P", "E", "M", "B", "T1",
                                          "T2", "O")]
        self.cfg, self.g = cfg, g
        for k in ("eR", "eL", "bg2", "pv", "wsp", "hp", "stk", "ext", "ml2",
                  "mlE", "gate_O2", "gate_M", "seq", "dots_cum"):
            setattr(self, k, n(fac[k]))
        self.lam = fac["lam"][:, t]
        self.TR, self.TL, self.TPm = fac["TR"], fac["TL"], fac["TPm"]
        self.C = int(fac["C"][t])
        self.L = int(fac["L"][t])
        self.lamv = self.lam[g.lam_bucket]
        self.ptab = np.maximum(g.pair_table_index[g.pt_tab], 0)
        self.il_cache = {}
        # the pin set's -inf vetoes per (kind, base): [S, S]
        self.veto = {}
        for pos, bit, kinds in pins:
            p = int(pos[t])
            for kind in range(4):
                if p < 0 or not (kinds >> kind) & 1:
                    continue
                a = self.veto.get((kind, p), np.zeros(codes.shape[1:]))
                self.veto[(kind, p)] = a + np.where(codes[kind] & bit, 0.0,
                                                    NEG)

    def aux(self, kind, p, s, s1):
        a = self.veto.get((kind, p))
        return 0.0 if a is None else a[s, s1]

    def lam_mul(self, s, tsc):
        return NEG if tsc == NEG else self.lamv[s] * tsc

    def pem(self, i, j, s, s1):
        """Pair emission for target s at (i, j), source s1."""
        g = self.g
        if not g.pt[s, s1]:
            return NEG
        if g.pt_isbp[s, s1]:
            v = self.pv[j, j - i, self.ptab[s, s1]]
            if g.pt_wl[s, s1]:
                v += self.wsp[i]
            if g.pt_wr[s, s1]:
                v += self.wsp[j - 1]
        else:
            v = self.bg2[i] + self.bg2[j - 1]
        v += self.TPm[s, s1]
        return v + self.aux(2, i, s, s1) + self.aux(3, j - 1, s, s1)

    def il(self, j):
        if j not in self.il_cache:
            cfg = self.cfg
            self.il_cache[j] = _il_np(
                _tab_np(cfg.energy), self.seq, j, cfg.Wp, cfg.Cp, self.C,
                cfg.no_ene, self.dots_cum if cfg.fix_rss else None)
        return self.il_cache[j]


def _candidates(h: _Host, e: int, i: int, j: int, s: int):
    """The candidates of one cell in the reference's evaluation order:
    (scores [n], action(k) -> the k-th candidate's action)."""
    g, S, w = h.g, h.g.S, j - i
    sc, acts = [], []

    def add(score, act):
        sc.append(score)
        acts.append(act)

    if e == Os:
        # TT_O_OP for split i' descending, then TT_O_O
        for isp in range(j - 1, max(0, j - h.cfg.Wp) - 1, -1):
            wp = j - isp
            for (ts, s1, s2) in g.op_tuples:
                if ts == s:
                    add(h.O[isp, s2] + h.P[j, wp, s1]
                        + h.lam_mul(s, h.ext[j, wp]), ("O_OP", isp, s1, s2))
        for s1 in range(S):
            if g.rt[s, s1]:
                add(h.O[j - 1, s1] + h.TR[s, s1] + h.eR[j - 1, s]
                    + h.gate_O2[j - 1] + h.aux(0, j - 1, s, s1), ("O_O", s1))
    elif e == LLs:
        for s1 in range(S):
            if g.rt[s, s1]:
                add(h.LL[j - 1, w - 1, s1] + h.TR[s, s1] + h.eR[j - 1, s]
                    + h.aux(0, j - 1, s, s1), ("L_L", s1))
    elif e == Ps:
        for s1 in range(S):
            pe = h.pem(i, j, s, s1)
            if not g.pt[s, s1]:
                continue
            add(h.E[j - 1, w - 2, s1] + pe, ("P_E", s1))
            add(h.P[j - 1, w - 2, s1] + pe + h.lam_mul(s, h.stk[j, w]),
                ("P_P", s1))
    elif e == S2s:
        for s1 in range(S):
            if g.rt[s, s1]:
                add(h.T2[j - 1, w - 1, s1] + h.TR[s, s1] + h.eR[j - 1, s]
                    + h.gate_O2[j - 1] + h.aux(0, j - 1, s, s1), ("2_2", s1))
        add(h.P[j, w, s] + h.lam_mul(s, h.ml2[j, w]), ("2_P",))
    elif e == S1s:
        add(h.T2[j, w, s], ("1_2",))
        add(h.B[j, w, s], ("1_B",))
    elif e == Bs:
        for k in range(i + 1, j):
            for (ts, s1, s2) in g.b12_tuples:
                if ts == s:
                    add(h.T1[k, k - i, s1] + h.T2[j, j - k, s2],
                        ("B_12", k, s1, s2))
    elif e == Ms:
        for s1 in range(S):
            if g.lt[s, s1]:
                add(h.M[j, w - 1, s1] + h.TL[s, s1] + h.eL[i, s1]
                    + h.gate_M[i] + h.aux(1, i, s, s1), ("M_M", s1))
        add(h.B[j, w, s], ("M_B",))
    elif e == Es:
        if g.loop_mask[s]:
            add(h.LL[j, w, s] + h.lam_mul(s, h.hp[j, w]), ("E_H",))
        add(h.M[j, w, s] + h.lam_mul(s, h.mlE[j, w]), ("E_M",))
        # TT_E_P in the reference's evaluation order (motif_scanner.hpp:
        # 875-905): (dl, dk, quadruple), the valid ones
        tup = g.ep_tuples[g.ep_tuples[:, 0] == s] if len(g.ep_tuples) \
            else np.zeros((0, 4), np.int64)
        nd = min(h.cfg.Cp, w)
        if len(tup):
            il = h.il(j)
            dls = np.arange(nd + 1)
            DL, DK = np.meshgrid(dls, dls, indexing="ij")
            valid = (DK <= np.minimum(h.cfg.Cp, w - DL)) \
                & ~((DK == 0) & (DL == 0)) & (DL + DK <= w)
            tsc = il[w, DK, DL]
            valid &= tsc != NEG
            ll, kk = j - DL, i + DK
            vv = np.clip(ll - kk, 0, None)
            s1, s2, s3 = tup[:, 1], tup[:, 2], tup[:, 3]
            tfin = np.where(tsc == NEG, 0.0, tsc)
            ep = (h.P[ll[:, :, None], vv[:, :, None], s1[None, None, :]]
                  + h.LL[kk[:, :, None], DK[:, :, None], s2[None, None, :]]
                  + h.LL[j, DL[:, :, None], s3[None, None, :]]
                  + (h.lamv[s] * tfin)[:, :, None])
            di, ki, qi = np.nonzero(np.broadcast_to(valid[:, :, None],
                                                    ep.shape))
            base = len(sc)
            scores = np.concatenate([np.asarray(sc, float), ep[di, ki, qi]])

            def action(k):
                if k < base:
                    return acts[k]
                q = k - base
                a, b_, c_ = di[q], ki[q], qi[q]
                return ("E_P", i + int(DK[a, b_]), j - int(DL[a, b_]),
                        int(s1[c_]), int(s2[c_]), int(s3[c_]))
            return scores, action
    else:
        raise AssertionError(e)
    return np.asarray(sc, float), acts.__getitem__


def traceback(cfg, g, h: _Host, eps: float, stats=None):
    """The plain version of K13 for one read: (state path [L] node ids,
    structure string, pair cells [(j, w)]).  Raises if a cell has no
    candidate within eps or the walk does not end.  ``stats``, if given,
    gets the cells walked ("cells") and the candidates up to each cell's
    choice ("cands") added."""
    L = h.L
    state_path = np.zeros(L, np.int64)
    struct = [" "] * L
    pairs = []
    sA, sB = int(g.end_states[1]), int(g.end_states[2])
    s0 = sB if h.O[L, sA] < h.O[L, sB] else sA
    if not max(h.O[L, sA], h.O[L, sB]) > NEG:
        return state_path, "O" * L, pairs
    tables = (h.LL, h.P, h.E, h.M, h.B, h.T1, h.T2)
    stack = [(0, L, Os, s0)]
    guard = 0
    sl, sr = g.state_l, g.state_r
    while stack:
        guard += 1
        if guard > 40 * (L + 2):
            raise RuntimeError("cyk traceback did not terminate")
        i, j, e, s = stack.pop()
        if (e == LLs and j <= i) or (e == Os and j <= 0):
            continue
        scores, action = _candidates(h, e, i, j, s)
        if not len(scores):
            continue
        stored = h.O[j, s] if e == Os else tables[e][j, j - i, s]
        hit = np.nonzero(scores >= stored - eps * (1.0 + abs(stored)))[0]
        if not len(hit):
            raise RuntimeError("cyk traceback: no candidate within %g of "
                               "cell %s" % (eps, (i, j, e, s)))
        act = action(int(hit[0]))
        if stats is not None:
            stats["cells"] = stats.get("cells", 0) + 1
            stats["cands"] = stats.get("cands", 0) + int(hit[0]) + 1
        tt = act[0]
        if tt == "L_L":
            state_path[j - 1] = sr[s]
            stack.append((i, j - 1, LLs, act[1]))
        elif tt == "O_O":
            state_path[j - 1] = sr[s]
            struct[j - 1] = "O"
            stack.append((0, j - 1, Os, act[1]))
        elif tt == "2_2":
            state_path[j - 1] = sr[s]
            struct[j - 1] = "M"
            stack.append((i, j - 1, S2s, act[1]))
        elif tt == "E_H":
            for p in range(i, j):
                struct[p] = "H"
            stack.append((i, j, LLs, s))
        elif tt == "E_M":
            stack.append((i, j, Ms, s))
        elif tt == "M_B":
            stack.append((i, j, Bs, s))
        elif tt == "2_P":
            stack.append((i, j, Ps, s))
        elif tt == "1_2":
            stack.append((i, j, S2s, s))
        elif tt == "1_B":
            stack.append((i, j, Bs, s))
        elif tt in ("P_E", "P_P"):
            s1 = act[1]
            state_path[i] = sl[s1]
            struct[i] = "L"
            state_path[j - 1] = sr[s]
            struct[j - 1] = "R"
            pairs.append((j, j - i))
            stack.append((i + 1, j - 1, Es if tt == "P_E" else Ps, s1))
        elif tt == "O_OP":
            _, isp, s1, s2 = act
            stack.append((isp, j, Ps, s1))
            stack.append((0, isp, Os, s2))
        elif tt == "E_P":
            _, k, l, s1, s2, s3 = act
            if l == j:
                for p in range(i, k):
                    struct[p] = "B"
            elif k == i:
                for p in range(l, j):
                    struct[p] = "B"
            else:
                for p in range(i, k):
                    struct[p] = "I"
                for p in range(l, j):
                    struct[p] = "I"
            stack.append((l, j, LLs, s3))
            stack.append((i, k, LLs, s2))
            stack.append((k, l, Ps, s1))
        elif tt == "B_12":
            _, k, s1, s2 = act
            stack.append((k, j, S2s, s2))
            stack.append((i, k, S1s, s1))
        elif tt == "M_M":
            s1 = act[1]
            state_path[i] = sl[s1]
            struct[i] = "M"
            stack.append((i + 1, j, Ms, s1))
        else:
            raise AssertionError(tt)
    return state_path, "".join(struct), pairs


def rss_from_pairs(pair_cells, L: int) -> str:
    """Structure string from the Viterbi pair set alone: every struct
    class of the traceback (motif_scanner.hpp:262-362) is a pure
    function of the pair nesting — L/R at pair ends; interior of a
    childless pair H; one child: empty-gap side bulge B else internal I;
    >=2 children: M; unenclosed O."""
    struct = ["O"] * L
    # cells are (j, w): pair bases i = j - w and j - 1
    spans = sorted(((int(j) - int(w), int(j)) for j, w in pair_cells),
                   key=lambda p: (p[0], -p[1]))
    stack = []
    children = {sp: [] for sp in spans}
    roots = []
    for sp in spans:
        while stack and sp[0] >= stack[-1][1]:
            stack.pop()
        (children[stack[-1]] if stack else roots).append(sp)
        stack.append(sp)
    for (i, j) in spans:
        struct[i] = "L"
        struct[j - 1] = "R"
        cs = children[(i, j)]
        inner = range(i + 1, j - 1)
        if not cs:
            for p in inner:
                struct[p] = "H"
        else:
            covered = np.zeros(L, bool)
            for (k, l) in cs:
                covered[k:l] = True
            mark = "M" if len(cs) >= 2 else (
                "B" if (cs[0][0] == i + 1 or cs[0][1] == j - 1) else "I")
            for p in inner:
                if not covered[p]:
                    struct[p] = mark
    return "".join(struct)


def host_inputs(state, d, c, st):
    """The host traceback's inputs of a chunk: the tables in the dp_max
    row layout and the factors, as numpy (batch axis last)."""
    n = lambda x: x.detach().cpu().numpy()
    tabs = {k: n(v) for k, v in DMB.row_layout(state, st).items()}
    fac = {k: n(getattr(d, k)) for k in ("eR", "eL", "bg2", "pv", "lam")}
    fac.update({k: n(getattr(c, k)) for k in (
        "wsp", "hp", "stk", "ext", "ml2", "mlE", "gate_O2", "gate_M", "seq",
        "C", "L", "dots_cum")})
    fac.update(TR=n(st.TR), TL=n(st.TL), TPm=n(st.pt_ltw))
    return tabs, fac


def host_tracebacks(cfg, g, state, d, c, st, eps, n=None, stats=None):
    """The plain version of K13 over the reads of a chunk (the first
    ``n``): [(state path, struct, pair cells)]; ``stats`` as traceback
    takes it."""
    tabs, fac = host_inputs(state, d, c, st)
    pins = [(p.pos.cpu().numpy(), int(p.bit), int(p.kinds))
            for p in DP.pin_set(c.pin)]
    codes = DP.class_codes(g)
    B = fac["L"].shape[0] if n is None else n
    return [traceback(cfg, g, _Host(cfg, g, tabs, fac, t, pins, codes), eps,
                      stats) for t in range(B)]


def cyk_batch(cfg: J.ModelConfig, params: J.Params, sd_b, Ys_b, Ye_b,
              bp_ok, device=None, mark=None):
    """The Viterbi alignments of a chunk: the CYK tables of the reads
    under their Ys/Ye pins (K10-K12 on the card, the plain max DP on the
    CPU), then the traceback (K13 on the card, ``traceback`` on the CPU).
    ``bp_ok`` is the chunk's min-BPP mask from the posterior pass (the same
    function of the same inputs as JAX's recomputation).  Returns
    [(psihat [L] node ids, rss string)] per read; raises if a read's
    traceback fails.  ``mark(stage)``, if given, is called after
    cyk_tables and cyk_traceback."""
    dev = DEV.resolve(device)
    mark = mark or (lambda stage: None)
    k = J.kernels(cfg, dev)
    mdp = DMB.MaxDP(k.dp)
    eps = EPS[k.dtype]
    L = torch.as_tensor(sd_b.L, device=dev).long()
    pins = cyk_pins(torch.as_tensor(Ys_b, device=dev),
                    torch.as_tensor(Ye_b, device=dev), L)
    d, c = J.batch_factors(cfg, params, sd_b, bp_ok, device=dev,
                           aux_b={"pin": pins})
    state = mdp.tables(d, c)
    mark("cyk_tables")
    Ln = L.cpu().numpy()
    if dev.type == "cuda":
        from ..ops import kernels as K
        psihat, pairs, err = K.cyk_traceback(state, d, c, mdp.mst, eps)
        del state
        psihat, pairs, err = (x.cpu().numpy() for x in (psihat, pairs, err))
        bad = np.nonzero(err)[0]
        if len(bad):
            raise RuntimeError(
                "cyk traceback failed on reads %s of the chunk (codes %s: 1 "
                "step guard or stack, 2 no candidate within %g)"
                % (bad.tolist(), err[bad].tolist(), eps))
        out = [(psihat[t, :Ln[t]].astype(np.int64),
                rss_from_pairs(np.argwhere(pairs[t]), int(Ln[t])))
               for t in range(len(Ln))]
    else:
        out = [(path, rss_from_pairs(cells, int(Ln[t])))
               for t, (path, _, cells) in enumerate(host_tracebacks(
                   cfg, k.g, state, d, c, k.dp.st, eps))]
        del state
    mark("cyk_traceback")
    return out


def viterbi_alignment(cfg: J.ModelConfig, params: J.Params, sd: J.SeqData,
                      Ys: int, Ye: int, device=None):
    """One read's (state path [L], rss) under its Ys/Ye pins (cyk_batch on
    a batch of one, with the read's own min-BPP mask)."""
    dev = DEV.resolve(device)
    sd_b = J.stack_seqdata([sd], dev)
    bp_ok, _ = J.effective_bp_mask_batch(cfg, sd_b, dev)
    return cyk_batch(cfg, params, sd_b, [Ys], [Ye], bp_ok, dev)[0]
