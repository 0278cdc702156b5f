"""K13's launch plan and its walk on the CPU.

ops/kernels.traceback_plan picks, before any launch, the block of the CYK
traceback kernel (csrc/cyk_traceback.cu): one block of NW warps per read,
the grammar's lists (ops/kernels.tb_lists) staged in shared memory where
they fit, the walk's stack there too where it fits beside them, else in
a device scratch.  The tests below hold the plans to the card's limit,
the ctypes structs to the C structs, and a numpy mirror of the kernel's
walk (its candidate count and decode, its scores from the kernel's table
layout and factor tensors, its lowest hit over rounds of 32 NW
candidates, its pushes) to the host traceback scan/cyk.py traceback and
_candidates' first-within-eps choice at every walked cell.  No GPU is
needed."""
import re

import numpy as np
import pytest
import torch

from rnaelem_tpu_torch.alphabet import seq_to_ints
from rnaelem_tpu_torch.model import joint as TJ
from rnaelem_tpu_torch.ops import dp as DP
from rnaelem_tpu_torch.ops import dp_maxb as DMB
from rnaelem_tpu_torch.ops import kernels as K
from rnaelem_tpu_torch.scan import cyk as CYK
from rnaelem_tpu_torch.scan import scanner as SC

torch.set_num_threads(1)

DTYPES = (torch.float32, torch.float64)
NEG = -np.inf


def _cfg(pattern, Lp=32, **kw):
    kw = dict(dict(pattern=pattern, Lp=Lp, max_span=28, max_iloop=10,
                   min_bpp=1e-4, tau=0.1, dtype="float64"), **kw)
    return TJ.ModelConfig(**kw)


def _mst(cfg):
    return DMB.MaxStatic.of(TJ.kernels(cfg, "cpu").dp.st)


# ------------------------------------------------------------ the plans

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pattern,dots", [("(.....)", 0), ("..*..", 0),
                                          (None, 12), (None, 14)])
def test_traceback_plan_fits_the_card(pattern, dots, dtype):
    """For the main grammars and wide ones (12 and 14 dots) at Lp = 32,
    96 and 400: the lists are staged where they fit beside the dot
    counts, the stack is shared where it fits beside them, the shared
    bytes are tb_smem_bytes' and at most SMEM_LIMIT; the forced device
    variant keeps the lists' place and moves the stack out."""
    cfg = _cfg(pattern or "." * dots)
    li, iv, tv = K.tb_lists(_mst(cfg))
    n = (li.ni, li.nt)
    assert (li.ni, li.nt) == (iv.numel(), tv.numel())
    for Lp in (32, 96, 400):
        p = K.traceback_plan(Lp, dtype, n)
        it = torch.empty((), dtype=dtype).element_size()
        lists = it * li.nt + 4 * li.ni
        assert p.cap == 3 * (Lp + 2) + 8 and p.NW == K.TB_WARPS
        assert p.lists == ("shared" if lists + 4 * (Lp + 1) <= K.SMEM_LIMIT
                           else "device")
        fixed = (lists if p.lists == "shared" else 0) + 4 * (Lp + 1)
        assert p.stack == ("shared" if fixed + 16 * p.cap <= K.SMEM_LIMIT
                           else "device")
        assert p.smem == K.tb_smem_bytes(Lp, dtype, n, p.stack == "shared",
                                         p.lists == "shared")
        assert p.smem == fixed + (16 * p.cap if p.stack == "shared" else 0)
        assert p.smem <= K.SMEM_LIMIT
        d = K.traceback_plan(Lp, dtype, n, variant="device")
        assert (d.stack, d.lists) == ("device", p.lists)
        assert d.smem == fixed
        assert d.grid_args == (p.NW, 0, int(p.lists == "shared"), fixed)


def test_traceback_plan_main_shapes_and_refusals():
    """The tRNA scan's shape (S=29, Lp=96) keeps lists and stack in shared
    memory at both types; 12 dots at f64 (S=105) keeps its lists there but
    has no room for the stack beside them at Lp=1100, where forcing a
    shared stack is refused; 14 dots at f64 (S=136) reads its lists where
    they lie and keeps the stack shared; a foreign variant and warps
    outside 1..8 are refused, and warps are forced."""
    n = (lambda li: (li.ni, li.nt))(K.tb_lists(_mst(_cfg("(.....)")))[0])
    for dt in DTYPES:
        p = K.traceback_plan(96, dt, n)
        assert (p.stack, p.lists, p.NW) == ("shared", "shared", 4)
        assert p.smem < 48 * 1024
    w12 = (lambda li: (li.ni, li.nt))(K.tb_lists(_mst(_cfg("." * 12)))[0])
    assert (K.traceback_plan(1000, torch.float64, w12).stack) == "shared"
    p = K.traceback_plan(1100, torch.float64, w12)
    assert (p.stack, p.lists) == ("device", "shared")
    with pytest.raises(ValueError, match="does not fit"):
        K.traceback_plan(1100, torch.float64, w12, variant="shared")
    w14 = (lambda li: (li.ni, li.nt))(K.tb_lists(_mst(_cfg("." * 14)))[0])
    p = K.traceback_plan(400, torch.float64, w14)
    assert (p.stack, p.lists) == ("shared", "device")
    with pytest.raises(ValueError, match="variant"):
        K.traceback_plan(96, torch.float64, n, variant="global")
    for w in (0, 9):
        with pytest.raises(ValueError, match="warps"):
            K.traceback_plan(96, torch.float64, n, warps=w)
    assert K.traceback_plan(96, torch.float64, n, warps=8).NW == 8
    big = (10 ** 6, 10 ** 5)
    p = K.traceback_plan(96, torch.float64, big)
    assert (p.stack, p.lists) == ("shared", "device")


def _c_fields(src, name):
    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    out = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            for x in decl.split(","):
                out.append(re.sub(r"[^\w]", "", x.split()[-1]))
    return out


@pytest.mark.parametrize("cname", ["TbLists", "TbGrid", "TbCfg", "TbData"])
def test_the_traceback_structs_match_their_c_layout(cname):
    """TbLists, TbGrid, TbCfg and TbData as ctypes builds them, field by
    field (csrc/cyk_traceback.cu); a plan's grid_args fill TbGrid."""
    src = (K.CSRC / "cyk_traceback.cu").read_text()
    py = getattr(K, cname)
    assert _c_fields(src, cname) == [f[0] for f in py._fields_]
    if cname == "TbGrid":
        py(*K.traceback_plan(96, torch.float32, (100, 10)).grid_args)


def test_tb_lists_pack_the_grammar():
    """tb_lists' buffers hold each list at its offset (st.k and the
    MaxStatic's), the pair transitions packed as ((code + 2) << 2) | (wl
    << 1) | wr and unpacked by the kernel's rule."""
    cfg = _cfg("((..).)")
    st = TJ.kernels(cfg, "cpu").dp.st
    mst = _mst(cfg)
    li, iv, tv = K.tb_lists(mst)
    kk = dict(st.k, **mst.k)
    for name in K.TB_INT_LISTS:
        if name == "pt":
            continue
        a = kk[name].numpy().ravel()
        off = getattr(li, name)
        assert np.array_equal(iv.numpy()[off:off + a.size], a), name
    for name in K.TB_SCALAR_LISTS:
        a = kk[name].numpy().ravel()
        off = getattr(li, name)
        assert np.array_equal(tv.numpy()[off:off + a.size], a), name
    S = st.dims.S
    pt = iv.numpy()[li.pt:li.pt + S * S]
    code = kk["pt_code"].numpy().ravel()
    assert np.array_equal((pt >> 2) - 2, code)
    assert np.array_equal((pt >> 1) & 1, kk["pt_wl"].numpy().ravel())
    assert np.array_equal(pt & 1, kk["pt_wr"].numpy().ravel())
    assert set(np.unique(code)) <= set(range(-2, int(code.max()) + 1))
    assert K.tb_lists(mst)[1] is iv          # built once


# ---------------------------------------------- the kernel's walk, mirrored

LL_, P_, E_, M_, B_, T1_, T2_, O_ = range(8)
DKS, DLS = (0, 1, 1, 1, 2, 2), (1, 0, 1, 2, 1, 2)


class WalkMirror:
    """csrc/cyk_traceback.cu's Tb (count, cand) and the kernel's walk for
    read b in numpy: the tables in the kernel's layout [R, W1, S, B] (row
    j at j + PAD), the factor tensors the launch takes, tb_lists' buffers
    and the pins' positions and classes as the Aux struct holds them."""

    def __init__(self, st, mst, state, d, c, b):
        li, iv, tv = K.tb_lists(mst)
        self.iv, self.tv = iv.numpy(), tv.numpy()
        self.o = {f: getattr(li, f) for f in K.TB_INT_LISTS
                  + K.TB_SCALAR_LISTS}
        n = lambda t: t.detach().numpy()
        self.T = [n(state[k])[..., b] for k in ("LL", "P", "E", "M", "Bt",
                                                "T1", "T2")]
        self.Ot = n(state["O"])[..., b]
        self.f = {k: n(getattr(d, k))[..., b] for k in ("eR", "eL", "bg2",
                                                          "pv")}
        self.f.update({k: n(getattr(c, k))[..., b] for k in (
            "wsp", "gate_O2", "gate_M", "hp", "stk", "ext", "ml2", "mlE")})
        self.f.update({k: n(c.ep[k])[..., b] for k in ("misA", "misB",
                                                        "spec_il")})
        self.SZ = n(mst.SZg)
        self.dc = n(c.dots_cum)[:, b]
        self.C, self.L = int(c.C[b]), int(c.L[b])
        self.lam = n(d.lam)[:, b]
        D = st.dims
        self.Lp, self.Wp, self.Cp, self.S = D.Lp, D.Wp, D.Cp, D.S
        self.PAD, self.fix_rss, self.no_ene = st.PAD, D.fix_rss, D.no_ene
        self.code = st.k["cls_code"].numpy()
        self.pins = [(int(p.pos[b]), int(p.bit), int(p.kinds))
                     for p in DP.pin_set(c.pin)]

    def l(self, name, k):
        return int(self.iv[self.o[name] + k])

    def w(self, name, k):
        return self.tv[self.o[name] + k]

    def tab(self, e, j, w, s):
        if w < 0 or w > self.Wp or j < 0 or j > self.Lp:
            return NEG
        return self.T[e][j + self.PAD, w, s]

    def O(self, j, s):
        return NEG if j < 0 or j > self.Lp else self.Ot[j + self.PAD, s]

    def lamv(self, s):
        return self.lam[self.l("bucket", s)]

    @staticmethod
    def lam_mul(lam, x):
        return NEG if x == NEG else lam * x

    def veto(self, base, kind, t, s):
        req = 0
        for pos, bit, kinds in self.pins:
            if (kinds >> kind) & 1 and pos == base:
                req |= bit
        return req != 0 and (self.code[kind, t, s] & req) != req

    def dots(self, lo, hi, n):
        return not self.fix_rss or self.dc[hi] - self.dc[lo] == n

    def pem(self, i, j, s, s1, pk):
        code = (pk >> 2) - 2
        if code == -2:
            v = self.f["bg2"][i] + self.f["bg2"][j - 1]
        else:
            v = self.f["pv"][j, j - i, code]
            if pk & 2:
                v += self.f["wsp"][i]
            if pk & 1:
                v += self.f["wsp"][j - 1]
        r = v + self.w("pt_lt", s * self.S + s1)
        return NEG if self.veto(i, 2, s, s1) or self.veto(j - 1, 3, s, s1) \
            else r

    def il(self, j, w, dk, dl):
        usum, v, i = dk + dl, w - dk - dl, j - w
        if usum < 1 or usum > self.C or v < 0:
            return NEG
        ok = self.dots(i, i + dk, dk) and self.dots(j - dl, j, dl)
        ci = -1
        if not self.no_ene:
            for c_ in range(6):
                if dk == DKS[c_] and dl == DLS[c_]:
                    ci = c_
        if ci >= 0:
            e = self.f["spec_il"][ci, j, w]
        else:
            e = NEG
            for g in range(4):
                x = (self.f["misB"][g, j - dl, v] + self.SZ[g, dl, dk]
                     + self.f["misA"][g, j, w])
                e = x if x > e else e
        return e if ok else NEG

    def n_rt(self, s):
        return self.l("rt_off", s + 1) - self.l("rt_off", s)

    def count(self, e, i, j, s):
        w = j - i
        if e == O_:
            ns = min(j, self.Wp)
            return ns * (self.l("op_off", s + 1) - self.l("op_off", s)) \
                + self.n_rt(s)
        if e == LL_:
            return self.n_rt(s)
        if e == P_:
            return 2 * self.S
        if e == T2_:
            return self.n_rt(s) + 1
        if e == T1_:
            return 2
        if e == B_:
            return max(w - 1, 0) * (self.l("b12_off", s + 1)
                                    - self.l("b12_off", s))
        if e == M_:
            return self.l("lt_off", s + 1) - self.l("lt_off", s) + 1
        nd = min(self.Cp, w) + 1
        return 2 + nd * nd * (self.l("ept_off", s + 1)
                              - self.l("ept_off", s))

    def cand(self, e, i, j, s, q):
        """(exists, score, the host's action tuple)"""
        w, f = j - i, self.f
        if e == O_:
            nop = self.l("op_off", s + 1) - self.l("op_off", s)
            ns = min(j, self.Wp)
            if q < ns * nop:
                wp, k = q // nop + 1, self.l("op_off", s) + q % nop
                isp, s1, s2 = j - wp, self.l("op_a", k), self.l("op_c", k)
                return True, (self.O(isp, s2) + self.tab(P_, j, wp, s1)
                              + self.lam_mul(self.lamv(s), f["ext"][j, wp])
                              ), ("O_OP", isp, s1, s2)
            k = self.l("rt_off", s) + q - ns * nop
            s1 = self.l("rt_s", k)
            v = (self.O(j - 1, s1) + self.w("rt_w", k) + f["eR"][j - 1, s]
                 + f["gate_O2"][j - 1])
            return True, NEG if self.veto(j - 1, 0, s, s1) else v, \
                ("O_O", s1)
        if e in (LL_, T2_):
            if e == T2_ and q == self.n_rt(s):
                return True, self.tab(P_, j, w, s) + self.lam_mul(
                    self.lamv(s), f["ml2"][j, w]), ("2_P",)
            k = self.l("rt_off", s) + q
            s1 = self.l("rt_s", k)
            v = self.tab(e, j - 1, w - 1, s1) + self.w("rt_w", k) \
                + f["eR"][j - 1, s]
            if e == T2_:
                v = v + f["gate_O2"][j - 1]
            return True, NEG if self.veto(j - 1, 0, s, s1) else v, \
                ("L_L" if e == LL_ else "2_2", s1)
        if e == P_:
            s1, pp = q >> 1, q & 1
            pk = self.l("pt", s * self.S + s1)
            if (pk >> 2) - 2 == -1:
                return False, NEG, None
            pe = self.pem(i, j, s, s1, pk)
            if not pp:
                return True, self.tab(E_, j - 1, w - 2, s1) + pe, ("P_E", s1)
            return True, (self.tab(P_, j - 1, w - 2, s1) + pe
                          + self.lam_mul(self.lamv(s), f["stk"][j, w])), \
                ("P_P", s1)
        if e == T1_:
            return True, self.tab(B_ if q else T2_, j, w, s), \
                ("1_B",) if q else ("1_2",)
        if e == B_:
            nb = self.l("b12_off", s + 1) - self.l("b12_off", s)
            k, t = i + 1 + q // nb, self.l("b12_off", s) + q % nb
            s1, s2 = self.l("b12_a", t), self.l("b12_c", t)
            return True, self.tab(T1_, k, k - i, s1) \
                + self.tab(T2_, j, j - k, s2), ("B_12", k, s1, s2)
        if e == M_:
            nlt = self.l("lt_off", s + 1) - self.l("lt_off", s)
            if q == nlt:
                return True, self.tab(B_, j, w, s), ("M_B",)
            k = self.l("lt_off", s) + q
            s1 = self.l("lt_s", k)
            v = (self.tab(M_, j, w - 1, s1) + self.w("lt_w", k)
                 + f["eL"][i, s1] + f["gate_M"][i])
            return True, NEG if self.veto(i, 1, s, s1) else v, ("M_M", s1)
        # E
        if q == 0:
            if not self.l("loopm", s):
                return False, NEG, ("E_H",)
            return True, self.tab(LL_, j, w, s) + self.lam_mul(
                self.lamv(s), f["hp"][j, w]), ("E_H",)
        if q == 1:
            return True, self.tab(M_, j, w, s) + self.lam_mul(
                self.lamv(s), f["mlE"][j, w]), ("E_M",)
        nq = self.l("ept_off", s + 1) - self.l("ept_off", s)
        nd = min(self.Cp, w) + 1
        r = q - 2
        qi, dk, dl = r % nq, (r // nq) % nd, r // nq // nd
        t = self.l("ept_off", s) + qi
        s1, s2, s3 = (self.l(x, t) for x in ("ept_s1", "ept_s2", "ept_s3"))
        k, l_ = i + dk, j - dl
        x1, x2, x3 = (self.tab(P_, l_, l_ - k, s1), self.tab(LL_, k, dk, s2),
                      self.tab(LL_, j, dl, s3))
        e0 = self.il(j, w, dk, dl) if dk + dl <= w and not (
            dk == 0 and dl == 0) else NEG
        if not e0 > NEG:
            return False, NEG, None
        return True, x1 + x2 + x3 + self.lam_mul(self.lamv(s), e0), \
            ("E_P", k, l_, s1, s2, s3)

    def choose(self, e, i, j, s, NW, eps):
        """The kernel's choice at a cell: warp 0 alone where n <= 32, else
        rounds of 32 NW candidates, each warp's first hit, the lowest over
        the warps: (candidate index, action) or None."""
        n = self.count(e, i, j, s)
        stored = self.O(j, s) if e == O_ else self.tab(e, j, j - i, s)
        thr = stored - eps * (1.0 + abs(stored))
        width = 32 if n <= 32 else 32 * NW
        for base in range(0, n, width):
            hits = []
            for warp in range(width // 32):
                for lane in range(32):
                    q = base + 32 * warp + lane
                    if q >= n:
                        break
                    ex, sc, act = self.cand(e, i, j, s, q)
                    if ex and sc >= thr:
                        hits.append((q, act))
                        break
            if hits:
                return min(hits)
        return None


def _walk(m, h, NW, eps):
    """The kernel's walk of one read on the mirror, each cell's choice
    held against the host's _candidates + first-within-eps: (psihat,
    pair cells, walked cells)."""
    L = m.L
    path = np.zeros(m.Lp, np.int64)
    pairs = []
    sA, sB = m.l("end_states", 1), m.l("end_states", 2)
    stack = []
    if max(m.O(L, sA), m.O(L, sB)) > NEG:
        stack.append((0, L, O_, sB if m.O(L, sA) < m.O(L, sB) else sA))
    sl = lambda s: m.l("state_l", s)
    sr = lambda s: m.l("state_r", s)
    tables = (h.LL, h.P, h.E, h.M, h.B, h.T1, h.T2)
    walked = 0
    while stack:
        i, j, e, s = stack.pop()
        if (e == LL_ and j <= i) or (e == O_ and j <= 0):
            continue
        if m.count(e, i, j, s) == 0:
            continue
        got = m.choose(e, i, j, s, NW, eps)
        scores, action = CYK._candidates(h, e, i, j, s)
        stored = h.O[j, s] if e == O_ else tables[e][j, j - i, s]
        hit = np.nonzero(scores >= stored - eps * (1.0 + abs(stored)))[0]
        assert got is not None and len(hit), (i, j, e, s)
        act = got[1]
        assert act == tuple(int(x) if not isinstance(x, str) else x
                            for x in action(int(hit[0]))), (i, j, e, s)
        walked += 1
        tt = act[0]
        if tt in ("L_L", "O_O", "2_2"):
            path[j - 1] = sr(s)
            stack.append(((0 if tt == "O_O" else i), j - 1,
                          {"L_L": LL_, "O_O": O_, "2_2": T2_}[tt], act[1]))
        elif tt in ("E_H", "E_M", "M_B", "2_P", "1_2", "1_B"):
            stack.append((i, j, {"E_H": LL_, "E_M": M_, "M_B": B_,
                                 "2_P": P_, "1_2": T2_, "1_B": B_}[tt], s))
        elif tt in ("P_E", "P_P"):
            path[i], path[j - 1] = sl(act[1]), sr(s)
            pairs.append((j, j - i))
            stack.append((i + 1, j - 1, E_ if tt == "P_E" else P_, act[1]))
        elif tt == "O_OP":
            stack += [(act[1], j, P_, act[2]), (0, act[1], O_, act[3])]
        elif tt == "E_P":
            _, k, l_, s1, s2, s3 = act
            stack += [(l_, j, LL_, s3), (i, k, LL_, s2), (k, l_, P_, s1)]
        elif tt == "B_12":
            stack += [(act[1], j, T2_, act[3]), (i, act[1], T1_, act[2])]
        else:                                   # M_M
            path[i] = sl(act[1])
            stack.append((i + 1, j, M_, act[1]))
    return path, pairs, walked


def _chunk(pattern, seed, **kw):
    """CPU CYK tables of four reads (30, 29, 32 and 25 nt at Lp = 32)
    under the pin set of the port's posterior pass (read 0 moved to Ye ==
    L), distinct random weights: (cfg, kernels, mst, state, d, c)."""
    cfg = _cfg(pattern, **kw)
    k = TJ.kernels(cfg, "cpu")
    rng = np.random.RandomState(seed)
    p = TJ.init_params(k.g, cfg, device="cpu")
    p = p._replace(
        singles=p.singles + torch.as_tensor(0.3 * rng.randn(
            *p.singles.shape)),
        pairs=p.pairs + torch.as_tensor(0.3 * rng.randn(*p.pairs.shape)),
        lam=torch.tensor([0.8, 1.2], dtype=torch.float64))
    lengths = (30, 29, 32, 25)
    sds = []
    for L in lengths:
        s_ = seq_to_ints("".join("ACGU"[x] for x in rng.randint(0, 4, L)))
        q = np.full(L + 1, 10)
        q[-1] = 0
        sds.append(TJ.make_seqdata(cfg, s_, q))
    sd = TJ.stack_seqdata(sds, "cpu")
    bp, _ = TJ.effective_bp_mask_batch(cfg, sd, "cpu")
    res = SC.scan_posteriors_batch(cfg, p, sd, device="cpu")
    Ys, Ye = res["Ys"].clone(), res["Ye"].clone()
    Ye[0] = sd.L[0]                     # a read pinned to its end
    pins = CYK.cyk_pins(Ys, Ye, sd.L)
    d, c = TJ.batch_factors(cfg, p, sd, bp, "cpu", aux_b={"pin": pins})
    state = DMB.MaxDP(k.dp).tables(d, c)
    return cfg, k, DMB.MaxStatic.of(k.dp.st), state, d, c


@pytest.mark.parametrize("case", [("(.....)", {}), ("((..).)", {}),
                                  ("(.*)", {}), ("(.....)",
                                                 {"no_ene": True})],
                         ids=["(.....)", "((..).)", "(.*)", "no_ene"])
def test_the_kernels_walk_picks_the_host_candidate(case):
    """On CPU CYK tables under the pin set, the mirror of K13's walk picks
    at every walked cell the candidate _candidates + first-within-eps
    picks, with one warp and with rounds of 32 x 4 and 32 x 8 candidates,
    and ends with the host traceback's psihat and pair set."""
    pattern, kw = case
    cfg, k, mst, state, d, c = _chunk(pattern, 7, **kw)
    st, g = k.dp.st, k.g
    eps = CYK.EPS[torch.float64]
    tabs, fac = CYK.host_inputs(state, d, c, st)
    pins = [(p.pos.numpy(), int(p.bit), int(p.kinds))
            for p in DP.pin_set(c.pin)]
    codes = DP.class_codes(g)
    walked = 0
    for t in range(4):
        h = CYK._Host(cfg, g, tabs, fac, t, pins, codes)
        want_path, _, want_pairs = CYK.traceback(cfg, g, h, eps)
        m = WalkMirror(st, mst, state, d, c, t)
        for NW in (1, 4, 8):
            path, pairs, n = _walk(m, h, NW, eps)
            L = m.L
            np.testing.assert_array_equal(path[:L], want_path)
            assert sorted(pairs) == sorted(want_pairs)
            walked += n
    assert walked > 0


def test_the_walks_row_indices_fit_32_bits():
    """tb_rows_fit (the launcher's tb_rows_fit): the scan's shapes and
    50 dots at Lp = 400 fit 32-bit row indices, tables past 2^31 rows of
    reads do not; the C check is the same formula."""
    assert K.tb_rows_fit(96, 50, 51, 29, 1)
    assert K.tb_rows_fit(400, 50, 51, 1378, 1)
    assert not K.tb_rows_fit(2000, 1000, 1001, 1378, 1)
    assert not K.tb_rows_fit(100000, 30000, 30001, 1, 1)
    src = (K.CSRC / "cyk_traceback.cu").read_text()
    body = re.search(r"static bool tb_rows_fit\(const DPDims& D\) \{(.*?)\n\}",
                     src, re.S).group(1)
    assert "(D.Lp + 1LL + D.PAD) * W1 * D.S < (1LL << 31)" in body
    assert "cells * (D.Tp > 6 ? D.Tp : 6) < (1LL << 31)" in body
