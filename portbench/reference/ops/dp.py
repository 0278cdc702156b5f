"""Frozen copy of rnaelem_tpu_torch/ops/dp.py for the benchmark's plain
reference (portbench/reference): plain PyTorch and numpy only, the
CUDA kernel branches removed, imports kept inside this copy.

Joint (energy x motif) banded inside DP and its outside pass — batched
(PyTorch).

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

The plain versions are pure functions of the windows of earlier rows
(``front_col`` ... ``o_col``, mirroring the JAX column body ``cols_fn``:
exp-space contractions under per-read max shifts) whose outputs the plain
stages write into the tables.  ``dp_ends`` (``dp_parts`` its parts) runs
an autograd Function whose backward is the outside pass (JAX ``dp_bwd``):
the columns j = Lp..1 in reverse, four adjoint stages per column, each
the kernels K5-K7 (outside_band.cu, outside_ep.cu, outside_ext.cu) for
CUDA tensors and, for CPU tensors, torch.autograd.grad of the stage's
pure function on leaf copies of the saved rows.  The hoisted exp(lambda
x) tensors the stages read are K16's (hoisted.cu) for CUDA tensors, with
K17 for lambda's cotangent, and ``hoisted_plain`` (autograd through
``_LamExp``) for CPU tensors.  A pass's ends are K19 (ends.cu) for CUDA
tensors and its plain twin otherwise: the parts' gather and what the
caller forms of them (``Ends``: the objective, the scanner's lse, the
masks' parts[:, 0]), and the seed of the outside pass from their
cotangent; lambda's per-read sums of the outside pass are K20
(lam_sum.cu) or ``lam_sum_plain``.  A pass's tables are views of one
allocation, its cotangents of two (those a caller may keep, and the
rest).

The scanner (scan/scanner.py) adds "aux" log factors to the transitions
that emit a base (JAX ``DiffFactors.aux*``): kind R on the right-chain
transitions (L, T2 and O chains) at base j-1, L on the M chain at base
j-w, PL and PR on the pair edges at bases j-w and j-1.  The plain versions
take them dense, [Lp, S, S, B] per kind as in JAX; the kernels take only
what the scanner uses: a per-read ``Pin`` (a -inf veto at one base on
every transition outside one class) and the class sums of the transition
posteriors, the cotangent of the probe ``DiffFactors.cls`` [4, Lp, B]
(per base: start, in, end and tail mass summed over the kinds).

Cell conventions (span (i, j), i = j - w, bases i..j-1):
  LL: ST_L linear runs inside loops;   P: paired span (i, j-1);
  E:  interior of pair (i-1, j);       M/B/T1/T2: multiloop states;
  O:  exterior prefix [0, j).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import device as DEV
from .ep_fast import build_ep_static
from .semiring import (NEG, lam_mul, lse, lse_weights,
                       logadd, mask_neg, safe_log)

SPEC_COMBOS = ((0, 1), (1, 0), (1, 1), (1, 2), (2, 1), (2, 2))

# aux kinds and the transition classes of the scanner's posteriors
AUX = ("auxR", "auxL", "auxPL", "auxPR")
CLASSES = ("start", "in", "end", "tail")
CLS_START, CLS_IN, CLS_END, CLS_TAIL = 1, 2, 4, 8


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
    lam: torch.Tensor     # [2, B] per-read copies
    alphaP: torch.Tensor  # [Lp+1, Wp+1, B] injected P-cell factor
    auxR: Optional[torch.Tensor] = None   # [Lp, S, S, B] (plain only)
    auxL: Optional[torch.Tensor] = None
    auxPL: Optional[torch.Tensor] = None
    auxPR: Optional[torch.Tensor] = None
    cls: Optional[torch.Tensor] = None    # [4, Lp, B] class-sum probe:
    #                                       zeros (the kernels require it)


KINDS_ALL = 15          # bit k: aux kind k, in AUX order (R, L, PL, PR)
KINDS_RIGHT = 1 | 8    # R and PR, the kinds that emit base j-1
MAX_PINS = 3


class Pin(NamedTuple):
    """One entry of the scanner's pin set: at base pos[b] of read b only
    the transitions of the entry's kinds whose class has ``bit`` survive
    (JAX aux_end, scan/cyk.py _pin_aux).  ConstFactors.pin holds one Pin
    (the end pass) or a tuple of up to MAX_PINS (CYK: start, end, tail);
    their vetoes add up."""
    pos: torch.Tensor     # [B] int32 base per read, -1 for none
    bit: int
    kinds: int = KINDS_ALL


def pin_set(pin) -> tuple:
    """The entries of a ConstFactors.pin: None, one Pin or a tuple."""
    if pin is None:
        return ()
    return (pin,) if isinstance(pin, Pin) else tuple(pin)


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
    pin: Optional[Pin] = None


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
    """Max over dims with -inf replaced by 0 (the shift base), out of the
    gradient as in JAX: the shift cancels exactly, and differentiating it
    leaves rounding noise on cotangents that are exactly 0 (posteriors
    of impossible transitions)."""
    m = torch.amax(x, dim=dims, keepdim=keepdim).detach()
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


def class_codes(g):
    """[4 kinds (R, L, PL, PR), S, S] int32 class bits of transition
    target t <- source s (JAX scan/scanner.py state_masks): 1 start (the
    0 -> 1 node crossing), 2 in, 4 end (M-2 -> M-1), 8 tail (R and PR
    targets at node M-2).  The right kinds read the right nodes, the left
    kinds the left nodes (their chains run leftwards)."""
    M, S = g.M, g.S
    full = lambda m: np.broadcast_to(m, (S, S))
    Tl, Sl = g.state_l[:, None], g.state_l[None, :]
    Tr, Sr = g.state_r[:, None], g.state_r[None, :]
    right = ((Sr == 0) & (Tr == 1), (Tr != 0) & (Tr != M - 1),
             (Sr == M - 2) & (Tr == M - 1), full(Tr == M - 2))
    left = ((Tl == 0) & (Sl == 1), (Sl != 0) & (Sl != M - 1),
            (Tl == M - 2) & (Sl == M - 1), np.zeros((S, S), bool))
    code = lambda ms: sum(full(m).astype(np.int32) << c
                          for c, m in enumerate(ms))
    return np.stack([code(right), code(left), code(left), code(right)])


def _csr_by_target(tuples, S: int):
    """(t, a, c) tuples -> CSR offsets [S+1] and (a, c) lists sorted by t."""
    tuples = np.asarray(tuples, np.int64).reshape(-1, 3)
    order = np.argsort(tuples[:, 0], kind="stable")
    tt = tuples[order]
    off = np.zeros(S + 1, np.int64)
    np.add.at(off, tt[:, 0] + 1, 1)
    return np.cumsum(off), tt[:, 1], tt[:, 2]


def _csr_by(key, n: int, *vals):
    """Entries grouped by ``key`` in 0..n-1: CSR offsets [n+1] and each
    of ``vals`` in that (stable) order."""
    key = np.asarray(key, np.int64)
    order = np.argsort(key, kind="stable")
    off = np.zeros(n + 1, np.int64)
    np.add.at(off, key + 1, 1)
    return np.cumsum(off), [np.asarray(v)[order] for v in vals]


def _csr_finite(mat):
    """Finite entries of a log matrix [target, source] as CSR by target:
    offsets [S+1], source ids, log weights."""
    tgt, src = np.nonzero(np.isfinite(mat))
    off = np.zeros(mat.shape[0] + 1, np.int64)
    np.add.at(off, tgt + 1, 1)
    return np.cumsum(off), src, mat[tgt, src]


# ------------------------------------------------------------ static

def chain_lists(g):
    """TT_E_P chain factorization (motif_model.hpp:315-335): a quadruple
    (tgt, s1, s2, s3) is a node path l -> a -> c -> r; pairs13 = distinct
    (s1, s3) -> AR = distinct (a, r) -> K2 = distinct (s2, AR index) ->
    target state.  Returns the three sorted lists."""
    ep_all = g.ep_tuples if len(g.ep_tuples) else np.zeros((0, 4), np.int64)
    l_, r_ = g.state_l, g.state_r
    pairs13 = sorted(set((int(q[1]), int(q[3])) for q in ep_all))
    ar_list = sorted(set((int(l_[q[1]]), int(r_[q[3]])) for q in ep_all))
    ar_of = {p: i for i, p in enumerate(ar_list)}
    k2_list = sorted(set(
        (int(q[2]), ar_of[(int(l_[q[1]]), int(r_[q[3]]))]) for q in ep_all))
    return pairs13, ar_list, k2_list


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
        self.TR = f(TRlog)                 # the no-rss chain (ops/linear.py)
        self.TL = f(TLlog)
        mbg, combos = _pem_combos(g, ltau)
        self.Mbg = f(mbg)
        self.combos = [(t, a, b, f(m)) for (t, a, b, m) in combos]
        codes = class_codes(g)
        self.cls_mask = f(np.stack([(codes >> c) & 1 for c in range(4)],
                                   axis=1))       # [kind, class, S, S]
        self.cls_code = torch.as_tensor(codes, device=device)
        # pair transitions: code -1 none, -2 background, else dense table
        dense_tab = np.maximum(g.pair_table_index[g.pt_tab], 0)
        code = np.where(g.pt, np.where(g.pt_isbp, dense_tab, -2), -1)
        self.pt_code = torch.as_tensor(code, device=device)
        self.pt_wl = torch.as_tensor(g.pt_wl, device=device)
        self.pt_wr = torch.as_tensor(g.pt_wr, device=device)
        self.pt_ltw = f(np.where(g.pt_tau, ltau, 0.0))

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

        l_, r_ = g.state_l, g.state_r
        pairs13, ar_list, k2_list = chain_lists(g)
        ar_of = {p: i for i, p in enumerate(ar_list)}
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
        kk["cls_code"] = i32(codes)
        kk["diag"] = i32(g.diag_mask)
        kk["loopm"] = i32(g.loop_mask)
        kk["bucket"] = i32(g.lam_bucket)
        kk["end_states"] = i32(g.end_states)
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
            kk["p13_ar"], kk["k2_tgt"] = i32(p13_ar), i32(k2_tgt)
            n13r, n2r = np.arange(self.n13), np.arange(self.n2)
            for name, key, n, vals in (
                    ("s1", p13_s1, S, (n13r,)), ("s3", p13_s3, S, (n13r,)),
                    ("k2a", k2_ar, self.n_ar, (n2r,)),
                    ("k2s", k2_s2, S, (n2r,))):
                off, (v,) = _csr_by(key, n, *vals)
                kk[name + "_off"], kk[name + "_k"] = i32(off), i32(v)

        # ---- the outside kernels' reverse lists (CSR by source)
        for name, mat in (("rtr", TRlog), ("ltr", TLlog)):
            tgt, src = np.nonzero(np.isfinite(mat))
            off, (t_, w_) = _csr_by(src, S, tgt, mat[tgt, src])
            kk[name + "_off"], kk[name + "_t"] = i32(off), i32(t_)
            kk[name + "_w"] = f(w_)
        for name, tuples in (("b12", g.b12_tuples), ("op", g.op_tuples)):
            tt = np.asarray(tuples, np.int64).reshape(-1, 3)
            off, (t_, c_) = _csr_by(tt[:, 1], S, tt[:, 0], tt[:, 2])
            kk[name + "a_off"], kk[name + "a_t"] = i32(off), i32(t_)
            kk[name + "a_c"] = i32(c_)
            off, (t_, a_) = _csr_by(tt[:, 2], S, tt[:, 0], tt[:, 1])
            kk[name + "c_off"], kk[name + "c_t"] = i32(off), i32(t_)
            kk[name + "c_a"] = i32(a_)
        pt_t, pt_s = np.nonzero(code != -1)
        kk["ptl_t"], kk["ptl_s"] = i32(pt_t), i32(pt_s)
        self.n_pt = len(pt_t)
        self.k = kk


    # the plain versions' dense one-hot matrices of the split tuples,
    # [S*S, S] each (S^3 values: 21 GB at f64 for 1,378 states), built at
    # their first use: the kernels never read them
    @functools.cached_property
    def Hb12(self):
        """[S*S, S]: 1 at (a * S + c, t) for each split tuple (t, a, c)."""
        return self._tuple_matrices(self.g.b12_tuples, 1)[0]

    @functools.cached_property
    def Hop(self):
        """Per lambda bucket b, [S*S, S]: 1 at (a * S + c, t) for each
        exterior tuple (t, a, c) whose target t is in bucket b."""
        return self._tuple_matrices(self.g.op_tuples, 2)

    def _tuple_matrices(self, tuples, n_buckets):
        S = self.g.S
        tt = np.asarray(tuples, np.int64).reshape(-1, 3)
        bucket = np.asarray(self.g.lam_bucket)[tt[:, 0]] if n_buckets > 1 \
            else np.zeros(len(tt), np.int64)
        idx = lambda a: torch.as_tensor(a, device=self.device)
        out = []
        for b in range(n_buckets):
            m = torch.zeros((S * S, S), dtype=self.dtype, device=self.device)
            sel = tt[bucket == b]
            m[idx(sel[:, 1] * S + sel[:, 2]), idx(sel[:, 0])] = 1.0
            out.append(m)
        return out


def read_sum(x, ndims: int):
    """Sum ``x`` over its first ``ndims`` dims in one fixed order: padded
    with zeros to a power of two, then halves added elementwise.  Every
    output gets the same bits whatever the other dims hold, so a read's
    sum does not depend on the batch it came in (a torch reduction picks
    its order from the number of outputs, the batch size among them)."""
    n = int(np.prod(x.shape[:ndims], dtype=np.int64))
    x = x.reshape((n,) + tuple(x.shape[ndims:]))
    p = 1 << max(0, n - 1).bit_length()
    if p > n:
        x = torch.cat([x, x.new_zeros((p - n,) + tuple(x.shape[1:]))])
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        x = x[:h] + x[h:]
    return x[0]


class _LamExp(torch.autograd.Function):
    """exp(lam_mul(lam[b], X)) for b = 0, 1, stacked [2, *X.shape], for
    lam [2, B] and X [..., B] (or [..., 1]); lambda's cotangent is summed
    per read by read_sum."""

    @staticmethod
    def forward(ctx, lam, X):
        out = torch.stack([torch.exp(lam_mul(lam[b], X)) for b in range(2)])
        ctx.save_for_backward(out, X)
        return out

    @staticmethod
    def backward(ctx, g):
        out, X = ctx.saved_tensors
        t = g * out * torch.where(torch.isneginf(X), torch.zeros_like(X), X)
        return torch.stack([read_sum(t[b], t.dim() - 2)
                            for b in range(2)]), None


class _RowScale(torch.autograd.Function):
    """x * exp(l + r[None])[:, None, :] for x [w, t, B], l [w, B] and r
    [B] (or None); the cotangents of l and r are summed per read by
    read_sum (a torch sum over t or w picks its order from B on the
    CPU)."""

    @staticmethod
    def forward(ctx, x, l, r):
        f = torch.exp(l if r is None else l + r[None])
        ctx.save_for_backward(x, f)
        ctx.has_r = r is not None
        return x * f[:, None, :]

    @staticmethod
    def backward(ctx, g):
        x, f = ctx.saved_tensors
        gl = read_sum(torch.movedim(g * x, 1, 0), 1) * f
        return g * f[:, None, :], gl, read_sum(gl, 1) if ctx.has_r else None


def hoisted(d: DiffFactors, c: ConstFactors, st: DPStatic):
    """The hoisted exp-space tensors of ``hoisted_plain`` (a dict by
    HOISTED): K16 for CUDA tensors, with no autograd record (lambda's
    cotangent from theirs is hoisted_lam_term's, K17); the plain version
    for CPU tensors."""
    return hoisted_plain(d, c, st)


def hoisted_plain(d: DiffFactors, c: ConstFactors, st: DPStatic):
    """Per-evaluation exp-space energy tensors (lambda flows here):
    eSZ [2, n_cls, Cp+1 (dl), Cp+1 (u1), B] with the per-read C cap
    (dl + u1 <= C) folded in, and eSZg [2, 4, Cp+1, Cp+1, B], the size
    weights without the cap
    summed per misA/misB group; emisA [2, 4, Lp+1, Wp+1, B]; emisB
    rows-leading [2, Lp+1+PAD, Wp+1, 4, B] with zero PAD rows."""
    lam = d.lam
    Cp, PAD = st.dims.Cp, st.PAD
    dt, dev = st.dtype, st.device
    dlarr = torch.arange(Cp + 1, device=dev)
    cmask = (dlarr[:, None, None] + dlarr[None, :, None]
             <= c.C[None, None, :])
    SZT = torch.as_tensor(np.ascontiguousarray(
        np.transpose(st.SZ, (0, 2, 1))), dtype=dt, device=dev)[..., None]
    eSZs = _LamExp.apply(lam, SZT)           # [2, n_cls, dl, u1, B]
    eSZ = eSZs * cmask
    grp = torch.as_tensor(st.grp, device=dev)
    eSZg = torch.zeros((2, 4) + tuple(eSZs.shape[2:]), dtype=dt,
                       device=dev).index_add_(1, grp, eSZs)
    misA, misB = c.ep["misA"], c.ep["misB"]
    emisA = _LamExp.apply(lam, misA)
    eB = _LamExp.apply(lam, misB).permute(0, 2, 3, 1, 4)  # [2, Lp+1, w, 4, B]
    pad = torch.zeros((2, PAD) + tuple(eB.shape[2:]), dtype=dt, device=dev)
    emisB = torch.cat([pad, eB], dim=1).contiguous()
    return dict(eSZ=eSZ.contiguous(), eSZg=eSZg, emisA=emisA.contiguous(),
                emisB=emisB)


CARVE_ALIGN = 512    # bytes: each view starts where an allocation would


def _carved(shapes, dtype, device, fill=None):
    """Views of one new allocation, one per shape, each starting on a
    CARVE_ALIGN boundary (the kernels' vector loads and cp.async copies
    take 16-byte aligned rows, as separate allocations give them); filled
    with ``fill`` in one launch if given."""
    step = CARVE_ALIGN // torch.empty((), dtype=dtype).element_size()
    offs, at = [], 0
    for shape in shapes:
        offs.append(at)
        at += -(-int(np.prod(shape, dtype=np.int64)) // step) * step
    buf = torch.empty(at, dtype=dtype, device=device)
    if fill is not None:
        buf.fill_(fill)
    return [buf[o:o + int(np.prod(x, dtype=np.int64))].view(x)
            for o, x in zip(offs, shapes)]


STATE_TABLES = ("LL", "P", "E", "M", "Bt", "T1", "T2", "ep")


def init_state(st: DPStatic, B: int):
    """Inside tables with PAD front rows of -inf: LL, P, E, M, Bt, T1, T2
    and the internal-loop term ep [Lp+1+PAD, Wp+1, S, B], O [Lp+1+PAD, S,
    B].  LL at width 0 is the grammar diagonal; O starts at
    end_states[0].  The outside pass reads every table, ep included.
    ep_shift [Lp+1, 3, B] holds the kernels' per-(column, read) exp-space
    shifts of the ep term: K3 writes a column's, K6 reads them (the plain
    versions neither write nor read it).  The tables are views of one
    allocation: one fill of -inf, one of zeros, the diagonal and the
    start."""
    Lp, Wp, S = st.dims.Lp, st.dims.Wp, st.dims.S
    PAD, dt, dev = st.PAD, st.dtype, st.device
    R = Lp + 1 + PAD
    shapes = [(R, Wp + 1, S, B)] * len(STATE_TABLES) + [(R, S, B),
                                                         (Lp + 1, 3, B)]
    views = _carved(shapes, dt, dev, NEG)
    views[-1].zero_()
    state = dict(zip(STATE_TABLES + ("O", "ep_shift"), views))
    state["LL"][PAD:, 0] = st.diag_col[:, None]
    state["O"][PAD, int(st.g.end_states[0])] = 0.0
    return state


# ------------------------------------------- plain column (pure functions)

def windows_of(tabs, j: int, st, keys=("L", "P", "T1", "E", "T2", "O")):
    """Windows of earlier rows feeding column j (JAX ``windows_of``):
    win[k] is row j-1-k.  E/T2 chains read only row j-1; P feeds the
    internal loop back to j-1-Cp; LL/T1/O feed band-wide reads."""
    Wp, Cp, PAD = st.dims.Wp, st.dims.Cp, st.PAD
    get = dict(
        L=lambda: _flip(tabs["LL"], j - 1, Wp, PAD),
        P=lambda: _flip(tabs["P"], j - 1, Cp, PAD),
        T1=lambda: _flip(tabs["T1"], j - 1, Wp, PAD),
        E=lambda: tabs["E"][j - 1 + PAD],
        T2=lambda: tabs["T2"][j - 1 + PAD],
        O=lambda: _flip(tabs["O"], j - 1, Wp, PAD))
    return {k: get[k]() for k in keys}


def col_rows(d: DiffFactors, h, j: int, st):
    """The row slices of the differentiable inputs that column j reads
    (JAX ``col_rows``); emisB holds rows j-Cp..j in ascending order.  The
    max DP (ops/dp_maxb.py) passes no hoisted tensors (h None)."""
    Lp, Wp, Cp, PAD = st.dims.Lp, st.dims.Wp, st.dims.Cp, st.PAD
    iw = torch.clamp(j - torch.arange(Wp + 1, device=st.device), 0, Lp - 1)
    r = j + PAD
    rows = dict(lam=d.lam, eR=d.eR[j - 1], eL=d.eL[iw], bgl=d.bg2[iw],
                bgr=d.bg2[j - 1], pv=d.pv[j], alphaP=d.alphaP[j])
    if h is not None:
        rows.update(emisA=h["emisA"][:, :, j],
                    emisB=h["emisB"][:, r - Cp: r + 1], eSZ=h["eSZ"])
    # aux rows as JAX aux_row reads them: R, PR at base j-1; L, PL at
    # bases clip(j - w)
    for k in AUX:
        a = getattr(d, k)
        if a is not None:
            rows[k] = a[j - 1] if k in ("auxR", "auxPR") else a[iw]
    if d.cls is not None:
        rows.update(clsR=d.cls[:, j - 1], clsL=d.cls[:, iw])
    return rows


def aux_of(rows, c, j, st, kinds=("R", "L", "PL", "PR")):
    """{kind: aux log factors} of the ``kinds`` column j reads — R and PR
    [S, S, B] at base j-1, L and PL [Wp+1, S, S, B] at bases clip(j - w) —
    from the dense rows, the class probe (class c of a kind adds
    cls[c] on its transitions) and the pin set; None without aux."""
    pins = pin_set(c.pin)
    if not (pins or "clsR" in rows or any(k in rows for k in AUX)):
        return None
    Lp, Wp, S = st.dims.Lp, st.dims.Wp, st.dims.S
    iw = torch.clamp(j - torch.arange(Wp + 1, device=st.device), 0, Lp - 1)
    B = rows["eR"].shape[-1]
    out = {}
    for kind, key in enumerate(AUX):
        if key[3:] not in kinds:
            continue
        right = key in ("auxR", "auxPR")
        a = rows.get(key)
        if a is None:
            a = torch.zeros(((S, S, B) if right else (Wp + 1, S, S, B)),
                            dtype=st.dtype, device=st.device)
        if "clsR" in rows:
            m = st.cls_mask[kind]                    # [class, S, S]
            a = a + (torch.einsum("cb,cts->tsb", rows["clsR"], m) if right
                     else torch.einsum("cwb,cts->wtsb", rows["clsL"], m))
        for p in pins:
            if not (p.kinds >> kind) & 1:
                continue
            pos = p.pos.long()
            hit = pos == (j - 1) if right else pos[None, :] == iw[:, None]
            deny = (st.cls_code[kind] & p.bit) == 0              # [S, S]
            veto = deny[..., None] & hit[..., None, None, :]
            a = a + torch.where(veto, NEG, 0.0).to(st.dtype)
        out[key[3:]] = a
    return out


def _chain(src, eRrow, st, aR=None):
    """Right-transition chain: [w,S,B] -> [w,S,B] target-indexed.  With
    aux R a log-sum-exp per target: a pin can veto every source near the
    shared shift, and at f32 exp(src - shift) would flush the ones left."""
    if aR is not None:
        return lse(src[:, None] + (st.TR[:, :, None] + aR)[None], axis=2) \
            + eRrow[None]
    m = _finmax(src, 1, keepdim=True)
    t = torch.einsum("ts,wsb->wtb", st.E_TR, torch.exp(src - m))
    return safe_log(t) + m + eRrow[None]


def _pem_dense(rows, c, j, st):
    """Dense pair emission [w, t, s, B] of column j (JAX pem_dense): the
    aux path's P, where the factored static matrices cannot carry a
    per-(t, s) factor."""
    Lp, Wp = st.dims.Lp, st.dims.Wp
    iw = torch.clamp(j - torch.arange(Wp + 1, device=st.device), 0, Lp - 1)
    code = st.pt_code
    zero = torch.zeros((), dtype=st.dtype, device=st.device)
    pvt = rows["pv"][:, torch.clamp(code, min=0)]           # [w, t, s, B]
    pvt = pvt + torch.where(st.pt_wl[None, :, :, None],
                            c.wsp[iw][:, None, None, :], zero) \
        + torch.where(st.pt_wr[None, :, :, None],
                      c.wsp[j - 1][None, None, None, :], zero)
    bgs = (rows["bgl"] + rows["bgr"][None])[:, None, None, :]
    pem = torch.where((code == -2)[None, :, :, None], bgs, pvt)
    return torch.where((code == -1)[None, :, :, None], NEG,
                       pem + st.pt_ltw[None, :, :, None])


def front_col(win, j, rows, c, st):
    """L chain (U1), P (U2: TT_P_E / TT_P_P) and T2 (U3) of column j."""
    Lp, Wp = st.dims.Lp, st.dims.Wp
    iw = torch.clamp(j - torch.arange(Wp + 1, device=st.device), 0, Lp - 1)
    lamv = rows["lam"][st.bucket]                 # [S, B]
    eRrow = rows["eR"]
    g_o2 = c.gate_O2[j - 1]
    ax = aux_of(rows, c, j, st, ("R", "PL", "PR"))
    aR = None if ax is None else ax["R"]
    # U1: ST_L chain (motif_model.hpp:243-257); width 0 is the diagonal
    Lcol = _chain(_shift_w(win["L"][0], 1), eRrow, st, aR)
    Lcol = torch.cat([st.diag_col[None, :, None].expand_as(Lcol[:1]),
                      Lcol[1:]])
    # U2: P <- pem * (E | P), factored into static-matrix contractions
    # (dense with aux, as JAX's pem_dense path)
    prevE2 = _shift_w(win["E"], 2)
    prevP2 = _shift_w(win["P"][0], 2)
    if ax is not None:
        pem = _pem_dense(rows, c, j, st) + ax["PL"] + ax["PR"][None]
        a_pe = lse(pem + prevE2[:, None], axis=2)
        a_pp = lse(pem + prevP2[:, None], axis=2)
    else:
        wl, wr = c.wsp[iw], c.wsp[j - 1]
        pvj = rows["pv"]
        outs = []
        for src in (prevE2, prevP2):
            m = _finmax(src, 1, keepdim=True)
            ex = torch.exp(src - m)
            acc = _RowScale.apply(torch.einsum("ts,wsb->wtb", st.Mbg, ex),
                                  rows["bgl"], rows["bgr"])
            for (t, a, b2, mask) in st.combos:
                fac = pvj[:, t, :]
                if a:
                    fac = fac + wl
                if b2:
                    fac = fac + wr
                acc = acc + _RowScale.apply(
                    torch.einsum("ts,wsb->wtb", mask, ex), fac, None)
            outs.append(safe_log(acc) + m)
        a_pe, a_pp = outs
    a_pp = a_pp + lam_mul(lamv[None], c.stk[j][:, None, :])
    Pcol = logadd(a_pe, a_pp) + rows["alphaP"][:, None, :]
    Pcol = mask_neg(Pcol, c.okP[j][:, None, :])
    # U3: 2 (TT_2_2 / TT_2_P)
    T2col = logadd(
        _chain(_shift_w(win["T2"], 1), eRrow, st, aR) + g_o2[None, None, :],
        Pcol + lam_mul(lamv[None], c.ml2[j][:, None, :]))
    T2col = mask_neg(T2col, c.okB[j][:, None, :])
    return Lcol, Pcol, T2col


def bif_col(win, j, c, st, T2col):
    """B (U4: TT_B_12) as a dk contraction then the static tuple sum,
    and T1 (U5).  dk = 0 and 2-cells of width 0 are excluded."""
    Wp, S = st.dims.Wp, st.dims.S
    T1W = win["T1"]                              # T1F[dk] = row j-dk, dk>=1
    m1 = _finmax(T1W, (0, 1, 2))
    zero1 = torch.zeros_like(T1W[:1])
    ex1 = torch.cat([zero1, torch.exp(T1W - m1)])
    X1 = _shear(ex1, Wp + 1, 0.0)                # [dk, w, S, B]
    m2 = _finmax(T2col, (0, 1))
    ex2 = torch.exp(T2col - m2)
    ex2 = torch.cat([torch.zeros_like(ex2[:1]), ex2[1:]])
    G = torch.einsum("dwab,dcb->wacb", X1, ex2)
    out = torch.einsum("wqb,qt->wtb", G.reshape(Wp + 1, S * S, -1), st.Hb12)
    Bcol = mask_neg(safe_log(out) + m1 + m2, c.okB[j][:, None, :])
    T1col = mask_neg(logadd(T2col, Bcol), c.okB[j][:, None, :])
    return Bcol, T1col


def m_col(j, rows, c, st, Bcol):
    """M chain (U6: TT_M_M / TT_M_B), sequential over the band
    (motif_model.hpp:346-366)."""
    Lp, Wp, S = st.dims.Lp, st.dims.Wp, st.dims.S
    iw = torch.clamp(j - torch.arange(Wp + 1, device=st.device), 0, Lp - 1)
    eLrows = rows["eL"]                          # [w, S, B] source-keyed
    gMs = c.gate_M[iw]                           # [w, B]
    okMj = c.okM[j]                              # [w, B]
    bvecs = mask_neg(Bcol, okMj[:, None, :])
    B = bvecs.shape[-1]
    ax = aux_of(rows, c, j, st, ("L",))
    x = torch.full((S, B), NEG, dtype=st.dtype, device=st.device)
    out = []
    for w in range(Wp + 1):
        t = x[None, :, :] + st.TL[:, :, None] + eLrows[w][None] \
            + gMs[w][None, None, :]
        if ax is not None:
            t = t + ax["L"][w]
        x = mask_neg(logadd(bvecs[w], lse(t, axis=1)), okMj[w][None, :])
        out.append(x)
    return torch.stack(out)


def _ep_specials(c, j, exPF, exLB, exL3, lam, st):
    """Base-coupled internal loops — stack-adjacent bulges (0,1)/(1,0)
    and 1x1/1x2/2x1/2x2 internals (energy_param.hpp:744-795) — in the
    chain-factored exp space; a [w, n2, B] contribution carrying the
    ep_col shifts."""
    lamk2 = lam[st.lamk2_idx]                    # [n2, B]
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


def ep_col(win, j, rows, c, st, Lcol, Pcol):
    """U7 TT_E_P internal-loop sum (motif_model.hpp:329-335,
    energy_param.hpp:744-795), chain-factored through pairs13 -> AR -> K2
    with the five (u1, u2) energy classes fused into W[dl, x, u1] per
    lambda bucket; exp space under per-read max shifts."""
    Wp, Cp, S = st.dims.Wp, st.dims.Cp, st.dims.S
    dev = st.device
    B = Lcol.shape[-1]
    if not st.have_ep:
        return torch.full((Wp + 1, S, B), NEG, dtype=st.dtype, device=dev)
    lam = rows["lam"]
    PF = torch.cat([Pcol[None], win["P"]], dim=0)
    LB = torch.cat([Lcol[None], win["L"]], dim=0)
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
    emisB = torch.flip(rows["emisB"].transpose(0, 1), dims=(0,))
    V_bu = []
    for b in range(2):
        mBsh = _shear(emisB[:, b], Wp + 1, 0.0)  # [dl, x, 4, B]
        mArow = rows["emisA"][b]                 # [4, w, B]
        wA = [mArow[g_][st.ru] * st.ru_ok[:, :, None] for g_ in range(4)]
        Wall = None
        for x_ in range(st.n_cls):
            g_ = int(st.grp[x_])
            t = (mBsh[:, :, g_, None, :]
                 * rows["eSZ"][b][x_][:, None, :, :]
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
        outw = outw + _ep_specials(c, j, exPF, exLB, exL3, lam, st)
    out = torch.einsum("wkb,kt->wtb", outw, st.Hot_k2_tgt)
    return safe_log(out) + (mPF + mL3 + mLB)


def e_col(j, rows, c, st, Lcol, Mcol, epcol):
    """E (U7: TT_E_H / TT_E_M / TT_E_P) of column j."""
    lamv = rows["lam"][st.bucket]
    hterm = torch.where(st.loopm[None, :, None],
                        Lcol + lam_mul(lamv[None], c.hp[j][:, None, :]),
                        torch.full_like(Lcol, NEG))
    mterm = Mcol + lam_mul(lamv[None], c.mlE[j][:, None, :])
    Ecol = logadd(logadd(hterm, mterm), epcol)
    return mask_neg(Ecol, c.okE[j][:, None, :])


def o_col(win, j, rows, c, st, Pcol):
    """O column (U8: TT_O_O / TT_O_OP): O = O chain + O*P splits per
    lambda bucket.  Slot 0 (row j) is zero-weighted: okP kills w = 0."""
    S = st.dims.S
    lam = rows["lam"]
    eRrow = rows["eR"]
    g_o2 = c.gate_O2[j - 1]
    B = Pcol.shape[-1]
    Orows = torch.cat([torch.full((1, S, B), NEG, dtype=st.dtype,
                                  device=st.device), win["O"]], dim=0)
    prevO = Orows[1]
    ax = aux_of(rows, c, j, st, ("R",))
    oo = _chain(prevO[None], eRrow, st, None if ax is None else ax["R"])[0] \
        + g_o2[None, :]
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
    return logadd(oo, op_term)


# ------------------------------------------------- plain column stages

def band_front_plain(state, j, d, c, h, st):
    """L, P and T2 of column j into the tables."""
    PAD = st.PAD
    win = windows_of(state, j, st, ("L", "P", "E", "T2"))
    L, P, T2 = front_col(win, j, col_rows(d, h, j, st), c, st)
    state["LL"][j + PAD] = L
    state["P"][j + PAD] = P
    state["T2"][j + PAD] = T2


def band_bif_plain(state, j, d, c, h, st):
    """B and T1 of column j."""
    PAD = st.PAD
    Bc, T1 = bif_col(windows_of(state, j, st, ("T1",)), j, c, st,
                     state["T2"][j + PAD])
    state["Bt"][j + PAD] = Bc
    state["T1"][j + PAD] = T1


def band_m_plain(state, j, d, c, h, st):
    """M chain of column j."""
    PAD = st.PAD
    state["M"][j + PAD] = m_col(j, col_rows(d, h, j, st), c, st,
                                state["Bt"][j + PAD])


def ep_stage_plain(state, j, d, c, h, st):
    """TT_E_P internal-loop term of column j into the ep table."""
    PAD = st.PAD
    state["ep"][j + PAD] = ep_col(
        windows_of(state, j, st, ("L", "P")), j, col_rows(d, h, j, st), c,
        st, state["LL"][j + PAD], state["P"][j + PAD])


def band_e_plain(state, j, d, c, h, st):
    """E of column j."""
    PAD = st.PAD
    state["E"][j + PAD] = e_col(j, col_rows(d, h, j, st), c, st,
                                state["LL"][j + PAD], state["M"][j + PAD],
                                state["ep"][j + PAD])


def ext_stage_plain(state, j, d, c, h, st):
    """Exterior O column j."""
    PAD = st.PAD
    state["O"][j + PAD] = o_col(windows_of(state, j, st, ("O",)), j,
                                col_rows(d, h, j, st), c, st,
                                state["P"][j + PAD])


# ------------------------------------------- plain outside (adjoint) stages
#
# The outside pass walks the columns j = Lp..1.  For each column four
# adjoint stages run in reverse stage order — O (K7), E (K5), the
# internal-loop term (K6), then M, B/T1 and L/P/T2 (K5) — each adding the
# cotangents of its inputs into the gradient state ``gs`` (tables shaped
# like the inside tables, row cotangents shaped like DiffFactors and the
# hoisted tensors).  When a stage runs, the cotangents of its outputs are
# complete: later columns were done first, and within the column its
# consumers ran before it.  The plain versions rebuild the stage from
# leaf copies of the saved forward rows and take torch.autograd.grad.

GRAD_TABLES = ("LL", "P", "E", "T1", "T2", "O")


# the cotangents a caller may keep as a leaf's gradient (the masks' pair
# posterior, the scanner's class sums, the dense aux): an allocation of
# their own, so that what a caller keeps holds none of the pass's tables
KEPT_GRADS = ("alphaP",) + AUX + ("cls",)


def init_grads(fs, d: DiffFactors, c: ConstFactors, h):
    """Zero gradient state for the inside tables ``fs``: views of two
    allocations, each filled once, the KEPT_GRADS and the pass's own.
    Beside the cotangents of the tables, the factors and the hoisted
    tensors: lambda's direct terms, all per read (the [2, B] cotangent of
    the plain stages and of K6's small-loop term, K5's and K7's per-cell
    partials DL[j, w, target, read], summed per bucket in finish_grads,
    and K6's size-weight partials GSZ [2, 4, Cp+1, Cp+1, B]); the
    scanner's dense aux (plain versions) and class probe; with a probe,
    the kernels' class-partial buffers (cpR, cpL) [4, Wp+1, S, B]
    (cls_red zeroes what it sums)."""
    col = fs["LL"][0]
    B = col.shape[-1]
    like = {k: fs[k] for k in GRAD_TABLES}
    like.update(gM=col, gB=col, gep=col, eR=d.eR, eL=d.eL, bg2=d.bg2,
                pv=d.pv)
    like.update({k: h[k] for k in ("eSZ", "emisA", "emisB")})
    shapes = {k: tuple(v.shape) for k, v in like.items()}
    shapes.update(lam=(2, B), DL=tuple(fs["LL"][: d.pv.shape[0]].shape),
                  GSZ=tuple(h["eSZg"].shape))
    if d.cls is not None:
        part = (4, col.shape[0], col.shape[1], B)
        shapes.update(_cpR=part, _cpL=part)
    kept = {k: tuple(getattr(d, k).shape) for k in KEPT_GRADS
            if getattr(d, k) is not None}
    gs = {}
    for group in (kept, shapes):
        gs.update(zip(group, _carved(list(group.values()), col.dtype,
                                     col.device, 0.0)))
    if d.cls is not None:
        gs["_cls_parts"] = (gs.pop("_cpR"), gs.pop("_cpL"))
    return gs


class Ends(NamedTuple):
    """What a pass's end (K19) forms from its parts [B, 3] besides them:
    mode "parts" nothing; "objective" f [B] and eff [B], the per-read
    objective terms (train/objective.py) of the flags and [B] vectors
    below; "lse" z = lse(parts) and PyN = exp(parts[:, 0] - z) (the
    scanner); "null" z = parts[:, 0] (the masks' motif-free pass)."""
    mode: str = "parts"
    lik_ratio: bool = False
    restrict_ari: Optional[torch.Tensor] = None  # [B] bool
    lik_sign: Optional[torch.Tensor] = None      # [B] +-1
    is_neg: Optional[torch.Tensor] = None        # [B] bool
    valid: Optional[torch.Tensor] = None         # [B] bool
    eff: Optional[torch.Tensor] = None           # [B]


PARTS = Ends()


def ends_plain(parts, ends: Ends):
    """K19's plain twin, forward: (y, y2) that ``ends`` forms from the
    parts [B, 3] (None where its mode has none).  The objective's maths
    are train/objective's, the scanner's scan/scanner's."""
    if ends.mode == "parts":
        return None, None
    if ends.mode == "null":
        return parts[:, 0].clone(), None
    if ends.mode == "lse":
        from ..scan.scanner import lse_ends_plain
        return lse_ends_plain(parts)
    from ..train.objective import objective_plain
    return objective_plain(parts, ends)


def ends_adj_plain(parts, ends: Ends, gy=None, gparts=None):
    """K19's plain twin, adjoint: the parts' cotangent [B, 3] from that of
    the mode's output gy [B] and of the parts gparts [B, 3] (either
    None), in closed form (the mode's weights d y / d parts, as jax.vjp
    of the forward gives them)."""
    g = torch.zeros_like(parts)
    if gy is not None and ends.mode != "parts":
        if ends.mode == "null":
            w = torch.zeros_like(parts)
            w[:, 0] = 1.0
        elif ends.mode == "lse":
            w = lse_weights(parts, torch.ones(3, dtype=torch.bool,
                                              device=parts.device))[1]
        else:
            from ..train.objective import objective_weights
            w = objective_weights(parts, ends)
        g = gy[:, None] * w
    return g if gparts is None else g + gparts


def extract_parts_plain(O, L, st):
    """parts[b, k] = O[L_b + PAD, end_states[k], b] (ragged lengths)."""
    B = O.shape[-1]
    rows = O[L + st.PAD, :, torch.arange(B, device=O.device)]
    return rows[:, st.end_states]                # [B, 3]


def seed_parts_plain(gO, gbar, L, st):
    """gbar [B, 3] enters the O cotangent gO at row L_b (JAX dp_bwd), end
    state k = 0, 1, 2 in turn."""
    B = gbar.shape[0]
    ar = torch.arange(B, device=gbar.device)
    rows = L.long() + st.PAD
    for k in range(3):
        es = torch.full_like(ar, int(st.g.end_states[k]))
        gO.index_put_((rows, es, ar), gbar[:, k].to(gO.dtype),
                      accumulate=True)


def ends_fwd(st, ends: Ends, O=None, L=None, parts=None):
    """K19 for CUDA tensors, its plain twin otherwise: (parts, y, y2) of
    the inside table O at rows L (or of the given parts) under
    ``ends``."""
    if O is not None:
        parts = extract_parts_plain(O, L, st)
    return (parts,) + ends_plain(parts, ends)


def ends_adj(st, ends: Ends, parts, gy=None, gparts=None, gO=None, L=None,
             gbar=False):
    """K19's adjoint for CUDA tensors, its plain twin otherwise: the
    parts' cotangent seeded into gO's rows L (when given) and returned
    (when ``gbar``)."""
    g = ends_adj_plain(parts, ends, gy, gparts)
    if gO is not None:
        seed_parts_plain(gO, g, L, st)
    return g if gbar else None


class _PartsEnds(torch.autograd.Function):
    """What ``ends`` forms of given parts [B, 3] (the no-rss chain's):
    K19 without its gather and seed, its adjoint the parts' cotangent."""

    @staticmethod
    def forward(ctx, st, ends, parts):
        _, y, y2 = ends_fwd(st, ends, parts=parts)
        ctx.set_materialize_grads(False)
        ctx.st, ctx.ends = st, ends
        ctx.save_for_backward(parts)
        if y2 is not None:
            ctx.mark_non_differentiable(y2)
        return y, y2

    @staticmethod
    def backward(ctx, gy, _):
        (parts,) = ctx.saved_tensors
        return None, None, ends_adj(ctx.st, ctx.ends, parts, gy, gbar=True)


def parts_ends(st, parts, ends: Ends = PARTS):
    """(parts, y, y2) of ``ends`` for parts [B, 3] a pass gave (the no-rss
    chain's), as dp_ends returns them."""
    if ends.mode == "parts":
        return parts, None, None
    return (parts,) + _PartsEnds.apply(st, ends, parts)


def zero_probe(Lp: int, B: int, dtype, device):
    """A class probe [4, Lp, B] of zeros that requires grad, marked as
    made so: the kernels, which take the probe as zeros only, then need
    no count of its nonzeros on the device (a host sync) until it is
    written in place (its version moves)."""
    t = torch.zeros((4, Lp, B), dtype=dtype, device=device,
                    requires_grad=True)
    t._rnaelem_zero_version = t._version
    return t


def lam_sum_plain(DL, lam, st, extra=None):
    """K20's plain twin: (lam + per bucket the read_sum of the per-cell
    partials DL [Lp+1, Wp+1, S, B], summed over the bucket's states by
    read_sum) + extra: the same bits for a read in any batch."""
    DLs = read_sum(DL, 2)                                # [S, B]
    out = lam + torch.stack([read_sum(DLs[st.bucket == b], 1)
                             for b in range(2)])
    return out if extra is None else out + extra


def lam_sum(DL, lam, st, extra=None):
    """Lambda's per-read cotangent from a gradient state's parts: K20 for
    CUDA tensors, lam_sum_plain otherwise."""
    return lam_sum_plain(DL, lam, st, extra)


def hoisted_lam_term(cots, d: DiffFactors, c: ConstFactors, st):
    """What the hoisted exponentials' cotangents ``cots`` (eSZ, eSZg,
    emisA, emisB; None: zero) carry to lambda, [2, B] per read: K17 for
    CUDA tensors, autograd through hoisted_plain for CPU tensors (None
    where nothing reaches lambda)."""
    lam = d.lam.detach().requires_grad_(True)
    with torch.enable_grad():
        h = hoisted_plain(d._replace(lam=lam), c, st)
        (g,) = torch.autograd.grad([h[k] for k in HOISTED], [lam],
                                   list(cots), allow_unused=True)
    return g


def finish_grads(gs, d: DiffFactors, c: ConstFactors, st, lam: bool = True):
    """Cotangents of (eR, eL, bg2, pv, lam, alphaP, eSZ, eSZg, emisA,
    emisB) from a gradient state, every one per read.  Lambda's (None
    unless ``lam``) is its whole cotangent: its direct term, the kernels'
    per-cell partials summed per bucket, and then what the hoisted
    exponentials' cotangents carry to it (K20 over K17's term on the
    card, lam_sum_plain over autograd through hoisted_plain on the CPU:
    the same bits for a read in any batch)."""
    hc = (gs["eSZ"], gs["GSZ"], gs["emisA"], gs["emisB"])
    g = None
    if lam:
        g = lam_sum(gs["DL"], gs["lam"], st, hoisted_lam_term(hc, d, c, st))
    return (gs["eR"], gs["eL"], gs["bg2"], gs["pv"], g, gs["alphaP"]) + hc


def aux_grads(gs):
    """Cotangents of the dense aux and of the class probe present in the
    gradient state: {name: tensor}."""
    return {k: gs[k] for k in AUX + ("cls",) if k in gs}


def _leaves(**xs):
    return {k: v.detach().requires_grad_(True) for k, v in xs.items()}


def _aux_leaves(rows):
    """Leaf copies of the aux rows in ``rows`` (dense and class probe)."""
    return _leaves(**{k: rows[k] for k in AUX + ("clsR", "clsL")
                      if k in rows})


def _vjp(outs, gouts, leaves):
    """torch.autograd.grad of ``outs`` against ``leaves`` (a dict),
    seeded with ``gouts``; unused leaves give no entry."""
    names = list(leaves)
    gr = torch.autograd.grad(list(outs), [leaves[n] for n in names],
                             list(gouts), allow_unused=True)
    return {n: g for n, g in zip(names, gr) if g is not None}


def _accumulate(gs, gr, j, st):
    """Add the leaf cotangents of one adjoint stage at column j into gs."""
    Lp, Wp, Cp, PAD = st.dims.Lp, st.dims.Wp, st.dims.Cp, st.PAD
    r = j + PAD
    iw = torch.clamp(j - torch.arange(Wp + 1, device=st.device), 0, Lp - 1)
    win = dict(winL=("LL", Wp), winP=("P", Cp), winT1=("T1", Wp),
               winO=("O", Wp))
    col = dict(Lcol="LL", Pcol="P", T2col="T2")
    for k, g in gr.items():
        if k in win:
            tab, n = win[k]
            gs[tab][r - n: r] += torch.flip(g, dims=(0,))
        elif k in col:
            gs[col[k]][r] += g
        elif k == "winE":
            gs["E"][r - 1] += g
        elif k == "winT2":
            gs["T2"][r - 1] += g
        elif k == "Mcol":
            gs["gM"].copy_(g)
        elif k == "epcol":
            gs["gep"].copy_(g)
        elif k == "eR":
            gs["eR"][j - 1] += g
        elif k == "bgr":
            gs["bg2"][j - 1] += g
        elif k == "eL":
            gs["eL"].index_add_(0, iw, g)
        elif k == "bgl":
            gs["bg2"].index_add_(0, iw, g)
        elif k in ("pv", "alphaP"):
            gs[k][j] += g
        elif k == "emisA":
            gs["emisA"][:, :, j] += g
        elif k == "emisB":
            gs["emisB"][:, r - Cp: r + 1] += g
        elif k in ("auxR", "auxPR"):
            gs[k][j - 1] += g
        elif k in ("auxL", "auxPL"):
            gs[k].index_add_(0, iw, g)
        elif k == "clsR":
            gs["cls"][:, j - 1] += g
        elif k == "clsL":
            gs["cls"].index_add_(1, iw, g)
        else:                                     # lam, eSZ
            gs[k] += g


@torch.enable_grad()
def ext_adj_plain(fs, gs, j, d, c, h, st):
    """Adjoint of the O column (K4): O window, P row j, eR, lambda."""
    r = j + st.PAD
    rows = col_rows(d, h, j, st)
    lv = _leaves(winO=windows_of(fs, j, st, ("O",))["O"], Pcol=fs["P"][r],
                 eR=rows["eR"], lam=rows["lam"])
    lv.update(_aux_leaves(rows))
    rows.update({k: v for k, v in lv.items() if k not in ("winO", "Pcol")})
    out = o_col(dict(O=lv["winO"]), j, rows, c, st, lv["Pcol"])
    _accumulate(gs, _vjp([out], [gs["O"][r]], lv), j, st)


@torch.enable_grad()
def e_adj_plain(fs, gs, j, d, c, h, st):
    """Adjoint of E (K2's band_e): LL row j, the M and ep columns (into
    gs['gM'], gs['gep']), lambda."""
    r = j + st.PAD
    rows = col_rows(d, h, j, st)
    lv = _leaves(Lcol=fs["LL"][r], Mcol=fs["M"][r], epcol=fs["ep"][r],
                 lam=rows["lam"])
    rows.update(lam=lv["lam"])
    out = e_col(j, rows, c, st, lv["Lcol"], lv["Mcol"], lv["epcol"])
    gs["gM"].zero_()
    gs["gep"].zero_()
    _accumulate(gs, _vjp([out], [gs["E"][r]], lv), j, st)


@torch.enable_grad()
def ep_adj_plain(fs, gs, j, d, c, h, st):
    """Adjoint of the internal-loop term (K3): LL and P rows j..j-Wp /
    j-Cp, the hoisted mismatch and size weights, lambda."""
    r = j + st.PAD
    if not st.have_ep:
        return
    rows = col_rows(d, h, j, st)
    win = windows_of(fs, j, st, ("L", "P"))
    lv = _leaves(Lcol=fs["LL"][r], Pcol=fs["P"][r], winL=win["L"],
                 winP=win["P"], emisA=rows["emisA"], emisB=rows["emisB"],
                 eSZ=rows["eSZ"], lam=rows["lam"])
    rows.update({k: lv[k] for k in ("emisA", "emisB", "eSZ", "lam")})
    out = ep_col(dict(L=lv["winL"], P=lv["winP"]), j, rows, c, st,
                 lv["Lcol"], lv["Pcol"])
    _accumulate(gs, _vjp([out], [gs["gep"]], lv), j, st)


@torch.enable_grad()
def band_adj_plain(fs, gs, j, d, c, h, st):
    """Adjoint of M, B/T1 and L/P/T2 (K2): the rows j-1 of LL, E, P, T2,
    the T1 window, eR, eL, bg2, pv, alphaP, lambda."""
    r = j + st.PAD
    rows = col_rows(d, h, j, st)
    win = windows_of(fs, j, st, ("L", "P", "E", "T2", "T1"))
    lv = _leaves(winL=win["L"][:1], winP=win["P"][:1], winE=win["E"],
                 winT2=win["T2"], winT1=win["T1"], eR=rows["eR"],
                 eL=rows["eL"], bgl=rows["bgl"], bgr=rows["bgr"],
                 pv=rows["pv"], alphaP=rows["alphaP"],
                 lam=rows["lam"])
    lv.update(_aux_leaves(rows))
    rows.update({k: v for k, v in lv.items() if not k.startswith("win")})
    w = dict(L=lv["winL"], P=lv["winP"], E=lv["winE"], T2=lv["winT2"],
             T1=lv["winT1"])
    L, P, T2 = front_col(w, j, rows, c, st)
    Bc, T1 = bif_col(w, j, c, st, T2)
    M = m_col(j, rows, c, st, Bc)
    gr = _vjp([L, P, T2, T1, M],
              [gs["LL"][r], gs["P"][r], gs["T2"][r], gs["T1"][r], gs["gM"]],
              lv)
    # winL / winP hold only row j-1 here
    for k, tab in (("winL", "LL"), ("winP", "P")):
        if k in gr:
            gs[tab][r - 1] += gr.pop(k)[0]
    _accumulate(gs, gr, j, st)


# ---------------------------------------------- wrappers (kernel or plain)

def _stage(name: str, plain_fn):
    """Wrapper ``name``: the plain version for CPU tensors, the kernel
    wrapper ``ops.kernels.<name>`` (which launches or raises) otherwise."""
    return plain_fn


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

ext_adj = _stage("ext_adj", ext_adj_plain)
e_adj = _stage("e_adj", e_adj_plain)
ep_adj = _stage("ep_adj", ep_adj_plain)
band_adj = _stage("band_adj", band_adj_plain)

# adjoint stages of one column, in the order the outside pass runs them
ADJ_STAGES = (ext_adj, e_adj, ep_adj, band_adj)
PLAIN_ADJ_STAGES = (ext_adj_plain, e_adj_plain, ep_adj_plain,
                    band_adj_plain)

HOISTED = ("eSZ", "eSZg", "emisA", "emisB")


GRAD_KEYS = ("eR", "eL", "bg2", "pv", "lam", "alphaP") + HOISTED


class _DPParts(torch.autograd.Function):
    """A pass: (parts [B, 3] log partition parts, y, y2): what ``ends``
    forms of them (K19; None where its mode has none, y2 not
    differentiable).  The backward is the outside pass (outside_state,
    seeded by K19's adjoint) and finish_grads.  The hoisted exponentials
    are formed inside, so lambda's cotangent gets their share from
    finish_grads with its direct terms, per read.  ``names`` are the
    DiffFactors fields given (the aux ones only when present)."""

    @staticmethod
    def forward(ctx, dp, c, ends, names, *vals):
        d = DiffFactors(**dict(zip(names, vals)))
        h = hoisted(d, c, dp.st)
        state = dp.run_inside(d, c, h)
        parts, y, y2 = ends_fwd(dp.st, ends, O=state["O"], L=c.L)
        ctx.set_materialize_grads(False)
        ctx.dp, ctx.c, ctx.d, ctx.h, ctx.state = dp, c, d, h, state
        ctx.names, ctx.ends = names, ends
        ctx.save_for_backward(parts)
        if y2 is not None:
            ctx.mark_non_differentiable(y2)
        return parts, y, y2

    @staticmethod
    def backward(ctx, gparts, gy, _):
        (parts,) = ctx.saved_tensors
        dp, c, d, names = ctx.dp, ctx.c, ctx.d, ctx.names
        gs = dp.outside_state(ctx.state, gparts, d, c, ctx.h, ctx.ends,
                              parts, gy)
        ctx.state = None
        lam = ctx.needs_input_grad[4 + names.index("lam")]
        grads = dict(zip(GRAD_KEYS, finish_grads(gs, d, c, dp.st, lam)))
        grads.update(aux_grads(gs))
        return (None,) * 4 + tuple(grads.get(k) for k in names)


class InsideDP:
    """Joint inside DP and its outside pass for one compiled grammar +
    dims, on one device and dtype."""

    def __init__(self, g, dims: Dims, energy_tab, dtype, device):
        self.st = DPStatic(g, dims, energy_tab, dtype, device)
        self.dims = dims

    def start(self, d: DiffFactors, c: ConstFactors):
        """(hoisted tensors, fresh inside-table state) for one evaluation."""
        return hoisted(d, c, self.st), init_state(self.st, c.wsp.shape[-1])

    def run_columns(self, state, d, c, h, j0: int, j1: int):
        """Columns j0..j1-1, every stage in update order.  On the card the
        B/T1, M and O stages (which need only L, P and T2 of the column)
        run on a side stream of the state's device, concurrently with the
        internal-loop stage; events order the two streams (E needs M; the
        next column's B needs this column's T2)."""
        st = self.st
        for j in range(j0, j1):
            for stage in STAGES:
                stage(state, j, d, c, h, st)

    def run_inside(self, d: DiffFactors, c: ConstFactors, h):
        state = init_state(self.st, c.wsp.shape[-1])
        self.run_columns(state, d, c, h, 1, self.dims.Lp + 1)
        return state

    def inside_tables(self, d: DiffFactors, c: ConstFactors):
        """All inside tables (state dict, row j at j + PAD)."""
        return self.run_inside(d, c, hoisted(d, c, self.st))

    def outside_columns(self, fs, gs, d, c, h, j1: int, j0: int):
        """Adjoint stages of columns j1-1 down to j0: column j's adjoint
        ends before column j-1's starts.  On the card K5's M chain (which
        needs only E's adjoint) runs on a side stream of the state's
        device, concurrently with the internal-loop adjoint K6; events
        order the two streams (the rest of K5 needs the chain)."""
        st = self.st
        for j in range(j1 - 1, j0 - 1, -1):
            for stage in ADJ_STAGES:
                stage(fs, gs, j, d, c, h, st)

    def outside_state(self, fs, gparts, d, c, h, ends: Ends = PARTS,
                      parts=None, gy=None):
        """The outside pass (JAX dp_bwd) from the inside tables ``fs``: the
        final gradient state.  K19's adjoint seeds it with the cotangents
        of the parts, gparts [B, 3], and of what ``ends`` formed of the
        pass's ``parts``, gy [B] (either None; ``parts`` is needed by the
        modes other than "parts")."""
        gs = init_grads(fs, d, c, h)
        ends_adj(self.st, ends, gparts if parts is None else parts, gy,
                 gparts, gO=gs["O"], L=c.L)
        self.outside_columns(fs, gs, d, c, h, self.dims.Lp + 1, 1)
        return gs

    def outside(self, fs, gbar, d, c, h):
        """Cotangents of (eR, eL, bg2, pv, lam, alphaP, eSZ, eSZg, emisA,
        emisB), per read, of the outside pass seeded with the parts'
        cotangent gbar [B, 3] (finish_grads)."""
        return finish_grads(self.outside_state(fs, gbar, d, c, h), d, c,
                            self.st)

    def extract_parts(self, Ofin, c: ConstFactors):
        """parts[b, k] = O[L_b, end_states[k], b] (ragged lengths): K19's
        gather for CUDA tensors, extract_parts_plain otherwise."""
        return ends_fwd(self.st, PARTS, O=Ofin, L=c.L)[0]

    def dp_parts(self, d: DiffFactors, c: ConstFactors):
        """The pass's log partition parts [B, 3] (dp_ends' parts)."""
        return self.dp_ends(d, c)[0]

    def dp_ends(self, d: DiffFactors, c: ConstFactors, ends: Ends = PARTS):
        """The pass's (parts [B, 3], y, y2) under ``ends`` (_DPParts)."""
        names = tuple(k for k in DiffFactors._fields
                      if getattr(d, k) is not None)
        return _DPParts.apply(self, c, ends, names,
                              *[getattr(d, k) for k in names])


def build_dp(g, dims: Dims, energy_tab, dtype=torch.float64, device=None):
    """The inside DP of grammar ``g`` on ``device`` (None: CUDA)."""
    return InsideDP(g, dims, energy_tab, dtype, DEV.resolve(device))
