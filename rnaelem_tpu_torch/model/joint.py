"""RNAelem joint model: parameters + factor construction + logZ API
(PyTorch).

Parameter layout mirrors the reference (motif_model.hpp:147-168): one
emission table per '.'/')' node plus the shared background table 0, a
2-vector lambda, optional softmax parameterization s with
theta = s - logsumexp(s) (profile_hmm.hpp:103-111).  Emission tables are
two dense banks — ``singles [n_single, 4]`` and ``pairs [n_pair, 6]`` —
indexed through the grammar's table maps.

The DP (ops/dp.py) is batched with a trailing batch axis and takes the
weights as per-read copies (``per_read``): ``batch_logZ_parts_pr`` is the
one path, and ``batch_logZ_parts`` runs it on the copies of shared
weights.  On the card the factors are K14 (csrc/factors.cu) with K15
their adjoint into the per-read weights; on the CPU (or with
``plain=True``) the plain version below, whose autograd is the adjoint.  Every entry point takes an explicit ``device``: None means CUDA
(and raises without a GPU).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import device as DEV
from ..energy import params as EPARAMS
from ..energy import tables as ET
from ..grammar.profile import Grammar, compile_pattern, null_grammar
from ..ops import dp as DP
from ..ops import linear as LIN
from ..ops.semiring import NEG, lse


class Params(NamedTuple):
    """Model weights; per-read copies (``per_read``) carry a leading
    read axis: singles [B, n_single, 4], pairs [B, n_pair, 6], lam
    [B, 2]."""
    singles: torch.Tensor   # [n_single, 4] log-space theta (or raw s)
    pairs: torch.Tensor     # [n_pair, 6]
    lam: torch.Tensor       # [2]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static configuration; hashable so builders cache per config."""
    pattern: str
    Lp: int
    max_span: int = 50
    max_iloop: int = 30
    min_bpp: float = 1e-4
    energy: str = EPARAMS.T2004
    turn: int = 3            # 0 under the NO_TURN test mode
    theta_softmax: bool = False
    no_ene: bool = False
    no_rss: bool = False
    no_prf: bool = False
    no_theta: bool = False   # DBG_NO_THETA test mode
    fix_rss: bool = False    # DBG_FIX_RSS test mode
    tau: float = 0.1
    rho_s: float = 0.0
    rho_theta: float = 0.0
    rho_lambda: float = 0.0
    lambda_prior: float = -1.0
    s_prior: float = 0.0
    dtype: str = "float64"

    @property
    def Wp(self) -> int:
        return min(self.Lp, self.max_span)

    @property
    def Cp(self) -> int:
        return max(1, min(self.max_iloop, self.Wp))


class SeqData(NamedTuple):
    """Per-sequence inputs (padded to Lp); host numpy arrays for one read,
    stacked with a leading batch axis (numpy or tensors) for a batch."""
    seq: np.ndarray        # [Lp] int32 codes, 0 beyond L
    ws: np.ndarray         # [Lp] positional log-weights (0 beyond L)
    L: np.ndarray          # scalar int32
    has_motif: np.ndarray  # scalar bool (ws sentinel == 0,
    #                        motif_model.hpp:62-70)
    rss_pair: np.ndarray   # [Lp+1, Wp+1] bool fixed-structure pairs
    dots: np.ndarray       # [Lp] bool: rss '.' marks (True if not fix_rss)


def make_seqdata(cfg: ModelConfig, seq_codes, quals=None,
                 rss: str = "") -> SeqData:
    """Host-side packing of one read into padded arrays.

    quals: int phred array of length L+1 (the trailing element is the
    has-motif sentinel, kmer-psp.py:66) or None for flat weights.
    """
    L = len(seq_codes)
    Lp, Wp = cfg.Lp, cfg.Wp
    seq = np.zeros(Lp, np.int32)
    seq[:L] = seq_codes
    ws = np.zeros(Lp, np.float64)
    has_motif = False
    if quals is not None:
        q = np.asarray(quals)
        cnt = np.bincount(q[:-1], minlength=127 - 33)
        mode = int(np.flatnonzero(cnt == cnt.max())[-1])
        ws[:L] = np.log((0.01 + q[:-1]) / (0.01 + mode))
        has_motif = (q[-1] == 0)
    rss_pair = np.zeros((Lp + 1, Wp + 1), bool)
    dots = np.ones(Lp, bool)
    if cfg.fix_rss and rss:
        dots[:] = False
        dots[:L] = np.frombuffer(rss.encode(), np.uint8) == ord(".")
        stack = []
        for p, ch in enumerate(rss):
            if ch == "(":
                stack.append(p)
            elif ch == ")":
                i = stack.pop()
                jj, w = p + 1, p + 1 - i
                if w <= Wp:
                    rss_pair[jj, w] = True
    return SeqData(seq=seq, ws=ws, L=np.int32(L),
                   has_motif=np.bool_(has_motif), rss_pair=rss_pair,
                   dots=dots)


def stack_seqdata(sds, device) -> SeqData:
    """Stack per-read SeqData into batch tensors on ``device`` (one host
    np.stack and one transfer per field)."""
    return SeqData(*[torch.as_tensor(np.stack(xs), device=device)
                     for xs in zip(*sds)])


def init_params(g: Grammar, cfg: ModelConfig, dtype=None,
                device=None) -> Params:
    """Flat initialization: s = 0 -> theta = -log(arity)
    (profile_hmm.hpp:286-313)."""
    dev = DEV.resolve(device)
    dt = DEV.torch_dtype(dtype or cfg.dtype)
    ns = int((g.single_table_index >= 0).sum())
    npair = max(1, g.n_pair_tables)
    if cfg.theta_softmax:
        singles = torch.zeros((ns, 4), dtype=dt, device=dev)
        pairs = torch.zeros((npair, 6), dtype=dt, device=dev)
    else:
        singles = torch.full((ns, 4), -math.log(4.0), dtype=dt, device=dev)
        pairs = torch.full((npair, 6), -math.log(6.0), dtype=dt, device=dev)
    return Params(singles=singles, pairs=pairs,
                  lam=torch.ones((2,), dtype=dt, device=dev))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def pack_params(g: Grammar, p: Params) -> np.ndarray:
    """Reference order: tables in creation order, then lambda
    (motif_model.hpp:147-157)."""
    singles, pairs = _np(p.singles), _np(p.pairs)
    out = []
    for t, sz in enumerate(g.table_sizes):
        if sz == 6:
            out.append(pairs[g.pair_table_index[t]])
        else:
            out.append(singles[g.single_table_index[t]])
    out.append(_np(p.lam))
    return np.concatenate(out)


def unpack_params(g: Grammar, flat, like: Params) -> Params:
    flat = np.asarray(flat)
    singles = _np(like.singles).copy()
    pairs = _np(like.pairs).copy()
    k = 0
    for t, sz in enumerate(g.table_sizes):
        if sz == 6:
            pairs[g.pair_table_index[t]] = flat[k:k + 6]
            k += 6
        else:
            singles[g.single_table_index[t]] = flat[k:k + 4]
            k += 4
    as_like = lambda a, ref: torch.as_tensor(a, dtype=ref.dtype,
                                             device=ref.device)
    return Params(singles=as_like(singles, like.singles),
                  pairs=as_like(pairs, like.pairs),
                  lam=as_like(flat[k:k + 2], like.lam))


def effective_theta(cfg: ModelConfig, p: Params) -> Params:
    if not cfg.theta_softmax:
        return p
    return Params(
        singles=p.singles - lse(p.singles, axis=-1)[..., None],
        pairs=p.pairs - lse(p.pairs, axis=-1)[..., None],
        lam=p.lam)


class _Kernels(NamedTuple):
    g: Grammar
    gnull: Grammar
    dp: DP.InsideDP
    dp_null: DP.InsideDP      # the motif-free (S=1) DP of the BPP masks
    dims: DP.Dims
    tab: dict
    dtype: torch.dtype
    device: torch.device


@functools.lru_cache(maxsize=32)
def _kernels_cached(cfg: ModelConfig, device: str) -> _Kernels:
    g = compile_pattern(cfg.pattern)
    gn = null_grammar()
    dtype = DEV.torch_dtype(cfg.dtype)
    tab = ET.device_tables(cfg.energy, dtype, device)
    ltau = float(np.log(cfg.tau)) if cfg.tau > 0 else -np.inf
    dims = DP.Dims(Lp=cfg.Lp, Wp=cfg.Wp, Cp=cfg.Cp, S=g.S,
                   no_ene=cfg.no_ene, fix_rss=cfg.fix_rss, ltau=ltau)
    dp = DP.build_dp(g, dims, tab, dtype, device)
    dims_n = dims._replace(S=1)
    dp_null = DP.build_dp(gn, dims_n, tab, dtype, device)
    return _Kernels(g=g, gnull=gn, dp=dp, dp_null=dp_null, dims=dims,
                    tab=tab, dtype=dtype, device=torch.device(device))


def kernels(cfg: ModelConfig, device=None) -> _Kernels:
    """Grammar, energy tables and the DP for ``cfg`` on ``device``."""
    return _kernels_cached(cfg, str(DEV.resolve(device)))


def _grid(cfg: ModelConfig, device):
    j = torch.arange(cfg.Lp + 1, device=device)[:, None]
    w = torch.arange(cfg.Wp + 1, device=device)[None, :]
    return j, w


def _band_masks(cfg: ModelConfig, sd: SeqData, bp_ok):
    """is_parsable masks in (j, w) layout (energy_model.hpp:289-338), for
    stacked reads: each [B, Lp+1, Wp+1]."""
    L = torch.as_tensor(sd.L, device=bp_ok.device).long()
    W = torch.clamp(L, max=cfg.max_span)
    return ET.band_masks(bp_ok, L, W, cfg.Wp, cfg.turn)


def _complementary_bp(cfg: ModelConfig, k: _Kernels, sd: SeqData):
    """Candidate pairs by complementarity, band and turn: [B, Lp+1, Wp+1]."""
    seq = torch.as_tensor(sd.seq, device=k.device).long()
    L = torch.as_tensor(sd.L, device=k.device).long()
    W = torch.clamp(L, max=cfg.max_span)
    return ET.pair_mask_jw(k.tab, seq, L, W, cfg.Wp, cfg.turn)


def score_inputs(cfg: ModelConfig, k: _Kernels, sd: SeqData, bp_ok):
    """(seq [B, Lp] int64, L [B] int64, bp_ok [B, Lp+1, Wp+1] bool,
    dots_cum [B, Lp+1] int32) as the score-table kernel takes them."""
    dev = k.device
    seq = torch.as_tensor(sd.seq, device=dev).long().contiguous()
    L = torch.as_tensor(sd.L, device=dev).long()
    dots = torch.as_tensor(sd.dots, device=dev).to(torch.int32)
    dots_cum = torch.cat([torch.zeros_like(dots[:, :1]),
                          torch.cumsum(dots, dim=1, dtype=torch.int32)],
                         dim=1)
    bp_ok = torch.as_tensor(bp_ok, device=dev).bool().contiguous()
    return seq, L, bp_ok, dots_cum


def _const_factors(cfg: ModelConfig, k: _Kernels, sd: SeqData, bp_ok):
    """Per-read constants for the batch, batch-minor (trailing B)."""
    dev, dt = k.device, k.dtype
    seq, L, bp_ok, dots_cum = score_inputs(cfg, k, sd, bp_ok)
    dots = torch.as_tensor(sd.dots, device=dev).bool()
    W = torch.clamp(L, max=cfg.max_span)
    C = torch.clamp(W - 2 - (2 if cfg.turn == 0 else 5),
                    max=cfg.max_iloop).to(torch.int32)
    sc = ET.score_tables(k.tab, seq, L, bp_ok, dots_cum, cfg.Wp,
                         cfg.max_span, cfg.turn, cfg.no_ene, cfg.fix_rss)
    if cfg.fix_rss:
        gate = torch.where(dots, 0.0, NEG).to(dt).T.contiguous()
    else:
        gate = torch.zeros((cfg.Lp, seq.shape[0]), dtype=dt, device=dev)
    ws = torch.as_tensor(sd.ws, device=dev).to(dt)
    return DP.ConstFactors(
        wsp=ws.T.contiguous(), hp=sc["hp"], stk=sc["stk"], ext=sc["ext"],
        ml2=sc["ml2"], mlE=sc["mlE"], okP=sc["okP"], okE=sc["okE"],
        okM=sc["okM"], okB=sc["okB"], gate_O2=gate, gate_M=gate,
        seq=seq.T.contiguous(), C=C, L=L,
        dots_cum=dots_cum.T.contiguous(),
        ep={kk: sc[kk] for kk in ("misA", "misB", "t_out", "t_in",
                                  "spec_il")})


def per_read(params: Params, B: int) -> Params:
    """B per-read copies of shared weights (views: nothing is copied)."""
    return Params(*[x[None].expand(B, *x.shape) for x in params])


def _theta(cfg: ModelConfig, params_b: Params, dt):
    """Effective emission tables of per-read weights: singles [B,
    n_single, 4], pairs [B, n_pair, 6]."""
    th = effective_theta(cfg, params_b)
    # DBG_NO_THETA pins theta to log(1)=0 while keeping the gradient path
    if cfg.no_theta and not cfg.no_prf:
        th = th._replace(singles=th.singles - th.singles.detach(),
                         pairs=th.pairs - th.pairs.detach())
    return th.singles.to(dt), th.pairs.to(dt)


def _emission_parts(cfg: ModelConfig, k: _Kernels, sd: SeqData):
    """(seq [B, Lp] int64, ws [B, Lp], the base one-hot [B, Lp, 4])."""
    seq = torch.as_tensor(sd.seq, device=k.device).long()
    ws = torch.as_tensor(sd.ws, device=k.device).to(k.dtype)
    oh4 = torch.nn.functional.one_hot(torch.clamp(seq - 1, 0, 3), 4)
    return seq, ws, oh4.to(k.dtype)


class _OneHot(torch.autograd.Function):
    """v[b, n, t] = sum_k oh[b, n, k] w[b, t, k] for a one-hot ``oh``
    (exact: one product per cell).  The weights' cotangent is summed per
    read by DP.read_sum: a read's gradient has the same bits in any batch
    (a batched matrix product's order depends on the batch size)."""

    @staticmethod
    def forward(ctx, oh, w):
        ctx.save_for_backward(oh)
        return torch.einsum("bnk,btk->bnt", oh, w)

    @staticmethod
    def backward(ctx, g):
        (oh,) = ctx.saved_tensors
        prod = oh[:, :, None, :] * g[:, :, :, None]        # [b, n, t, k]
        return None, DP.read_sum(torch.movedim(prod, 1, 0), 1)


def _single_emissions(cfg, k, singles, seq, ws, oh4, tid, ws_flags):
    """Per-state single emissions + positional weight, [B, Lp, S]: the
    table of each state's node picked by a one-hot contraction (not a
    gather: the backward is then a product rather than a sorted,
    accumulating index_put over every cell) that keeps the read axis."""
    g, dev, dt = k.g, k.device, k.dtype
    B, Lp = seq.shape
    zero = torch.zeros((), dtype=dt, device=dev)
    f = torch.as_tensor(ws_flags, device=dev)
    w = torch.where(f[None, None, :], ws[:, :, None], zero)
    if cfg.no_prf:
        return torch.zeros((B, Lp, g.S), dtype=dt, device=dev) + w
    slot = torch.as_tensor(g.single_table_index[tid], device=dev)
    v = _OneHot.apply(oh4, singles[:, slot])
    return torch.where((seq > 0)[:, :, None], v, zero) + w


def right_emissions(cfg: ModelConfig, k: _Kernels, params_b: Params,
                    sd: SeqData, plain: bool = False):
    """eR [Lp, S, B] (right emission + ws) of per-read weights,
    batch-minor: the one differentiable input of the no-rss chain (K14
    alone, mode "eR", on the card; ``plain`` runs the plain version on
    any device)."""
    if k.device.type == "cuda" and not plain:
        return _card_factors(cfg, k, params_b, sd, "eR")["eR"]
    seq, ws, oh4 = _emission_parts(cfg, k, sd)
    singles, _ = _theta(cfg, params_b, k.dtype)
    eR = _single_emissions(cfg, k, singles, seq, ws, oh4, k.g.tid_r,
                           k.g.ws_r)
    return torch.movedim(eR, 0, -1).contiguous()


# K14's outputs that no gradient flows through
CARD_CONSTS = ("alphaP", "seq64", "seqT", "L64", "dcum", "dcumT", "gate",
               "C", "wsp")


class _CardFactors(torch.autograd.Function):
    """K14 (the factors of per-read weights) with K15 (their adjoint into
    the weights) as its backward: the card's form of _diff_factors and
    _const_factors, whose autograd is the plain version.  ``mode`` "dp"
    gives (eR, eL, bg2, pv, *CARD_CONSTS), "eR" gives eR alone."""

    @staticmethod
    def forward(ctx, cfg, st, mode, reads, singles, pairs):
        from ..ops import kernels as K
        out = K.factors(st, cfg, mode, *reads, singles=singles, pairs=pairs)
        ctx.set_materialize_grads(False)
        ctx.meta = (cfg, st, mode, reads[0])
        ctx.save_for_backward(singles, pairs)
        if mode == "eR":
            return out["eR"]
        consts = [out[n] for n in CARD_CONSTS]
        ctx.mark_non_differentiable(*consts)
        return tuple(out[n] for n in ("eR", "eL", "bg2", "pv")) + \
            tuple(consts)

    @staticmethod
    def backward(ctx, geR, geL=None, gbg2=None, gpv=None, *_):
        from ..ops import kernels as K
        cfg, st, mode, seq = ctx.meta
        singles, pairs = ctx.saved_tensors
        gs, gp = K.factors_adj(st, cfg, mode, seq, singles, pairs, geR, geL,
                               gbg2, gpv)
        return None, None, None, None, gs, gp


def _card_reads(k: _Kernels, sd: SeqData):
    """The reads as K14 takes them: codes int32, positional weights
    float64, lengths int32, rss dots bool, on the card (stack_seqdata's
    types: nothing is converted on the main path)."""
    dev = k.device
    as_t = lambda x, t: torch.as_tensor(x, device=dev).to(t).contiguous()
    return (as_t(sd.seq, torch.int32), as_t(sd.ws, torch.float64),
            as_t(sd.L, torch.int32), as_t(sd.dots, torch.bool))


def _card_factors(cfg: ModelConfig, k: _Kernels, params_b, sd: SeqData,
                  mode: str):
    """K14's outputs (a dict, kernels.FAC_OUT's names) for per-read
    weights (None in mode "null", the masks' motif-free factors), through
    _CardFactors where a gradient can flow (not under no_prf: the factors
    do not depend on the weights there)."""
    from ..ops import kernels as K
    reads = _card_reads(k, sd)
    if mode == "null":
        return K.factors(k.dp_null.st, cfg, mode, *reads)
    singles, pairs = (x.to(k.dtype) for x in params_b[:2])
    if mode == "eR":
        pairs = None
    if cfg.no_prf:
        return K.factors(k.dp.st, cfg, mode, *reads, singles=singles.detach(),
                         pairs=None if pairs is None else pairs.detach())
    got = _CardFactors.apply(cfg, k.dp.st, mode, reads, singles, pairs)
    if mode == "eR":
        return {"eR": got}
    return dict(zip(("eR", "eL", "bg2", "pv") + CARD_CONSTS, got))


def _card_const_factors(cfg: ModelConfig, k: _Kernels, out, bp_ok):
    """ConstFactors from K14's constants and K1's tables."""
    bp_ok = torch.as_tensor(bp_ok, device=k.device).bool().contiguous()
    sc = ET.score_tables(k.tab, out["seq64"], out["L64"], bp_ok, out["dcum"],
                         cfg.Wp, cfg.max_span, cfg.turn, cfg.no_ene,
                         cfg.fix_rss)
    return DP.ConstFactors(
        wsp=out["wsp"], hp=sc["hp"], stk=sc["stk"], ext=sc["ext"],
        ml2=sc["ml2"], mlE=sc["mlE"], okP=sc["okP"], okE=sc["okE"],
        okM=sc["okM"], okB=sc["okB"], gate_O2=out["gate"],
        gate_M=out["gate"], seq=out["seqT"], C=out["C"], L=out["L64"],
        dots_cum=out["dcumT"],
        ep={kk: sc[kk] for kk in ("misA", "misB", "t_out", "t_in",
                                  "spec_il")})


def _diff_factors(cfg: ModelConfig, k: _Kernels, params_b: Params,
                  sd: SeqData):
    """Differentiable factors for the batch, batch-minor (trailing B),
    from per-read weights: each read's factors depend on its own copy
    alone, and lam comes out [2, B]."""
    g, dev, dt = k.g, k.device, k.dtype
    Lp = cfg.Lp
    seq, ws, oh4 = _emission_parts(cfg, k, sd)
    B = seq.shape[0]
    singles, pairs = _theta(cfg, params_b, dt)
    zero = torch.zeros((), dtype=dt, device=dev)
    eR = _single_emissions(cfg, k, singles, seq, ws, oh4, g.tid_r, g.ws_r)
    eL = _single_emissions(cfg, k, singles, seq, ws, oh4, g.tid_l, g.ws_l)
    if cfg.no_prf:
        bg2 = torch.zeros((B, Lp), dtype=dt, device=dev)
    else:
        bg2 = torch.where(seq > 0, _OneHot.apply(oh4, singles[:, :1])[..., 0],
                          zero)
    j, w = _grid(cfg, dev)
    i = torch.clamp(j - w, 0, Lp - 1)
    bt = k.tab["bp"][seq[:, i], seq[:, torch.clamp(j - 1, 0, Lp - 1)]
                     .expand(-1, -1, cfg.Wp + 1)]
    Tp = max(1, g.n_pair_tables)
    if cfg.no_prf:
        pv = torch.zeros((B, Lp + 1, cfg.Wp + 1, Tp), dtype=dt, device=dev)
    else:
        oh6 = torch.nn.functional.one_hot(torch.clamp(bt - 1, 0, 5), 6)
        pvv = _OneHot.apply(oh6.to(dt).reshape(B, -1, 6), pairs).reshape(
            B, Lp + 1, cfg.Wp + 1, Tp)
        pv = torch.where((bt > 0)[..., None], pvv, zero)
    mv = lambda x: torch.movedim(x, 0, -1).contiguous()
    return DP.DiffFactors(
        eR=mv(eR), eL=mv(eL), bg2=mv(bg2), pv=mv(pv),
        lam=params_b.lam.to(dt).T,
        alphaP=torch.zeros((Lp + 1, cfg.Wp + 1, B), dtype=dt, device=dev))


def batch_factors(cfg: ModelConfig, params: Params, sd_b: SeqData,
                  bp_ok_b, device=None, aux_b=None, plain: bool = False):
    """``batch_factors_pr`` on per-read copies of shared weights."""
    return batch_factors_pr(cfg, per_read(params, len(sd_b.L)), sd_b,
                            bp_ok_b, device, aux_b, plain)


def _dense_aux(aux_b):
    """The dense aux of ``aux_b`` (JAX layout [B, Lp, S, S]) batch-minor."""
    return {k: torch.movedim(aux_b[k], 0, -1).contiguous()
            for k in DP.AUX if k in (aux_b or {})}


def batch_factors_pr(cfg: ModelConfig, params_b: Params, sd_b: SeqData,
                     bp_ok_b, device=None, aux_b=None, plain: bool = False):
    """Batched (DiffFactors, ConstFactors) for the DP from per-read
    weights: K14 (K15 its adjoint) with K1 on the card, the plain version
    (_diff_factors, _const_factors; autograd its adjoint) on the CPU or
    with ``plain``.

    sd_b: SeqData with a leading batch axis; bp_ok_b: [B, Lp+1, Wp+1];
    aux_b: the scanner's aux factors (ops/dp.py) or None — dense
    auxR/auxL/auxPL/auxPR [B, Lp, S, S] (the JAX layout; plain versions
    only), the class probe "cls" [4, Lp, B] and a "pin" (dp.Pin).
    """
    k = kernels(cfg, device)
    if k.device.type == "cuda" and not plain:
        out = _card_factors(cfg, k, params_b, sd_b, "dp")
        c = _card_const_factors(cfg, k, out, bp_ok_b)
        d = DP.DiffFactors(eR=out["eR"], eL=out["eL"], bg2=out["bg2"],
                           pv=out["pv"], lam=params_b.lam.to(k.dtype).T,
                           alphaP=out["alphaP"])
    else:
        bp_ok_b = torch.as_tensor(bp_ok_b, device=k.device)
        c = _const_factors(cfg, k, sd_b, bp_ok_b)
        d = _diff_factors(cfg, k, params_b, sd_b)
    if aux_b:
        d = d._replace(cls=aux_b.get("cls"), **_dense_aux(aux_b))
        c = c._replace(pin=aux_b.get("pin"))
    return d, c


def _null_batch_factors(cfg: ModelConfig, k: _Kernels, sd_b: SeqData,
                        bp0_b, plain: bool = False):
    """Batched factors for the motif-free McCaskill pass (BPP pruning):
    the constants of the reads with zero positional weights, unit
    emissions, lambda 1 and a zero injected pair factor alphaP that the
    caller differentiates (K14 in mode "null" on the card, unless
    ``plain``)."""
    if k.device.type == "cuda" and not plain:
        out = _card_factors(cfg, k, None, sd_b, "null")
        d = DP.DiffFactors(eR=out["eR"], eL=out["eL"], bg2=out["bg2"],
                           pv=out["pv"], lam=out["lam"],
                           alphaP=out["alphaP"])
        return d, _card_const_factors(cfg, k, out, bp0_b)
    c = _const_factors(cfg, k, sd_b, bp0_b)
    c = c._replace(wsp=torch.zeros_like(c.wsp))
    Lp, Wp, B = cfg.Lp, cfg.Wp, bp0_b.shape[0]
    z = lambda *shape: torch.zeros(shape, dtype=k.dtype, device=k.device)
    d = DP.DiffFactors(eR=z(Lp, 1, B), eL=z(Lp, 1, B), bg2=z(Lp, B),
                       pv=z(Lp + 1, Wp + 1, 1, B),
                       lam=torch.ones((2, B), dtype=k.dtype,
                                      device=k.device),
                       alphaP=z(Lp + 1, Wp + 1, B))
    return d, c


def _candidate_pairs(cfg: ModelConfig, k: _Kernels, sd_b: SeqData):
    if cfg.fix_rss:
        return torch.as_tensor(sd_b.rss_pair, device=k.device).bool()
    return _complementary_bp(cfg, k, sd_b)


def bpp_posterior_batch(cfg: ModelConfig, sd_b: SeqData, device=None):
    """Batched base-pair probabilities from the motif-free pass
    (energy_model.hpp:188-266): the gradient of logZ with respect to the
    injected per-pair log-factor alphaP is the pair posterior.
    Returns (logZ [B], post [B, Lp+1, Wp+1], bp0 [B, Lp+1, Wp+1])."""
    k = kernels(cfg, device)
    bp0 = _candidate_pairs(cfg, k, sd_b)
    d, c = _null_batch_factors(cfg, k, sd_b, bp0)
    alphaP = d.alphaP.requires_grad_(True)
    with torch.enable_grad():
        z = k.dp_null.dp_parts(d, c)[:, 0]
        (post,) = torch.autograd.grad(z.sum(), alphaP)
    return z.detach(), torch.movedim(post, -1, 0), bp0


def effective_bp_mask_batch(cfg: ModelConfig, sd_b: SeqData, device=None):
    """Batched bp_ok after min-BPP pruning and bpp_eff [B]
    (energy_model.hpp:211-266): the given structure under fix_rss,
    complementarity alone at min_bpp <= 0 (or no-rss), else the candidate
    pairs whose motif-free posterior reaches min_bpp."""
    k = kernels(cfg, device)
    bp0 = _complementary_bp(cfg, k, sd_b)
    total = torch.clamp(bp0.sum(dim=(1, 2)), min=1)
    if cfg.fix_rss:
        rss = torch.as_tensor(sd_b.rss_pair, device=k.device).bool()
        return rss, rss.sum(dim=(1, 2)).to(k.dtype) / total
    if cfg.min_bpp <= 0 or cfg.no_rss:
        return bp0, torch.ones(bp0.shape[0], dtype=k.dtype, device=k.device)
    _, post, _ = bpp_posterior_batch(cfg, sd_b, device)
    keep = bp0 & (torch.log(torch.clamp(post, min=1e-300))
                  >= math.log(cfg.min_bpp))
    return keep, keep.sum(dim=(1, 2)).to(k.dtype) / total


def bpp_posterior(cfg: ModelConfig, sd: SeqData, device=None):
    """Per-read wrapper: (logZ, post [Lp+1, Wp+1], bp0) of one read."""
    dev = DEV.resolve(device)
    z, post, bp0 = bpp_posterior_batch(cfg, stack_seqdata([sd], dev), dev)
    return z[0], post[0], bp0[0]


def effective_bp_mask(cfg: ModelConfig, sd: SeqData, device=None):
    """Per-read wrapper: (bp_ok [Lp+1, Wp+1], bpp_eff) of one read."""
    dev = DEV.resolve(device)
    keep, eff = effective_bp_mask_batch(cfg, stack_seqdata([sd], dev),
                                        dev)
    return keep[0], eff[0]


def batch_logZ_parts(cfg: ModelConfig, params: Params, sd_b: SeqData,
                     bp_ok_b=None, device=None, aux_b=None):
    """``batch_logZ_parts_pr`` on per-read copies of shared weights."""
    return batch_logZ_parts_pr(cfg, per_read(params, len(sd_b.L)), sd_b,
                               bp_ok_b, device, aux_b)


def batch_logZ_parts_pr(cfg: ModelConfig, params_b: Params, sd_b: SeqData,
                        bp_ok_b=None, device=None, aux_b=None):
    """[B, 3] log partition parts at end states (0,0), (0,M-2), (0,M-1)
    from per-read weights (read b's parts depend on its own copy alone).

    part_func(ari, nasi) of the reference (motif_trainer.hpp:108-112) is
    a logsumexp over a subset of these.  No-rss models run the forward
    chain (ops/linear.py, K8/K9) on their right emissions; the pair masks
    play no part there.  ``aux_b``: the scanner's aux factors, as
    ``batch_factors_pr`` takes them (the chain reads only auxR).
    """
    if cfg.no_rss:
        k = kernels(cfg, device)
        L = torch.as_tensor(sd_b.L, device=k.device).long()
        aux_b = aux_b or {}
        return LIN.linear_parts(
            k.dp.st, right_emissions(cfg, k, params_b, sd_b), L,
            _dense_aux(aux_b).get("auxR"), aux_b.get("pin"),
            aux_b.get("cls"))
    if bp_ok_b is None:
        bp_ok_b, _ = effective_bp_mask_batch(cfg, sd_b, device)
    d, c = batch_factors_pr(cfg, params_b, sd_b, bp_ok_b, device, aux_b)
    return kernels(cfg, device).dp.dp_parts(d, c)


def linear_parts(cfg: ModelConfig, params: Params, sd: SeqData,
                 device=None):
    """[3] no-rss chain parts of one read (JAX ``linear_parts``)."""
    dev = DEV.resolve(device)
    cfg1 = dataclasses.replace(cfg, no_rss=True)
    return batch_logZ_parts(cfg1, params, stack_seqdata([sd], dev),
                            device=dev)[0]


def logZ_parts(cfg: ModelConfig, params: Params, sd: SeqData, bp_ok=None,
               with_eff=False, device=None):
    """[3] parts of one read (JAX ``logZ_parts``): the read's own min-BPP
    masks unless ``bp_ok`` is given; with ``with_eff`` also bpp_eff (1 for
    no-rss models and for given masks)."""
    dev = DEV.resolve(device)
    sd_b = stack_seqdata([sd], dev)
    eff = torch.ones((), dtype=DEV.torch_dtype(cfg.dtype), device=dev)
    if cfg.no_rss:
        bp_b = None
    elif bp_ok is None:
        bp_b, effs = effective_bp_mask_batch(cfg, sd_b, dev)
        eff = effs[0]
    else:
        bp_b = torch.as_tensor(bp_ok, device=dev)[None]
    parts = batch_logZ_parts(cfg, params, sd_b, bp_b, device=dev)[0]
    return (parts, eff) if with_eff else parts


def part_func(parts, ari=True, nasi=True):
    """sumL over selected end states (motif_trainer.hpp:108-112)."""
    sel = torch.as_tensor([nasi, ari, ari], device=parts.device)
    return lse(torch.where(sel, parts, torch.full_like(parts, NEG)), axis=-1)


class JointModel(torch.nn.Module):
    """The joint model's parameters (``singles``, ``pairs``, ``lam``) as
    nn.Parameters; ``forward`` gives the [B, 3] log partition parts."""

    def __init__(self, cfg: ModelConfig, params: Params = None, device=None):
        super().__init__()
        dev = DEV.resolve(device)
        self.cfg = cfg
        if params is None:
            params = init_params(compile_pattern(cfg.pattern), cfg,
                                 device=dev)
        dt = DEV.torch_dtype(cfg.dtype)
        as_p = lambda x: torch.nn.Parameter(
            torch.as_tensor(x, dtype=dt, device=dev).clone())
        self.singles = as_p(params.singles)
        self.pairs = as_p(params.pairs)
        self.lam = as_p(params.lam)

    @property
    def device(self):
        return self.lam.device

    def params(self) -> Params:
        return Params(singles=self.singles, pairs=self.pairs, lam=self.lam)

    def forward(self, sd_b: SeqData, bp_ok_b=None):
        return batch_logZ_parts(self.cfg, self.params(), sd_b, bp_ok_b,
                                device=self.device)
