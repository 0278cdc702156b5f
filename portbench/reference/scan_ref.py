"""The plain reference of a scan cell: what the port's ``Scanner.scan``
writes for a read (the start, end and inner posteriors, the motif region
Ys/Ye, the Viterbi alignment psihat/rss) and each read's E[N], worked out
again from the reads and the weights with the plain DP, in the same
length buckets of 32."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .model import joint as J
from .ops import dp as DP
from .ops import dp_maxb as DMB
from .scan import cyk as CYK
from .scan import scanner as SC


def bucket_of(L: int) -> int:
    """The scan driver's length bucket: the next multiple of 32, at
    least 32."""
    return max(32, ((L + 31) // 32) * 32)


def scan_config(cfg: J.ModelConfig, params: J.Params, Lp: int):
    """The scanner's plain-theta configuration and weights at ``Lp``."""
    th = J.effective_theta(cfg, params)
    cfg2 = dataclasses.replace(cfg, theta_softmax=False, Lp=Lp)
    return cfg2, J.Params(singles=th.singles.detach(),
                          pairs=th.pairs.detach(), lam=params.lam.detach())


def _params(cfg, singles, pairs, lam, device):
    dt = J.kernels(dataclasses.replace(cfg, Lp=32), device).dtype
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    return J.Params(as_t(singles), as_t(pairs), as_t(lam))


def _buckets(reads):
    out = {}
    for i, (seq, _) in enumerate(reads):
        out.setdefault(bucket_of(len(seq)), []).append(i)
    return out


def _stack(cfg_b, reads, idx, device):
    return J.stack_seqdata([J.make_seqdata(cfg_b, reads[i][0], reads[i][1])
                            for i in idx], device)


def posteriors(cfg: J.ModelConfig, singles, pairs, lam, reads, device):
    """Per read (in the order given) a dict of Pys [L], Pye [L+1], Pyi
    [L], Ys, Ye and its own E[N] (singles, pairs), as numpy; and the
    min-BPP masks of the reads by bucket, {Lp: (indices, bp_ok)}, which
    ``align`` and ``path_gaps`` reuse.  ``reads``: (seq codes, quals)."""
    params = _params(cfg, singles, pairs, lam, device)
    out, masks = [None] * len(reads), {}
    for Lp, idx in sorted(_buckets(reads).items()):
        cfg_b, p_b = scan_config(cfg, params, Lp)
        res = posteriors_pr(cfg_b, p_b, _stack(cfg_b, reads, idx, device),
                            device)
        masks[Lp] = (idx, res["bp_ok"])
        n = {k: J._np(res[k]) for k in ("Pys", "Pye", "Pyi", "Ys", "Ye")}
        for t, i in enumerate(idx):
            L = len(reads[i][0])
            out[i] = dict(Pys=n["Pys"][t][:L], Pye=n["Pye"][t][:L + 1],
                          Pyi=n["Pyi"][t][:L], Ys=int(n["Ys"][t]),
                          Ye=int(n["Ye"][t]),
                          EN=[J._np(x[t]).astype(np.float64)
                              for x in res["EN"]])
    return out, masks


def align(cfg: J.ModelConfig, singles, pairs, lam, reads, pins, masks,
          device):
    """The Viterbi alignment (psihat [L], rss) of each read under its pins
    ``pins[i]`` = (Ys, Ye), on the masks ``posteriors`` gave."""
    params = _params(cfg, singles, pairs, lam, device)
    out = [None] * len(reads)
    for Lp, (idx, bp_ok) in sorted(masks.items()):
        cfg_b, p_b = scan_config(cfg, params, Lp)
        if cfg_b.no_rss:
            continue
        got = CYK.cyk_batch(cfg_b, p_b, _stack(cfg_b, reads, idx, device),
                            [pins[i][0] for i in idx],
                            [pins[i][1] for i in idx], bp_ok, device=device)
        for t, i in enumerate(idx):
            out[i] = got[t]
    return out


def posteriors_pr(cfg, params, sd_b, device):
    """scan.scanner.scan_posteriors_batch with the weights as per-read
    copies, so that E[N] comes per read: Pys, Pyi [B, Lp], Pye [B, Lp+1],
    Ys, Ye [B], EN (singles [B, n, 4], pairs [B, n, 6]) and bp_ok."""
    k = J.kernels(cfg, device)
    dt, B, Lp = k.dtype, len(sd_b.L), cfg.Lp
    valid = torch.ones(B, dtype=dt, device=device)
    L = torch.as_tensor(sd_b.L, device=device).long()
    bp_ok, _ = J.effective_bp_mask_batch(cfg, sd_b, device)
    lse_ends = DP.Ends("lse")
    leaves = J.per_read(J.Params(*[x.detach().requires_grad_(True)
                                   for x in params]), B)
    cls = DP.zero_probe(Lp, B, dt, device)
    with torch.enable_grad():
        _, z, _ = J.batch_ends_pr(cfg, leaves, sd_b, bp_ok, device,
                                  aux_b={"cls": cls}, ends=lse_ends)
        gr = torch.autograd.grad(z, list(leaves[:2]) + [cls], valid)
    Pys, Pyi, Ys, Ys32 = SC.pass1_posteriors_plain(gr[2], L)
    pin = DP.Pin(Ys32, DP.CLS_START)
    cls_e = DP.zero_probe(Lp, B, dt, device)
    with torch.enable_grad():
        _, ze, _ = J.batch_ends(
            cfg, J.Params(*[x.detach() for x in params]), sd_b, bp_ok,
            device, aux_b={"cls": cls_e, "pin": pin}, ends=lse_ends)
        (ge,) = torch.autograd.grad(ze, cls_e, valid)
    Pye, Ye = SC.end_posteriors_plain(ge, L)
    return dict(Pys=Pys, Pyi=Pyi, Pye=Pye, Ys=Ys, Ye=Ye, EN=gr[:2],
                bp_ok=bp_ok)


def rss_pairs(rss: str):
    """The pair cells (j, w) of a structure string's L/R letters."""
    stack, cells = [], []
    for p, ch in enumerate(rss):
        if ch == "L":
            stack.append(p)
        elif ch == "R":
            i = stack.pop()
            cells.append((p + 1, p + 1 - i))
    return cells


def path_gaps(cfg: J.ModelConfig, singles, pairs, lam, reads, pins, paths,
              masks, device):
    """For each read, the log score by which the best alignment with the
    pairs and node path of ``paths[i]`` (psihat, rss) lies below the best
    alignment, both under the pins ``pins[i]`` = (Ys, Ye), on the masks
    ``posteriors`` gave: the plain max DP, then the same tables with bp_ok
    the path's pairs alone and dense aux vetoes that keep, at each base,
    only emissions of the path's node there, paired where the path pairs
    it and unpaired elsewhere.  0 for a path that is optimal (a tie), inf
    for one no alignment has; None where ``paths[i]`` is None."""
    params = _params(cfg, singles, pairs, lam, device)
    gaps = [None] * len(reads)
    for Lp, (idx, bp) in sorted(masks.items()):
        idx = [i for i in idx if paths[i] is not None]
        if not idx:
            continue
        rows = [t for t, i in enumerate(masks[Lp][0]) if paths[i] is not None]
        bp = bp[rows]
        cfg_b, p_b = scan_config(cfg, params, Lp)
        k = J.kernels(cfg_b, device)
        g = k.g
        sd = _stack(cfg_b, reads, idx, device)
        L = torch.as_tensor(sd.L, device=device).long()
        pin = CYK.cyk_pins(
            torch.as_tensor([pins[i][0] for i in idx], device=device),
            torch.as_tensor([pins[i][1] for i in idx], device=device), L)
        mdp = DMB.MaxDP(k.dp)
        S, W1 = g.S, cfg_b.Wp + 1
        gbp = torch.zeros((len(idx), Lp + 1, W1), dtype=torch.bool)
        aux = np.zeros((4, len(idx), Lp, S, S))
        sr, sl = np.asarray(g.state_r), np.asarray(g.state_l)
        for t, i in enumerate(idx):
            psi, rss = paths[i]
            for j_, w_ in rss_pairs(rss):
                if w_ < W1:
                    gbp[t, j_, w_] = True
            for p, node in enumerate(psi):
                paired = rss[p] in "LR"
                right = np.where(sr[:, None] == node, 0.0, -np.inf) \
                    * np.ones(S)
                left = np.where(sl[None, :] == node, 0.0, -np.inf) \
                    * np.ones((S, 1))
                aux[0, t, p] = -np.inf if paired else right
                aux[1, t, p] = -np.inf if paired else left
                aux[2, t, p] = left if paired else -np.inf
                aux[3, t, p] = right if paired else -np.inf
        ends = list(g.end_states[1:])
        best = []
        for bp_t, extra in ((bp, {}), (gbp.to(device) & bp, {
                k_: torch.as_tensor(aux[n], dtype=k.dtype, device=device)
                for n, k_ in enumerate(DP.AUX)})):
            d, c = J.batch_factors(cfg_b, p_b, sd, bp_t, device=device,
                                   aux_b=dict(extra, pin=pin))
            O = mdp.tables(d, c)["O"]
            best.append([float(O[int(L[t]) + mdp.st.PAD, ends, t].max())
                         for t in range(len(idx))])
        for t, i in enumerate(idx):
            gaps[i] = best[0][t] - best[1][t]
    return gaps
