"""Scanner posteriors (PyTorch): motif start/end/inside posteriors, the
conditional end pass and E[N] (JAX scan/scanner.py).

Replicates RNAelemScanDP (motif_scanner.hpp:186-260, 364-800):

* Pys[p], the posterior that the motif starts at base p (transitions
  crossing node 0 -> 1), Pyi[p], the inside-motif posterior, and PyN, the
  no-motif probability, are derivatives of logZ with respect to log
  factors on the transitions that emit base p.  The port takes them as
  the cotangent of a class probe (ops/dp.py): four numbers per (base,
  read) whose transitions' posteriors summed over the emission kinds
  (R right-chain, L left-chain, PL/PR pair edges) are the start, in, end
  and tail mass — what JAX sums from dense [Lp, S, S] aux cotangents.
* The end pass re-runs the DP with a pin at Ys: a -inf veto on every
  transition emitting base Ys outside the start class (only the 0 -> 1
  crossing survives, InsideEndFun, motif_scanner.hpp:581-665), and reads
  Pye from the M-2 -> M-1 crossings (plus, at p = L, the tail mass of
  the read's last base).
* E[N], the expected emission counts, is the weights' gradient of the
  first pass.

Both passes are the port's one gradient path (model/joint.py
batch_logZ_parts through the DP's autograd Function): the kernels K2, K4,
K5, K7 (K8/K9 for --no-rss models) take the pin and write the class sums.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import device as DEV
from ..model import joint as J
from ..ops import dp as DP
from ..ops.semiring import lse


class StateMasks(NamedTuple):
    """[S, S] bool masks over (target, source) transitions."""
    r_start: torch.Tensor   # right emission crossing 0 -> 1
    r_in: torch.Tensor
    r_end: torch.Tensor     # crossing M-2 -> M-1
    r_tail: torch.Tensor    # target.r == M-2 (for Pye[L])
    l_start: torch.Tensor
    l_in: torch.Tensor
    l_end: torch.Tensor
    pl_start: torch.Tensor
    pl_in: torch.Tensor
    pl_end: torch.Tensor
    pr_start: torch.Tensor
    pr_in: torch.Tensor
    pr_end: torch.Tensor
    pr_tail: torch.Tensor


def state_masks(cfg: J.ModelConfig, device=None) -> StateMasks:
    """The 14 class masks of JAX ``state_masks``, read off the class bits
    the kernels take (ops/dp.py class_codes)."""
    dev = DEV.resolve(device)
    codes = torch.as_tensor(DP.class_codes(J.kernels(cfg, dev).g),
                            device=dev)
    cls = {n: 1 << c for c, n in enumerate(DP.CLASSES)}
    m = {}
    for kind, pre in enumerate(("r", "l", "pl", "pr")):
        for name, bit in cls.items():
            m[pre + "_" + name] = (codes[kind] & bit) != 0
    return StateMasks(**{k: m[k] for k in StateMasks._fields})


def _argmax_last(v):
    """max_index semantics: ties resolve to the LAST maximal index
    (util.hpp:232-241), over the last axis."""
    n = v.shape[-1]
    return n - 1 - torch.argmax(torch.flip(v, dims=(-1,)), dim=-1)


def scan_posteriors_batch(cfg: J.ModelConfig, params: J.Params,
                          sd_b: J.SeqData, valid=None, device=None,
                          mark=None):
    """Batched posterior and conditional-end passes (JAX
    ``_scan_posteriors_jit``) for the reads of ``sd_b`` (leading batch
    axis) under plain-theta weights (driver.scan_config).  Returns a dict
    of Pys, Pyi [B, Lp], Pye [B, Lp+1], PyN, Z, Ze [B], Ys, Ye [B] int64,
    EN (Params: the expected emission counts summed over the valid
    reads), eff [B] and bp_ok [B, Lp+1, Wp+1] (the min-BPP masks, which
    the CYK pass reuses).  Rows where ``valid`` is 0 (padding) have zero
    posteriors and add nothing to EN.  ``mark(stage)``, if given, is
    called at the start (begin) and after each stage: masks,
    pass1_forward, pass1_outside, end_forward, end_outside."""
    dev = DEV.resolve(device)
    mark = mark or (lambda stage: None)
    mark("begin")
    dt = J.kernels(cfg, dev).dtype
    B, Lp = len(sd_b.L), cfg.Lp
    valid = torch.ones(B, dtype=dt, device=dev) if valid is None else \
        torch.as_tensor(valid, dtype=dt, device=dev)
    L = torch.as_tensor(sd_b.L, device=dev).long()
    bp_ok, eff = J.effective_bp_mask_batch(cfg, sd_b, dev)
    mark("masks")

    # pass 1: class sums and the weights' gradient (E[N]) of sum_b
    # valid_b logZ_b
    leaves = J.Params(*[x.detach().clone().requires_grad_(True)
                        for x in params])
    cls = torch.zeros((4, Lp, B), dtype=dt, device=dev, requires_grad=True)
    with torch.enable_grad():
        parts = J.batch_logZ_parts(cfg, leaves, sd_b, bp_ok, dev,
                                   aux_b={"cls": cls})
        z = lse(parts, axis=-1)
        mark("pass1_forward")
        gr = torch.autograd.grad(z, list(leaves) + [cls], valid,
                                 allow_unused=True)
    mark("pass1_outside")
    EN = J.Params(*[torch.zeros_like(x) if g is None else g
                    for x, g in zip(leaves, gr[:3])])
    inb = torch.arange(Lp, device=dev)[None, :] < L[:, None]
    zero = torch.zeros((), dtype=dt, device=dev)
    Pys = torch.where(inb, gr[3][0].T, zero)
    Pyi = torch.where(inb, gr[3][1].T, zero)
    PyN = torch.exp(parts[:, 0] - z).detach()
    Ys = _argmax_last(torch.where(inb, Pys, -1.0))

    # end pass, start pinned per read at Ys
    pin = DP.Pin(Ys.to(torch.int32).contiguous(), DP.CLS_START)
    cls_e = torch.zeros((4, Lp, B), dtype=dt, device=dev,
                        requires_grad=True)
    with torch.enable_grad():
        parts_e = J.batch_logZ_parts(
            cfg, J.Params(*[x.detach() for x in params]), sd_b, bp_ok, dev,
            aux_b={"cls": cls_e, "pin": pin})
        ze = lse(parts_e, axis=-1)
        mark("end_forward")
        (ge,) = torch.autograd.grad(ze, cls_e, valid)
    mark("end_outside")
    Pye_pos = torch.where(inb, ge[2].T, zero)
    lastb = torch.clamp(L - 1, 0, Lp - 1)
    pye_L = ge[3][lastb, torch.arange(B, device=dev)]
    pos = torch.arange(Lp + 1, device=dev)[None, :]
    Pye = torch.cat([Pye_pos, torch.zeros((B, 1), dtype=dt, device=dev)],
                    dim=1) + (pos == L[:, None]) * pye_L[:, None]
    Ye = _argmax_last(torch.where(pos <= L[:, None], Pye, -1.0))
    return dict(Pys=Pys, Pyi=Pyi, Pye=Pye, PyN=PyN, Z=z.detach(),
                Ze=ze.detach(), Ys=Ys, Ye=Ye, EN=EN, eff=eff, bp_ok=bp_ok)
