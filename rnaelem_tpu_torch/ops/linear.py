"""The no-rss forward chain (kernel row J) and its adjoint (PyTorch).

A model trained with ``--no-rss`` (any pattern written with ``_``) scores
a read by a plain forward chain over the motif states, with no secondary
structure (motif_model.hpp:170-190; JAX ``_linear_parts_one``):

  o_0[t]     = 0 at end_states[0], -inf elsewhere
  o_{p+1}[t] = logsumexp_s(o_p[s] + TR[t, s]) + eR[p, t]    for p < L_b
  parts[b]   = o_{L_b}[end_states]                           [B, 3]

TR is the grammar's right-transition matrix (log tau on the
tau-transitions, 0 on the others, -inf where there is none): the dense
``DPStatic.TR`` for the plain version, its finite entries as the DP's CSR
lists by target (K8) and by source (K9) for the kernels.

The scanner's aux factors enter at the transitions (JAX
``_linear_parts_one`` with ``aux``): a dense auxR [Lp, S, S, B] (target,
source) for the plain version, and for both versions a per-read
``dp.Pin`` and the class probe cls [4, Lp, B] whose cotangent is the
class sums of the transition posteriors per base (ops/dp.py).

``linear_parts`` launches K8 (forward, csrc/linear_fwd.cu) and, for the
gradient, K9 (adjoint, csrc/linear_adj.cu) for CUDA tensors; for CPU
tensors it runs the plain version ``chain_plain`` (a loop of log-sum-exp)
and autograd takes its adjoint.  The same plain version is the card's
reference for both kernels.
"""
from __future__ import annotations

import torch

from .dp import pin_set
from .semiring import NEG, lse


def chain_aux(st, Lp, B, auxR=None, pin=None, cls=None):
    """Dense auxR [Lp, S, S, B] of the chain from its parts (None if
    none): the given auxR, the class probe on the R kind's classes, the
    pin set's -inf vetoes."""
    if auxR is None and pin is None and cls is None:
        return None
    S = st.dims.S
    a = torch.zeros((Lp, S, S, B), dtype=st.dtype, device=st.device) \
        if auxR is None else auxR
    if cls is not None:
        a = a + torch.einsum("cpb,cts->ptsb", cls, st.cls_mask[0])
    for p in pin_set(pin):
        if not p.kinds & 1:
            continue
        hit = p.pos.long()[None, :] == torch.arange(
            Lp, device=st.device)[:, None]                    # [Lp, B]
        deny = (st.cls_code[0] & p.bit) == 0
        a = a + torch.where(deny[None, :, :, None] & hit[:, None, None, :],
                            NEG, 0.0).to(st.dtype)
    return a


def chain_plain(st, eR, L, auxR=None):
    """[B, 3] chain values at the end states; st the grammar's DPStatic,
    eR [Lp, S, B], L [B], auxR [Lp, S, S, B] or None."""
    Lp, S, B = eR.shape
    o = torch.full((S, B), NEG, dtype=eR.dtype, device=eR.device)
    o[int(st.end_states[0])] = 0.0
    L = L.to(eR.device)
    for p in range(Lp):
        t = o[None, :, :] + st.TR[:, :, None]
        if auxR is not None:
            t = t + auxR[p]
        nxt = lse(t, axis=1) + eR[p]
        o = torch.where((p < L)[None, :], nxt, o)
    return o[st.end_states].T


class _ChainParts(torch.autograd.Function):
    """K8 forward (saving the chain rows), K9 backward; with a class
    probe ``cls`` K9 also writes the class sums, its cotangent."""

    @staticmethod
    def forward(ctx, st, eR, L, pin, cls):
        from . import kernels as K
        parts, rows = K.chain_fwd(st, eR, L, pin)
        ctx.st, ctx.pin, ctx.with_cls = st, pin, cls is not None
        ctx.save_for_backward(eR, L, rows)
        return parts

    @staticmethod
    def backward(ctx, gparts):
        from . import kernels as K
        eR, L, rows = ctx.saved_tensors
        g_cls = torch.empty((4, eR.shape[0], eR.shape[-1]), dtype=eR.dtype,
                            device=eR.device) if ctx.with_cls else None
        g_eR = K.chain_adj(ctx.st, eR, L, rows, gparts.contiguous(), ctx.pin,
                           g_cls)
        return None, g_eR, None, None, g_cls


def linear_parts(st, eR, L, auxR=None, pin=None, cls=None):
    """[B, 3] no-rss parts: K8/K9 for CUDA tensors, the plain version
    (autograd for the gradient) for CPU tensors.  The kernels take the
    pin and the class probe, not a dense auxR."""
    if eR.device.type == "cpu":
        return chain_plain(st, eR, L, chain_aux(st, eR.shape[0],
                                                eR.shape[-1], auxR, pin, cls))
    if auxR is not None:
        raise ValueError("the chain kernels take the scanner's aux as a pin "
                         "and a class probe, not a dense auxR")
    if cls is not None:
        from . import kernels as K
        K._req_zero_probe(cls)
    return _ChainParts.apply(st, eR, L, pin, cls)
