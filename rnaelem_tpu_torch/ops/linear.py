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

``linear_parts`` launches K8 (forward, csrc/linear_fwd.cu) and, for the
gradient, K9 (adjoint, csrc/linear_adj.cu) for CUDA tensors; for CPU
tensors it runs the plain version ``chain_plain`` (a loop of log-sum-exp)
and autograd takes its adjoint.  The same plain version is the card's
reference for both kernels.
"""
from __future__ import annotations

import torch

from .semiring import NEG, lse


def chain_plain(st, eR, L):
    """[B, 3] chain values at the end states; st the grammar's DPStatic,
    eR [Lp, S, B], L [B]."""
    Lp, S, B = eR.shape
    o = torch.full((S, B), NEG, dtype=eR.dtype, device=eR.device)
    o[int(st.end_states[0])] = 0.0
    L = L.to(eR.device)
    for p in range(Lp):
        nxt = lse(o[None, :, :] + st.TR[:, :, None], axis=1) + eR[p]
        o = torch.where((p < L)[None, :], nxt, o)
    return o[st.end_states].T


class _ChainParts(torch.autograd.Function):
    """K8 forward (saving the chain rows), K9 backward."""

    @staticmethod
    def forward(ctx, st, eR, L):
        from . import kernels as K
        parts, rows = K.chain_fwd(st, eR, L)
        ctx.st = st
        ctx.save_for_backward(eR, L, rows)
        return parts

    @staticmethod
    def backward(ctx, gparts):
        from . import kernels as K
        eR, L, rows = ctx.saved_tensors
        return None, K.chain_adj(ctx.st, eR, L, rows,
                                 gparts.contiguous()), None


def linear_parts(st, eR, L):
    """[B, 3] no-rss parts: K8/K9 for CUDA tensors, the plain version
    (autograd for the gradient) for CPU tensors."""
    if eR.device.type == "cpu":
        return chain_plain(st, eR, L)
    return _ChainParts.apply(st, eR, L)
