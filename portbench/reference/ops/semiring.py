"""Frozen copy of rnaelem_tpu_torch/ops/semiring.py for the benchmark's plain
reference (portbench/reference): plain PyTorch and numpy only, the
CUDA kernel branches removed, imports kept inside this copy.

Log-semiring primitives for the banded DP (PyTorch).

All DP values are log-space; zero = -inf, one = 0 (util.hpp:192-229).
The -inf conventions match the JAX package: a reduction over only -inf
terms gives -inf (never NaN, never log(tiny)), and lam_mul keeps -inf
energies at -inf even for lambda == 0.
"""
from __future__ import annotations

import math

import torch

NEG = -math.inf


def _finite_or_zero(m):
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def safe_log(s):
    """log(s) for s > 0, -inf for s == 0."""
    tiny = torch.finfo(s.dtype).tiny
    return torch.where(s > 0, torch.log(torch.clamp(s, min=tiny)),
                       torch.full_like(s, NEG))


def lse(x, axis=-1):
    """logsumexp that gives -inf (not NaN) for all--inf reductions."""
    m = _finite_or_zero(torch.amax(x, dim=axis, keepdim=True)).detach()
    s = torch.sum(torch.exp(x - m), dim=axis)
    return safe_log(s) + m.squeeze(axis)


def lse_weights(x, use):
    """(lse over the columns ``use`` (bool [n]) of x [B, n], the softmax
    weights of those columns: 0 elsewhere, and where no term is
    finite)."""
    xm = torch.where(use[None], x, torch.full_like(x, NEG))
    m = _finite_or_zero(torch.amax(xm, dim=-1, keepdim=True))
    e = torch.exp(xm - m)
    s = e.sum(dim=-1, keepdim=True)
    w = torch.where(s > 0, e / torch.where(s > 0, s, torch.ones_like(s)),
                    torch.zeros_like(e))
    return lse(xm, axis=-1), w


def logadd(a, b):
    """Elementwise log(e^a + e^b), -inf-safe."""
    m = _finite_or_zero(torch.maximum(a, b)).detach()
    return safe_log(torch.exp(a - m) + torch.exp(b - m)) + m


def lam_mul(lam, tsc):
    """lambda * tsc with the reference's skip-on-zero semantics: -inf
    energies stay -inf even for lambda == 0 (energy_model.hpp guards
    `zeroL != tsc` before applying `lam*tsc`)."""
    ninf = torch.isneginf(tsc)
    return torch.where(ninf, torch.full_like(tsc, NEG),
                       lam * torch.where(ninf, torch.zeros_like(tsc), tsc))


def mask_neg(x, mask):
    """Gate log values: keep where mask else -inf."""
    return torch.where(mask, x, torch.full_like(x, NEG))
