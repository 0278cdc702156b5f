"""Frozen copy of rnaelem_tpu_torch/train/optim.py for the benchmark's plain
reference (portbench/reference): plain PyTorch and numpy only, the
CUDA kernel branches removed, imports kept inside this copy.

Optimizers with the reference's exact semantics (host-side numpy over
the packed parameter vector, a few hundred floats).

Adam (optimizer.hpp:72-173): bias-corrected moments with the reference's
beta^(t+1) correction quirk (beta1t *= beta1 happens before the first
update), L1/L2 regularization folded into fn/gr *before* the update,
bound clipping *after*, convergence |gr|^2 < (y+1)*1e-8.

L-BFGS-B (--no-shuffle mode) delegates to scipy's implementation of the
same Nocedal/Zhu algorithm the reference embeds (optimizer.hpp:175-2790),
with the regularization/bounds applied identically.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np


class Adam:
    def __init__(self, alpha=0.1, beta1=0.9, beta2=0.999, eps=1e-8):
        self.alpha, self.beta1, self.beta2, self.eps = (
            alpha, beta1, beta2, eps)
        self.lower = None
        self.upper = None
        self.rgl_type = None   # 0 none, 1 L1, 2 L2
        self.rho = None
        self._t = 0
        self._x = None

    def set_bounds(self, lower, upper):
        self.lower = np.asarray(lower, float)
        self.upper = np.asarray(upper, float)

    def set_regularization(self, rgl_type, rho):
        self.rgl_type = np.asarray(rgl_type, int)
        self.rho = np.asarray(rho, float)

    def rgl_term(self, x) -> float:
        if self.rgl_type is None:
            return 0.0
        r = np.where(self.rgl_type == 1, self.rho * np.abs(x),
                     np.where(self.rgl_type == 2,
                              self.rho * x * x / 2.0, 0.0))
        return float(r.sum())

    def before_update(self, x, y, gr):
        if self.rgl_type is None:
            return y
        t1 = self.rgl_type == 1
        t2 = self.rgl_type == 2
        y = y + self.rgl_term(x)
        gr += np.where(t1, self.rho * np.sign(x), 0.0)
        gr += np.where(t2, self.rho * x, 0.0)
        return y

    def minimize(self, f: Callable, x0, max_iter: int,
                 callback: Optional[Callable] = None):
        """f(x, iter) -> (y, gr); mirrors Adam::minimize
        (optimizer.hpp:128-159)."""
        x = np.array(x0, float)
        m = np.zeros_like(x)
        v = np.zeros_like(x)
        beta1t, beta2t = self.beta1, self.beta2
        self._t = 0
        while True:
            self._t += 1
            y, gr = f(x, self._t - 1)
            gr = np.array(gr, float)
            y = self.before_update(x, y, gr)
            beta1t *= self.beta1
            beta2t *= self.beta2
            m += (1.0 - self.beta1) * (gr - m)
            v += (1.0 - self.beta2) * (gr * gr - v)
            mhat = m / (1.0 - beta1t)
            vhat = v / (1.0 - beta2t)
            x -= self.alpha * mhat / (np.sqrt(vhat) + self.eps)
            if self.lower is not None:
                np.clip(x, self.lower, self.upper, out=x)
            if callback is not None:
                callback(self._t, x, y, gr)
            if (gr * gr).sum() < (y + 1.0) * 1e-8 or self._t >= max_iter:
                break
        self._x = x
        return x

    def x(self):
        return self._x

    def itercount(self):
        return self._t - 1
