"""Optimizers with the reference's exact semantics (host-side numpy over
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


class Lbfgsb:
    """scipy L-BFGS-B with the reference's regularization semantics and
    best-x tracking (optimizer.hpp:293-324)."""

    def __init__(self, maxiter=100, eps=1e-5):
        self.maxiter = maxiter
        self.eps = eps
        self.lower = None
        self.upper = None
        self.rgl_type = None
        self.rho = None
        self._best_x = None
        self._best_y = np.inf
        self._fdfcount = 0

    set_bounds = Adam.set_bounds
    set_regularization = Adam.set_regularization
    rgl_term = Adam.rgl_term

    def minimize(self, f: Callable, x0, callback=None):
        from scipy.optimize import minimize as sp_min

        def wrapped(x):
            y, gr = f(x, self._fdfcount)
            self._fdfcount += 1
            gr = np.array(gr, float)
            if self.rgl_type is not None:
                t1 = self.rgl_type == 1
                t2 = self.rgl_type == 2
                y = y + self.rgl_term(x)
                gr += np.where(t1, self.rho * np.sign(x), 0.0)
                gr += np.where(t2, self.rho * x, 0.0)
            if y < self._best_y:
                self._best_y, self._best_x = y, np.array(x)
            return y, gr

        bounds = None
        if self.lower is not None:
            bounds = [(lo if np.isfinite(lo) else None,
                       hi if np.isfinite(hi) else None)
                      for lo, hi in zip(self.lower, self.upper)]
        res = sp_min(wrapped, np.array(x0, float), jac=True,
                     method="L-BFGS-B", bounds=bounds,
                     callback=callback,
                     options=dict(maxiter=self.maxiter,
                                  ftol=self.eps, gtol=1e-10))
        if self._best_x is None:
            self._best_x = res.x
        return self._best_x

    def best_x(self):
        return self._best_x

    def fdfcount(self):
        return self._fdfcount
