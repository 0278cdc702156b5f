"""Helpers the per-layer metric readers share.  A reader's ``read(rec)``
returns a number or None (nothing to read: the metric is left out).
``rec`` holds ``spans`` {name: [seconds]} (the span-timed units after the
profiled sub-window), ``walls`` (every unit of the window), ``profile``
(the profiled sub-window: wall_s, busy_s, kernels, by_function {CUDA
function: seconds}, units), ``work`` {kernel: (bytes, operations)} of one
profiled unit's inputs, summed over the profiled units, and ``dtype``."""
from __future__ import annotations

import statistics

from portbench.work import counts as WORK


def mean_ms(rec, key):
    xs = rec.get("spans", {}).get(key)
    return 1e3 * statistics.fmean(xs) if xs else None


def least_s(rec, kernels=None):
    """The least time of the counted work of ``kernels`` (all: None)."""
    work = rec.get("work")
    if not work:
        return None
    sel = work if kernels is None else {k: v for k, v in work.items()
                                        if k in kernels}
    if not sel:
        return None
    return WORK.least_s(*WORK.total(sel), rec["dtype"])


def roofline(rec, kernels, functions):
    """Share (%) of the least time of ``kernels``' counted work in the
    device time of the CUDA ``functions`` that implement them."""
    p = rec.get("profile")
    least = least_s(rec, kernels)
    if not p or least is None:
        return None
    t = sum(p["by_function"].get(f, 0.0) for f in functions)
    return 100.0 * least / t if t > 0 else None


def mfu(rec):
    """Share (%) of the profiled sub-window's wall that the counted work
    of its units needs at the card's peaks."""
    p = rec.get("profile")
    least = least_s(rec)
    if not p or least is None or p["wall_s"] <= 0:
        return None
    return 100.0 * least / p["wall_s"]


def idle(rec):
    p = rec.get("profile")
    if not p or p["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["wall_s"])
