"""What a traced run records: spans around the calls into the port's
layers (the device synchronised around each, so they stay out of the
untraced window) and a profiled sub-window (torch.profiler: the device's
busy time as the union of its operations' intervals, the device time by
CUDA function, and the host activity under each idle gap)."""
from __future__ import annotations

import time

import torch


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def memory_peak(dev) -> int:
    if torch.device(dev).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated())


class Spans:
    """Timed wrappers: while ``enabled`` each call of a wrapped function
    is timed with the device synchronised around it (seconds appended to
    ``times[key]``); while ``labels`` it runs under a profiler range of
    its key instead, untimed.  ``mark`` is the scanner's stage hook."""

    def __init__(self, dev, enabled=False):
        self.dev, self.enabled, self.labels = dev, enabled, False
        self.times = {}
        self._mark = None

    def add(self, key, seconds):
        if self.enabled:
            self.times.setdefault(key, []).append(seconds)

    def wrap(self, key, fn):
        def run(*a, **kw):
            if self.labels:
                with torch.profiler.record_function(key):
                    return fn(*a, **kw)
            if not self.enabled:
                return fn(*a, **kw)
            _sync(self.dev)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            _sync(self.dev)
            self.times.setdefault(key, []).append(time.perf_counter() - t0)
            return out
        return run

    def mark(self, stage):
        """The scanner's ``mark``: the stages of a chunk (begin, masks,
        pass1_forward, pass1_outside, end_forward, end_outside,
        cyk_tables, cyk_traceback) as spans named after the stage that
        ends."""
        _sync(self.dev)
        t = time.perf_counter()
        if stage != "begin" and self._mark is not None:
            self.times.setdefault(stage, []).append(t - self._mark)
        self._mark = t


def _function_name(key):
    """'void ep_adj_kernel<float, false>(DPDims, ...)' -> 'ep_adj_kernel'."""
    return key.split("(")[0].split("<")[0].replace("void ", "").strip()


class Profiled:
    """A profiled sub-window, started and stopped between the program's
    steps (the device synchronised at both ends)."""

    def __init__(self, dev, labels=()):
        self.dev, self.labels = dev, frozenset(labels)
        self.prof = None
        self.t = None
        self.done = None

    def start(self):
        if torch.device(self.dev).type != "cuda" or self.prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile
        _sync(self.dev)
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t = time.perf_counter()

    def stop(self):
        if self.prof is None or self.done is not None:
            return
        _sync(self.dev)
        wall = time.perf_counter() - self.t
        self.prof.__exit__(None, None, None)
        self.done = reduce_profile(self.prof, wall, self.labels)

    def result(self, units):
        if self.done is None:
            return None
        return dict(self.done, units=units)


def reduce_profile(prof, wall_s, labels=()):
    """{wall_s, busy_s, kernels, by_function {name: s}, device_ops [[name,
    s]] (top 10), idle_gaps [[host activity, s]] (top 10)}: the idle
    gaps summed by the innermost of the spans named ``labels`` that was
    open on the host at the gap's middle."""
    dev_ev, cpu_ev = [], []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            cpu_ev.append(e)
        elif not (getattr(e, "is_user_annotation", False)
                  or e.name in labels):
            # the spans' ranges mirrored on the device's timeline are no
            # device work
            dev_ev.append(e)
    by = {}
    spans = []
    for e in dev_ev:
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        name = _function_name(e.name)
        by[name] = by.get(name, 0.0) + (b - a) * 1e-6
    spans.sort()
    busy, end, gaps = 0.0, None, []
    for a, b in spans:
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    ranges = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in cpu_ev if e.name in labels)
    idle = {}
    for a, b in gaps:
        mid, name = 0.5 * (a + b), "host outside the spans"
        for s, t, n in ranges:
            if s > mid:
                break
            if t >= mid:
                name = n           # the innermost: the latest start
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:10]]
    return dict(wall_s=wall_s, busy_s=busy * 1e-6, kernels=len(dev_ev),
                by_function=by, device_ops=top(by), idle_gaps=top(idle))
