"""Faults planted in the port's timed path, each a context manager that
patches the port's module and restores it: the check must read them as
not correct (portbench/tests, and the fault readings of
``readings.py``).  The cells run on one chip, so the fault of an exchange
between chips has no place here."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(mod, name, make):
    old = getattr(mod, name)
    setattr(mod, name, make(old))
    try:
        yield
    finally:
        setattr(mod, name, old)


def train_unchanged():
    """A step that returns its state unchanged: Adam's update is not
    applied."""
    from rnaelem_tpu_torch.train import trainer as TRN

    def make(Adam):
        class Frozen(Adam):
            def minimize(self, f, x0, max_iter, callback=None):
                self.alpha = 0.0
                return super().minimize(f, x0, max_iter, callback)
        return Frozen
    return _patched(TRN, "Adam", make)


def train_half():
    """Half of the batch left out, the mean taken over the rest: the
    per-read values of the rows past the first half are dropped and the
    first half's doubled."""
    from rnaelem_tpu_torch.model import joint as J
    from rnaelem_tpu_torch.train import objective as OBJ

    def make(fn_grad):
        def run(cfg, params, batch, *a, **kw):
            f, grads, eff = fn_grad(cfg, params, batch, *a, **kw)
            B = f.shape[0]
            w = torch.zeros(B, dtype=f.dtype, device=f.device)
            w[:B // 2] = 2.0
            scale = lambda x: x * w.view((B,) + (1,) * (x.dim() - 1)).to(
                x.dtype)
            return scale(f), J.Params(*[scale(g) for g in grads]), eff
        return run
    return _patched(OBJ, "batch_fn_grad_pr", make)


def train_altered():
    """An answer altered where it is produced: the first read's objective
    term moved by 1."""
    from rnaelem_tpu_torch.train import objective as OBJ

    def make(fn_grad):
        def run(*a, **kw):
            f, grads, eff = fn_grad(*a, **kw)
            f = f.clone()
            f[0] += 1.0
            return f, grads, eff
        return run
    return _patched(OBJ, "batch_fn_grad_pr", make)


def scan_half():
    """Half of each chunk left out: the second half's posteriors and
    motif regions are the first half's."""
    from rnaelem_tpu_torch.scan import scanner as SC

    def make(post):
        def run(*a, **kw):
            res = dict(post(*a, **kw))
            B = res["Pys"].shape[0]
            h = B // 2
            if h:
                for k in ("Pys", "Pyi", "Pye", "Ys", "Ye"):
                    x = res[k].clone()
                    x[h:2 * h] = x[:h]
                    res[k] = x
            return res
        return run
    return _patched(SC, "scan_posteriors_batch", make)


def scan_altered():
    """An answer altered where it is produced: the first read of every
    chunk gets its start posterior at base 0 raised by 0.01 and its
    first base's motif node moved by one."""
    from rnaelem_tpu_torch.scan import cyk as CYK
    from rnaelem_tpu_torch.scan import scanner as SC

    def make_post(post):
        def run(*a, **kw):
            res = dict(post(*a, **kw))
            x = res["Pys"].clone()
            x[0, 0] += 0.01
            res["Pys"] = x
            return res
        return run

    def make_cyk(cyk):
        def run(*a, **kw):
            out = list(cyk(*a, **kw))
            psi, rss = out[0]
            psi = psi.copy()
            psi[0] = psi[0] + 1
            out[0] = (psi, rss)
            return out
        return run

    stack = contextlib.ExitStack()
    stack.enter_context(_patched(SC, "scan_posteriors_batch", make_post))
    stack.enter_context(_patched(CYK, "cyk_batch", make_cyk))
    return stack


FAULTS = {"adam": {"unchanged": train_unchanged, "half": train_half,
                   "altered": train_altered},
          "scan": {"half": scan_half, "altered": scan_altered}}
