"""The program side of a run: the port's entry points driven through
set-up, the measured window and, in a traced run, spans around the calls
into its layers and a profiled sub-window.

Each driver returns a dict: ``setup_s``; ``window_s``; the window's
``units`` (steps or calls) with their walls; ``attempted`` and
``failed``; ``program``, what the comparison with the reference needs;
and, traced, ``spans``, ``profile`` and ``batches`` (the inputs of the
profiled units, for the work counts)."""
from __future__ import annotations

import io
import math
import os
import time

import numpy as np
import torch

from . import gen
from . import trace as TR


# the spans of a training step, and those of a scan call
TRAIN_SPANS = ("objective", "negatives", "stack", "masks", "fn_grad",
               "reduce")
SCAN_SPANS = ("posteriors", "cyk")
# the span-timed training steps a traced window holds at the least
TIMED_UNITS = 5


class WindowDone(Exception):
    """Raised through the program's loop to end the window."""


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def model_config(J, conf: dict, Lp: int):
    """The port's ModelConfig of a configuration file at ``Lp``."""
    keys = ("max_span", "max_iloop", "min_bpp", "tau", "rho_s", "rho_theta",
            "rho_lambda", "lambda_prior", "theta_softmax", "dtype")
    return J.ModelConfig(pattern=conf["pattern"], Lp=Lp,
                         **{k: conf[k] for k in keys if k in conf})


def round_up(L: int) -> int:
    return max(32, ((L + 31) // 32) * 32)


def draw_weights(J, cfg, conf: dict, seed: int, dev):
    """Theta from the seed, on the device: each table a log-softmax of
    N(0, 1) draws; lambda at the configuration's lambda_init, or for a
    scan uniform on [0.5, 1.5].  Returns (singles, pairs, lam) tensors in
    the configuration's type."""
    g = J.kernels(cfg, dev).g
    ns = int((g.single_table_index >= 0).sum())
    npair = max(1, g.n_pair_tables)
    dt = J.kernels(cfg, dev).dtype
    gen_ = torch.Generator(device=dev)
    gen_.manual_seed(seed & 0xFFFFFFFFFFFFFFFF)
    z = torch.randn(ns * 4 + npair * 6 + 2, generator=gen_, device=dev,
                    dtype=torch.float64)
    singles = torch.log_softmax(z[:ns * 4].view(ns, 4), -1).to(dt)
    pairs = torch.log_softmax(z[ns * 4:ns * 4 + npair * 6].view(npair, 6),
                              -1).to(dt)
    lam = (0.5 + torch.special.ndtr(z[-2:])).to(dt)
    return singles, pairs, lam


# ------------------------------------------------------------ training

def run_adam(conf, mix, seed, seconds, traced, dev, tmp, t_start):
    """A Trainer in Adam minibatch mode on the mix's reads: set-up
    builds it, fills its mask cache for every positive by its own path
    and drives its first ``compare_steps`` steps (kept for the
    comparison); the window runs on from the next step until the first
    step that ends ``seconds`` after the window's start."""
    from rnaelem_tpu_torch.io.fastq import FastqReader
    from rnaelem_tpu_torch.model import joint as J
    from rnaelem_tpu_torch.train import objective as OBJ
    from rnaelem_tpu_torch.train import trainer as TRN

    seqs = gen.reads(mix, seed)
    fq = os.path.join(tmp, "positives.fq")
    gen.write_fastq(fq, seqs, mix["quality"], mix["flagged"])
    Lp = round_up(max(len(s) for s in seqs))
    cfg = model_config(J, conf, Lp)
    singles, pairs, lam = draw_weights(J, cfg, conf, seed, dev)
    params = J.Params(singles, pairs, lam)
    B, ncmp = mix["batch"], mix["compare_steps"]
    tr = TRN.Trainer(cfg, params, max_iter=1 << 40,
                     lambda_init=conf["lambda_init"],
                     kmer_shuf=conf["kmer_shuf"], batch_size=B, device=dev)
    tr.set_fq(fq)
    # the positives' masks, by the trainer's own path, a batch at a time
    rows = [(r.seq, r.qual) for r in FastqReader(fq).reads()]
    for k in range(0, len(rows), B):
        chunk = rows[k:k + B]
        cfg_b = tr._bucket_cfg(chunk, [])
        OBJ.device_batch(cfg_b, OBJ.host_rows(cfg_b, chunk),
                         bp_cache=tr._bp_cache, device=dev)

    state = dict(n=0, starts=[], xs=[], fns=[], grs=[], t0=None, end=None,
                 bad=0)
    spans = TR.Spans(dev, enabled=False)
    prof = TR.Profiled(dev, TRAIN_SPANS)
    n_settle, n_prof = mix["settle_steps"], mix["profile_steps"]
    # a traced window holds some span-timed steps past the profiled ones
    min_units = n_settle + n_prof + TIMED_UNITS if traced else 0
    orig_objective = tr._objective
    batches = []

    def objective(x, it):
        t = time.perf_counter()
        n = state["n"] = state["n"] + 1
        if n <= ncmp + 1:
            state["xs"].append(np.array(x, np.float64))
        if n == ncmp + 1:
            _sync(dev)
            t = time.perf_counter()
            state["t0"] = t
        elif n > ncmp + 1 + min_units and t - state["t0"] >= seconds:
            state["end"] = t
            raise WindowDone
        if traced and n > ncmp:
            k = n - ncmp - 1           # window step index
            if k == n_settle:
                prof.start()
                spans.labels = True
            elif k == n_settle + n_prof:
                prof.stop()
                spans.labels, spans.enabled = False, True
            if n_settle <= k < n_settle + n_prof:
                batches.append(it)
        state["starts"].append(t)
        fn, gr = orig_objective(x, it)
        if n <= ncmp:
            state["fns"].append(float(fn))
            state["grs"].append(np.array(gr, np.float64))
        elif not math.isfinite(float(fn)):
            state["bad"] += 1
        return fn, gr

    tr._objective = spans.wrap("objective", objective)
    tr._read_batch_host = spans.wrap("negatives", tr._read_batch_host)
    saved = {}
    if traced:
        for name, key in (("stack_reads", "stack"), ("batch_bp_masks",
                                                     "masks"),
                          ("batch_fn_grad_pr", "fn_grad"),
                          ("reduce_per_read", "reduce")):
            saved[name] = getattr(OBJ, name)
            setattr(OBJ, name, spans.wrap(key, saved[name]))
    try:
        tr.train()
        raise RuntimeError("the trainer stopped before the window ended")
    except WindowDone:
        pass
    finally:
        for name, f in saved.items():
            setattr(OBJ, name, f)
        prof.stop()
    starts = np.asarray(state["starts"][ncmp:])
    walls = np.diff(np.append(starts, state["end"]))
    out = dict(setup_s=state["t0"] - t_start,
               window_s=state["end"] - state["t0"],
               walls=walls, units=len(walls), attempted=len(walls) * B,
               failed=state["bad"] * B, memory_peak_bytes=TR.memory_peak(dev),
               program=dict(x=state["xs"], fn=state["fns"], gr=state["grs"],
                            fq=fq, cfg=cfg, singles=singles, pairs=pairs,
                            lambda_init=conf["lambda_init"]))
    if not all(math.isfinite(f) for f in state["fns"]):
        out["failed"] += B
    if traced:
        # the rows of the profiled steps: the reader's order per epoch
        # and the negatives' iteration numbers, for the work counts
        out.update(spans=spans.times, profile=prof.result(len(batches)),
                   batches=_epoch_rows(fq, B, batches))
    return out


def _epoch_rows(fq, B, iters):
    """The positives of the trainer's steps ``iters`` (0-based): the
    FastqBatchReader's order, each epoch reshuffled."""
    from .reference.io.fastq import FastqBatchReader
    qr = FastqBatchReader(fq)
    qr.set_batch_size(B)
    out, it = [], 0
    while iters and it <= max(iters):
        if qr.N() - qr.orig().cnt() < qr.N_batch():
            qr.skip(qr.N() - qr.orig().cnt())
        qr.clear()
        rows = []
        while not qr.is_end():
            r = qr.get_read()
            rows.append((r.seq, r.qual))
        if it in iters:
            out.append((it, rows))
        it += 1
    return out


# ---------------------------------------------------------------- scan

def run_scan(conf, mix, seed, seconds, traced, dev, tmp, t_start):
    """Scanner.scan of one FASTQ of the mix's reads per call, the records
    to a file: set-up builds the scanner and scans a file of one read of
    each length bucket; the window calls scan until the first call that
    ends ``seconds`` after its start."""
    from rnaelem_tpu_torch.model import joint as J
    from rnaelem_tpu_torch.scan import cyk as CYK
    from rnaelem_tpu_torch.scan import driver as SCD
    from rnaelem_tpu_torch.scan import scanner as SC

    seqs = gen.reads(mix, seed)
    fq = os.path.join(tmp, "reads.fq")
    gen.write_fastq(fq, seqs, mix["quality"], mix["flagged"])
    Lp = round_up(max(len(s) for s in seqs))
    cfg = model_config(J, conf, Lp)
    singles, pairs, lam = draw_weights(J, cfg, conf, seed, dev)
    sc = SCD.Scanner(cfg, J.Params(singles, pairs, lam), device=dev)
    # warm-up: one read of each bucket
    first = {}
    for s in seqs:
        first.setdefault(round_up(len(s)), s)
    warm = os.path.join(tmp, "warm.fq")
    gen.write_fastq(warm, list(first.values()), mix["quality"],
                    mix["flagged"])
    sc.scan(warm, io.StringIO(), log=io.StringIO())

    # what each call's chunks produced, for the comparison (the last
    # call's alone is kept)
    last = {}
    run0 = sc._run

    def run(fq_path, mark):
        out = run0(fq_path, mark)
        last["run"] = out
        return out

    sc._run = run
    chunks = []
    posteriors0 = SC.scan_posteriors_batch

    def posteriors(cfg_, params_, sd_b, *a, **kw):
        res = posteriors0(cfg_, params_, sd_b, *a, **kw)
        chunks.append((cfg_.Lp, [int(x) for x in J._np(sd_b.L)],
                       res["EN"]))
        return res

    spans = TR.Spans(dev, enabled=False)
    prof = TR.Profiled(dev, SCAN_SPANS)
    cyk0 = CYK.cyk_batch
    SC.scan_posteriors_batch = spans.wrap("posteriors", posteriors)
    CYK.cyk_batch = spans.wrap("cyk", cyk0)
    n_settle, n_prof = mix["settle_calls"], mix["profile_calls"]
    out_path = os.path.join(tmp, "records.raw")
    _sync(dev)
    t0 = time.perf_counter()
    walls, k, missing = [], 0, 0
    try:
        while True:
            if traced and k == n_settle:
                prof.start()
                spans.labels = True
            if traced and k == n_settle + n_prof:
                prof.stop()
                spans.labels, spans.enabled = False, True
            chunks.clear()
            ta = time.perf_counter()
            with open(out_path, "w") as f:
                sc.scan(fq, f, log=io.StringIO(),
                        mark=spans.mark if spans.enabled else None)
            _sync(dev)
            tb = time.perf_counter()
            walls.append(tb - ta)
            spans.add("call", tb - ta)
            missing += len(seqs) - _count_records(out_path)
            k += 1
            if tb - t0 >= seconds and (
                    not traced or k >= n_settle + n_prof + 1):
                break
    finally:
        SC.scan_posteriors_batch = posteriors0
        CYK.cyk_batch = cyk0
        prof.stop()
    reads, results, EN, _ = last["run"]
    out = dict(setup_s=t0 - t_start, window_s=tb - t0,
               walls=np.asarray(walls), units=len(walls),
               attempted=len(walls) * len(seqs),
               failed=missing,
               memory_peak_bytes=TR.memory_peak(dev),
               program=dict(reads=[(r.seq, r.qual) for r in reads],
                            results=results, chunks=list(chunks),
                            records=out_path, fq=fq, cfg=cfg,
                            singles=singles,
                            pairs=pairs, lam=lam))
    if traced:
        out.update(spans=spans.times, profile=prof.result(n_prof),
                   batches=[(r.seq, r.qual) for r in reads],
                   chunks_per_call=len(chunks))
    return out


def _count_records(path):
    n = 0
    with open(path) as f:
        for line in f:
            if line.startswith("id: "):
                n += 1
    return n


DRIVERS = {"adam": run_adam, "scan": run_scan}
