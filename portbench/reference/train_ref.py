"""The plain reference of an Adam training cell: the first steps of the
port's ``Trainer`` (Adam minibatch mode) worked out again from the same
inputs, the FASTQ file and the starting weights: the reads in the
reader's first-epoch order, the shuffled negatives (``shuffle``), the
min-BPP masks, the per-read objective and gradients (the plain DP), the
read-order reduction and the Adam update with the trainer's bounds and
regularization."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .alphabet import ints_to_seq, seq_to_ints
from .io.fastq import FastqReader
from .model import joint as J
from .shuffle import negative_for
from .train import objective as OBJ
from .train.optim import Adam


def bounds_reg(cfg: J.ModelConfig, nparam: int):
    """Trainer._bounds_reg without a parameter mask: lambda >= 0, L2 with
    rho_theta (rho_s under theta_softmax) and rho_lambda."""
    lower = np.full(nparam, -np.inf)
    upper = np.full(nparam, np.inf)
    lower[-2:] = 0.0
    rho = np.full(nparam - 2, cfg.rho_s if cfg.theta_softmax
                  else cfg.rho_theta)
    rho = np.concatenate([rho, [cfg.rho_lambda] * 2])
    return lower, upper, np.full(nparam, 2), rho


def bucket_cfg(cfg: J.ModelConfig, reads, negs):
    """Trainer._bucket_cfg: pad to the next multiple of 32 of the batch's
    longest row (at least 32, at most cfg.Lp)."""
    Lmax = max(max((len(s) for s, _ in reads), default=1),
               max((len(s) for s in negs), default=1))
    Lp = min(cfg.Lp, max(32, ((Lmax + 31) // 32) * 32))
    return cfg if Lp == cfg.Lp else dataclasses.replace(cfg, Lp=Lp)


def follow(cfg: J.ModelConfig, fq_path: str, singles, pairs, steps: int,
           batch: int, kmer: int, device, lambda_init: float = 0.0):
    """The first ``steps`` Adam steps of a Trainer over ``fq_path`` from
    the weights (singles, pairs) with lambda at ``lambda_init``, computed
    in ``cfg.dtype`` on ``device``.  Returns {"x0", "fn" [steps], "gr"
    [steps] (the packed gradient the optimizer gets, before the
    regularization), "x" (after the steps), "tables"} with the packed
    vectors in the reference's parameter order; the first epoch reads
    the file in order, so ``steps`` * ``batch`` must not exceed its
    reads."""
    qr = FastqReader(fq_path)
    reads = [(r.seq, r.qual) for r in qr.reads()]
    if steps * batch > len(reads):
        raise ValueError("the reference follows the first epoch only")
    g = J.kernels(cfg, device).g
    dt = J.kernels(cfg, device).dtype
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    p0 = J.Params(singles=as_t(singles), pairs=as_t(pairs),
                  lam=torch.full((2,), lambda_init, dtype=dt, device=device))
    x0 = J.pack_params(g, p0)
    out = {"x0": x0.copy(), "fn": [], "gr": []}

    steps_rows = []
    for it in range(steps):
        rows = reads[it * batch:(it + 1) * batch]
        negs = [seq_to_ints(negative_for(ints_to_seq(s), kmer, it))
                for s, _ in rows]
        steps_rows.append((bucket_cfg(cfg, rows, negs), rows, negs))
    masks = step_masks(steps_rows, device)

    def objective(x, it):
        params = J.unpack_params(g, x, p0)
        cfg_b, rows, negs = steps_rows[it]
        b = OBJ.stack_reads(cfg_b, rows, negs, device=device,
                            bp_fn=masks.lookup)
        f_b, gr_b, eff_b = OBJ.batch_fn_grad_pr(cfg_b, params, b,
                                                device=device)
        fn, grads, _ = OBJ.reduce_per_read(f_b, gr_b, eff_b)
        gr = J.pack_params(g, grads)
        out["fn"].append(fn)
        out["gr"].append(np.array(gr, np.float64))
        return fn, gr

    opt = Adam(alpha=0.1)
    lower, upper, rtype, rho = bounds_reg(cfg, len(x0))
    opt.set_bounds(lower, upper)
    opt.set_regularization(rtype, rho)
    out["x"] = np.array(opt.minimize(objective, x0, steps), np.float64)
    out["tables"] = table_slices(g)
    return out


class _Masks:
    """Min-BPP masks computed once for many rows, looked up by a row's
    padded codes (a read's mask does not depend on its batch)."""

    def __init__(self):
        self.d = {}

    def lookup(self, cfg, sd, device):
        keys = [bytes(r) for r in J._np(sd.seq).astype(np.int32)]
        bp = np.stack([self.d[(cfg.Lp, k)][0] for k in keys])
        eff = np.asarray([self.d[(cfg.Lp, k)][1] for k in keys])
        return torch.as_tensor(bp, device=device), torch.as_tensor(
            eff, device=device)


def step_masks(steps_rows, device):
    """The masks of every row of the given steps, one pass per bucket."""
    out = _Masks()
    by = {}
    for cfg_b, rows, negs in steps_rows:
        sds = by.setdefault(cfg_b, {})
        for seq, qual in rows:
            sd = J.make_seqdata(cfg_b, seq, qual)
            sds[bytes(sd.seq.astype(np.int32))] = sd
        for seq in negs:
            sd = J.make_seqdata(cfg_b, seq, np.zeros(len(seq) + 1, np.int64))
            sds[bytes(sd.seq.astype(np.int32))] = sd
    for cfg_b, sds in by.items():
        keys = list(sds)
        bp, eff = J.effective_bp_mask_batch(
            cfg_b, J.stack_seqdata([sds[k] for k in keys], device), device)
        bp, eff = J._np(bp), J._np(eff)
        for t, k in enumerate(keys):
            out.d[(cfg_b.Lp, k)] = (bp[t], float(eff[t]))
    return out


def table_slices(g):
    """{leaf: index array into the packed vector}: the singles, the pairs
    and lambda, the weights' three tensors."""
    idx = {"singles": [], "pairs": [], "lam": []}
    k = 0
    for sz in g.table_sizes:
        idx["pairs" if sz == 6 else "singles"].extend(range(k, k + sz))
        k += sz
    idx["lam"] = [k, k + 1]
    return {n: np.asarray(v, np.int64) for n, v in idx.items() if v}
