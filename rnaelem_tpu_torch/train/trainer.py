"""Training driver: minibatch EM with shuffled negatives (PyTorch).

Replicates RNAelemTrainer (motif_trainer.hpp:461-634): Adam over
minibatches with per-read deterministic shuffled negatives (default), or
L-BFGS-B full-batch without negatives (--no-shuffle); bounds clip lambda
at 0, L2 regularization with per-block rho; an interim model snapshot is
written at every epoch boundary; "considered BP" (mean bpp_eff) is logged
on the first evaluation.

Each evaluation is one batch of per-read values and gradients on the
device (objective.batch_fn_grad_pr) reduced in read order on the host
(objective.reduce_per_read), so the sum does not depend on how the batch
was laid out.  With a data-parallel ``group`` (parallel/mesh.py) every
rank draws the same batch, evaluates its own shard of rows and gathers
the others' per-read values before the same reduction; with an
``array_eval`` (parallel/arrayjob.py, the reference's TR_ARRAY file
protocol) every evaluation goes to the array's slaves instead.  Batches
are built when they are needed, in the order the JAX package's trainer
builds them, with no prefetch thread.
"""
from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from .. import device as DEV
from ..alphabet import ints_to_seq, seq_to_ints
from ..io.fastq import FastqBatchReader
from ..model import io as MIO
from ..model import joint as J
from ..pipeline.ushuffle import negative_for
from . import objective as OBJ
from .optim import Adam, Lbfgsb


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class Trainer:
    """Trains ``params`` (a Params on ``device``; None means CUDA; with a
    ``group``, on the group's device) on the FASTQ file given to
    ``set_fq``."""

    def __init__(self, cfg: J.ModelConfig, params: J.Params,
                 max_iter: int = 100, eps: float = 1e-5,
                 lambda_init: float = 0.0, kmer_shuf: int = 2,
                 batch_size: int = 100, no_shuffle: bool = False,
                 lik_ratio: bool = False, interim_out=None,
                 mask_indices=None, device=None, group=None,
                 array_eval=None):
        # a group fixes the device: each rank evaluates on its own card
        self.device = group.device if group is not None \
            else DEV.resolve(device)
        self.cfg = cfg
        self.params = params
        self.g = J.kernels(cfg, self.device).g
        self.max_iter = max_iter
        self.eps = eps
        self.lambda_init = lambda_init
        self.kmer_shuf = kmer_shuf
        self.batch_size = batch_size
        self.no_shuffle = no_shuffle
        self.lik_ratio = lik_ratio
        self.interim_out = interim_out
        self.mask_indices = mask_indices  # TR_MASK (motif_mask_trainer)
        self.group = group
        self._group_steps = {}   # per length bucket: the sharded step
        self.array_eval = array_eval
        # every rank trains the same numbers; rank 0 alone writes
        self._writer = group is None or group.rank == 0
        self.qr = FastqBatchReader()
        self._bp_cache = OBJ.BpMaskCache()
        self._eval_cnt = 0
        self._eff_logged = False

    def _bucket_cfg(self, reads, negs):
        """Length-bucketed config for this minibatch: pad to the next
        32-multiple instead of the file max.  A bucket is a config of its
        own (its DP index lists); the CUDA library is built once."""
        Lmax = max(max((len(s) for s, _ in reads), default=1),
                   max((len(s) for s in negs), default=1))
        Lp = min(self.cfg.Lp, max(32, ((Lmax + 31) // 32) * 32))
        return self.cfg if Lp == self.cfg.Lp \
            else dataclasses.replace(self.cfg, Lp=Lp)

    def _funcs_for(self, cfg):
        """The group's sharded step for one bucket config (it stacks,
        masks and evaluates this rank's rows), built once per bucket."""
        if cfg not in self._group_steps:
            from ..parallel import mesh as MESH
            self._group_steps[cfg] = MESH.make_sharded_per_read(
                cfg, self.group, self.lik_ratio)
        return self._group_steps[cfg]

    def set_fq(self, path: str):
        self.qr.open(path)
        self.qr.set_batch_size(self.batch_size)

    def _bounds_reg(self, nparam):
        lower = np.full(nparam, -np.inf)
        upper = np.full(nparam, np.inf)
        lower[-2:] = 0.0  # lambda >= 0 (motif_trainer.hpp:508-526)
        rho = np.full(
            nparam - 2,
            self.cfg.rho_s if self.cfg.theta_softmax
            else self.cfg.rho_theta)
        rho = np.concatenate([rho, [self.cfg.rho_lambda] * 2])
        rtype = np.full(nparam, 2)  # L2
        if self.mask_indices is not None:
            # freeze all but chosen indices: collapse bounds, zero reg
            # (motif_mask_trainer.hpp:36-103)
            keep = np.zeros(nparam, bool)
            keep[np.asarray(self.mask_indices)] = True
            x0 = J.pack_params(self.g, self.params)
            lower = np.where(keep, lower, x0)
            upper = np.where(keep, upper, x0)
            rho = np.where(keep[:len(rho)], rho[:len(rho)], 0.0)
        return lower, upper, rtype, rho

    def _read_batch_host(self, iter_cnt):
        """Advance the reader one minibatch and draw the iter-keyed
        negatives (motif_trainer.hpp:595-633)."""
        qr = self.qr
        if qr.N() - qr.orig().cnt() < qr.N_batch():
            qr.skip(qr.N() - qr.orig().cnt())
        epoch_end = qr.is_end_epoc()
        qr.clear()
        reads, negs = [], []
        while not qr.is_end():
            r = qr.get_read()
            if len(r.seq) + 1 != len(r.qual):
                raise ValueError(f"bad seq format. {r.id}")
            reads.append((r.seq, r.qual))
            if not self.no_shuffle:
                negs.append(seq_to_ints(negative_for(
                    ints_to_seq(r.seq), self.kmer_shuf, iter_cnt)))
        return dict(epoch_end=epoch_end, reads=reads, negs=negs)

    def _interim(self):
        if self.interim_out is not None and self._writer:
            self.interim_out.write(
                MIO.interim_line(self.cfg, self.params) + "\n")
            self.interim_out.flush()

    def _objective_array(self, x):
        """One distributed fn/gr evaluation through the file-based array
        protocol (motif_trainer.hpp:608-614): broadcast = model snapshot
        file, all-reduce = parse-and-sum of slave files.  The snapshot
        rides the same 6-significant-digit model writer the reference
        broadcasts with, its per-step quantization included."""
        self.params = J.unpack_params(self.g, x, self.params)
        self._interim()
        fn, gr, eff = self.array_eval(self.params)
        if not self._eff_logged:
            log("considered BP (sum eff):", eff)
            self._eff_logged = True
        self._eval_cnt += 1
        return fn, np.asarray(gr)

    def _objective(self, x, iter_cnt):
        """One fn/gr evaluation over the next minibatch
        (motif_trainer.hpp:595-633)."""
        if self.array_eval is not None:
            return self._objective_array(x)
        self.params = J.unpack_params(self.g, x, self.params)
        got = self._read_batch_host(iter_cnt)
        if got["epoch_end"]:
            self._interim()
        cfg_b = self._bucket_cfg(got["reads"], got["negs"])
        negs = None if self.no_shuffle else got["negs"]
        if self.group is None:
            batch = OBJ.stack_reads(cfg_b, got["reads"], negs,
                                    bp_cache=self._bp_cache,
                                    device=self.device)
            f_b, gr_b, eff_b = OBJ.batch_fn_grad_pr(
                cfg_b, self.params, batch, self.lik_ratio, self.device)
        else:
            f_b, gr_b, eff_b = self._funcs_for(cfg_b)(
                self.params, OBJ.host_rows(cfg_b, got["reads"], negs),
                self._bp_cache)
        fn, grads, eff = OBJ.reduce_per_read(f_b, gr_b, eff_b)
        gr = J.pack_params(self.g, grads)
        if not self._eff_logged:
            log("considered BP:", float(eff) / max(1, len(got["reads"])))
            self._eff_logged = True
        self._eval_cnt += 1
        return fn, gr

    def train(self) -> J.Params:
        self.params = self.params._replace(
            lam=torch.full_like(self.params.lam, self.lambda_init))
        x0 = J.pack_params(self.g, self.params)
        lower, upper, rtype, rho = self._bounds_reg(len(x0))
        t0 = time.time()
        if self.no_shuffle:
            opt = Lbfgsb(maxiter=self.max_iter - 1, eps=self.eps)
            opt.set_bounds(lower, upper)
            opt.set_regularization(rtype, rho)
            best = opt.minimize(self._objective, x0)
        else:
            opt = Adam(alpha=0.1)
            opt.set_bounds(lower, upper)
            opt.set_regularization(rtype, rho)

            def cb(t, x, y, gr):
                log(f"iter: {t - 1} , y: {y} , |gr|: {(gr * gr).sum()}"
                    f" , p|x|: {opt.rgl_term(x)}")

            best = opt.minimize(self._objective, x0, self.max_iter,
                                callback=cb)
        self.params = J.unpack_params(self.g, best, self.params)
        if self._eval_cnt:
            log("wall clock time per eval:",
                (time.time() - t0) / self._eval_cnt)
        return self.params
