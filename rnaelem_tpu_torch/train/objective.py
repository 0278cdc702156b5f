"""Training objective: the discriminative EM function value (PyTorch).

Replicates the function half of RNAelemTrainDP::operator()
(motif_trainer.hpp:124-272):

* default mode: f += Z(all) - Z(label-restricted); positives (has-motif
  sentinel) restrict to motif-present (ari), negatives/unflagged restrict
  to motif-absent (nasi);
* lik-ratio mode (TR_LIK_RATIO): f += +-(Z(motif) - Z(all)) with sign -1
  for flagged positives;
* reads whose partition functions are non-finite contribute nothing
  (motif_trainer.hpp:211-214).

``batch_fn_grad_pr`` adds the gradient, per read (through the DP's
outside pass); ``reduce_per_read`` sums it in read order on the host
(the trainer's step) and ``batch_fn_grad`` on the device; ``eval_file``
evaluates a whole FASTQ file (motif_eval.hpp:23-54).
"""
from __future__ import annotations

import os
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from .. import device as DEV
from ..model import joint as J
from ..ops.semiring import NEG, lse


class BatchData(NamedTuple):
    sd: J.SeqData               # fields stacked, leading batch axis
    restrict_ari: torch.Tensor  # [B] bool: restriction is motif-present
    lik_sign: torch.Tensor      # [B] +-1.0 for lik-ratio mode
    is_neg: torch.Tensor        # [B] bool: shuffled negative (weaker skip
    #                             check, motif_trainer.hpp:236)
    valid: torch.Tensor         # [B] bool (padding rows in a batch)
    bp_ok: torch.Tensor         # [B, Lp+1, Wp+1] pair masks, computed
    #                             once per sequence (parameter-free)
    eff: torch.Tensor           # [B] bpp_eff per read


class BpMaskCache:
    """Bounded LRU for pair masks keyed by (Lp, seq bytes); entries are
    evicted least-recently-used once the byte total exceeds the cap
    (default 256 MB, RNAELEM_BP_CACHE_MB)."""

    def __init__(self, max_bytes: int = None):
        if max_bytes is None:
            max_bytes = int(os.environ.get(
                "RNAELEM_BP_CACHE_MB", "256")) << 20
        self.max_bytes = max_bytes
        self._d = OrderedDict()
        self._bytes = 0

    @staticmethod
    def _size(v):
        bp, _ = v
        return bp.nbytes + 64

    def __contains__(self, k):
        return k in self._d

    def __len__(self):
        return len(self._d)

    def __getitem__(self, k):
        self._d.move_to_end(k)
        return self._d[k]

    def __setitem__(self, k, v):
        if k in self._d:
            self._bytes -= self._size(self._d[k])
        self._d[k] = v
        self._d.move_to_end(k)
        self._bytes += self._size(v)
        while self._bytes > self.max_bytes and len(self._d) > 1:
            _, old = self._d.popitem(last=False)
            self._bytes -= self._size(old)


def batch_bp_masks(cfg: J.ModelConfig, sd_batch, device=None):
    """Pair masks and bpp_eff for a stacked SeqData batch."""
    return J.effective_bp_mask_batch(cfg, sd_batch, device)


class HostRows(NamedTuple):
    """The host half of a batch, one entry per row (reads, then
    negatives): what stack_reads packs before anything goes to a device.
    Every rank of a data-parallel group builds the same rows and moves
    only its own shard of them (parallel/mesh.py)."""
    sds: list           # per-row J.SeqData (numpy)
    restrict_ari: list  # bool: restriction is motif-present
    lik_sign: list      # +-1.0 for lik-ratio mode (0.0 on padding rows)
    is_neg: list        # bool: shuffled negative
    valid: list         # bool: False on padding rows
    keys: list          # mask cache key (Lp, sequence bytes) or None


def host_rows(cfg: J.ModelConfig, reads, negatives=None) -> HostRows:
    """Pack reads (+ optional shuffled negatives) into per-row host
    arrays.

    reads: list of (seq_codes, quals) tuples. negatives: list of
    seq_codes (quality all zero, restricted to motif-absent,
    motif_trainer.hpp:228-245).  Only reads get a mask cache key: a
    negative is drawn afresh every iteration."""
    rows = HostRows([], [], [], [], [], [])
    for seq, quals in reads:
        sd = J.make_seqdata(cfg, seq, quals)
        _append(rows, sd, bool(sd.has_motif),
                -1.0 if bool(sd.has_motif) else 1.0, False, True,
                (cfg.Lp, np.asarray(seq).tobytes()))
    for seq in negatives or []:
        q = np.zeros(len(seq) + 1, np.int64)
        _append(rows, J.make_seqdata(cfg, seq, q), False, 1.0, True, True,
                None)
    return rows


def _append(rows: HostRows, *entry):
    for field, x in zip(rows, entry):
        field.append(x)


def device_batch(cfg: J.ModelConfig, rows: HostRows, bp_cache=None,
                 bp_fn=None, device=None) -> BatchData:
    """Stack host rows into a batch on ``device`` and add their pair
    masks.  bp_cache (optional, mutated): maps (Lp, sequence bytes) ->
    (bp_ok, eff) numpy; masks are parameter-independent so positives
    need them computed only once.  Padding rows (valid False) get empty
    masks and eff 0, and no mask pass."""
    dev = DEV.resolve(device)
    sd = J.stack_seqdata(rows.sds, dev)
    if bp_fn is None:
        bp_fn = batch_bp_masks

    if bp_cache is None and all(rows.valid):
        bp_ok, eff = (torch.as_tensor(x, device=dev)
                      for x in bp_fn(cfg, sd, dev))
    else:
        cache = {} if bp_cache is None else bp_cache
        keys = rows.keys
        miss = [i for i, k in enumerate(keys) if rows.valid[i]
                and (k is None or k not in cache)]
        Lp, Wp = cfg.Lp, cfg.Wp
        bp_np = np.zeros((len(keys), Lp + 1, Wp + 1), bool)
        eff_np = np.zeros(len(keys))
        if miss:
            mb, me = bp_fn(cfg, J.stack_seqdata([rows.sds[i] for i in miss],
                                                dev), dev)
            mb, me = J._np(mb), J._np(me)
            for t, i in enumerate(miss):
                bp_np[i], eff_np[i] = mb[t], me[t]
                if keys[i] is not None and bp_cache is not None:
                    bp_cache[keys[i]] = (mb[t], float(me[t]))
        for i, k in enumerate(keys):
            if k is not None and k in cache and i not in miss:
                bp_np[i], eff_np[i] = cache[k]
        bp_ok = torch.as_tensor(bp_np, device=dev)
        eff = torch.as_tensor(eff_np, device=dev)

    dt = DEV.torch_dtype(cfg.dtype)
    return BatchData(
        sd=sd,
        restrict_ari=torch.as_tensor(rows.restrict_ari, device=dev),
        lik_sign=torch.as_tensor(rows.lik_sign, dtype=dt, device=dev),
        is_neg=torch.as_tensor(rows.is_neg, device=dev),
        valid=torch.as_tensor(rows.valid, device=dev),
        bp_ok=bp_ok,
        eff=eff.to(dt),
    )


def stack_reads(cfg: J.ModelConfig, reads, negatives=None,
                bp_cache=None, bp_fn=None, device=None) -> BatchData:
    """Pack reads (+ optional shuffled negatives) into a batch on
    ``device``: ``host_rows`` then ``device_batch``."""
    return device_batch(cfg, host_rows(cfg, reads, negatives), bp_cache,
                        bp_fn, device)


def _per_read_terms(cfg, parts, batch: BatchData, lik_ratio: bool):
    """Per-read objective terms f[B] / eff[B] (motif_trainer.hpp:156-245)."""
    z_all = lse(parts, axis=-1)
    sel = torch.as_tensor([False, True, True], device=parts.device)[None]
    z_ari = lse(torch.where(sel, parts, torch.full_like(parts, NEG)),
                axis=-1)
    z_nasi = parts[:, 0]
    if lik_ratio:
        f = batch.lik_sign * (z_ari - z_all)
        ok = torch.isfinite(z_all) & torch.isfinite(z_ari)
    else:
        z_restr = torch.where(batch.restrict_ari, z_ari, z_nasi)
        f = z_all - z_restr
        ok = torch.isfinite(z_all) & (batch.is_neg | torch.isfinite(z_ari))
    zero = torch.zeros_like(f)
    f = torch.where(ok & batch.valid, f, zero)
    eff = torch.where(batch.valid & ~batch.is_neg, batch.eff.to(f.dtype),
                      zero)
    return f, eff


def batch_total(cfg: J.ModelConfig, params: J.Params, batch: BatchData,
                lik_ratio: bool = False, device=None):
    """(sum f, sum eff) over the batch through the batched DP."""
    parts = J.batch_logZ_parts(cfg, params, batch.sd, batch.bp_ok,
                               device=device)
    f, eff = _per_read_terms(cfg, parts, batch, lik_ratio)
    return f.sum(), eff.sum()


def batch_fn_grad_pr(cfg: J.ModelConfig, params: J.Params,
                     batch: BatchData, lik_ratio: bool = False, device=None):
    """(f [B], per-read gradients as Params with a leading read axis,
    eff [B]).

    The weights enter as per-read copies (a few KB of tables, B x
    [n, 4|6] and B x [2]), so d f_b / d weights of read b is the
    gradient of its own copy: the one-hot contractions of the factors
    and the outside pass's lambda terms keep the read axis.  The DP
    kernels themselves take one shared lambda (the copies are equal)."""
    B = batch.valid.shape[0]
    leaves = J.Params(*[x.detach().clone().requires_grad_(True)
                        for x in J.per_read(params, B)])
    with torch.enable_grad():
        parts = J.batch_logZ_parts_pr(cfg, leaves, batch.sd, batch.bp_ok,
                                      device=device)
        f, eff = _per_read_terms(cfg, parts, batch, lik_ratio)
        gr = torch.autograd.grad(f.sum(), list(leaves), allow_unused=True)
    grads = J.Params(*[torch.zeros_like(x) if g is None else g
                       for x, g in zip(leaves, gr)])
    return f.detach(), grads, eff


def batch_fn_grad(cfg: J.ModelConfig, params: J.Params, batch: BatchData,
                  lik_ratio: bool = False, device=None):
    """(fn, grads as Params, sum eff) over a batch: batch_fn_grad_pr
    summed over the reads on the device."""
    f, grads, eff = batch_fn_grad_pr(cfg, params, batch, lik_ratio, device)
    return f.sum(), J.Params(*[g.sum(dim=0) for g in grads]), eff.sum()


def reduce_per_read(f_b, grads_b, eff_b):
    """Read-order reduction on the host (f64 numpy), as the JAX package
    does: the same bits however the batch was split."""
    sum64 = lambda x: np.add.reduce(np.asarray(J._np(x), np.float64),
                                    axis=0)
    return (float(sum64(f_b)), J.Params(*[sum64(x) for x in grads_b]),
            float(sum64(eff_b)))


def assigned_range(N: int, n: int, tid: int):
    """Balanced contiguous slice for distributed eval slaves
    (arrayjob_manager.hpp:143-151); tid is 0-based here."""
    base, rem = divmod(N, n)
    start = tid * base + min(tid, rem)
    return start, start + base + (1 if tid < rem else 0)


def eval_file(cfg: J.ModelConfig, params: J.Params, fq_path: str,
              lik_ratio: bool = False, batch_size: int = 0, shard=None,
              device=None):
    """Full-file fn/gr evaluation (motif_eval.hpp:23-54, no-shuffle).

    shard=(tid, n) restricts to the tid-th of n contiguous slices (the
    array-eval slave path).  Returns (fn, flat_grad, sum_eff) with the
    gradient in the reference's parameter order (pack_params).
    """
    from ..io.fastq import FastqReader
    dev = DEV.resolve(device)
    reads = [(r.seq, r.qual) for r in FastqReader(fq_path).reads()]
    if shard is not None:
        lo, hi = assigned_range(len(reads), shard[1], shard[0])
        reads = reads[lo:hi]
    g = J.kernels(cfg, dev).g
    fn_total, eff_total, acc = 0.0, 0.0, None
    bs = batch_size or len(reads)
    for k in range(0, len(reads), bs):
        batch = stack_reads(cfg, reads[k:k + bs], device=dev)
        fn, grads, eff = batch_fn_grad(cfg, params, batch, lik_ratio, dev)
        fn_total += float(fn)
        eff_total += float(eff)
        acc = grads if acc is None else J.Params(
            *[a + b for a, b in zip(acc, grads)])
    return fn_total, J.pack_params(g, acc), eff_total
