"""Frozen copy of rnaelem_tpu_torch/train/objective.py for the benchmark's plain
reference (portbench/reference): plain PyTorch and numpy only, the
CUDA kernel branches removed, imports kept inside this copy.

Training objective: the discriminative EM function value (PyTorch).

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
(the trainer's step) and ``batch_fn_grad`` on the device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import device as DEV
from ..model import joint as J
from ..ops import dp as DP
from ..ops.semiring import lse_weights


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


def _ends(batch: BatchData, lik_ratio: bool):
    """The objective as a pass's end forms it (ops/dp.Ends, K19)."""
    return DP.Ends("objective", lik_ratio, batch.restrict_ari,
                   batch.lik_sign, batch.is_neg, batch.valid, batch.eff)


def _softplus(y):
    """log(1 + e^y) = max(y, 0) + log1p(e^-|y|): no overflow, and a
    finite derivative everywhere autograd takes one."""
    return torch.clamp(y, min=0) + torch.log1p(torch.exp(-torch.abs(y)))


def _objective_terms(parts, ends):
    """(f, ok & valid, d f / d parts [B, 3]) of the per-read objective
    (motif_trainer.hpp:156-245) under ``ends`` (mode "objective"): z_all
    = lse(parts), z_ari = lse(parts[:, 1:]), z_nasi = parts[:, 0].  The
    differences of two lse that nearly cancel are taken as
    softplus(+-(parts0 - z_ari)) and their gradients as products of the
    softmax weights (w_ari,k - w_all,k = w_ari,k w_all,0), each a few
    roundings from exact."""
    dev = parts.device
    z_all, wa = lse_weights(parts, torch.ones(3, dtype=torch.bool,
                                              device=dev))
    z_ari, wr = lse_weights(parts, torch.as_tensor([False, True, True],
                                                   device=dev))
    fin_all, fin_ari = torch.isfinite(z_all), torch.isfinite(z_ari)
    # parts0 - z_ari, 0 where both are -inf (no finite term: f is masked)
    x = torch.where(fin_all, parts[:, 0] - z_ari, torch.zeros_like(z_all))
    # d (z_all - z_ari) / d parts, times sg
    ari_w = lambda sg: torch.stack([sg * wa[:, 0],
                                    -(sg * (wa[:, 0] * wr[:, 1])),
                                    -(sg * (wa[:, 0] * wr[:, 2]))], dim=1)
    if ends.lik_ratio:
        sg = -ends.lik_sign
        return sg * _softplus(x), fin_all & fin_ari & ends.valid, ari_w(sg)
    ari = ends.restrict_ari
    f = torch.where(ari, _softplus(x), _softplus(-x))
    ok = fin_all & (ends.is_neg | fin_ari) & ends.valid
    nasi_w = torch.stack([-(wa[:, 1] + wa[:, 2]), wa[:, 1], wa[:, 2]], dim=1)
    return f, ok, torch.where(ari[:, None], ari_w(1.0), nasi_w)


def objective_plain(parts, ends):
    """K19's plain twin in mode "objective": the per-read terms (f [B],
    eff [B]) of the parts [B, 3], 0 where a read does not count."""
    f, ok, _ = _objective_terms(parts, ends)
    zero = torch.zeros_like(f)
    eff = torch.where(ends.valid & ~ends.is_neg, ends.eff.to(f.dtype), zero)
    return torch.where(ok, f, zero), eff


def objective_weights(parts, ends):
    """K19's plain twin's adjoint in mode "objective": d f / d parts [B,
    3], 0 where a read does not count."""
    _, ok, w = _objective_terms(parts, ends)
    return torch.where(ok[:, None], w, torch.zeros_like(w))


def batch_fn_grad_pr(cfg: J.ModelConfig, params: J.Params,
                     batch: BatchData, lik_ratio: bool = False, device=None):
    """(f [B], per-read gradients as Params with a leading read axis,
    eff [B]).

    The weights enter as per-read copies (per_read's views of shared
    weights, B x [n, 4|6] and B x [2]), so d f_b / d weights of read b is
    the gradient of its own copy: the one-hot contractions of the factors
    and the outside pass's lambda terms keep the read axis, and the
    gradient is taken at the copies (seeded with ones, the cotangent of
    each read's f).  The DP kernels take one shared lambda (the copies
    are one value)."""
    B = batch.valid.shape[0]
    leaves = J.per_read(J.Params(*[x.detach().requires_grad_(True)
                                   for x in params]), B)
    with torch.enable_grad():
        _, f, eff = J.batch_ends_pr(cfg, leaves, batch.sd, batch.bp_ok,
                                    device=device,
                                    ends=_ends(batch, lik_ratio))
        gr = torch.autograd.grad(f, list(leaves), torch.ones_like(f),
                                 allow_unused=True)
    grads = J.Params(*[torch.zeros(x.shape, dtype=x.dtype, device=x.device)
                       if g is None else g for x, g in zip(leaves, gr)])
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
