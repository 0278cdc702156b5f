"""Data parallelism over a torch.distributed group (JAX parallel/mesh.py).

The reference's distributed objective evaluation (TR_ARRAY,
motif_trainer.hpp:608-614 + motif_array_trainer.hpp) broadcasts the model
through a file, slices the FASTQ across array tasks and sums fn/gr/eff
from text files.  Here the ranks of a process group take that place, one
device each: the weights are replicated (every rank runs the same
optimizer on the same numbers), the read batch is split.

Every rank holds the whole host batch (objective.host_rows of the shared
FASTQ and the iteration-keyed negatives: identical bytes by
construction), pads it to a multiple of the world size with inert rows
(``pad_batch``) and stacks, uploads and masks only its own contiguous
shard of rows (reads, then negatives, JAX's order).  The per-read outputs
come back through one all-gather of one flat buffer per rank, in rank
order, which rebuilds the global batch order: on the devices under NCCL,
on the host under gloo (gloo has no CUDA all-gather).  The caller sums
them in read order (objective.reduce_per_read), so the trained model is
the same bytes as on one device: the kernels compute each read on its
own, and nothing is reduced across reads on a device.

Under gloo two ranks may share one card (NCCL refuses that); the kernels
still run on the card and only the gathers go through the host.
"""
from __future__ import annotations

import datetime
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .. import device as DEV
from ..model import joint as J
from ..train import objective as OBJ

TIMEOUT_S = 300.0   # a dead peer fails a collective after this long


class DataGroup(NamedTuple):
    """One rank's view of a data-parallel group."""
    rank: int
    world_size: int
    device: torch.device   # this rank's device
    backend: str           # "nccl" or "gloo"
    pg: object             # the torch.distributed process group

    @property
    def gather_device(self) -> torch.device:
        """Where the collectives' buffers live: gloo gathers on the
        host."""
        return self.device if self.backend == "nccl" else \
            torch.device("cpu")

    def close(self):
        dist.destroy_process_group(self.pg)


def _rank_device(device, rank: int) -> torch.device:
    """The rank's device: a CUDA device without an index (or None) means
    card ``rank`` modulo the cards this host has; anything else as
    given."""
    dev = DEV.resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def init_group(coordinator: str, world_size: int, rank: int, device=None,
               backend=None) -> DataGroup:
    """Join the group: ``coordinator`` is a TCP address (host:port, or a
    tcp:// URL) or a file:// store every rank can reach.  NCCL is the
    backend for CUDA devices and gloo for the CPU; ``backend="gloo"``
    with CUDA devices is the way to put two ranks on one card.  Rank 0
    builds the native shuffle and the CUDA kernels before the others load
    them."""
    dev = _rank_device(device, rank)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    url = coordinator if "://" in coordinator else "tcp://" + coordinator
    # NCCL is told its card rather than left to guess it from the rank
    bound = dict(device_id=dev) if backend == "nccl" else {}
    dist.init_process_group(
        backend, init_method=url, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S), **bound)
    group = DataGroup(rank, world_size, dev, backend, dist.group.WORLD)
    if rank == 0:
        from .. import native
        native.lib()
        if dev.type == "cuda":
            from ..ops import kernels
            kernels.lib()
    dist.barrier(group=group.pg)
    return group


# --------------------------------------------------------------- sharding

def pad_batch(rows: OBJ.HostRows, multiple: int) -> OBJ.HostRows:
    """Pad the host rows to a multiple of ``multiple`` with invalid rows
    (masked out of f and grad; L=1 keeps them parseable, as JAX's
    pad_batch does)."""
    n = len(rows.valid)
    npad = (-n) % multiple
    if npad == 0:
        return rows
    s0 = rows.sds[0]
    pad = J.SeqData(seq=np.zeros_like(s0.seq), ws=np.zeros_like(s0.ws),
                    L=np.int32(1), has_motif=np.bool_(False),
                    rss_pair=np.zeros_like(s0.rss_pair),
                    dots=np.zeros_like(s0.dots))
    return OBJ.HostRows(rows.sds + [pad] * npad,
                        rows.restrict_ari + [False] * npad,
                        rows.lik_sign + [0.0] * npad,
                        rows.is_neg + [False] * npad,
                        rows.valid + [False] * npad,
                        rows.keys + [None] * npad)


def _shard(rows: OBJ.HostRows, group: DataGroup) -> OBJ.HostRows:
    """This rank's contiguous shard of the padded rows."""
    rows = pad_batch(rows, group.world_size)
    m = len(rows.valid) // group.world_size
    lo = group.rank * m
    return OBJ.HostRows(*[field[lo:lo + m] for field in rows])


def gather_rows(group: DataGroup, cols):
    """All-gather per-row tensors of this rank's shard (each [m, ...], one
    dtype) in rank order: one flat buffer per rank, one collective.
    Returns the gathered tensors [world_size * m, ...] on the group's
    gather device."""
    m = cols[0].shape[0]
    widths = [int(np.prod(c.shape[1:], dtype=np.int64)) for c in cols]
    buf = torch.cat([c.reshape(m, w) for c, w in zip(cols, widths)], 1)
    buf = buf.to(group.gather_device).contiguous()
    out = torch.empty((group.world_size * m, buf.shape[1]), dtype=buf.dtype,
                      device=buf.device)
    dist.all_gather_into_tensor(out, buf, group=group.pg)
    parts = torch.split(out, widths, 1)
    return [p.reshape((-1,) + tuple(c.shape[1:]))
            for p, c in zip(parts, cols)]


# ------------------------------------------------------------ the steps

def make_sharded_per_read(cfg: J.ModelConfig, group: DataGroup,
                          lik_ratio: bool = False):
    """The production data-parallel training step (JAX mesh.py:126):
    returns step(params, rows, bp_cache=None) -> (f [B], per-read grads
    as Params with a leading read axis, eff [B]) over the host rows of the
    whole batch, gathered on every rank and not reduced: the caller sums
    them in read order (objective.reduce_per_read), which gives the bits
    of the single-device path.  ``params`` lie on the group's device;
    ``bp_cache`` is this rank's mask cache (its own rows only)."""
    def step(params, rows: OBJ.HostRows, bp_cache=None):
        n = len(rows.valid)
        batch = OBJ.device_batch(cfg, _shard(rows, group), bp_cache,
                                 device=group.device)
        f, grads, eff = OBJ.batch_fn_grad_pr(cfg, params, batch, lik_ratio,
                                             group.device)
        out = gather_rows(group, [f, *grads, eff])
        out = [x[:n] for x in out]
        return out[0], J.Params(*out[1:-1]), out[-1]

    return step


def make_sharded_bp_masks(cfg: J.ModelConfig, group: DataGroup):
    """The min-BPP pruning masks data-parallel (JAX mesh.py:160): returns
    run(cfg, sds) -> (keep [n, Lp+1, Wp+1] bool, eff [n]) for a list of
    per-read host SeqData, each rank masking its own shard (the S=1 DP
    and its outside pass), gathered on every rank."""
    dt = DEV.torch_dtype(cfg.dtype)

    def run(cfg_, sds):
        # the step is built for one bucket's cfg; another would give
        # masks of the wrong shape
        if cfg_ != cfg:
            raise ValueError("make_sharded_bp_masks: cfg mismatch")
        n = len(sds)
        rows = OBJ.HostRows(list(sds), [False] * n, [1.0] * n,
                            [False] * n, [True] * n, [None] * n)
        mine = _shard(rows, group)
        keep, eff = OBJ.batch_bp_masks(
            cfg, J.stack_seqdata(mine.sds, group.device), group.device)
        keep, eff = gather_rows(group, [keep.to(dt), eff.to(dt)])
        return keep[:n].bool(), eff[:n]

    return run


def make_sharded_fn_grad(cfg: J.ModelConfig, group: DataGroup,
                         lik_ratio: bool = False):
    """Returns step(params, rows) -> (fn, grads as Params, eff) over the
    whole batch, each rank's sums over its shard reduced with one
    all_reduce (JAX mesh.py:78, its psum).  The sum's order depends on
    the split: the trainer uses make_sharded_per_read."""
    def step(params, rows: OBJ.HostRows):
        batch = OBJ.device_batch(cfg, _shard(rows, group),
                                 device=group.device)
        fn, grads, eff = OBJ.batch_fn_grad(cfg, params, batch, lik_ratio,
                                           group.device)
        cols = [fn.reshape(1), *[g.reshape(-1) for g in grads],
                eff.reshape(1)]
        buf = torch.cat(cols).to(group.gather_device)
        dist.all_reduce(buf, group=group.pg)
        parts = torch.split(buf, [c.numel() for c in cols])
        return parts[0][0], J.Params(*[p.reshape(g.shape) for p, g in zip(
            parts[1:-1], grads)]), parts[-1][0]

    return step
