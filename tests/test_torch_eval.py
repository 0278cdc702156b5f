"""The port's objective function value against the RNAelem C++ goldens, and
its model files and weight carry-over against the JAX package.

Golden values in tests/golden/eval_{0,1,3}.fn come from the reference's
eval path (motif_eval.hpp, TR_NORMAL|TR_NO_SHUFFLE) on fixtures
{0,1,3}.model x 0.fq, the same bar as test_grad_golden.py.  The pair
masks (min-bpp 1e-4 pruning) come from the JAX package until the port's
outside pass exists; model 2 is the no-rss model (kernel row J, not
ported yet).
"""
import io
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rnaelem_tpu.model import io as JIO
from rnaelem_tpu.model import joint as JJ
from rnaelem_tpu_torch.io.fastq import FastqReader
from rnaelem_tpu_torch.model import io as TIO
from rnaelem_tpu_torch.model.convert import params_from_numpy
from rnaelem_tpu_torch.train import objective as OBJ

HERE = os.path.dirname(__file__)
FIX = os.path.join(HERE, "fixtures")
GOLD = os.path.join(HERE, "golden")
LP = 48


def _golden_fn(x):
    with open(os.path.join(GOLD, "eval_%s.fn" % x)) as f:
        return float(f.read().split(":")[1])


def _jax_masks(cfg_t, reads):
    """min_bpp pruning masks from the JAX package (pattern-free)."""
    cj = JJ.ModelConfig(**{**cfg_t.__dict__, "pattern": "."})
    JJ.kernels(cj)  # build constants eagerly, outside the jit trace
    sds = [JJ.make_seqdata(cj, s, q) for s, q in reads]
    sd = jax.tree.map(lambda *x: jnp.asarray(np.stack(x)), *sds)
    bp, eff = JJ._effective_bp_mask_batch_jit(cj, sd)
    return np.array(bp), np.array(eff)


@pytest.mark.parametrize("x", ["0", "1", "3"])
def test_fn_matches_reference(x):
    cfg, params = TIO.read_model(os.path.join(FIX, "%s.model" % x), Lp=LP,
                                 device="cpu")
    reads = [(r.seq, r.qual) for r in
             FastqReader(os.path.join(FIX, "0.fq")).reads()]
    masks = _jax_masks(cfg, reads)
    batch = OBJ.stack_reads(cfg, reads, bp_fn=lambda *a: masks,
                            device="cpu")
    fn, eff = OBJ.batch_total(cfg, params, batch, device="cpu")
    assert float(fn) == pytest.approx(_golden_fn(x), abs=1e-6)
    assert float(eff) == pytest.approx(float(masks[1].sum()), abs=1e-12)


@pytest.mark.parametrize("x", ["0", "1", "2", "3"])
def test_model_io_matches_jax(x):
    """params_from_numpy of the JAX reader's params equals the port's own
    reader, and the port writes the same bytes as the JAX writer."""
    path = os.path.join(FIX, "%s.model" % x)
    cj, pj = JIO.read_model(path, Lp=LP)
    ct, pt = TIO.read_model(path, Lp=LP, device="cpu")
    assert ct.__dict__ == cj.__dict__
    conv = params_from_numpy(np.asarray(pj.singles), np.asarray(pj.pairs),
                             np.asarray(pj.lam), device="cpu")
    for a, b in zip(conv, pt):
        assert a.dtype == b.dtype == torch.float64
        assert torch.equal(a, b)
    fj, ft = io.StringIO(), io.StringIO()
    JIO.write_model(fj, cj, pj)
    TIO.write_model(ft, ct, pt)
    assert ft.getvalue() == fj.getvalue()
    assert TIO.interim_line(ct, pt) == JIO.interim_line(cj, pj)
