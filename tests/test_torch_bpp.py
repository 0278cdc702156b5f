"""The port's base-pair posteriors and min-BPP pruning masks (the motif-free,
S=1 pass through the plain versions of K1-K7 on the CPU, f64): the RNAfold
dot plot of tests/test_bpp_rnafold.py, and the JAX package's masks."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rnaelem_tpu.alphabet import seq_to_ints
from rnaelem_tpu.model import joint as JJ
from rnaelem_tpu_torch.io.fastq import FastqReader
from rnaelem_tpu_torch.model import joint as TJ

# the CPU path is many small torch ops: one thread per test process
# (xdist worker) keeps parallel workers from oversubscribing the cores
torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
FIX = os.path.join(HERE, "fixtures")


def _rnafold_dot_plot():
    """log p of the pairs in RNAfold's dot plot 1.0.ps ("i j sqrt(p)
    ubox", 1-origin), keyed by (i - 1, j)."""
    gold = {}
    with open(os.path.join(FIX, "1.0.ps")) as f:
        for line in f:
            a = line.split()
            if len(a) == 4 and a[3] == "ubox" and not a[0].startswith("%"):
                i, j, sp = int(a[0]), int(a[1]), float(a[2])
                gold[(i - 1, j)] = 2.0 * np.log(sp)
    return gold


def test_bpp_matches_rnafold():
    """bpp_posterior on the 236-nt read of 1.fq, W=50, C=30, against the
    RNAfold -p --maxBPspan=50 dot plot to 1e-5 in log space."""
    read = FastqReader(os.path.join(FIX, "1.fq")).get_read()
    L, W, C = len(read.seq), 50, 30
    cfg = TJ.ModelConfig(pattern=".", Lp=L, max_span=W, max_iloop=C,
                         min_bpp=0.0, dtype="float64")
    sd = TJ.make_seqdata(cfg, read.seq)
    z, post, bp0 = TJ.bpp_posterior(cfg, sd, device="cpu")
    assert np.isfinite(float(z))
    post = post.numpy()
    assert not np.isnan(post).any()
    gold = _rnafold_dot_plot()
    checked = 0
    for (i, j), lg in gold.items():
        w = j - i
        if w > W:
            continue
        mine = np.log(max(post[j, w], 1e-300))
        assert abs(mine - lg) < 1e-5, ((i, j), mine, lg)
        checked += 1
    assert checked > 100
    # cells RNAfold omits are genuinely tiny (below its 1e-5 cutoff)
    extra = [(j - w, j) for j in range(1, L + 1) for w in range(1, W + 1)
             if (j - w, j) not in gold and post[j, w] > 1e-4]
    assert not extra, extra
    assert not (post[~bp0.numpy()] != 0).any()


def _reads(cfg_j, cfg_t, n, seed):
    rng = np.random.RandomState(seed)
    sdj, sdt = [], []
    for L in rng.randint(cfg_t.Lp - 10, cfg_t.Lp + 1, n):
        s = seq_to_ints("".join("ACGU"[c] for c in rng.randint(0, 4, L)))
        sdj.append(JJ.make_seqdata(cfg_j, s))
        sdt.append(TJ.make_seqdata(cfg_t, s))
    sdj = jax.tree.map(lambda *x: jnp.asarray(np.stack(x)), *sdj)
    return sdj, sdt


@pytest.mark.parametrize("max_iloop", [8, 30])
def test_effective_bp_mask_batch_matches_jax(max_iloop):
    """min_bpp=1e-4 masks and bpp_eff on B=4 random reads equal JAX's
    _effective_bp_mask_batch_jit; the per-read wrappers agree with the
    batch."""
    kw = dict(pattern=".", Lp=40, max_span=20, max_iloop=max_iloop,
              min_bpp=1e-4, dtype="float64")
    cj, ct = JJ.ModelConfig(**kw), TJ.ModelConfig(**kw)
    JJ.kernels(cj)  # build constants eagerly, outside the jit trace
    sdj, sdt = _reads(cj, ct, 4, seed=7 + max_iloop)
    want_bp, want_eff = JJ._effective_bp_mask_batch_jit(cj, sdj)
    want_bp, want_eff = np.asarray(want_bp), np.asarray(want_eff)
    got_bp, got_eff = TJ.effective_bp_mask_batch(
        ct, TJ.stack_seqdata(sdt, "cpu"), device="cpu")
    assert want_bp.sum() > 0 and (want_eff < 1).all()
    np.testing.assert_array_equal(got_bp.numpy(), want_bp)
    np.testing.assert_allclose(got_eff.numpy(), want_eff, rtol=1e-12)
    keep, eff = TJ.effective_bp_mask(ct, sdt[0], device="cpu")
    assert torch.equal(keep, got_bp[0])
    assert float(eff) == float(got_eff[0])


def test_bpp_posterior_batch_matches_jax():
    """The posteriors themselves (d logZ / d alphaP of the S=1 pass)
    against JAX's _bpp_posterior_batch_jit, and logZ."""
    kw = dict(pattern=".", Lp=32, max_span=16, max_iloop=8, min_bpp=1e-4,
              dtype="float64")
    cj, ct = JJ.ModelConfig(**kw), TJ.ModelConfig(**kw)
    JJ.kernels(cj)
    sdj, sdt = _reads(cj, ct, 3, seed=3)
    zj, pj, bj = JJ._bpp_posterior_batch_jit(cj, sdj)
    zt, pt, bt = TJ.bpp_posterior_batch(ct, TJ.stack_seqdata(sdt, "cpu"),
                                        device="cpu")
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-12)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0,
                               atol=1e-10)
