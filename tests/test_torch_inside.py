"""The port's forward inside DP (plain versions of kernels K2-K4 on the
CPU, f64) against the JAX package, the reference path-count oracles, and
the guard of the no-rss chain, which raises until row J is ported."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rnaelem_tpu.alphabet import seq_to_ints
from rnaelem_tpu.model import joint as JJ
from rnaelem_tpu_torch.model import joint as TJ
from rnaelem_tpu_torch.model.convert import params_from_numpy

from test_dp_pathcount import CASES

# the CPU path is many small torch ops: one thread per test process
# (xdist worker) keeps parallel workers from oversubscribing the cores
torch.set_num_threads(1)

LP = 32
_MASKS = {}


def _jax_masks(cj, sdj):
    """The JAX package's min_bpp pruning masks.  They come from the
    motif-free (null grammar) pass, so they do not depend on the pattern:
    compile them once per loop width and share them across patterns."""
    key = cj.max_iloop
    if key not in _MASKS:
        cm = JJ.ModelConfig(**{**cj.__dict__, "pattern": "."})
        JJ.kernels(cm)  # build constants eagerly, outside the jit trace
        _MASKS[key] = np.array(JJ._effective_bp_mask_batch_jit(cm, sdj)[0])
    return _MASKS[key]


def _setup(pattern, max_iloop, seed=1):
    kw = dict(pattern=pattern, Lp=LP, max_span=16, max_iloop=max_iloop,
              min_bpp=1e-4, tau=0.1, dtype="float64")
    cj, ct = JJ.ModelConfig(**kw), TJ.ModelConfig(**kw)
    rng = np.random.RandomState(seed)
    sdj, sdt = [], []
    for L in (LP, 27, 20):
        s = "".join("ACGU"[c] for c in rng.randint(0, 4, L))
        q = rng.randint(0, 40, L + 1)
        q[-1] = 0 if L % 2 else 5
        sdj.append(JJ.make_seqdata(cj, seq_to_ints(s), q))
        sdt.append(TJ.make_seqdata(ct, seq_to_ints(s), q))
    sdj = jax.tree.map(lambda *x: jnp.asarray(np.stack(x)), *sdj)
    pj = JJ.init_params(JJ.kernels(cj).g, cj, jnp.float64)
    pj = pj._replace(
        singles=pj.singles + jnp.asarray(0.3 * rng.randn(*pj.singles.shape)),
        pairs=pj.pairs + jnp.asarray(0.3 * rng.randn(*pj.pairs.shape)),
        lam=jnp.asarray([0.7, 1.3]))
    pt = params_from_numpy(np.asarray(pj.singles), np.asarray(pj.pairs),
                           np.asarray(pj.lam), device="cpu")
    return cj, ct, sdj, TJ.stack_seqdata(sdt, "cpu"), pj, pt


@pytest.mark.parametrize("max_iloop", [8, 30])
@pytest.mark.parametrize("pattern", ["(.....)", "(.*)", ".(.)", "(.).(.)",
                                     "..*.."])
def test_logZ_parts_match_jax(pattern, max_iloop):
    cj, ct, sdj, sdt, pj, pt = _setup(pattern, max_iloop)
    # both sides get the JAX package's min_bpp=1e-4 pruning masks
    bp = _jax_masks(cj, sdj)
    want = np.asarray(JJ._batch_logZ_parts_jit(cj, pj, sdj, None,
                                               jnp.asarray(bp)))
    got = TJ.batch_logZ_parts(ct, pt, sdt, torch.as_tensor(bp),
                              device="cpu").numpy()
    assert np.isfinite(want).any()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-9)


@pytest.mark.parametrize("pattern,seq,rss,count", CASES)
def test_path_count(pattern, seq, rss, count):
    """Path-count oracles (RNAelem-test/test.cpp:88-203): with emissions
    pinned to 1, energies off, the structure fixed and no hairpin turn,
    Z is the integer number of motif-alignment parse paths."""
    cfg = TJ.ModelConfig(pattern=pattern, Lp=16, max_span=16, max_iloop=16,
                         min_bpp=0.0, turn=0, no_ene=True, no_theta=True,
                         fix_rss=True, tau=1.0, dtype="float64")
    sd = TJ.stack_seqdata([TJ.make_seqdata(cfg, seq_to_ints(seq), None,
                                           rss)], "cpu")
    params = TJ.init_params(TJ.kernels(cfg, "cpu").g, cfg, device="cpu")
    parts = TJ.batch_logZ_parts(cfg, params, sd, device="cpu")
    got = float(torch.exp(TJ.part_func(parts))[0])
    assert got == pytest.approx(count, rel=1e-9), (pattern, seq, rss)
