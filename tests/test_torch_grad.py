"""The port's gradient (plain versions of the outside kernels K5-K7 on the
CPU, f64) against the JAX package's batch_fn_grad and dp_parts VJP, with
the port's own min-BPP pruning masks held equal to JAX's.  Each case
compiles a JAX forward and VJP, so the matrix stays small."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rnaelem_tpu.alphabet import seq_to_ints
from rnaelem_tpu.model import joint as JJ
from rnaelem_tpu.train import objective as JO
from rnaelem_tpu_torch.model import joint as TJ
from rnaelem_tpu_torch.model.convert import params_from_numpy
from rnaelem_tpu_torch.train import objective as TO

# the CPU path is many small torch ops: one thread per test process
# (xdist worker) keeps parallel workers from oversubscribing the cores
torch.set_num_threads(1)

LP = 32
NAMES = ("singles", "pairs", "lam")
_MASKS = {}


def _jax_bp_fn(cj, reads):
    """The JAX package's masks for stack_reads.  They come from the
    motif-free pass, so one compile per loop width, energy switch and read
    set serves every pattern."""
    key = (cj.max_iloop, cj.no_ene,
           b"".join(np.asarray(s).tobytes() + b"|" for s, _ in reads))

    def bp_fn(cfg, sd):
        if key not in _MASKS:
            cm = JJ.ModelConfig(**{**cj.__dict__, "pattern": "."})
            JJ.kernels(cm)  # build constants eagerly, outside the trace
            _MASKS[key] = JJ._effective_bp_mask_batch_jit(cm, sd)
        return _MASKS[key]
    return bp_fn


def _setup(pattern, max_iloop, seed=2, **opts):
    """Both packages' configs, B=3 reads of ragged lengths (one of 4 nt,
    shorter than every motif here) and randomized weights."""
    kw = dict(pattern=pattern, Lp=LP, max_span=16, max_iloop=max_iloop,
              min_bpp=1e-4, tau=0.1, dtype="float64")
    kw.update(opts)
    cj, ct = JJ.ModelConfig(**kw), TJ.ModelConfig(**kw)
    rng = np.random.RandomState(seed)
    reads = []
    for i, L in enumerate((LP, 23, 4)):
        s = "".join("ACGU"[c] for c in rng.randint(0, 4, L))
        q = rng.randint(0, 40, L + 1)
        q[-1] = 0 if i != 1 else 5
        reads.append((seq_to_ints(s), q))
    pj = JJ.init_params(JJ.kernels(cj).g, cj, jnp.float64)
    pj = pj._replace(
        singles=pj.singles + jnp.asarray(0.3 * rng.randn(*pj.singles.shape)),
        pairs=pj.pairs + jnp.asarray(0.3 * rng.randn(*pj.pairs.shape)),
        lam=jnp.asarray([0.7, 1.3]))
    pt = params_from_numpy(np.asarray(pj.singles), np.asarray(pj.pairs),
                           np.asarray(pj.lam), device="cpu")
    return cj, ct, reads, pj, pt


def _check(cj, ct, reads, pj, pt, lik_ratio=False):
    bj = JO.stack_reads(cj, reads, bp_fn=_jax_bp_fn(cj, reads))
    bt = TO.stack_reads(ct, reads, device="cpu")
    np.testing.assert_array_equal(bt.bp_ok.numpy(), np.asarray(bj.bp_ok))
    np.testing.assert_allclose(bt.eff.numpy(), np.asarray(bj.eff),
                               rtol=1e-12)
    fj, gj, ej = JO.batch_fn_grad(cj, pj, bj, lik_ratio)
    ft, gt, et = TO.batch_fn_grad(ct, pt, bt, lik_ratio, device="cpu")
    assert np.isfinite(float(ft))
    assert float(ft) == pytest.approx(float(fj), rel=1e-9, abs=1e-12)
    assert float(et) == pytest.approx(float(ej), rel=1e-12)
    for name, a, b in zip(NAMES, gt, gj):
        a, b = a.numpy(), np.asarray(b)
        assert not np.isnan(a).any(), name
        scale = max(1.0, float(np.abs(b).max()))
        assert np.abs(a - b).max() <= 1e-9 * scale, name


@pytest.mark.parametrize("pattern,max_iloop", [
    ("(.....)", 8), ("(.....)", 30), ("(.*)", 8), (".(.)", 8),
    ("(.).(.)", 8), ("..*..", 8)])
def test_batch_fn_grad_matches_jax(pattern, max_iloop):
    _check(*_setup(pattern, max_iloop))


@pytest.mark.parametrize("opts,lik_ratio", [
    (dict(fix_rss=False, no_ene=True), False),
    (dict(), True),
], ids=["no_ene", "lik_ratio"])
def test_batch_fn_grad_options_match_jax(opts, lik_ratio):
    _check(*_setup("(.*)", 8, seed=3, **opts), lik_ratio=lik_ratio)


def test_batch_fn_grad_fix_rss_matches_jax():
    """Fixed-structure reads: the masks are the given pairs and the dot
    gates reach every flank of the outside pass."""
    cj, ct, reads, pj, pt = _setup(".(.)", 8, seed=4, fix_rss=True)
    rng = np.random.RandomState(4)
    sdj, sdt = [], []
    for s, q in reads:
        rss = "".join(rng.choice(list("..(.)")) for _ in s)
        depth, fixed = 0, []
        for ch in rss:  # keep it balanced: drop unmatched brackets
            if ch == "(":
                depth += 1
            elif ch == ")":
                if depth == 0:
                    ch = "."
                else:
                    depth -= 1
            fixed.append(ch)
        for p in range(len(fixed) - 1, -1, -1):
            if depth and fixed[p] == "(":
                fixed[p] = "."
                depth -= 1
        rss = "".join(fixed)
        sdj.append(JJ.make_seqdata(cj, s, q, rss))
        sdt.append(TJ.make_seqdata(ct, s, q, rss))
    sdj = jax.tree.map(lambda *x: jnp.asarray(np.stack(x)), *sdj)
    bp = np.asarray(sdj.rss_pair)
    gj = jax.grad(lambda p: JJ.part_func(JJ._batch_logZ_parts_jit(
        cj, p, sdj, None, jnp.asarray(bp))).sum())(pj)
    leaves = [x.clone().requires_grad_(True) for x in pt]
    parts = TJ.batch_logZ_parts(ct, TJ.Params(*leaves),
                                TJ.stack_seqdata(sdt, "cpu"),
                                torch.as_tensor(bp), device="cpu")
    gt = torch.autograd.grad(TJ.part_func(parts).sum(), leaves)
    for name, a, b in zip(NAMES, gt, gj):
        a, b = a.numpy(), np.asarray(b)
        assert not np.isnan(a).any(), name
        scale = max(1.0, float(np.abs(b).max()))
        assert np.abs(a - b).max() <= 1e-9 * scale, name


def test_dp_parts_alphaP_cotangent_matches_jax():
    """d parts / d alphaP (the pair posteriors' machinery) against the
    JAX custom VJP, seeded with random part cotangents."""
    cj, ct, reads, pj, pt = _setup("(.*)", 8, seed=5, min_bpp=0.0)
    bj = JO.stack_reads(cj, reads)
    bt = TO.stack_reads(ct, reads, device="cpu")
    gbar = np.random.RandomState(5).randn(len(reads), 3)
    k = JJ.kernels(cj)
    dj, c_j = JJ.batch_factors(cj, pj, bj.sd, bj.bp_ok)
    _, vjp = jax.vjp(lambda a: k.dp_parts(dj._replace(alphaP=a), c_j),
                     dj.alphaP)
    (want,) = vjp(jnp.asarray(gbar))
    d, c = TJ.batch_factors(ct, pt, bt.sd, bt.bp_ok, device="cpu")
    alpha = d.alphaP.requires_grad_(True)
    parts = TJ.kernels(ct, "cpu").dp.dp_parts(d, c)
    (got,) = torch.autograd.grad(parts, alpha, torch.as_tensor(gbar))
    want = np.asarray(want)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)


def test_batch_fn_grad_of_a_wide_grammar_matches_jax():
    """An all-dot pattern of 12 dots (S = n_ar = 105, the width whose K6
    and K11 blocks outgrow shared memory at f64 and -c 30, so that the
    card runs their device variants): the port's plain path against the
    JAX package, fn and gradient within 1e-9, on short reads."""
    _check(*_setup("." * 12, 6, max_span=12))
