"""The port's no-rss forward chain (kernel row J; the plain version of
K8/K9 on the CPU, f64) against the JAX package's _linear_parts_one and
jax.grad through it, through the port's batched and single-read entry
points."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rnaelem_tpu.alphabet import seq_to_ints
from rnaelem_tpu.model import joint as JJ
from rnaelem_tpu_torch.model import joint as TJ
from rnaelem_tpu_torch.model.convert import params_from_numpy
from rnaelem_tpu_torch.ops import linear as LIN

# the CPU path is many small torch ops: one thread per test process
# (xdist worker) keeps parallel workers from oversubscribing the cores
torch.set_num_threads(1)

LP = 32


def _setup(pattern, tau, no_prf=False, seed=1):
    """Both packages' no-rss configs, four reads of ragged lengths (one of
    3 nt, shorter than every motif here) and randomized emissions."""
    kw = dict(pattern=pattern, Lp=LP, max_span=16, max_iloop=8,
              min_bpp=1e-4, tau=tau, no_rss=True, no_prf=no_prf,
              dtype="float64")
    cj, ct = JJ.ModelConfig(**kw), TJ.ModelConfig(**kw)
    rng = np.random.RandomState(seed)
    pj = JJ.init_params(JJ.kernels(cj).g, cj, jnp.float64)
    pj = pj._replace(
        singles=pj.singles + jnp.asarray(0.3 * rng.randn(*pj.singles.shape)))
    pt = params_from_numpy(np.asarray(pj.singles), np.asarray(pj.pairs),
                           np.asarray(pj.lam), device="cpu")
    sdj, sdt = [], []
    for L in (LP, 20, 11, 3):
        s = seq_to_ints("".join("ACGU"[c] for c in rng.randint(0, 4, L)))
        q = rng.randint(0, 40, L + 1)
        sdj.append(JJ.make_seqdata(cj, s, q))
        sdt.append(TJ.make_seqdata(ct, s, q))
    sdj = jax.tree.map(lambda *x: jnp.asarray(np.stack(x)), *sdj)
    return cj, ct, pj, pt, sdj, TJ.stack_seqdata(sdt, "cpu")


CASES = [(p, tau, False) for p in ("..*..", ".....", "....*....")
         for tau in (0.1, 0.0)] + [("..*..", 0.1, True)]


@pytest.mark.parametrize("pattern,tau,no_prf", CASES)
def test_linear_parts_and_gradient_match_jax(pattern, tau, no_prf):
    """[B, 3] parts of the batched chain and the gradient of sum_b
    part_func to the emission tables, to 1e-9 relative."""
    cj, ct, pj, pt, sdj, sdt = _setup(pattern, tau, no_prf)

    def total_j(p):
        parts = jax.vmap(lambda sd: JJ._linear_parts_one(cj, p, sd))(sdj)
        return JJ.part_func(parts).sum(), parts

    (_, want), gj = jax.value_and_grad(total_j, has_aux=True)(pj)
    leaves = TJ.Params(*[x.clone().requires_grad_(True) for x in pt])
    got = TJ.batch_logZ_parts(ct, leaves, sdt, device="cpu")
    b = np.asarray(gj.singles)
    if no_prf:
        # the chain sees the positional weights alone
        assert not got.requires_grad and np.abs(b).max() == 0
    else:
        (gt,) = torch.autograd.grad(TJ.part_func(got).sum(),
                                    [leaves.singles])
        a = gt.numpy()
        assert not np.isnan(a).any()
        assert np.abs(a - b).max() <= 1e-9 * np.abs(b).max()
    want, got = np.asarray(want), got.detach().numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    assert fin.sum() >= 9
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-9, atol=0)


def test_single_read_wrappers_match_jax():
    """linear_parts / logZ_parts of one read equal JAX's."""
    cj, ct, pj, pt, sdj, sdt = _setup("..*..", 0.1)
    one_j = jax.tree.map(lambda x: x[1], sdj)
    one_t = TJ.SeqData(*[x[1].numpy() for x in sdt])
    want = np.asarray(JJ.linear_parts(cj, pj, one_j))
    got = TJ.linear_parts(ct, pt, one_t, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    parts, eff = TJ.logZ_parts(ct, pt, one_t, with_eff=True, device="cpu")
    np.testing.assert_allclose(parts.numpy(), want, rtol=1e-12)
    assert float(eff) == 1.0


def test_chain_plain_matches_dense_recursion():
    """The plain chain against the recursion written out in numpy: the
    end values of every read, tau = 0 included (no -inf - -inf)."""
    for tau in (0.1, 0.0):
        _, ct, _, pt, _, sdt = _setup("..*..", tau)
        k = TJ.kernels(ct, "cpu")
        eR = TJ.right_emissions(ct, k, TJ.per_read(pt, len(sdt.L)),
                                sdt).numpy()
        TR = k.dp.st.TR.numpy()
        es = k.g.end_states
        got = LIN.chain_plain(k.dp.st, torch.as_tensor(eR),
                              torch.as_tensor(sdt.L).long()).numpy()
        for b, L in enumerate(np.asarray(sdt.L)):
            o = np.full(k.g.S, -np.inf)
            o[es[0]] = 0.0
            for p in range(L):
                with np.errstate(invalid="ignore"):
                    t = o[None, :] + TR
                m = np.max(t, axis=1)
                mm = np.where(np.isfinite(m), m, 0.0)
                with np.errstate(divide="ignore"):
                    o = (np.log(np.exp(t - mm[:, None]).sum(1)) + mm
                         + eR[p, :, b])
            np.testing.assert_allclose(got[b], o[es], rtol=1e-12)
