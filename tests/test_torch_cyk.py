"""The port's CYK/Viterbi alignment (kernel rows L and M: plain versions
on the CPU, f64) against the JAX package and the RNAelem C++ goldens: the
max-semiring tables under the Ys/Ye/tail pin set against JAX's
build_max_tables, the alignments against JAX's table-based
viterbi_alignment, rss_from_pairs, the internal-loop energies of the host
traceback (_il_np) and of K13 (the factor tensors) against JAX's
iloop_scores (tests/test_torch_cyk_scan.py holds the scan records, the
command line and the normal mode)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rnaelem_tpu.alphabet import seq_to_ints
from rnaelem_tpu.energy.tables import iloop_scores
from rnaelem_tpu.model import joint as JJ
from rnaelem_tpu.ops import dp_maxb as JDMB
from rnaelem_tpu.scan import cyk as JCYK
from rnaelem_tpu.scan.scanner import state_masks
from rnaelem_tpu_torch.model import joint as TJ
from rnaelem_tpu_torch.model.convert import params_from_numpy
from rnaelem_tpu_torch.ops import dp_maxb as TDMB
from rnaelem_tpu_torch.ops.dp_maxb import SPEC_COMBOS
from rnaelem_tpu_torch.ops.ep_fast import seq_tables
from rnaelem_tpu_torch.scan import cyk as TCYK
from rnaelem_tpu_torch.scan import scanner as TS

# the CPU path is many small torch ops: one thread per test process
torch.set_num_threads(1)

TABLES = ("LL", "P", "E", "M", "B", "T1", "T2", "O")


def _configs(pattern, no_ene=False, Lp=32, **kw):
    kw = dict(dict(pattern=pattern, Lp=Lp, max_span=28, max_iloop=10,
                   min_bpp=1e-4, tau=0.1, no_ene=no_ene, dtype="float64"),
              **kw)
    return JJ.ModelConfig(**kw, with_aux=True), TJ.ModelConfig(**kw)


def _weights(cj, seed):
    """Distinct random weights (no exact ties), both packages."""
    rng = np.random.RandomState(seed)
    pj = JJ.init_params(JJ.kernels(cj).g, cj, jnp.float64)
    pj = pj._replace(
        singles=pj.singles + 0.3 * rng.randn(*pj.singles.shape),
        pairs=pj.pairs + 0.3 * rng.randn(*pj.pairs.shape),
        lam=jnp.asarray([0.8, 1.2]))
    return pj, params_from_numpy(*[np.asarray(x) for x in pj], device="cpu")


def _reads(cj, ct, lengths, seed):
    rng = np.random.RandomState(seed)
    sdj, sdt = [], []
    for L in lengths:
        s = seq_to_ints("".join("ACGU"[c] for c in rng.randint(0, 4, L)))
        q = np.full(L + 1, 10)
        q[-1] = 0
        sdj.append(JJ.make_seqdata(cj, s, q))
        sdt.append(TJ.make_seqdata(ct, s, q))
    return sdj, sdt


# ------------------------------------------ (a) the max tables vs JAX

TABLE_CASES = [(p, ne) for ne in (False, True)
               for p in ("(.....)", "((..).)", "(.*)")]


@pytest.fixture(scope="module")
def max_tables(request):
    """(port tables, JAX tables) of four reads under the pin set: read 1
    has Ye == L < Lp, read 2 Ye == L == Lp, read 3 Ys == Ye."""
    pattern, no_ene = request.param
    cj, ct = _configs(pattern, no_ene)
    pj, pt = _weights(cj, 3)
    sdj, sdt = _reads(cj, ct, (30, 29, 32, 25), 5)
    Ys, Ye = np.array([2, 0, 5, 7]), np.array([12, 29, 32, 7])
    kj = JJ.kernels(cj)
    sd_b = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *sdj)
    bp_b, _ = JJ._effective_bp_mask_batch_jit(cj, sd_b)
    m = state_masks(cj)
    aux_b = jax.vmap(lambda ys, ye, L: JCYK._pin_aux(
        cj, kj.g, m, ys, ye, L, jnp.float64))(
        jnp.asarray(Ys), jnp.asarray(Ye), sd_b.L)
    d_b, c_b = JJ.batch_factors(cj, pj, sd_b, bp_b, aux_b)
    tables_fn, _ = JDMB.build_max_tables(kj.g, kj.dims, kj.tab, jnp.float64)
    want = dict(zip(TABLES, [np.asarray(x) for x in tables_fn(d_b, c_b)]))
    kt = TJ.kernels(ct, "cpu")
    sdt = TJ.stack_seqdata(sdt, "cpu")
    pins = TCYK.cyk_pins(torch.as_tensor(Ys), torch.as_tensor(Ye), sdt.L)
    d, c = TJ.batch_factors(ct, pt, sdt, torch.tensor(np.asarray(bp_b)),
                            "cpu", aux_b={"pin": pins})
    state = TDMB.MaxDP(kt.dp).tables(d, c)
    got = {k: v.numpy() for k, v in TDMB.row_layout(state, kt.dp.st).items()}
    return got, want


@pytest.mark.parametrize("name", TABLES)
@pytest.mark.parametrize("max_tables", TABLE_CASES, indirect=True,
                         ids=["%s%s" % (p, "-no_ene" if ne else "")
                              for p, ne in TABLE_CASES])
def test_max_tables_match_jax(max_tables, name):
    """Each CYK table [Lp+1, ..., B] against JAX's batch-minor max DP
    (tests/test_dp_maxb.py): identical -inf placement, finite cells
    within 1e-10."""
    got, want = max_tables
    a, b = got[name], want[name]
    assert a.shape == b.shape
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    fin = np.isfinite(b)
    assert fin.any()
    assert np.abs(a[fin] - b[fin]).max() <= 1e-10


def test_max_tables_refuse_negative_lambda():
    """The size classes are maxed before the lambda multiply, which holds
    for lambda >= 0 only."""
    _, ct = _configs("(.....)", Lp=16, max_span=12, max_iloop=6)
    kt = TJ.kernels(ct, "cpu")
    _, sdt = _reads(*_configs("(.....)", Lp=16, max_span=12, max_iloop=6),
                    (14,), 1)
    sdt = TJ.stack_seqdata(sdt, "cpu")
    params = TJ.init_params(kt.g, ct, device="cpu")
    params = params._replace(lam=torch.tensor([0.5, -0.1],
                                              dtype=torch.float64))
    bp, _ = TJ.effective_bp_mask_batch(ct, sdt, "cpu")
    d, c = TJ.batch_factors(ct, params, sdt, bp, "cpu")
    with pytest.raises(ValueError, match="lambda >= 0"):
        TDMB.MaxDP(kt.dp).tables(d, c)


# --------------------------------- (b) alignments vs JAX's traceback

@pytest.fixture(scope="module")
def alignments():
    """JAX's table-based viterbi_alignment of four reads with distinct
    weights (test_dp_maxb.py:83's set-up) under the pins of the port's
    posterior pass, and the port's viterbi_alignment and cyk_batch."""
    cj, ct = _configs("(.....)")
    pj, pt = _weights(cj, 7)
    sdj, sdt_l = _reads(cj, ct, (30, 29, 32, 25), 11)
    sdt = TJ.stack_seqdata(sdt_l, "cpu")
    res = TS.scan_posteriors_batch(ct, pt, sdt, device="cpu")
    Ys, Ye = res["Ys"].numpy(), res["Ye"].numpy()
    want = [JCYK.viterbi_alignment(cj, pj, sdj[t], int(Ys[t]), int(Ye[t]))
            for t in range(4)]
    batch = TCYK.cyk_batch(ct, pt, sdt, Ys, Ye, res["bp_ok"], device="cpu")
    single = [TCYK.viterbi_alignment(ct, pt, sdt_l[t], int(Ys[t]),
                                     int(Ye[t]), device="cpu")
              for t in range(4)]
    return want, dict(cyk_batch=batch, viterbi_alignment=single), \
        [int(s.L) for s in sdt_l]


@pytest.mark.parametrize("fn", ["cyk_batch", "viterbi_alignment"])
@pytest.mark.parametrize("t", range(4))
def test_alignment_matches_jax(alignments, fn, t):
    """psihat and rss of each read identical to JAX's host traceback."""
    want, got, Ls = alignments
    path, rss = got[fn][t]
    np.testing.assert_array_equal(path, np.asarray(want[t][0])[:Ls[t]])
    assert rss == want[t][1]
    assert "L" in rss


# ------------------------------------------------ (c) rss_from_pairs

@pytest.mark.parametrize("cells,L,want", [
    # pair span (0,10) with child (3,8): both gaps > 0 -> I
    ([(10, 10), (8, 5)], 12, "LIILHHHRIROO"),
    # child flush left (empty left gap) -> bulge
    ([(10, 10), (8, 7)], 10, "LLHHHHHRBR"),
    # two children -> M
    ([(12, 12), (5, 4), (10, 4)], 12, "LLHHRMLHHRMR"),
])
def test_rss_from_pairs_classes(cells, L, want):
    """Nesting classification (test_dp_maxb.py:115)."""
    assert TCYK.rss_from_pairs(cells, L) == want == \
        JCYK.rss_from_pairs(cells, L)


# ----------------------------------- (d) internal-loop energies

def _il_setup(fix_rss):
    kw = dict(pattern="(...)", Lp=48, max_span=20, max_iloop=12,
              min_bpp=0.0, tau=0.1, dtype="float64", fix_rss=fix_rss)
    return JJ.ModelConfig(**kw), TJ.ModelConfig(**kw)


def _k13_il(ct, seq, j, C, dcum):
    """il[w, dk, dl] as K13 (csrc/cyk_traceback.cu il) forms it from the
    factor tensors K11 reads: spec_il at the six base-coupled gaps, else
    max over the misA/misB groups of misB(inner) + SZ[g, dl, dk] +
    misA(outer); -inf past the cap, the geometry or the dot gates."""
    Lp, Wp, Cp = ct.Lp, ct.Wp, ct.Cp
    kt = TJ.kernels(ct, "cpu")
    ept = {k: v[0].numpy() for k, v in seq_tables(
        kt.tab, torch.as_tensor(seq)[None], Lp, Wp, False,
        torch.float64).items()}
    SZ = TDMB.MaxStatic.of(kt.dp.st).SZg.numpy()
    il = np.full((Wp + 1, Cp + 1, Cp + 1), -np.inf)
    for w in range(min(Wp, j) + 1):
        for dk in range(Cp + 1):
            for dl in range(Cp + 1):
                v, i = w - dk - dl, j - w
                if not 1 <= dk + dl <= C or v < 0:
                    continue
                if dcum is not None and (
                        dcum[i + dk] - dcum[i] != dk
                        or dcum[j] - dcum[j - dl] != dl):
                    continue
                if (dk, dl) in SPEC_COMBOS:
                    il[w, dk, dl] = ept["spec_il"][
                        SPEC_COMBOS.index((dk, dl)), j, w]
                    continue
                il[w, dk, dl] = max(
                    ept["misB"][g, j - dl, v] + SZ[g, dl, dk]
                    + ept["misA"][g, j, w] for g in range(4))
    return il


@pytest.mark.parametrize("version", ["il_np", "k13"])
@pytest.mark.parametrize("fix_rss", [False, True])
def test_il_matches_iloop_scores(fix_rss, version):
    """The host traceback's _il_np and K13's factorised energies against
    JAX's energy.tables.iloop_scores (tests/test_il_factorized.py:77,
    108) on random sequences, caps and dot masks, at the in-band cells
    (w <= j): finite cells within 1e-12 relative, same -inf placement."""
    cj, ct = _il_setup(fix_rss)
    kj = JJ.kernels(cj)
    tabn = TCYK._tab_np(ct.energy)
    rng = np.random.RandomState(42)
    for trial in range(2):
        seq = rng.randint(1, 5, ct.Lp)
        C = [12, 7][trial]
        dcum = None
        if fix_rss:
            dcum = np.concatenate([[0], np.cumsum(rng.randint(0, 2, ct.Lp))])
        for j in [1, 5, 17, 30, ct.Lp]:
            ref = np.asarray(iloop_scores(
                kj.tab, jnp.asarray(seq), j, cj.Wp, cj.Cp, C, False,
                None if dcum is None else jnp.asarray(dcum)))
            got = TCYK._il_np(tabn, seq, j, ct.Wp, ct.Cp, C, False, dcum) \
                if version == "il_np" else _k13_il(ct, seq, j, C, dcum)
            inband = np.arange(ct.Wp + 1)[:, None, None] <= j
            a = np.where(inband, got, -np.inf)
            b = np.where(inband, ref, -np.inf)
            np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
            np.testing.assert_allclose(a[np.isfinite(b)], b[np.isfinite(b)],
                                       rtol=1e-12)
