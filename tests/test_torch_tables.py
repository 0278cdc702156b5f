"""The port's score tables, factored internal-loop tables, band masks and
batch factors (kernel table rows A-C) against the JAX package, f64 on the
CPU, for both energy sets: ints and bools equal, floats within 1e-12.
Also: the port's own copies of the grammar compiler and the energy npz
tables give what the JAX package's give."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rnaelem_tpu.alphabet import seq_to_ints
from rnaelem_tpu.energy import params as JP
from rnaelem_tpu.energy import tables as JET
from rnaelem_tpu.grammar.profile import compile_pattern as j_compile
from rnaelem_tpu.model import joint as JJ
from rnaelem_tpu.ops import ep_fast as JEPF
from rnaelem_tpu_torch.energy import params as TP
from rnaelem_tpu_torch.energy import tables as TET
from rnaelem_tpu_torch.grammar.profile import compile_pattern as t_compile
from rnaelem_tpu_torch.model import joint as TJ
from rnaelem_tpu_torch.model.convert import params_from_numpy
from rnaelem_tpu_torch.ops import ep_fast as TEPF

# the CPU path is many small torch ops: one thread per test process
# (xdist worker) keeps parallel workers from oversubscribing the cores
torch.set_num_threads(1)

LP = 48
PATTERN = "(.....)"


def _reads(seed, n=4):
    rng = np.random.RandomState(seed)
    out = []
    for L in (LP, LP - 5, LP - 13, 9)[:n]:
        s = "".join("ACGU"[c] for c in rng.randint(0, 4, L))
        q = rng.randint(0, 40, L + 1)
        q[-1] = 0 if L % 2 else 7
        out.append((seq_to_ints(s), q))
    return out


def _assert_same(name, got, want):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want),
                                      err_msg=name)
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-12,
                                   err_msg=name)


@pytest.mark.parametrize("energy", [JP.T2004, JP.A2007])
@pytest.mark.parametrize("wp", [20, 48])
def test_batch_factors_match_jax(energy, wp):
    kw = dict(pattern=PATTERN, Lp=LP, max_span=wp, max_iloop=12,
              min_bpp=0.0, tau=0.1, energy=energy, dtype="float64")
    cj, ct = JJ.ModelConfig(**kw), TJ.ModelConfig(**kw)
    reads = _reads(3)
    sdj = jax.tree.map(lambda *x: jnp.asarray(np.stack(x)),
                       *[JJ.make_seqdata(cj, s, q) for s, q in reads])
    sdt = TJ.stack_seqdata([TJ.make_seqdata(ct, s, q) for s, q in reads],
                           "cpu")
    g = JJ.kernels(cj).g
    pj = JJ.init_params(g, cj, jnp.float64)
    rng = np.random.RandomState(1)
    pj = pj._replace(
        singles=pj.singles + jnp.asarray(rng.randn(*pj.singles.shape)),
        pairs=pj.pairs + jnp.asarray(rng.randn(*pj.pairs.shape)),
        lam=jnp.asarray([0.6, 1.4]))
    pt = params_from_numpy(np.asarray(pj.singles), np.asarray(pj.pairs),
                           np.asarray(pj.lam), device="cpu")
    bpj, effj = JJ._effective_bp_mask_batch_jit(cj, sdj)
    bpt, efft = TJ.effective_bp_mask_batch(ct, sdt, device="cpu")
    _assert_same("bp_ok", bpt, bpj)
    _assert_same("eff", efft, effj)

    dj, cjf = JJ.batch_factors(cj, pj, sdj, bpj)
    dt, ctf = TJ.batch_factors(ct, pt, sdt, bpt, device="cpu")
    for name in ("eR", "eL", "bg2", "pv", "alphaP"):
        _assert_same(name, getattr(dt, name), getattr(dj, name))
    for name in ("wsp", "hp", "stk", "ext", "ml2", "mlE", "okP", "okE",
                 "okM", "okB", "gate_O2", "gate_M", "C", "L", "dots_cum"):
        _assert_same(name, getattr(ctf, name), getattr(cjf, name))
    for name in ("misA", "misB", "t_out", "t_in", "spec_il"):
        _assert_same(name, ctf.ep[name], cjf.ep[name])


@pytest.mark.parametrize("energy", [JP.T2004, JP.A2007])
def test_row_a_functions_match_jax(energy):
    """The per-read plain functions of rows A and B one by one, including
    pair_mask_jw / left_pair_cum, which the batch path folds into the
    score-table kernel's band masks."""
    Wp, turn, no_ene = 20, 3, False
    tj = JET.device_tables(energy, jnp.float64)
    tt = TET.device_tables(energy, torch.float64, "cpu")
    for seq, _ in _reads(5):
        L = len(seq)
        sj = np.zeros(LP, np.int32)
        sj[:L] = seq
        st = torch.as_tensor(sj).long()
        W = min(L, Wp)
        bpj = JET.pair_mask_jw(tj, jnp.asarray(sj), L, W, Wp, turn)
        bpt = TET.pair_mask_jw(tt, st, L, W, Wp, turn)
        _assert_same("pair_mask_jw", bpt, bpj)
        _assert_same("left_pair_cum", TET.left_pair_cum(bpt, LP, Wp),
                     JET.left_pair_cum(bpj, LP, Wp))
        _assert_same("hairpin", TET.hairpin_scores(tt, st, Wp, no_ene),
                     JET.hairpin_scores(tj, jnp.asarray(sj), L, W, Wp,
                                        no_ene))
        _assert_same("stack", TET.stack_scores(tt, st, Wp, no_ene),
                     JET.stack_scores(tj, jnp.asarray(sj), Wp, no_ene))
        for fn in ("exterior_scores", "ml2_scores", "mlE_scores"):
            _assert_same(fn, getattr(TET, fn)(tt, st, L, Wp, no_ene),
                         getattr(JET, fn)(tj, jnp.asarray(sj), L, Wp,
                                          no_ene))
        ej = JEPF.seq_tables(tj, jnp.asarray(sj), LP, Wp, no_ene,
                             jnp.float64)
        et = TEPF.seq_tables(tt, st, LP, Wp, no_ene, torch.float64)
        for k in ("misA", "misB", "t_out", "t_in", "spec_il"):
            _assert_same(k, et[k], ej[k])


@pytest.mark.parametrize("pattern", ["(.....)", "(.*)", ".(.)", "(.).(.)",
                                     "..*..", "(...)*(...)"])
def test_grammar_copy_matches_jax(pattern):
    gj, gt = j_compile(pattern), t_compile(pattern)
    for f in ("M", "S", "nodes", "reg_pattern", "n_pair_tables",
              "table_sizes"):
        assert getattr(gt, f) == getattr(gj, f), f
    for f in ("pair", "theta_id", "state_l", "state_r", "n2s", "loop_mask",
              "diag_mask", "lam_bucket", "rt", "rt_tau", "lt", "lt_tau",
              "pt", "pt_tau", "pt_isbp", "pt_tab", "pt_wl", "pt_wr",
              "op_tuples", "b12_tuples", "ep_tuples", "end_states", "tid_r",
              "tid_l", "ws_r", "ws_l", "pair_table_index",
              "single_table_index"):
        np.testing.assert_array_equal(getattr(gt, f), getattr(gj, f),
                                      err_msg=f)


@pytest.mark.parametrize("energy", [JP.T2004, JP.A2007])
def test_energy_npz_copy_matches_jax(energy):
    ej, et = JP.load(energy), TP.load(energy)
    for f in ("stack", "hairpin", "bulge", "internal", "ninio",
              "mismatch_h", "mismatch_i", "mismatch_1n", "mismatch_23",
              "mismatch_m", "mismatch_e", "dangle5", "dangle3", "int11",
              "int21", "int22", "term_au", "mlintern", "mlclosing", "lxc"):
        np.testing.assert_array_equal(np.asarray(getattr(et, f)),
                                      np.asarray(getattr(ej, f)), err_msg=f)
    for f in ("triloops", "tetraloops", "hexaloops"):
        assert getattr(et, f) == getattr(ej, f), f
