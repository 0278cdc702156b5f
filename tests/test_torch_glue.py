"""The plain twins of the port's glue kernels K18-K21 (what they run on the
CPU, and what chip_smoke.py holds the kernels to on the card) against the
JAX package, f64:

* K18: the candidate pairs (model/joint.py _complementary_bp, through
  energy/tables.pair_mask_jw) against JAX _complementary_bp under vmap,
  and the min-BPP threshold (model/joint.bpp_keep_plain) on JAX's own
  posterior against _effective_bp_mask_batch_jit, bit for bit, with the
  fix_rss, min_bpp <= 0 and no-rss branches;
* K19: a pass's ends (ops/dp.ends_plain, ends_adj_plain): the objective
  in both forms against JAX _per_read_terms over parts with -inf entries
  (f and eff within 1e-12, the parts' cotangent within 1e-12 of jax.vjp),
  the scanner's lse and the masks' parts[:, 0], and the seed of the O
  cotangent against JAX dp_bwd's scatter-add;
* K20: lambda's per-read sums (ops/dp.lam_sum_plain) bit for bit
  read_sum composed as finish_grads composed it, and the same bits for a
  read in batches of 1, 3 and 8;
* K21: the scanner's posteriors (scan/scanner.py pass1_posteriors_plain,
  end_posteriors_plain) on the class sums of the fixture models 0-3 (and
  on those sums rounded, so Pys ties) bit for bit JAX
  _scan_posteriors_jit's assembly (tests/test_torch_scan.py holds the
  whole scan_posteriors_batch against _scan_posteriors_jit)."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rnaelem_tpu.alphabet import seq_to_ints
from rnaelem_tpu.model import joint as JJ
from rnaelem_tpu.ops import semiring as JSR
from rnaelem_tpu.scan import scanner as JS
from rnaelem_tpu.train import objective as JO
from rnaelem_tpu_torch.io.fastq import FastqReader
from rnaelem_tpu_torch.model import io as TIO
from rnaelem_tpu_torch.model import joint as TJ
from rnaelem_tpu_torch.ops import dp as DP
from rnaelem_tpu_torch.scan import driver as TD
from rnaelem_tpu_torch.scan import scanner as TS

# the CPU path is many small torch ops: one thread per test process
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")
F64 = torch.float64


def _bits_equal(a, b):
    a = np.ascontiguousarray(np.asarray(a, np.float64))
    b = np.ascontiguousarray(np.asarray(b, np.float64))
    return a.shape == b.shape and (a.view(np.int64) == b.view(np.int64)).all()


def _rel(a, b):
    """Max-norm error of a against b, relative to b's max norm (finite
    values; the non-finite ones must sit alike)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    np.testing.assert_array_equal(a[~np.isfinite(a)], b[~np.isfinite(b)])
    fin = np.isfinite(b)
    if not fin.any():
        return 0.0
    return np.abs(a[fin] - b[fin]).max() / max(np.abs(b[fin]).max(), 1e-300)


# -------------------------------------------------------------- K18

MASK_KW = dict(pattern=".", Lp=32, max_span=24, min_bpp=1e-4,
               dtype="float64")


def _mask_reads(cj, ct, n=4, seed=5, rss=False):
    """n random reads of Lp-10..Lp nt for both packages (JAX SeqData
    stacked, the port's stacked on the CPU); with ``rss`` each gets a
    fixed structure of four outer pairs."""
    rng = np.random.RandomState(seed)
    sdj, sdt = [], []
    for L in rng.randint(ct.Lp - 10, ct.Lp + 1, n):
        s = seq_to_ints("".join("ACGU"[c] for c in rng.randint(0, 4, L)))
        r = "((((" + "." * (L - 8) + "))))" if rss else ""
        sdj.append(JJ.make_seqdata(cj, s, None, r))
        sdt.append(TJ.make_seqdata(ct, s, None, r))
    sdj = jax.tree.map(lambda *x: jnp.asarray(np.stack(x)), *sdj)
    return sdj, TJ.stack_seqdata(sdt, "cpu")


@pytest.fixture(scope="module", params=[10, 30])
def jax_post(request):
    """(-c, JAX's candidates and motif-free posterior [B, Lp+1, Wp+1], the
    reads of both packages) at -c 10 or 30."""
    kw = dict(MASK_KW, max_iloop=request.param)
    cj, ct = JJ.ModelConfig(**kw), TJ.ModelConfig(**kw)
    JJ.kernels(cj)  # build constants eagerly, outside the jit trace
    sdj, sdt = _mask_reads(cj, ct, seed=request.param)
    _, post, bp0 = JJ._bpp_posterior_batch_jit(cj, sdj)
    return request.param, np.asarray(bp0), np.asarray(post), sdj, sdt


def test_candidates_match_jax(jax_post):
    """K18's candidates twin (pair_mask_jw) equals JAX _complementary_bp
    under vmap."""
    c_, bp0, _, sdj, sdt = jax_post
    kw = dict(MASK_KW, max_iloop=c_)
    cj, ct = JJ.ModelConfig(**kw), TJ.ModelConfig(**kw)
    want = jax.vmap(lambda sd: JJ._complementary_bp(cj, JJ.kernels(cj),
                                                    sd))(sdj)
    got = TJ._complementary_bp(ct, TJ.kernels(ct, "cpu"), sdt)
    assert got.dtype == torch.bool and want.sum() > 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), bp0)


def test_threshold_matches_jax_bitwise(jax_post):
    """K18's threshold twin on JAX's posterior (batch-minor, as K5-K7
    leave it): keep and eff bit for bit _effective_bp_mask_batch_jit's, at
    min_bpp 1e-4 and, at -c 30, 1e-2 (the threshold itself does not
    depend on -c)."""
    c_, bp0, post, sdj, _ = jax_post
    bp0_t = torch.as_tensor(bp0.copy())
    post_t = torch.as_tensor(np.moveaxis(post, 0, -1).copy())
    for min_bpp in (1e-4, 1e-2) if c_ == 30 else (1e-4,):
        cj = JJ.ModelConfig(**dict(MASK_KW, max_iloop=c_, min_bpp=min_bpp))
        JJ.kernels(cj)
        want_keep, want_eff = (np.asarray(x) for x in
                               JJ._effective_bp_mask_batch_jit(cj, sdj))
        keep, eff = TJ.bpp_keep_plain(bp0_t, bp0_t, post_t, min_bpp, F64)
        assert 0 < want_keep.sum() < bp0.sum()
        np.testing.assert_array_equal(keep.numpy(), want_keep)
        assert eff.dtype == F64 and _bits_equal(eff.numpy(), want_eff)


@pytest.mark.parametrize("case", ["min_bpp 0", "fix_rss", "no_rss"])
def test_mask_branches_match_jax_bitwise(case):
    """effective_bp_mask_batch's other branches on the CPU (K18's twin on
    its counts under fix_rss) against _effective_bp_mask_batch_jit: the
    given structure with count(rss) / count(candidates), the candidates
    with eff 1."""
    kw = dict(MASK_KW, max_iloop=10)
    kw.update({"min_bpp 0": dict(min_bpp=0.0), "fix_rss": dict(fix_rss=True),
               "no_rss": dict(no_rss=True)}[case])
    cj, ct = JJ.ModelConfig(**kw), TJ.ModelConfig(**kw)
    JJ.kernels(cj)
    sdj, sdt = _mask_reads(cj, ct, seed=7, rss=case == "fix_rss")
    want_keep, want_eff = (np.asarray(x) for x in
                           JJ._effective_bp_mask_batch_jit(cj, sdj))
    keep, eff = TJ.effective_bp_mask_batch(ct, sdt, device="cpu")
    assert want_keep.sum() > 0
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert _bits_equal(eff.numpy(), want_eff)


# -------------------------------------------------------------- K19

def _parts_case(B=12, seed=3):
    """Parts [B, 3] with -inf in every pattern of the three (reads 0-7),
    and the objective's per-read inputs, as JAX BatchData and ops/dp.Ends
    fields."""
    rng = np.random.RandomState(seed)
    parts = rng.randn(B, 3) * 3.0 - 20.0
    for r in range(8):
        parts[r, [k for k in range(3) if (r >> k) & 1]] = -np.inf
    fields = dict(restrict_ari=rng.rand(B) < 0.5,
                  lik_sign=np.where(rng.rand(B) < 0.5, -1.0, 1.0),
                  is_neg=rng.rand(B) < 0.4, valid=rng.rand(B) < 0.85,
                  eff=rng.rand(B))
    fields["valid"][:8] = True
    return parts, fields, rng.randn(B)


@pytest.mark.parametrize("lik_ratio", [False, True])
def test_objective_twin_matches_jax(lik_ratio):
    """f and eff of K19's objective twin against JAX _per_read_terms
    within 1e-12 (relative, max norm; -inf/NaN placement equal), and the
    parts' cotangent against jax.vjp of f within 1e-12."""
    parts, fields, gy = _parts_case()
    jb = JO.BatchData(sd=None, bp_ok=None, **{
        k: jnp.asarray(v) for k, v in fields.items()})
    f_j, eff_j = JO._per_read_terms(None, jnp.asarray(parts), jb, lik_ratio)
    ends = DP.Ends("objective", lik_ratio, **{
        k: torch.as_tensor(v) for k, v in fields.items()})
    pt = torch.as_tensor(parts)
    f_t, eff_t = DP.ends_plain(pt, ends)
    assert _rel(f_t.numpy(), f_j) <= 1e-12
    assert _bits_equal(eff_t.numpy(), eff_j)
    assert (f_t[:8] == 0).any() and (f_t != 0).any()
    _, vjp = jax.vjp(lambda p: JO._per_read_terms(None, p, jb, lik_ratio)[0],
                     jnp.asarray(parts))
    (g_j,) = vjp(jnp.asarray(gy))
    g_t = DP.ends_adj_plain(pt, ends, torch.as_tensor(gy))
    assert np.isfinite(g_t.numpy()).all() and np.abs(g_j).max() > 0
    assert _rel(g_t.numpy(), g_j) <= 1e-12


@pytest.mark.parametrize("lik_ratio", [False, True])
def test_objective_twin_autograd_is_its_adjoint(lik_ratio):
    """Autograd through K19's objective twin (as chip_smoke's plain path
    takes it) is finite over reads with -inf parts, motif-free reads among
    them, and equals the closed-form adjoint within 1e-12."""
    parts, fields, gy = _parts_case(seed=4)
    ends = DP.Ends("objective", lik_ratio, **{
        k: torch.as_tensor(v) for k, v in fields.items()})
    pt = torch.as_tensor(parts).requires_grad_(True)
    f, _ = DP.ends_plain(pt, ends)
    (g,) = torch.autograd.grad(f, pt, torch.as_tensor(gy))
    want = DP.ends_adj_plain(pt.detach(), ends, torch.as_tensor(gy))
    assert torch.isfinite(g).all()
    assert _rel(g.numpy(), want.numpy()) <= 1e-12


@pytest.mark.parametrize("mode", ["lse", "null", "parts"])
def test_scan_and_mask_ends_match_jax(mode):
    """K19's other modes: the scanner's z = lse(parts) and PyN = exp(parts0
    - z) against JAX's lse, the masks' z = parts[:, 0], the parts alone;
    each cotangent (with a cotangent of the parts beside) against jax.vjp
    within 1e-12."""
    parts, _, gy = _parts_case()
    gp = np.random.RandomState(9).randn(*parts.shape)
    pt = torch.as_tensor(parts)
    ends = DP.Ends(mode)
    y_t, y2_t = DP.ends_plain(pt, ends)
    fn = {"lse": lambda p: JSR.lse(p, axis=-1), "null": lambda p: p[:, 0],
          "parts": lambda p: jnp.zeros(p.shape[0], p.dtype)}[mode]
    if mode != "parts":
        assert _rel(y_t.numpy(), fn(jnp.asarray(parts))) <= 1e-12
    if mode == "lse":
        z = JSR.lse(jnp.asarray(parts), axis=-1)
        assert _rel(y2_t.numpy(), jnp.exp(jnp.asarray(parts)[:, 0] - z)) \
            <= 1e-12
    _, vjp = jax.vjp(lambda p: (fn(p), p), jnp.asarray(parts))
    (g_j,) = vjp((jnp.asarray(gy), jnp.asarray(gp)))
    g_t = DP.ends_adj_plain(pt, ends, torch.as_tensor(gy),
                            torch.as_tensor(gp))
    assert _rel(g_t.numpy(), g_j) <= 1e-12


@pytest.mark.parametrize("pattern", ["(...)", "null"])
def test_seed_matches_jax_scatter(pattern):
    """K19's seed twin (ops/dp.ends_adj into the O cotangent) puts gbar at
    row L_b + PAD as JAX dp_bwd's zeros(S, B).at[end_states].add(gbar.T)
    (the end states coincide in the null grammar) and as seed_parts'
    index_put_ composition, bit for bit."""
    ct = TJ.ModelConfig(pattern="(...)", Lp=20, max_span=12, max_iloop=6,
                        dtype="float64")
    k = TJ.kernels(ct, "cpu")
    st = (k.dp_null if pattern == "null" else k.dp).st
    B, S, R = 5, st.dims.S, st.dims.Lp + 1 + st.PAD
    rng = np.random.RandomState(4)
    gbar = rng.randn(B, 3)
    L = torch.as_tensor([20, 3, 11, 20, 7])
    es = np.asarray(st.g.end_states)
    ge = np.asarray(jnp.zeros((S, B)).at[es, :].add(jnp.asarray(gbar.T)))
    gO = torch.zeros((R, S, B), dtype=F64)
    DP.ends_adj(st, DP.PARTS, torch.as_tensor(gbar),
                gparts=torch.as_tensor(gbar), gO=gO, L=L)
    want = np.zeros((R, S, B))
    want[L.numpy() + st.PAD, :, np.arange(B)] = ge.T
    assert _bits_equal(gO.numpy(), want)
    gO2 = torch.zeros_like(gO)
    rows, ar = L + st.PAD, torch.arange(B)
    for kk in range(3):
        gO2.index_put_((rows, torch.full_like(ar, int(es[kk])), ar),
                       torch.as_tensor(gbar[:, kk]), accumulate=True)
    assert torch.equal(gO, gO2)


# -------------------------------------------------------------- K20

def _lam_static():
    ct = TJ.ModelConfig(pattern="((...*..))", Lp=18, max_span=12,
                        max_iloop=6, dtype="float64")
    return TJ.kernels(ct, "cpu").dp.st


def _finish_grads_lam(DL, lam, st):
    """lambda's cotangent as finish_grads composed it before K20."""
    DLs = DP.read_sum(DL, 2)
    return lam + torch.stack([DP.read_sum(DLs[st.bucket == b], 1)
                              for b in range(2)])


def test_lam_sum_twin_is_read_sum_composition():
    """K20's twin bit for bit read_sum composed as finish_grads did, plus
    an extra term added last (finish_grads adds K17's term so:
    tests/test_torch_factors.py holds finish_grads to this twin)."""
    st = _lam_static()
    assert 0 < int((st.bucket == 1).sum()) < st.dims.S
    rng = np.random.RandomState(6)
    B = 8
    DL = torch.as_tensor(rng.randn(st.dims.Lp + 1, st.dims.Wp + 1,
                                   st.dims.S, B))
    DL[:, :, :, 3] = -0.0
    lam, extra = (torch.as_tensor(rng.randn(2, B)) for _ in range(2))
    want = _finish_grads_lam(DL, lam, st)
    got = DP.lam_sum_plain(DL, lam, st)
    assert _bits_equal(got.numpy(), want.numpy())
    assert _bits_equal(DP.lam_sum_plain(DL, lam, st, extra).numpy(),
                       (want + extra).numpy())


def test_lam_sum_twin_does_not_depend_on_the_batch():
    """A read's lambda cotangent from K20's twin has the same bits in
    batches of 1, 3 and 8 reads."""
    st = _lam_static()
    rng = np.random.RandomState(7)
    DL = torch.as_tensor(rng.randn(st.dims.Lp + 1, st.dims.Wp + 1,
                                   st.dims.S, 8))
    lam = torch.as_tensor(rng.randn(2, 8))
    full = DP.lam_sum_plain(DL, lam, st)
    for n in (1, 3):
        part = DP.lam_sum_plain(DL[..., :n].contiguous(),
                                lam[:, :n].contiguous(), st)
        assert _bits_equal(part.numpy(), full[:, :n].numpy())


# -------------------------------------------------------------- K21

def _jax_assembly(g, L, end):
    """_scan_posteriors_jit's assembly (JAX scan/scanner.py:160-190) from
    class sums g [4, Lp, B] (start, in, end, tail mass per base)."""
    g, L = jnp.asarray(g), jnp.asarray(L)
    Lp, B = g.shape[1], g.shape[2]
    inb = jnp.arange(Lp)[None, :] < L[:, None]
    if not end:
        Pys = jnp.where(inb, g[0].T, 0.0)
        Pyi = jnp.where(inb, g[1].T, 0.0)
        return Pys, Pyi, JS._argmax_last(jnp.where(inb, Pys, -1.0))
    Pye_pos = jnp.where(inb, g[2].T, 0.0)
    lastb = jnp.clip(L - 1, 0, Lp - 1)
    pye_L = g[3][lastb, jnp.arange(B)]
    Pye = jnp.concatenate([Pye_pos, jnp.zeros((B, 1), g.dtype)], axis=1)
    Pye = Pye + (jnp.arange(Lp + 1)[None, :] == L[:, None]) * pye_L[:, None]
    Ye = JS._argmax_last(jnp.where(jnp.arange(Lp + 1)[None, :]
                                   <= L[:, None], Pye, -1.0))
    return Pye, Ye


@pytest.fixture(scope="module", params=["0", "1", "2", "3"])
def class_sums(request):
    """The class sums (pass 1, end pass) scan_posteriors_batch hands K21's
    twin for fixture model x on 0.fq at Lp 45, a padding row beside, and
    its outputs."""
    path = os.path.join(FIX, request.param + ".model")
    ct, pt = TD.scan_config(*TIO.read_model(path, Lp=45, device="cpu"), 45)
    reads = list(FastqReader(os.path.join(FIX, "0.fq")).reads())
    rows = [(r.seq, r.qual) for r in reads] + [(reads[0].seq, reads[0].qual)]
    sd = TJ.stack_seqdata([TJ.make_seqdata(ct, s, q) for s, q in rows], "cpu")
    seen = []
    twin = TS._posteriors

    def record(g, L, end):
        seen.append((g.detach().clone(), L.clone(), end))
        return twin(g, L, end)

    TS._posteriors = record
    try:
        out = TS.scan_posteriors_batch(ct, pt, sd, [1.0, 1.0, 0.0],
                                       device="cpu")
    finally:
        TS._posteriors = twin
    assert [e for _, _, e in seen] == [False, True]
    return request.param, seen, out


def test_posterior_twins_match_jax_assembly(class_sums):
    """K21's twins on a fixture's class sums, and on those sums rounded to
    a coarse grid (ties in Pys and Pye: the last-maximum rule), bit for
    bit JAX's assembly; the scan's outputs are the twins'."""
    x, seen, out = class_sums
    names = {False: ("Pys", "Pyi", "Ys"), True: ("Pye", "Ye")}
    ties = 0
    for g, L, end in seen:
        for gg in (g, torch.round(g * 4.0) / 4.0):
            got = TS.end_posteriors_plain(gg, L) if end else \
                TS.pass1_posteriors_plain(gg, L)
            want = _jax_assembly(gg.numpy(), L.numpy(), end)
            for a, b in zip(got, want):
                if a.dtype.is_floating_point:
                    assert _bits_equal(a.numpy(), b), x
                else:
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            if gg is not g:
                ties += int(sum((row == row.max()).sum() > 1
                                for row in got[0].numpy()))
        got = TS.end_posteriors_plain(g, L) if end else \
            TS.pass1_posteriors_plain(g, L)
        for name, a in zip(names[end], got):
            assert torch.equal(a, out[name]), (x, name)
    assert ties > 0
