"""The port's hand-written CUDA kernels against their plain PyTorch
versions.  The card-only tests carry the ``gpu`` marker and skip without
a CUDA device; this file imports no JAX, so on the card it runs alone:
    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from rnaelem_tpu_torch.alphabet import seq_to_ints
from rnaelem_tpu_torch.energy import tables as ET
from rnaelem_tpu_torch.model import joint as J
from rnaelem_tpu_torch.ops import dp as DP
from rnaelem_tpu_torch.ops import dp_maxb as DMB
from rnaelem_tpu_torch.ops import kernels as K
from rnaelem_tpu_torch.ops import linear as LIN
from rnaelem_tpu_torch.train import objective as OBJ

# the CPU path is many small torch ops: one thread per test process
# (xdist worker) keeps parallel workers from oversubscribing the cores
torch.set_num_threads(1)


def _batch(cfg, device, n=5, seed=0):
    rng = np.random.RandomState(seed)
    reads = []
    for i in range(n):
        L = int(rng.randint(cfg.Lp - 12, cfg.Lp + 1))
        s = "".join("ACGU"[c] for c in rng.randint(0, 4, L))
        q = rng.randint(0, 40, L + 1)
        q[-1] = 0 if i % 2 else 9
        reads.append((seq_to_ints(s), q))
    return OBJ.stack_reads(cfg, reads, device=device)


def _cfg(dtype, pattern="(.....)"):
    return J.ModelConfig(pattern=pattern, Lp=40, max_span=24, max_iloop=12,
                         min_bpp=0.0, tau=0.1, dtype=dtype)


DP_KERNELS = ("score_tables", "inside_band", "inside_ep", "inside_ext",
              "outside_band", "outside_ep", "outside_ext")
ROWS_CD = ("factors", "factors_adj", "hoisted", "hoisted_adj")


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README)")


@pytest.mark.parametrize("name", ["score_tables", "band_front", "band_bif",
                                  "band_m", "band_e", "ep_stage",
                                  "ext_stage", "ext_adj", "e_adj", "ep_adj",
                                  "band_adj", "chain_fwd", "chain_adj",
                                  "max_band_front", "max_band_bif",
                                  "max_band_m", "max_band_e", "max_ep_stage",
                                  "max_ext_stage", "cyk_traceback",
                                  "factors", "factors_adj", "hoisted",
                                  "hoisted_adj"])
def test_kernel_wrappers_reject_cpu_tensors(name):
    """A wrapper launches its kernel or raises: handed CPU tensors it
    raises before building anything (the CPU path is the dispatcher's
    plain version, never a fallback inside the wrapper)."""
    cfg = _cfg("float64")
    batch = _batch(cfg, "cpu")
    k = J.kernels(cfg, "cpu")
    if name in ROWS_CD:
        p = J.per_read(J.init_params(k.g, cfg, device="cpu"), 5)
        reads = J._card_reads(k, batch.sd)
        d, c = J.batch_factors(cfg, J.init_params(k.g, cfg, device="cpu"),
                               batch.sd, batch.bp_ok, device="cpu")
        h = DP.hoisted(d, c, k.dp.st)
        args = {"factors": (k.dp.st, cfg, "dp") + reads + (p.singles,
                                                           p.pairs),
                "factors_adj": (k.dp.st, cfg, "dp", reads[0], p.singles,
                                p.pairs, d.eR, d.eL, d.bg2, d.pv),
                "hoisted": (k.dp.st, d.lam, c),
                "hoisted_adj": (k.dp.st, d.lam, c,
                                [h[n] for n in DP.HOISTED])}[name]
        with pytest.raises(ValueError, match="CUDA"):
            getattr(K, name)(*args)
        return
    if name.startswith("chain_"):
        eR = torch.zeros((cfg.Lp, k.g.S, 2), dtype=torch.float64)
        L = torch.full((2,), cfg.Lp, dtype=torch.int64)
        args = (k.dp.st, eR, L) + ((eR, torch.zeros((2, 3))) if
                                 name == "chain_adj" else ())
        with pytest.raises(ValueError, match="CUDA"):
            getattr(K, name)(*args)
        return
    if name == "score_tables":
        seq, L, bp_ok, dots_cum = J.score_inputs(cfg, k, batch.sd,
                                                 batch.bp_ok)
        with pytest.raises(ValueError, match="CUDA"):
            K.score_tables(k.tab, seq, L, bp_ok, dots_cum, cfg.Wp,
                           cfg.max_span, cfg.turn, False, False)
        return
    params = J.init_params(k.g, cfg, device="cpu")
    d, c = J.batch_factors(cfg, params, batch.sd, batch.bp_ok, device="cpu")
    h, state = k.dp.start(d, c)
    args = (state, 1, d, c, h, k.dp.st)
    if name.startswith("max_") or name == "cyk_traceback":
        mst = DMB.MaxStatic.of(k.dp.st)
        args = (state, d, c, mst, 1e-9) if name == "cyk_traceback" else \
            (state, 1, d, c, mst)
    if name.endswith("_adj"):
        args = (state, DP.init_grads(state, d, c, h)) + args[1:]
    with pytest.raises(ValueError, match="CUDA"):
        getattr(K, name)(*args)


@pytest.mark.parametrize("nonzero", [False, True])
def test_kernels_take_the_class_probe_as_zeros_only(nonzero):
    """The kernels write the class sums without adding the probe to the
    transitions, so their routes refuse a probe that is not all zero."""
    cls = torch.zeros((4, 6, 3), dtype=torch.float64)
    if not nonzero:
        K._req_zero_probe(cls)
        return
    cls[2, 4, 1] = 1e-30
    with pytest.raises(ValueError, match="zeros only"):
        K._req_zero_probe(cls)


def _score_inputs(B, Lp, Wp, seed):
    """K1's inputs for B reads on the card, made with numpy: random codes
    up to each read's length (0 beyond; lengths from 1 to Lp, Lp among
    them), bp_ok a random 15% (K1 takes any mask), dots_cum of random
    dots."""
    rng = np.random.RandomState(seed)
    L = rng.randint(1, Lp + 1, B)
    L[0] = Lp
    seq = rng.randint(1, 5, (B, Lp))
    seq[np.arange(Lp)[None, :] >= L[:, None]] = 0
    bp = rng.rand(B, Lp + 1, Wp + 1) < 0.15
    dots = rng.rand(B, Lp) < 0.9
    dc = np.concatenate([np.zeros((B, 1), np.int64), np.cumsum(dots, 1)], 1)
    f = lambda x, t: torch.as_tensor(x, dtype=t, device="cuda")
    return (f(seq, torch.int64), f(L, torch.int64), f(bp, torch.bool),
            f(dc, torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("B", [1, 7, 128, 600])
@pytest.mark.parametrize("opts", [{}, dict(fix_rss=True), dict(no_ene=True),
                                  dict(turn=0), dict(span=60)])
def test_score_tables_kernel_matches_plain(dtype, B, opts):
    """K1 (one launch) against its plain version: ints and bools equal,
    floats within 1e-6 relative with the same -inf cells, at B = 1, 7,
    128, 600 (groups of reads with an empty tail), under fix_rss, no_ene
    and both hairpin turns, and with the band as wide as the reads (span
    60 > Lp: diagonals from -Lp, i < 0 everywhere at the left)."""
    _need_cuda()
    opts = dict(opts)
    cfg = J.ModelConfig(pattern="(.....)", Lp=40,
                        max_span=opts.pop("span", 24), max_iloop=12,
                        min_bpp=0.0, tau=0.1, dtype=dtype, **opts)
    k = J.kernels(cfg, "cuda")
    args = _score_inputs(B, cfg.Lp, cfg.Wp, seed=B) + (
        cfg.Wp, cfg.max_span, cfg.turn, cfg.no_ene, cfg.fix_rss)
    K.reset_counts()
    got = ET.score_tables(k.tab, *args)
    assert K.KERNELS["score_tables"].launches == 1
    want = ET.score_tables_plain(k.tab, *args)
    for key in ET.SCORE_KEYS:
        a, b = got[key].cpu(), want[key].cpu()
        assert (a.dtype, a.shape) == (b.dtype, b.shape), key
        if not b.is_floating_point():
            assert torch.equal(a, b), key
            continue
        assert torch.equal(torch.isneginf(a), torch.isneginf(b)), key
        fin = torch.isfinite(b)
        assert torch.all((a[fin] - b[fin]).abs()
                         <= 1e-6 * b[fin].abs() + 1e-12), key
    batch = _batch(cfg, "cuda")
    real = J.score_inputs(cfg, k, batch.sd, batch.bp_ok) + args[4:]
    for key, a in ET.score_tables(k.tab, *real).items():
        b = ET.score_tables_plain(k.tab, *real)[key]
        if not b.is_floating_point():
            assert torch.equal(a, b), key


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", ["(.....)", "(.*)", "..*.."])
@pytest.mark.parametrize("dtype,tol", [("float64", 1e-9), ("float32", 2e-3)])
def test_inside_kernels_match_plain(pattern, dtype, tol):
    """The forward through K1-K4 vs the f64 plain version (on the CPU) on
    the same inputs; every kernel launched."""
    _need_cuda()
    ref_cfg = _cfg("float64", pattern)
    batch = _batch(ref_cfg, "cpu")
    k = J.kernels(ref_cfg, "cpu")
    rng = np.random.RandomState(3)
    p = J.init_params(k.g, ref_cfg, device="cpu")
    p = J.Params(p.singles + 0.3 * torch.as_tensor(rng.randn(*p.singles.shape)),
                 p.pairs + 0.3 * torch.as_tensor(rng.randn(*p.pairs.shape)),
                 torch.tensor([0.8, 1.2], dtype=torch.float64))
    ref = J.batch_logZ_parts(ref_cfg, p, batch.sd, batch.bp_ok, device="cpu")
    cfg = _cfg(dtype, pattern)
    dt = torch.float32 if dtype == "float32" else torch.float64
    pc = J.Params(*[x.to("cuda", dt) for x in p])
    sdc = J.SeqData(*[x.cuda() for x in batch.sd])
    K.reset_counts()
    got = J.batch_logZ_parts(cfg, pc, sdc, batch.bp_ok.cuda(), device="cuda")
    torch.cuda.synchronize()
    for name in ("score_tables", "inside_band", "inside_ep", "inside_ext"):
        assert K.KERNELS[name].launches > 0, name
    fin = torch.isfinite(ref)
    assert torch.equal(fin, torch.isfinite(got.cpu()))
    assert float((got.cpu().double() - ref)[fin].abs().max()) <= tol


def _random_rss(rng, L, min_loop=3):
    """A random nested dot-bracket structure of length L."""
    rss, opened = [], []
    for p in range(L):
        if opened and p - opened[-1] > min_loop and rng.rand() < 0.3:
            opened.pop()
            rss.append(")")
        elif rng.rand() < 0.25:
            opened.append(p)
            rss.append("(")
        else:
            rss.append(".")
    for p in opened:  # unmatched openings stay unpaired
        rss[p] = "."
    return "".join(rss)


@pytest.mark.gpu
@pytest.mark.parametrize("opts", [
    dict(fix_rss=True),
    dict(fix_rss=True, no_ene=True, turn=0, tau=1.0),
    dict(no_ene=True),
    dict(no_prf=True, theta_softmax=True),
    dict(turn=0, max_iloop=4),
])
def test_inside_kernel_branches_match_plain(opts):
    """The kernels' option branches (fixed structure dot gating, energies
    off, no profile, no hairpin turn, a narrow loop cap) vs the f64 plain
    version on the CPU."""
    _need_cuda()
    kw = dict(pattern="(.*)", Lp=30, max_span=20, max_iloop=12,
              min_bpp=0.0, tau=0.1, dtype="float64")
    kw.update(opts)
    cfg = J.ModelConfig(**kw)
    rng = np.random.RandomState(7)
    sds = []
    for L in (30, 26, 21):
        s = "".join("ACGU"[c] for c in rng.randint(0, 4, L))
        q = rng.randint(0, 40, L + 1)
        rss = _random_rss(rng, L) if cfg.fix_rss else ""
        sds.append(J.make_seqdata(cfg, seq_to_ints(s), q, rss))
    sd = J.stack_seqdata(sds, "cpu")
    bp, _ = J.effective_bp_mask_batch(cfg, sd, device="cpu")
    p = J.init_params(J.kernels(cfg, "cpu").g, cfg, device="cpu")
    p = J.Params(p.singles + 0.3 * torch.as_tensor(rng.randn(*p.singles.shape)),
                 p.pairs + 0.3 * torch.as_tensor(rng.randn(*p.pairs.shape)),
                 torch.tensor([0.7, 1.3], dtype=torch.float64))
    ref = J.batch_logZ_parts(cfg, p, sd, bp, device="cpu")
    got = J.batch_logZ_parts(cfg, J.Params(*[x.cuda() for x in p]),
                             J.SeqData(*[x.cuda() for x in sd]), bp.cuda(),
                             device="cuda").cpu()
    fin = torch.isfinite(ref)
    assert fin.any()
    assert torch.equal(fin, torch.isfinite(got))
    assert float((got - ref)[fin].abs().max()) <= 1e-9


@pytest.mark.gpu
def test_column_stages_match_plain():
    """Each column stage alone, f64, on identical inputs."""
    _need_cuda()
    cfg = _cfg("float64")
    batch = _batch(cfg, "cuda")
    k = J.kernels(cfg, "cuda")
    params = J.init_params(k.g, cfg, device="cuda")
    d, c = J.batch_factors(cfg, params, batch.sd, batch.bp_ok, device="cuda")
    h, state = k.dp.start(d, c)
    j0, PAD = 30, k.dp.st.PAD
    k.dp.run_columns(state, d, c, h, 1, j0)
    for stage, plain in zip(DP.STAGES, DP.PLAIN_STAGES):
        ks = DP.clone_state(state)
        stage(ks, j0, d, c, h, k.dp.st)
        plain(state, j0, d, c, h, k.dp.st)
        for key in ("LL", "P", "T2", "Bt", "T1", "M", "E", "O"):
            a, b = ks[key][j0 + PAD], state[key][j0 + PAD]
            assert torch.equal(torch.isfinite(a), torch.isfinite(b)), key
            fin = torch.isfinite(b)
            assert torch.all((a[fin] - b[fin]).abs()
                             <= 1e-9 * b[fin].abs().clamp(min=1)), key


def _adj_inputs(cfg, device, seed=3):
    """Factors of a random batch with randomized weights, the kernel
    forward's tables and a random parts cotangent."""
    batch = _batch(cfg, device, seed=seed)
    k = J.kernels(cfg, device)
    rng = np.random.RandomState(seed)
    p = J.init_params(k.g, cfg, device="cpu", dtype="float64")
    dt = torch.float32 if cfg.dtype == "float32" else torch.float64
    f = lambda x: torch.as_tensor(x, dtype=dt, device=device)
    p = J.Params(f(p.singles.numpy() + 0.3 * rng.randn(*p.singles.shape)),
                 f(p.pairs.numpy() + 0.3 * rng.randn(*p.pairs.shape)),
                 f(np.array([0.8, 1.2])))
    d, c = J.batch_factors(cfg, p, batch.sd, batch.bp_ok, device=device)
    h = DP.hoisted(d, c, k.dp.st)
    fs = k.dp.run_inside(d, c, h)
    gbar = f(rng.rand(c.wsp.shape[-1], 3))
    return k.dp, d, c, h, fs, gbar


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", ["(.....)", "(.*)", "..*.."])
@pytest.mark.parametrize("dtype,tol", [("float64", 1e-9), ("float32", 1e-4)])
def test_outside_kernels_match_plain(pattern, dtype, tol):
    """K5-K7 (ext_adj, e_adj, ep_adj, band_adj) one stage at a time on
    column j0 against their plain adjoints, on identical inputs: the
    cotangent tables below j0 and every row cotangent, relative to its
    max norm."""
    _need_cuda()
    cfg = _cfg(dtype, pattern)
    dp, d, c, h, fs, gbar = _adj_inputs(cfg, "cuda")
    st, j0 = dp.st, 25
    gs = DP.init_grads(fs, d, c, h)
    DP.seed_parts(gs, gbar, c, st)
    dp.outside_columns(fs, gs, d, c, h, cfg.Lp + 1, j0 + 1)
    K.reset_counts()
    for stage, plain in zip(DP.ADJ_STAGES, DP.PLAIN_ADJ_STAGES):
        kg = {k_: v.clone() for k_, v in gs.items() if not k_.startswith("_")}
        stage(fs, kg, j0, d, c, h, st)
        plain(fs, gs, j0, d, c, h, st)
        rows = j0 + st.PAD + (0 if stage.__name__ == "band_adj" else 1)
        pairs = [(kg[k_][:rows], gs[k_][:rows]) for k_ in DP.GRAD_TABLES]
        pairs += [(kg[k_], gs[k_]) for k_ in
                  ("eR", "eL", "bg2", "pv", "alphaP", "emisA", "emisB")]
        for a, b in pairs:
            assert not torch.isnan(a).any(), stage.__name__
            scale = max(1.0, float(b.abs().max()))
            assert float((a - b).abs().max()) <= tol * scale, stage.__name__
    for name in ("outside_band", "outside_ep", "outside_ext"):
        assert K.KERNELS[name].launches > 0, name


@pytest.mark.gpu
def test_outside_pass_kernels_match_plain_and_repeat_bitwise():
    """The whole outside pass at f64: kernels vs plain versions on the
    same forward tables, and two kernel runs give the same bits."""
    _need_cuda()
    cfg = _cfg("float64")
    dp, d, c, h, fs, gbar = _adj_inputs(cfg, "cuda", seed=4)
    got = dp.outside(fs, gbar, d, c, h)
    again = dp.outside(fs, gbar, d, c, h)
    gs = DP.init_grads(fs, d, c, h)
    DP.seed_parts(gs, gbar, c, dp.st)
    for j in range(cfg.Lp, 0, -1):
        for plain in DP.PLAIN_ADJ_STAGES:
            plain(fs, gs, j, d, c, h, dp.st)
    want = DP.finish_grads(gs, dp.st)
    for a, a2 in zip(got, again):
        assert torch.equal(a, a2)
    # the kernels carry the size weights' cotangent on eSZg, the plain
    # version on eSZ: lambda's whole cotangent compares
    pairs = list(zip(got[:4], want[:4])) + [
        (got[5], want[5]), (DP.lam_total(got, d, c, dp.st),
                            DP.lam_total(want, d, c, dp.st))]
    for a, b in pairs:
        scale = max(1.0, float(b.abs().max()))
        assert float((a - b).abs().max()) <= 1e-9 * scale


@pytest.mark.gpu
def test_bpp_masks_kernels_match_plain():
    """The S=1 pass of the min-BPP masks: posteriors through K1-K7 at f64
    against the same function on the CPU (plain versions)."""
    _need_cuda()
    cfg = J.ModelConfig(pattern="(.....)", Lp=40, max_span=24, max_iloop=12,
                        min_bpp=1e-4, dtype="float64")
    batch = _batch(cfg, "cpu", seed=6)
    zc, pc, bc = J.bpp_posterior_batch(cfg, batch.sd, device="cpu")
    sd = J.SeqData(*[x.cuda() for x in batch.sd])
    K.reset_counts()
    zg, pg, bg = J.bpp_posterior_batch(cfg, sd, device="cuda")
    for name in DP_KERNELS:
        assert K.KERNELS[name].launches > 0, name
    assert torch.equal(bg.cpu(), bc)
    assert float((zg.cpu() - zc).abs().max()) <= 1e-9
    assert float((pg.cpu() - pc).abs().max()) <= 1e-9


def _chain_inputs(pattern, tau, dtype, no_prf=False, n=6, seed=8):
    """eR [Lp, S, B] of random reads with random emissions, their
    lengths and a random parts cotangent, on the card."""
    cfg = J.ModelConfig(pattern=pattern, Lp=40, max_span=24, max_iloop=12,
                        min_bpp=0.0, tau=tau, no_rss=True, no_prf=no_prf,
                        dtype=dtype)
    batch = _batch(cfg, "cuda", n=n, seed=seed)
    k = J.kernels(cfg, "cuda")
    rng = np.random.RandomState(seed)
    p = J.init_params(k.g, cfg, device="cuda")
    p = p._replace(singles=p.singles + torch.as_tensor(
        0.3 * rng.randn(*p.singles.shape), dtype=p.singles.dtype,
        device="cuda"))
    eR = J.right_emissions(cfg, k, J.per_read(p, n), batch.sd)
    L = torch.as_tensor(batch.sd.L, device="cuda").long()
    gp = torch.as_tensor(rng.rand(n, 3), dtype=eR.dtype, device="cuda")
    return k.dp.st, eR, L, gp


@pytest.mark.gpu
@pytest.mark.parametrize("pattern,tau,no_prf", [
    ("..*..", 0.1, False), ("..*..", 0.0, False), ("....*....", 0.1, False),
    ("..*..", 0.1, True)])
@pytest.mark.parametrize("dtype,tol", [("float64", 1e-9), ("float32", 1e-4)])
@pytest.mark.parametrize("B", [1, 7, 128, 600])
def test_chain_kernels_match_plain(pattern, tau, no_prf, dtype, tol, B):
    """K8 (parts) and K9 (the cotangent of eR) against the plain chain
    and its autograd on the same inputs, relative in the max norm, at B =
    1, 7, 128 and 600 reads; two kernel runs give the same bits; likewise
    under a pin per read with the class sums of K9 against the plain
    chain's class probe."""
    _need_cuda()
    st, eR, L, gp = _chain_inputs(pattern, tau, dtype, no_prf, n=B)
    K.reset_counts()
    parts, rows = K.chain_fwd(st, eR, L)
    g = K.chain_adj(st, eR, L, rows, gp)
    parts2, rows2 = K.chain_fwd(st, eR, L)
    assert torch.equal(parts, parts2)
    assert torch.equal(g, K.chain_adj(st, eR, L, rows2, gp))
    assert K.KERNELS["linear_fwd"].launches == 2
    assert K.KERNELS["linear_adj"].launches == 2
    leaf = eR.detach().clone().requires_grad_(True)
    want = LIN.chain_plain(st, leaf, L)
    (gw,) = torch.autograd.grad(want, leaf, gp)
    want = want.detach()
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(parts))
    assert float((parts - want)[fin].abs().max()) <= tol * float(
        want[fin].abs().max())
    assert not torch.isnan(g).any()
    assert float((g - gw).abs().max()) <= tol * float(gw.abs().max())
    B = eR.shape[-1]
    pin = DP.Pin(torch.as_tensor(np.arange(B) * 5 % 30 - 1, dtype=torch.int32,
                                 device="cuda"), DP.CLS_START)
    parts, rows = K.chain_fwd(st, eR, L, pin)
    cls = torch.empty((4, eR.shape[0], B), dtype=eR.dtype, device="cuda")
    g = K.chain_adj(st, eR, L, rows, gp, pin, cls)
    cls2 = torch.empty_like(cls)
    assert torch.equal(g, K.chain_adj(st, eR, L, rows, gp, pin, cls2))
    assert torch.equal(cls, cls2)
    leaf = eR.detach().clone().requires_grad_(True)
    probe = torch.zeros_like(cls, requires_grad=True)
    want = LIN.chain_plain(st, leaf, L, LIN.chain_aux(
        st, eR.shape[0], B, pin=pin, cls=probe))
    gw, gc = torch.autograd.grad(want, [leaf, probe], gp)
    want = want.detach()
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(parts))
    assert float((parts - want)[fin].abs().max()) <= tol * float(
        want[fin].abs().max())
    for a, b in ((g, gw), (cls, gc)):
        assert not torch.isnan(a).any()
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


def _chain_plans(st, S, Lp, B, dtype, aux):
    """Every plan of K8 and K9 for the shape: the shape's (the one-warp
    block at S <= 32), K9 also in tiles of 3 steps and in the device
    variant."""
    nnz = int(st.k["rtr_t"].numel())
    fwd = [K.chain_plan("linear_fwd", S, Lp, B, dtype, aux, 0)]
    p = K.chain_plan("linear_adj", S, Lp, B, dtype, aux, nnz)
    adj = [p, p._replace(R=3, smem=K.chain_smem_bytes(
        "linear_adj", S, dtype, 3, nnz, aux)),
        K.chain_plan("linear_adj", S, Lp, B, dtype, aux, nnz,
                     variant="device")]
    return fwd, adj


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", ["..*..", "....*...."])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("pinned", [False, True])
def test_chain_kernels_do_not_depend_on_the_batch(pattern, dtype, pinned):
    """Each read's K8 parts and chain rows (up to its length: rows beyond
    it are not written) and K9's cotangent of eR and class sums (with a
    pin per read and the class probe) are bitwise equal in batches of
    600, 1, 7 and 128 reads and under every plan of the kernels: the
    shape's (one warp at S=28), K9's tiles of 3 steps and its device
    variant."""
    _need_cuda()
    st, eR, L, gp = _chain_inputs(pattern, 0.1, dtype, n=600, seed=12)
    Lp, S, B = eR.shape
    pin = DP.Pin(torch.as_tensor(np.arange(B) * 7 % 45 - 5,
                                 dtype=torch.int32, device="cuda"),
                 DP.CLS_START) if pinned else None

    def run(lo, hi, fplan=None, aplan=None):
        pn = None if pin is None else pin._replace(
            pos=pin.pos[lo:hi].contiguous())
        e, l_ = eR[..., lo:hi].contiguous(), L[lo:hi].contiguous()
        parts, rows = K.chain_fwd(st, e, l_, pn, plan=fplan)
        gpp = torch.where(torch.isfinite(parts), gp[lo:hi], 0.0)
        cls = torch.empty((4, Lp, hi - lo), dtype=eR.dtype, device="cuda") \
            if pinned else None
        g = K.chain_adj(st, e, l_, rows, gpp.contiguous(), pn, cls,
                        plan=aplan)
        return parts, rows, g, cls

    ref = run(0, B)
    Ls = L.clamp(max=Lp).tolist()

    def same(out, lo):
        parts, rows, g, cls = out
        for i in range(parts.shape[0]):
            b = lo + i
            assert torch.equal(parts[i], ref[0][b]), b
            assert torch.equal(rows[:Ls[b] + 1, :, i],
                               ref[1][:Ls[b] + 1, :, b]), b
            assert torch.equal(g[..., i], ref[2][..., b]), b
            if pinned:
                assert torch.equal(cls[..., i], ref[3][..., b]), b

    for lo, hi in ((0, 1), (3, 10), (100, 228), (599, 600)):
        same(run(lo, hi), lo)
    fwd, adj = _chain_plans(st, S, Lp, B, eR.dtype, pinned)
    assert (fwd[0].walkers == 32) == (S <= 32)
    K.reset_counts()
    for fp in fwd:
        for ap in adj:
            same(run(0, B, fp, ap), 0)
    n = len(fwd) * len(adj)
    assert K.KERNELS["linear_fwd"].launches == n
    assert K.KERNELS["linear_adj"].launches == n
    assert sum(K.KERNELS["linear_adj"].variants.values()) == n


@pytest.mark.gpu
@pytest.mark.parametrize("pattern,opts", [
    ("(.*)", {}), ("..*..", dict(no_rss=True))])
def test_per_read_gradients_on_the_card_match_cpu(pattern, opts):
    """batch_fn_grad_pr through the kernels (one shared lambda, per-read
    partials) against the plain versions on the CPU, f64, per read."""
    _need_cuda()
    cfg = J.ModelConfig(pattern=pattern, Lp=40, max_span=24, max_iloop=12,
                        min_bpp=1e-4, tau=0.1, dtype="float64", **opts)
    batch = _batch(cfg, "cpu", seed=9)
    rng = np.random.RandomState(9)
    p = J.init_params(J.kernels(cfg, "cpu").g, cfg, device="cpu")
    noise = lambda x: 0.3 * torch.as_tensor(rng.randn(*x.shape))
    p = J.Params(p.singles + noise(p.singles), p.pairs + noise(p.pairs),
                 torch.tensor([0.7, 1.3], dtype=torch.float64))
    fc, gc, _ = OBJ.batch_fn_grad_pr(cfg, p, batch, device="cpu")
    bg = OBJ.BatchData(*[J.SeqData(*[x.cuda() for x in f])
                         if isinstance(f, J.SeqData) else f.cuda()
                         for f in batch])
    fg, gg, _ = OBJ.batch_fn_grad_pr(cfg, J.Params(*[x.cuda() for x in p]),
                                     bg, device="cuda")
    assert float((fg.cpu() - fc).abs().max()) <= 1e-9
    for a, b in zip(gg, gc):
        for r in range(b.shape[0]):
            scale = max(1.0, float(b[r].abs().max()))
            assert float((a[r].cpu() - b[r]).abs().max()) <= 1e-9 * scale


def _to(batch, dev, lo=0, hi=None):
    """Rows lo:hi of a batch, on ``dev``."""
    cut = lambda x: x[lo:hi].to(dev)
    return OBJ.BatchData(*[J.SeqData(*[cut(x) for x in f])
                           if isinstance(f, J.SeqData) else cut(f)
                           for f in batch])


def _random_params(cfg, dev, seed=9):
    rng = np.random.RandomState(seed)
    p = J.init_params(J.kernels(cfg, "cpu").g, cfg, device="cpu",
                      dtype="float64")
    noise = lambda x: 0.3 * torch.as_tensor(rng.randn(*x.shape))
    dt = torch.float32 if cfg.dtype == "float32" else torch.float64
    return J.Params(*[x.to(dt).to(dev) for x in (
        p.singles + noise(p.singles), p.pairs + noise(p.pairs),
        torch.tensor([0.7, 1.3], dtype=torch.float64))])


@pytest.mark.gpu
@pytest.mark.parametrize("pattern,opts", [
    ("(.....)", {}), ("..*..", dict(no_rss=True)), (".....*.....", {})])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_per_read_outputs_do_not_depend_on_the_batch(pattern, opts, dtype):
    """On the card a read's f, every gradient leaf and eff have the same
    bits in any batch: the whole batch against its two parts (a
    data-parallel group gathers the shards' values and must train the
    single device's model), and the masks likewise.  The structure
    models run through the fused K3 and K6 (one block per read and range
    of x) and the M chain's read groups of K2 and K5 (9 reads: groups of
    8 or 4 that the parts 0:4 and 4:9 cut differently)."""
    _need_cuda()
    cfg = J.ModelConfig(pattern=pattern, Lp=40, max_span=24, max_iloop=12,
                        min_bpp=1e-4, tau=0.1, dtype=dtype, **opts)
    batch = _to(_batch(cfg, "cpu", n=9, seed=9), "cuda")
    p = _random_params(cfg, "cuda")
    K.reset_counts()
    whole = OBJ.batch_fn_grad_pr(cfg, p, batch, device="cuda")
    if not cfg.no_rss:
        for name in ("inside_band", "inside_ep", "outside_band",
                     "outside_ep"):
            assert K.KERNELS[name].launches > 0, name
    parts = [OBJ.batch_fn_grad_pr(cfg, p, _to(batch, "cuda", lo, hi),
                                  device="cuda")
             for lo, hi in ((0, 4), (4, None))]
    f, g, e = [[x[i] for x in parts] for i in range(3)]
    assert torch.equal(whole[0], torch.cat(f))
    assert torch.equal(whole[2], torch.cat(e))
    for k, leaf in enumerate(whole[1]):
        assert torch.equal(leaf, torch.cat([x[k] for x in g])), k
    keep, eff = OBJ.batch_bp_masks(cfg, batch.sd, "cuda")
    for lo, hi in ((0, 4), (4, None)):
        kp, ep = OBJ.batch_bp_masks(cfg, _to(batch, "cuda", lo, hi).sd,
                                    "cuda")
        assert torch.equal(kp, keep[lo:hi]) and torch.equal(ep, eff[lo:hi])


def _paired_rss(rng, s, min_loop=3):
    """A random nested structure on ``s`` whose pairs are canonical or
    G-U, so that the energy model admits it."""
    ok = ("AU", "UA", "GC", "CG", "GU", "UG")
    rss, opened = [], []
    for p, ch in enumerate(s):
        if opened and p - opened[-1] > min_loop and \
                s[opened[-1]] + ch in ok and rng.rand() < 0.5:
            opened.pop()
            rss.append(")")
        elif rng.rand() < 0.25:
            opened.append(p)
            rss.append("(")
        else:
            rss.append(".")
    for p in opened:
        rss[p] = "."
    return "".join(rss)


def _ep_reads(cfg, n, seed):
    """n random reads of Lp-40..Lp nt (loop caps C_b = min(L, span) - 7
    below Cp for the short ones), a random structure each under fix_rss."""
    rng = np.random.RandomState(seed)
    reads = []
    for i in range(n):
        L = int(rng.randint(max(12, cfg.Lp - 40), cfg.Lp + 1))
        s = "".join("ACGU"[c] for c in rng.randint(0, 4, L))
        q = rng.randint(0, 40, L + 1)
        q[-1] = 0 if i % 2 else 9
        reads.append((seq_to_ints(s), q,
                      _paired_rss(rng, s) if cfg.fix_rss else ""))
    return reads


def _ep_inputs(cfg, reads, null=False, seed=21):
    """(InsideDP, factors, hoisted terms, the kernel forward's tables, a
    parts cotangent) on the card for ``reads``: the grammar's DP with
    random weights, or the masks' S=1 DP."""
    sd = J.stack_seqdata([J.make_seqdata(cfg, *r) for r in reads], "cuda")
    k = J.kernels(cfg, "cuda")
    rng = np.random.RandomState(seed)
    if null:
        dp = k.dp_null
        d, c = J._null_batch_factors(cfg, k, sd,
                                     J._candidate_pairs(cfg, k, sd))
    else:
        dp = k.dp
        bp, _ = J.effective_bp_mask_batch(cfg, sd, device="cuda")
        d, c = J.batch_factors(cfg, _random_params(cfg, "cuda", seed), sd,
                               bp, device="cuda")
    h = DP.hoisted(d, c, dp.st)
    fs = dp.run_inside(d, c, h)
    gbar = torch.as_tensor(rng.rand(len(reads), 3), dtype=dp.st.dtype,
                           device="cuda")
    return dp, d, c, h, fs, gbar


EP_CASES = {
    "S29-f64": dict(pattern="(.....)", dtype="float64"),
    "S15-f64": dict(pattern="...", dtype="float64"),
    "S91-f64": dict(pattern=".....*.....", dtype="float64", n=3),
    "S1-f64": dict(pattern="(.....)", dtype="float64", null=True),
    "fix_rss-f64": dict(pattern="(.*)", dtype="float64", fix_rss=True),
    "no_ene-f64": dict(pattern="(.*)", dtype="float64", no_ene=True),
    "short-f64": dict(pattern="(.....)", dtype="float64", Lp=36),
    "S91-f64-wide": dict(pattern=".....*.....", dtype="float64", n=3,
                         Lp=120, max_span=110),
    "S29-f32-c32": dict(pattern="(.....)", dtype="float32", max_iloop=32),
    "S29-f32-B33": dict(pattern="(.....)", dtype="float32", n=33),
    "S91-f32": dict(pattern=".....*.....", dtype="float32"),
    "S1-f32-B33": dict(pattern="(.....)", dtype="float32", null=True,
                       n=33),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(EP_CASES))
def test_fused_ep_kernels_match_plain(case):
    """K3 (ep_stage) on every third column and K6 (ep_adj) on one against
    ep_stage_plain and ep_adj_plain on identical inputs, at the default
    spans (Cp=30, Wp=50; Wp=36 for the short reads, Wp=110 for the wide
    ones, Cp=32 the widest max internal loop every pattern fits) with
    loop caps below Cp: S=1 (the masks' null grammar), 15, 29 and 91,
    fix_rss and no_ene, B=5 and 33 (blocks of one read, ranges of x); f64
    within 1e-9 and f32 within 1e-4 relative; a second run of each
    kernel gives the same bits.  The outside pass reads the shifts of the
    forward from its cloned state."""
    _need_cuda()
    kw = dict(EP_CASES[case])
    n, null = kw.pop("n", 5), kw.pop("null", False)
    opts = dict(Lp=60, max_span=50, max_iloop=30, min_bpp=0.0, tau=0.1)
    opts.update(kw)
    cfg = J.ModelConfig(**opts)
    dp, d, c, h, fs, gbar = _ep_inputs(cfg, _ep_reads(cfg, n, 17), null)
    st = dp.st
    assert st.have_ep
    tol = 1e-9 if cfg.dtype == "float64" else 1e-4
    r = lambda j: j + st.PAD
    K.reset_counts()
    seen, cols = 0, range(1, cfg.Lp + 1, 3)
    for j in cols:
        ks = DP.clone_state(fs)
        ps = DP.clone_state(fs)
        K.ep_stage(ks, j, d, c, h, st)
        again = ks["ep"][r(j)].clone()
        K.ep_stage(ks, j, d, c, h, st)
        assert torch.equal(again, ks["ep"][r(j)])
        DP.ep_stage_plain(ps, j, d, c, h, st)
        a, b = ks["ep"][r(j)], ps["ep"][r(j)]
        fin = torch.isfinite(b)
        if cfg.dtype == "float64":
            assert torch.equal(torch.isfinite(a), fin), j
        else:   # f32 exp space flushes cells far below a read's maximum
            top = torch.where(fin, b, torch.full_like(b, -1e30)).reshape(
                -1, n).amax(0)
            fin = fin & (b >= top - 50.0)
            assert torch.isfinite(a[fin]).all(), j
        if fin.any():     # column 1 holds no internal loop
            seen += 1
            err = (a[fin] - b[fin]).abs() / b[fin].abs().clamp(min=1.0)
            assert float(err.max()) <= tol, j
    assert seen >= 3
    assert K.KERNELS["inside_ep"].launches == 2 * 2 * len(cols)
    gs = DP.init_grads(fs, d, c, h)
    DP.seed_parts(gs, gbar, c, st)
    j0 = cfg.Lp // 2
    dp.outside_columns(fs, gs, d, c, h, cfg.Lp + 1, j0 + 1)
    kg, kg2, pg = (DP.clone_state(gs) for _ in range(3))
    K.reset_counts()
    K.ep_adj(fs, kg, j0, d, c, h, st)
    K.ep_adj(fs, kg2, j0, d, c, h, st)
    assert K.KERNELS["outside_ep"].launches == 2 * 2
    assert K.KERNELS["inside_ep"].launches == 0
    for k_ in kg:
        if not k_.startswith("_"):
            assert torch.equal(kg[k_], kg2[k_]), k_
    DP.ep_adj_plain(fs, pg, j0, d, c, h, st)
    for k_ in DP.GRAD_TABLES + ("emisA", "emisB"):
        a, b = kg[k_], pg[k_]
        assert not torch.isnan(a).any(), k_
        scale = max(1.0, float(b.abs().max()))
        assert float((a - b).abs().max()) <= tol * scale, k_
    lk = DP.lam_total(DP.finish_grads(kg, st), d, c, st)
    lp = DP.lam_total(DP.finish_grads(pg, st), d, c, st)
    assert float((lk - lp).abs().max()) <= tol * max(
        1.0, float(lp.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fused_ep_kernels_do_not_depend_on_the_batch(dtype):
    """K3's ep table and the outside pass's cotangents through K6 of a
    batch of 9 reads and of its parts 0:4 and 4:9 have the same bits per
    read."""
    _need_cuda()
    cfg = J.ModelConfig(pattern="(.....)", Lp=60, max_span=50,
                        max_iloop=30, min_bpp=0.0, tau=0.1, dtype=dtype)
    reads = _ep_reads(cfg, 9, 23)
    dp, d, c, h, fs, gbar = _ep_inputs(cfg, reads)
    whole = dp.outside_state(fs, gbar, d, c, h)
    for lo, hi in ((0, 4), (4, 9)):
        dq, cq, hq, fq, _ = _ep_inputs(cfg, reads[lo:hi])[1:]
        assert torch.equal(fs["ep"][..., lo:hi], fq["ep"])
        part = dp.outside_state(fq, gbar[lo:hi], dq, cq, hq)
        for k_ in DP.GRAD_TABLES + ("DL", "GSZ", "emisA", "emisB"):
            assert torch.equal(whole[k_][..., lo:hi], part[k_]), k_


def _band_inputs(cfg, reads, null=False, pinned=False, seed=21):
    """_ep_inputs, and with ``pinned`` the scanner's aux: a pin per read
    (start class, the last read unpinned) and the class probe."""
    if not pinned:
        return _ep_inputs(cfg, reads, null, seed)
    sd = J.stack_seqdata([J.make_seqdata(cfg, *r) for r in reads], "cuda")
    k = J.kernels(cfg, "cuda")
    rng = np.random.RandomState(seed)
    pos = (rng.rand(len(reads)) * J._np(sd.L)).astype(np.int32)
    pos[-1] = -1
    aux = {"cls": torch.zeros((4, cfg.Lp, len(reads)), dtype=k.dp.st.dtype,
                              device="cuda"),
           "pin": DP.Pin(torch.as_tensor(pos, device="cuda"), DP.CLS_START)}
    bp, _ = J.effective_bp_mask_batch(cfg, sd, device="cuda")
    d, c = J.batch_factors(cfg, _random_params(cfg, "cuda", seed), sd, bp,
                           device="cuda", aux_b=aux)
    h = DP.hoisted(d, c, k.dp.st)
    fs = k.dp.run_inside(d, c, h)
    gbar = torch.as_tensor(rng.rand(len(reads), 3), dtype=k.dp.st.dtype,
                           device="cuda")
    gbar = torch.where(torch.isfinite(k.dp.extract_parts(fs["O"], c)), gbar,
                       0.0)
    return k.dp, d, c, h, fs, gbar


BAND_CASES = {
    "S29-f64": dict(pattern="(.....)", dtype="float64"),
    "S29-f32-B33": dict(pattern="(.....)", dtype="float32", n=33),
    "S1-f64": dict(pattern="(.....)", dtype="float64", null=True),
    "S1-f32-B33": dict(pattern="(.....)", dtype="float32", null=True,
                       n=33),
    "S78-f32": dict(pattern="..........", dtype="float32"),
    "S91-f64": dict(pattern=".....*.....", dtype="float64"),
    "S91-f32-B33": dict(pattern=".....*.....", dtype="float32", n=33),
    "S29-f64-pin": dict(pattern="(.....)", dtype="float64", pinned=True),
    "S29-f32-pin-B33": dict(pattern="(.....)", dtype="float32",
                            pinned=True, n=33),
    "S91-f64-pin": dict(pattern=".....*.....", dtype="float64",
                        pinned=True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(BAND_CASES))
def test_m_chain_kernels_match_plain(case):
    """K2's stages (band_front, band_bif, band_m, band_e) and K5's (e_adj,
    band_adj) at one column against their plain versions on identical
    inputs: the masks' null grammar (S=1), S=29, 78 and 91 (an M-chain
    block of 8 or 4 reads spans several warps), B=5 and 33 (not a
    multiple of the reads per block), and the scanner's pin with the
    class probe; f64 within 1e-9 and f32 within 1e-4 relative; a second
    run of each kernel gives the same bits; K5 takes five launches per
    column, six with the class probe."""
    _need_cuda()
    kw = dict(BAND_CASES[case])
    n, null = kw.pop("n", 5), kw.pop("null", False)
    pinned = kw.pop("pinned", False)
    opts = dict(Lp=60, max_span=50, max_iloop=30, min_bpp=0.0, tau=0.1)
    opts.update(kw)
    cfg = J.ModelConfig(**opts)
    dp, d, c, h, fs, gbar = _band_inputs(cfg, _ep_reads(cfg, n, 19), null,
                                         pinned)
    st, j0 = dp.st, 40
    r, f32 = j0 + st.PAD, cfg.dtype == "float32"
    tol = 1e-4 if f32 else 1e-9
    for name, outs in (("band_front", ("LL", "P", "T2")),
                       ("band_bif", ("Bt", "T1")), ("band_m", ("M",)),
                       ("band_e", ("E",))):
        ks, ps = DP.clone_state(fs), DP.clone_state(fs)
        getattr(K, name)(ks, j0, d, c, h, st)
        first = {k_: ks[k_][r].clone() for k_ in outs}
        getattr(K, name)(ks, j0, d, c, h, st)
        getattr(DP, name + "_plain")(ps, j0, d, c, h, st)
        for k_ in outs:
            a, b = ks[k_][r], ps[k_][r]
            assert torch.equal(first[k_], a), (name, k_)
            fin = torch.isfinite(b)
            if f32:     # cells far below a read's maximum may flush
                top = torch.where(fin, b, torch.full_like(b, -1e30)).reshape(
                    -1, n).amax(0)
                fin = fin & (b >= top - 50.0)
                assert torch.isfinite(a[fin]).all(), (name, k_)
            else:
                assert torch.equal(torch.isfinite(a), fin), (name, k_)
            err = (a[fin] - b[fin]).abs() / b[fin].abs().clamp(min=1.0)
            assert fin.sum() == 0 or float(err.max()) <= tol, (name, k_)
    gs = DP.init_grads(fs, d, c, h)
    DP.seed_parts(gs, gbar, c, st)
    dp.outside_columns(fs, gs, d, c, h, cfg.Lp + 1, j0 + 1)
    kg, kg2, pg = (DP.clone_state(gs) for _ in range(3))
    K.reset_counts()
    for g_ in (kg, kg2):
        K.e_adj(fs, g_, j0, d, c, h, st)
        K.band_adj(fs, g_, j0, d, c, h, st)
    assert K.KERNELS["outside_band"].launches == 2 * (6 if pinned else 5)
    for k_ in kg:
        if not k_.startswith("_"):
            assert torch.equal(kg[k_], kg2[k_]), k_
    DP.e_adj_plain(fs, pg, j0, d, c, h, st)
    DP.band_adj_plain(fs, pg, j0, d, c, h, st)
    pairs = [(kg[k_][:r], pg[k_][:r]) for k_ in DP.GRAD_TABLES]
    pairs += [(kg[k_], pg[k_]) for k_ in
              ("eR", "eL", "bg2", "pv", "alphaP", "gM", "gep")
              + (("cls",) if pinned else ())]
    pairs.append((DP.lam_total(DP.finish_grads(kg, st), d, c, st),
                  DP.lam_total(DP.finish_grads(pg, st), d, c, st)))
    for i, (a, b) in enumerate(pairs):
        assert not torch.isnan(a).any(), i
        scale = max(1.0, float(b.abs().max()))
        assert float((a - b).abs().max()) <= tol * scale, i


@pytest.mark.gpu
def test_launches_follow_the_tensors_device():
    """Kernels launch on the device of their tensors, whatever device is
    current: batch_fn_grad_pr on cuda:1 from a process whose current
    device is 0 gives cuda:0's bits (needs two cards)."""
    _need_cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    cfg = _cfg("float64")
    torch.cuda.set_device(0)
    outs = []
    for dev in ("cuda:0", "cuda:1"):
        K.reset_counts()
        out = OBJ.batch_fn_grad_pr(cfg, _random_params(cfg, dev),
                                   _to(_batch(cfg, "cpu"), dev), device=dev)
        torch.cuda.synchronize(dev)
        assert K.KERNELS["outside_ep"].launches > 0
        assert torch.cuda.current_device() == 0
        outs.append([out[0].cpu(), *[x.cpu() for x in out[1]], out[2].cpu()])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def _scan_inputs(pattern, opts, device, n=5, seed=11):
    """A scan config (f64, plain theta) with random weights and a batch
    of random reads on ``device``."""
    cfg = J.ModelConfig(pattern=pattern, Lp=40, max_span=24, max_iloop=12,
                        min_bpp=1e-4, tau=0.1, dtype="float64", **opts)
    batch = _batch(cfg, "cpu", n=n, seed=seed)
    rng = np.random.RandomState(seed)
    p = J.init_params(J.kernels(cfg, "cpu").g, cfg, device="cpu")
    noise = lambda x: 0.3 * torch.as_tensor(rng.randn(*x.shape))
    p = J.Params(p.singles + noise(p.singles), p.pairs + noise(p.pairs),
                 torch.tensor([0.7, 1.3], dtype=torch.float64))
    if device != "cpu":
        batch = batch._replace(sd=J.SeqData(*[x.cuda() for x in batch.sd]),
                               bp_ok=batch.bp_ok.cuda())
        p = J.Params(*[x.cuda() for x in p])
    return cfg, p, batch


@pytest.mark.gpu
@pytest.mark.parametrize("pattern,opts", [
    ("(.....)", {}), ("(.*)", {}), ("..*..", dict(no_rss=True))])
def test_pinned_parts_and_class_sums_match_plain(pattern, opts):
    """The pinned forward (K2/K4, or K8) and the class sums of the
    outside pass (K5/K7 and K5's cls_red, or K9) against the plain
    versions on the CPU, f64, with a pin per read (one read unpinned);
    two kernel runs give the same bits."""
    _need_cuda()
    out = {}
    for dev in ("cpu", "cuda"):
        cfg, p, batch = _scan_inputs(pattern, opts, dev)
        B = batch.valid.shape[0]
        pin = DP.Pin(torch.tensor([3, 17, 30, -1, 9][:B], dtype=torch.int32,
                                  device=dev), DP.CLS_START)
        runs = []
        for _ in range(1 if dev == "cpu" else 2):
            cls = torch.zeros((4, cfg.Lp, B), dtype=torch.float64,
                              device=dev, requires_grad=True)
            with torch.enable_grad():
                parts = J.batch_logZ_parts(cfg, p, batch.sd, batch.bp_ok,
                                           device=dev,
                                           aux_b=dict(cls=cls, pin=pin))
                gw = torch.isfinite(parts).to(parts.dtype)
                (g,) = torch.autograd.grad(parts, cls, gw)
            runs.append((parts.detach().cpu(), g.cpu()))
        if dev == "cuda":
            assert all(torch.equal(a, b) for a, b in zip(*runs))
        out[dev] = runs[0]
    (pc, gc), (pg, gg) = out["cpu"], out["cuda"]
    fin = torch.isfinite(pc)
    assert torch.equal(fin, torch.isfinite(pg))
    assert float((pg - pc)[fin].abs().max()) <= 1e-9 * float(
        pc[fin].abs().max())
    assert gc.abs().max() > 0
    assert float((gg - gc).abs().max()) <= 1e-9 * float(gc.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("pattern,opts", [
    ("(.....)", {}), ("..*..", dict(no_rss=True))])
def test_scan_posteriors_on_the_card_match_cpu(pattern, opts):
    """scan_posteriors_batch through the kernels against the plain
    versions on the CPU, f64: posteriors, E[N] and the pins Ys, Ye."""
    _need_cuda()
    from rnaelem_tpu_torch.scan import scanner as SC
    res = {}
    for dev in ("cpu", "cuda"):
        cfg, p, batch = _scan_inputs(pattern, opts, dev, seed=12)
        K.reset_counts()
        res[dev] = SC.scan_posteriors_batch(cfg, p, batch.sd, device=dev)
    names = ("linear_fwd", "linear_adj") if opts else DP_KERNELS
    for name in names:
        assert K.KERNELS[name].launches > 0, name
    for key in ("Pys", "Pyi", "Pye", "PyN", "Z", "Ze", "EN"):
        a, b = res["cuda"][key], res["cpu"][key]
        for x, y in (zip(a, b) if key == "EN" else [(a, b)]):
            x, y = x.cpu(), y
            assert float((x - y).abs().max()) <= 1e-9 * max(
                1.0, float(y.abs().max())), key
    for key in ("Ys", "Ye"):
        assert torch.equal(res["cuda"][key].cpu(), res["cpu"][key]), key


def _cyk_inputs(pattern, dtype, device, seed=13):
    """A scan config with random weights, a batch of random reads and the
    CYK pin set: read 0 its posterior Ys/Ye, read 1 Ye == L, read 2 Ys ==
    Ye, the rest their posterior pins."""
    cfg, p, batch = _scan_inputs(pattern, {}, "cpu", n=6, seed=seed)
    from rnaelem_tpu_torch.scan import scanner as SC
    res = SC.scan_posteriors_batch(cfg, p, batch.sd, device="cpu")
    Ys, Ye = res["Ys"].clone(), res["Ye"].clone()
    L = batch.sd.L.long()
    Ye[1], Ye[2] = L[1], Ys[2]
    cfg = dataclasses.replace(cfg, dtype=dtype)
    dt = torch.float32 if dtype == "float32" else torch.float64
    p = J.Params(*[x.to(device, dt) for x in p])
    sd = J.SeqData(*[x.to(device) for x in batch.sd])
    from rnaelem_tpu_torch.scan import cyk as CYK
    pins = CYK.cyk_pins(Ys.to(device), Ye.to(device), sd.L)
    d, c = J.batch_factors(cfg, p, sd, res["bp_ok"].to(device),
                           device=device, aux_b={"pin": pins})
    return cfg, d, c, (Ys, Ye, res["bp_ok"])


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", ["(.....)", "(.*)"])
@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12), ("float32", 1e-4)])
def test_max_kernels_match_plain(pattern, dtype, tol):
    """K10-K12 under the CYK pin set against the plain max DP on the same
    card tensors: every stage of one column on the kernels' own earlier
    columns, and the whole tables (identical -inf placement, finite cells
    within tol); two kernel runs give the same bits."""
    _need_cuda()
    cfg, d, c, _ = _cyk_inputs(pattern, dtype, "cuda")
    mdp = DMB.MaxDP(J.kernels(cfg, "cuda").dp)
    K.reset_counts()
    runs = [mdp.tables(d, c) for _ in range(2)]
    for name in ("inside_band_max", "inside_ep_max", "inside_ext_max"):
        assert K.KERNELS[name].launches > 0, name
    plain = mdp.tables(d, c, plain=True)
    j0 = cfg.Lp - 5
    col = DP.clone_state(runs[0])
    ref = DP.clone_state(runs[0])
    for kern, pl in zip(DMB.STAGES, DMB.PLAIN_STAGES):
        kern(col, j0, d, c, mdp.mst)
        pl(ref, j0, d, c, mdp.mst)
    r = j0 + mdp.st.PAD
    for key in ("LL", "P", "E", "M", "Bt", "T1", "T2", "ep", "O"):
        assert torch.equal(runs[0][key], runs[1][key]), key
        for a, b in ((runs[0][key], plain[key]), (col[key][r], ref[key][r])):
            assert torch.equal(torch.isfinite(a), torch.isfinite(b)), key
            fin = torch.isfinite(b)
            if fin.any():
                assert float((a[fin] - b[fin]).abs().max()) <= tol, key


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", ["(.....)", "(.*)"])
def test_cyk_traceback_kernel_matches_host(pattern):
    """K13 against its plain version (the host traceback) on the same
    f64 tables of K10-K12: every read's psihat and pair set identical,
    under the shape's plan and with the stack in shared memory and in the
    device scratch at 1, 4 and 8 warps, the outputs equal across plans."""
    _need_cuda()
    from rnaelem_tpu_torch.scan import cyk as CYK
    cfg, d, c, _ = _cyk_inputs(pattern, "float64", "cuda", seed=14)
    k = J.kernels(cfg, "cuda")
    mdp = DMB.MaxDP(k.dp)
    state = mdp.tables(d, c)
    host = CYK.host_tracebacks(cfg, k.g, state, d, c, k.dp.st, 1e-9)
    L = c.L.cpu().numpy()
    li = K.tb_lists(mdp.mst)[0]
    plans = [None] + [K.traceback_plan(cfg.Lp, k.dp.st.dtype,
                                       (li.ni, li.nt), variant=v, warps=w)
                      for v in ("shared", "device") for w in (1, 4, 8)]
    first = None
    for plan in plans:
        K.reset_counts()
        out = K.cyk_traceback(state, d, c, mdp.mst, 1e-9, plan=plan)
        psihat, pairs, err = out
        assert K.KERNELS["cyk_traceback"].launches == 1
        assert not err.any()
        for t, (path, _, cells) in enumerate(host):
            np.testing.assert_array_equal(psihat[t, :L[t]].cpu().numpy(),
                                          path)
            got = sorted(map(tuple, np.argwhere(pairs[t].cpu().numpy())))
            assert got == sorted(cells), t
        if first is None:
            first = out
        assert all(torch.equal(a, b) for a, b in zip(out, first))


def _cyk_chunk(n, dtype, seed, pattern="(.....)"):
    """CYK inputs on the card at the scan's spans (W=50, C=30, Lp=60):
    n random reads, random weights, the CYK pin set from the card's
    posterior pass (read 0 with Ye == L, read 1 with Ys == Ye)."""
    from rnaelem_tpu_torch.scan import cyk as CYK
    from rnaelem_tpu_torch.scan import scanner as SC
    cfg = J.ModelConfig(pattern=pattern, Lp=60, max_span=50, max_iloop=30,
                        min_bpp=1e-4, tau=0.1, dtype=dtype)
    sd = J.stack_seqdata([J.make_seqdata(cfg, *r)
                          for r in _ep_reads(cfg, n, seed)], "cuda")
    p = _random_params(cfg, "cuda", seed)
    res = SC.scan_posteriors_batch(cfg, p, sd, device="cuda")
    Ys, Ye = res["Ys"].clone(), res["Ye"].clone()
    L = torch.as_tensor(sd.L, device="cuda").long()
    Ye[0], Ye[1] = L[0], Ys[1]
    d, c = J.batch_factors(cfg, p, sd, res["bp_ok"], device="cuda",
                           aux_b={"pin": CYK.cyk_pins(Ys, Ye, L)})
    return cfg, d, c


@pytest.mark.gpu
@pytest.mark.parametrize("n,pattern", [(12, "(.....)"), (64, "(.....)"),
                                       (5, ".....*.....")])
def test_fused_cyk_ep_kernel_matches_plain_bitwise(n, pattern):
    """K11 (max_ep_stage) against the max DP's ep_stage_plain at f64 on a
    12- and a 64-read chunk (K11's ranges of x follow B) and on S=91 (13
    entries per list: more than a thread holds in registers) under the
    CYK pin set, on every column of the kernels' tables: the same bits
    (max commutes with rounding; each candidate keeps the plain version's
    order of additions); one launch per column, a second run the same
    bits, and no T or V table in the state, only the ranges' partial
    rows."""
    _need_cuda()
    cfg, d, c = _cyk_chunk(n, "float64", 40 + n, pattern)
    mdp = DMB.MaxDP(J.kernels(cfg, "cuda").dp)
    state = mdp.tables(d, c)
    ks, ps = DP.clone_state(state), DP.clone_state(state)
    st = mdp.st
    finite = 0
    for j in range(1, cfg.Lp + 1):
        r = j + st.PAD
        K.reset_counts()
        K.max_ep_stage(ks, j, d, c, mdp.mst)
        first = ks["ep"][r].clone()
        K.max_ep_stage(ks, j, d, c, mdp.mst)
        assert K.KERNELS["inside_ep_max"].launches == 2
        assert torch.equal(first, ks["ep"][r]), j
        DMB.ep_stage_plain(ps, j, d, c, mdp.mst)
        a, b = ks["ep"][r], ps["ep"][r]
        assert torch.equal(torch.isneginf(a), torch.isneginf(b)), j
        assert torch.equal(a, b), j
        finite += int(torch.isfinite(b).sum())
    assert finite > 0
    assert torch.equal(ks["ep"], state["ep"])
    scr = [k_ for k_ in ks if k_.startswith("_ep")]
    assert scr == ["_ep_max_scratch"], scr
    part = ks["_ep_max_scratch"]["part"]
    assert part.shape[1:] == (st.dims.S, n)
    assert part.shape[0] <= st.dims.Wp + 1 + 16 * st.dims.Cp


def _f64(x):
    """``x`` (a tensor, dict or named tuple of them) with its float
    tensors in float64."""
    if torch.is_tensor(x):
        return x.double() if x.is_floating_point() else x
    if isinstance(x, dict):
        return {k_: _f64(v) for k_, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_f64(v) for v in x])
    if isinstance(x, (list, tuple)):
        return type(x)(_f64(v) for v in x)
    return x


EXT_CASES = {
    "K4-S29": dict(kernel="inside_ext"),
    "K4-S29-pin": dict(kernel="inside_ext", pinned=True),
    "K4-S1": dict(kernel="inside_ext", null=True),
    "K4-S1-pin": dict(kernel="inside_ext", null=True, pinned=True),
    "K12-S29": dict(kernel="inside_ext_max"),
    "K12-S29-pin": dict(kernel="inside_ext_max", pinned=True),
    "K12-S1": dict(kernel="inside_ext_max", null=True),
    "K12-S1-pin": dict(kernel="inside_ext_max", null=True, pinned=True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", sorted(EXT_CASES))
def test_ext_kernels_match_plain(case, dtype):
    """K4 (ext_stage) and K12 (max_ext_stage) on every third column
    against their plain versions on the same tables, at S=29 and at the
    masks' S=1, with a pin per read (start class; the last read unpinned)
    and without: K4 within 1e-9 (f64) and 1e-4 (f32, against the plain
    version at f64 on the same inputs) relative, K12 within 1e-12 (f64)
    and 1e-4 (f32) absolute, -inf placement identical; a second run gives
    the same bits; one launch per column."""
    _need_cuda()
    kw = EXT_CASES[case]
    null, pinned = kw.get("null", False), kw.get("pinned", False)
    cfg = J.ModelConfig(pattern="(.....)", Lp=60, max_span=50, max_iloop=30,
                        min_bpp=0.0, tau=0.1, dtype=dtype)
    n = 33
    dp, d, c, h, fs, _ = _ep_inputs(cfg, _ep_reads(cfg, n, 29), null)
    if pinned:
        pos = np.random.RandomState(3).randint(0, 40, n).astype(np.int32)
        pos[-1] = -1
        c = c._replace(pin=DP.Pin(torch.as_tensor(pos, device="cuda"),
                                  DP.CLS_START))
    st = dp.st
    assert st.dims.S == (1 if null else 29)
    f32 = dtype == "float32"
    if kw["kernel"] == "inside_ext":
        h = DP.hoisted(d, c, st)
        state = dp.run_inside(d, c, h)
        kern = lambda s_, j: K.ext_stage(s_, j, d, c, h, st)
        plain = lambda s_, j: DP.ext_stage_plain(s_, j, d, c, h, st)
        rel, tol = True, (1e-4 if f32 else 1e-9)
    else:
        mdp = DMB.MaxDP(dp)
        state = mdp.tables(d, c)
        kern = lambda s_, j: K.max_ext_stage(s_, j, d, c, mdp.mst)
        plain = lambda s_, j: DMB.ext_stage_plain(s_, j, d, c, mdp.mst)
        rel, tol = False, (1e-4 if f32 else 1e-12)
    ks, ps = DP.clone_state(state), DP.clone_state(state)
    if rel and f32:
        # the plain sum's f32 exp space flushes cells far below its
        # column's maxima: K4 at f32 is held to the plain version at f64
        # on the same inputs
        st64 = J.kernels(dataclasses.replace(cfg, dtype="float64"),
                         "cuda")
        st64 = (st64.dp_null if null else st64.dp).st
        ps, d64, c64, h64 = (_f64(x) for x in (ps, d, c, h))
        plain = lambda s_, j: DP.ext_stage_plain(s_, j, d64, c64, h64, st64)
    seen = 0
    for j in range(1, cfg.Lp + 1, 3):
        r = j + st.PAD
        K.reset_counts()
        kern(ks, j)
        first = ks["O"][r].clone()
        kern(ks, j)
        assert K.KERNELS[kw["kernel"]].launches == 2
        assert torch.equal(first, ks["O"][r]), j
        plain(ps, j)
        a, b = ks["O"][r].to(ps["O"].dtype), ps["O"][r]
        fin = torch.isfinite(b)
        assert torch.equal(torch.isfinite(a), fin), j
        if fin.any():
            seen += 1
            err = (a[fin] - b[fin]).abs()
            if rel:
                err = err / b[fin].abs().clamp(min=1.0)
            assert float(err.max()) <= tol, (j, float(err.max()))
    assert seen >= 5


@pytest.mark.gpu
@pytest.mark.parametrize("null", [False, True])
def test_ext_kernel_does_not_depend_on_the_batch(null):
    """A read's K4 column has the same bits alone (one read per block) and
    inside a batch of 128 (8 reads per block at S=29; one at S=1, where
    128 blocks fill the card), f32, on the same tables."""
    _need_cuda()
    cfg = J.ModelConfig(pattern="(.....)", Lp=60, max_span=50, max_iloop=30,
                        min_bpp=0.0, tau=0.1, dtype="float32")
    reads = _ep_reads(cfg, 128, 31)
    dp, d, c, h, fs, _ = _ep_inputs(cfg, reads, null)
    st = dp.st
    for i in (0, 77, 127):
        d1, c1, h1, f1, _ = _ep_inputs(cfg, [reads[i]], null)[1:]
        s1 = {k_: v[..., i:i + 1].contiguous() for k_, v in fs.items()
              if not k_.startswith("_")}
        sb = DP.clone_state(fs)
        for j in (1, 30, cfg.Lp):
            K.ext_stage(sb, j, d, c, h, st)
            K.ext_stage(s1, j, d1, c1, h1, st)
            r = j + st.PAD
            assert torch.equal(sb["O"][r][..., i:i + 1], s1["O"][r]), (i, j)


@pytest.mark.gpu
def test_pin_set_parts_and_class_sums_match_plain():
    """The sum DP (K2/K4 forward, K5/K7 class sums) under CYK's pin set
    of three entries (start, end, and the tail on the right kinds only)
    against the plain versions on the CPU, f64."""
    _need_cuda()
    from rnaelem_tpu_torch.scan import cyk as CYK
    from rnaelem_tpu_torch.scan import scanner as SC
    cfg, p, batch = _scan_inputs("(.....)", {}, "cpu", seed=15)
    res = SC.scan_posteriors_batch(cfg, p, batch.sd, device="cpu")
    Ys, Ye = res["Ys"], res["Ye"].clone()
    Ye[1] = batch.sd.L[1]
    out = {}
    for dev in ("cpu", "cuda"):
        cfg, p, batch = _scan_inputs("(.....)", {}, dev, seed=15)
        B = batch.valid.shape[0]
        L = batch.sd.L.long()
        pins = CYK.cyk_pins(Ys.to(dev), Ye.to(dev), L)
        cls = torch.zeros((4, cfg.Lp, B), dtype=torch.float64, device=dev,
                          requires_grad=True)
        with torch.enable_grad():
            parts = J.batch_logZ_parts(cfg, p, batch.sd, batch.bp_ok,
                                       device=dev,
                                       aux_b=dict(cls=cls, pin=pins))
            (g,) = torch.autograd.grad(parts, cls,
                                       torch.isfinite(parts).to(parts.dtype))
        out[dev] = (parts.detach().cpu(), g.cpu())
    (pc, gc), (pg, gg) = out["cpu"], out["cuda"]
    fin = torch.isfinite(pc)
    assert fin.any() and torch.equal(fin, torch.isfinite(pg))
    assert float((pg - pc)[fin].abs().max()) <= 1e-9 * float(
        pc[fin].abs().max())
    assert float((gg - gc).abs().max()) <= 1e-9 * float(gc.abs().max())


@pytest.mark.gpu
def test_structure_scan_on_the_card_matches_cpu():
    """Scanner.scan of the structure fixture model 0 on 0.fq at f64:
    the card (K1-K7, K10-K13) and the CPU write the same records but for
    the posteriors' last digits; the CYK kernels launched."""
    _need_cuda()
    import io
    import os
    from rnaelem_tpu_torch.model import io as MIO
    from rnaelem_tpu_torch.scan import driver as SCD
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    text = {}
    for dev in ("cpu", "cuda"):
        cfg, params = MIO.read_model(os.path.join(root, "tests", "fixtures",
                                                  "0.model"), Lp=48,
                                     device=dev)
        buf = io.StringIO()
        K.reset_counts()
        SCD.Scanner(cfg, params, dev).scan(
            os.path.join(root, "tests", "fixtures", "0.fq"), buf,
            log=io.StringIO())
        text[dev] = buf.getvalue().splitlines()
    for name in ("inside_band_max", "inside_ep_max", "inside_ext_max",
                 "cyk_traceback"):
        assert K.KERNELS[name].launches > 0, name
    assert len(text["cpu"]) == len(text["cuda"])
    for a, b in zip(text["cuda"], text["cpu"]):
        key = a.split(": ", 1)[0]
        if key in ("start", "end", "inner", "exist prob"):
            x = np.array([float(v) for v in
                          a.split(": ", 1)[1].strip("[]").split(",")])
            y = np.array([float(v) for v in
                          b.split(": ", 1)[1].strip("[]").split(",")])
            np.testing.assert_array_equal(np.isfinite(x), np.isfinite(y))
            fin = np.isfinite(y)
            np.testing.assert_allclose(x[fin], y[fin], rtol=1e-5, atol=1e-9)
        else:
            assert a == b, key


VARIANT_CASES = {
    "S29-f64": dict(pattern="(.....)", dtype="float64"),
    "S29-f32": dict(pattern="(.....)", dtype="float32"),
    "S91-f64": dict(pattern=".....*.....", dtype="float64", n=3),
    "S91-f32": dict(pattern=".....*.....", dtype="float32", n=3),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(VARIANT_CASES))
def test_device_variant_equals_the_shared_variant_bitwise(case):
    """K3 (ep_stage), K6 (ep_adj) and K11 (max_ep_stage) forced into the
    device variant (their layout in a device workspace) through
    ep_plan's keyword give the shared variant's bits at -c 30, where both
    fit: the ep rows and shifts of every third column, one column's
    cotangents, and the CYK tables' ep rows; each launch counts under its
    variant."""
    _need_cuda()
    kw = dict(VARIANT_CASES[case])
    n = kw.pop("n", 5)
    cfg = J.ModelConfig(Lp=60, max_span=50, max_iloop=30, min_bpp=0.0,
                        tau=0.1, **kw)
    dp, d, c, h, fs, gbar = _ep_inputs(cfg, _ep_reads(cfg, n, 17))
    st = dp.st
    plans = {v: {k_: K.ep_plan(k_, st.dims.S, st.n_ar, st.dims.Cp,
                               st.dtype, variant=v)
                 for k_ in ("inside_ep", "outside_ep", "inside_ep_max")}
             for v in ("shared", "device")}
    assert K.ep_plan("outside_ep", st.dims.S, st.n_ar, st.dims.Cp,
                     st.dtype) == plans["shared"]["outside_ep"]
    r = lambda j: j + st.PAD
    cols = range(2, cfg.Lp + 1, 3)
    K.reset_counts()
    for j in cols:
        a, b = DP.clone_state(fs), DP.clone_state(fs)
        K.ep_stage(a, j, d, c, h, st, plan=plans["shared"]["inside_ep"])
        K.ep_stage(b, j, d, c, h, st, plan=plans["device"]["inside_ep"])
        assert torch.equal(a["ep"][r(j)], b["ep"][r(j)]), j
        assert torch.equal(a["ep_shift"], b["ep_shift"]), j
    assert K.KERNELS["inside_ep"].variants == {"shared": len(cols),
                                               "device": len(cols)}
    gs = DP.init_grads(fs, d, c, h)
    DP.seed_parts(gs, gbar, c, st)
    j0 = cfg.Lp // 2
    dp.outside_columns(fs, gs, d, c, h, cfg.Lp + 1, j0 + 1)
    got = {}
    K.reset_counts()
    for v in ("shared", "device"):
        g_ = DP.clone_state(gs)
        K.ep_adj(fs, g_, j0, d, c, h, st, plan=plans[v]["outside_ep"])
        got[v] = g_
    for k_ in got["shared"]:
        if not k_.startswith("_"):
            assert torch.equal(got["shared"][k_], got["device"][k_]), k_
    assert K.KERNELS["outside_ep"].variants == {"shared": 1, "device": 1}
    mdp = DMB.MaxDP(dp)
    tabs = mdp.tables(d, c)
    for j in cols:
        a, b = DP.clone_state(tabs), DP.clone_state(tabs)
        K.max_ep_stage(a, j, d, c, mdp.mst,
                       plan=plans["shared"]["inside_ep_max"])
        K.max_ep_stage(b, j, d, c, mdp.mst,
                       plan=plans["device"]["inside_ep_max"])
        assert torch.equal(a["ep"][r(j)], b["ep"][r(j)]), j
        assert torch.equal(a["ep"][r(j)], tabs["ep"][r(j)]), j
    assert K.KERNELS["inside_ep_max"].variants["device"] == len(cols)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("pattern", ["(.....)", ".....*....."])
def test_m_chain_does_not_depend_on_its_group(pattern, dtype):
    """K2's band_m, K5's M chain (band_adj, pinned with the class probe)
    and K10's band_m_max, forced through band_plan's keywords into every
    group of reads the type takes (8, 4, 2, 1 at f32; 4, 2, 1 at f64)
    and the small ring at G = 1, give the same bits (B=13: no multiple of
    a group)."""
    _need_cuda()
    cfg = J.ModelConfig(pattern=pattern, Lp=60, max_span=50, max_iloop=30,
                        min_bpp=0.0, tau=0.1, dtype=dtype)
    reads = _ep_reads(cfg, 13, 19)
    dp, d, c, h, fs, gbar = _band_inputs(cfg, reads, pinned=True)
    st, j0 = dp.st, 40
    S, r = st.dims.S, j0 + st.PAD
    groups = (8, 4, 2, 1) if dtype == "float32" else (4, 2, 1)
    shapes = [(g_, 4) for g_ in groups] + [(1, 2)]
    gs = DP.init_grads(fs, d, c, h)
    DP.seed_parts(gs, gbar, c, st)
    dp.outside_columns(fs, gs, d, c, h, cfg.Lp + 1, j0 + 1)
    K.e_adj(fs, gs, j0, d, c, h, st)
    d0, c0, h0, f0 = _ep_inputs(cfg, reads)[1:5]
    mdp = DMB.MaxDP(dp)
    tabs = mdp.tables(d0, c0)
    ref = None
    K.reset_counts()
    for G, R in shapes:
        out = {}
        a = DP.clone_state(fs)
        K.band_m(a, j0, d, c, h, st,
                 plan=K.band_plan("inside_band", S, st.dtype, G=G, R=R))
        out["M"] = a["M"][r]
        g_ = DP.clone_state(gs)
        K.band_adj(fs, g_, j0, d, c, h, st,
                   plan=K.band_plan("outside_band", S, st.dtype, G=G, R=R))
        out.update({"grad " + k_: v for k_, v in g_.items()
                    if not k_.startswith("_")})
        m = DP.clone_state(tabs)
        K.max_band_m(m, j0, d0, c0, mdp.mst,
                     plan=K.band_plan("inside_band", S, st.dtype, G=G, R=R))
        out["max M"] = m["M"][r]
        if ref is None:
            ref = out
            assert torch.equal(out["max M"], tabs["M"][r])
        for k_ in ref:
            assert torch.equal(ref[k_], out[k_]), (G, R, k_)
    want = {"G=%d,R=%d" % s_: 1 for s_ in shapes}
    assert K.KERNELS["outside_band"].variants == want
    assert K.KERNELS["inside_band_max"].variants == want


K7_CASES = {
    "S29": dict(),
    "S29-pin": dict(pinned=True),
    "S1": dict(null=True),
    "S1-pin": dict(null=True, pinned=True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", sorted(K7_CASES))
def test_ext_adjoint_kernel_matches_plain(case, dtype):
    """K7 (ext_adj), one launch per column, against ext_adj_plain on the
    same tables at every fourth column, at S=29 and the masks' S=1,
    B=33, with a pin per read (start class; the last read unpinned) and
    the class probe, and without: the cotangents within 1e-9 (f64) and
    1e-4 (f32, against the plain version at f64 on the same inputs: the
    plain sum's f32 exp space flushes splits whose P and O cells lie far
    below their column's maxima) relative to their max norm, lambda's
    whole cotangent too, and with the probe the column's class sums (K7's
    partials, cpR slot 0); a second run gives the same bits."""
    _need_cuda()
    kw = K7_CASES[case]
    null, pinned = kw.get("null", False), kw.get("pinned", False)
    cfg = J.ModelConfig(pattern="(.....)", Lp=60, max_span=50, max_iloop=30,
                        min_bpp=0.0, tau=0.1, dtype=dtype)
    n = 33
    dp, d, c, h, _, gbar = _ep_inputs(cfg, _ep_reads(cfg, n, 29), null)
    st = dp.st
    if pinned:
        pos = np.random.RandomState(3).randint(0, 40, n).astype(np.int32)
        pos[-1] = -1
        c = c._replace(pin=DP.Pin(torch.as_tensor(pos, device="cuda"),
                                  DP.CLS_START))
        d = d._replace(cls=torch.zeros((4, cfg.Lp, n), dtype=st.dtype,
                                       device="cuda"))
    h = DP.hoisted(d, c, st)
    fs = dp.run_inside(d, c, h)
    gbar = torch.where(torch.isfinite(dp.extract_parts(fs["O"], c)), gbar,
                       0.0)
    assert st.dims.S == (1 if null else 29)
    f32 = dtype == "float32"
    tol = 1e-4 if f32 else 1e-9
    # the plain version's inputs (at f64 for the f32 kernel)
    pfs, pd, pc, ph = (_f64(x) for x in (DP.clone_state(fs), d, c, h)) \
        if f32 else (fs, d, c, h)
    pst = st
    if f32:
        k64 = J.kernels(dataclasses.replace(cfg, dtype="float64"), "cuda")
        pst = (k64.dp_null if null else k64.dp).st
    gs = DP.init_grads(fs, d, c, h)
    DP.seed_parts(gs, gbar, c, st)
    j1 = cfg.Lp + 1
    for j0 in range(cfg.Lp - 2, 1, -4):
        dp.outside_columns(fs, gs, d, c, h, j1, j0 + 1)
        j1 = j0 + 1
        kg, kg2 = (DP.clone_state(gs) for _ in range(2))
        pg = _f64(DP.clone_state(gs)) if f32 else DP.clone_state(gs)
        K.reset_counts()
        K.ext_adj(fs, kg, j0, d, c, h, st)
        K.ext_adj(fs, kg2, j0, d, c, h, st)
        assert K.KERNELS["outside_ext"].launches == 2
        for k_ in kg:
            if not k_.startswith("_"):
                assert torch.equal(kg[k_], kg2[k_]), (j0, k_)
        DP.ext_adj_plain(pfs, pg, j0, pd, pc, ph, pst)
        rows = j0 + st.PAD + 1
        pairs = [(kg[k_][:rows], pg[k_][:rows]) for k_ in DP.GRAD_TABLES]
        pairs += [(kg["eR"], pg["eR"]),
                  (DP.lam_total(DP.finish_grads(kg, st), d, c, st),
                   DP.lam_total(DP.finish_grads(pg, pst), pd, pc, pst))]
        if pinned:
            parts = K._cls_parts(kg, st, n, fs["O"].device)
            pairs.append((parts[0][:, 0].sum(1),
                          (pg["cls"] - _f64(gs["cls"]))[:, j0 - 1]))
        for i, (a, b) in enumerate(pairs):
            assert not torch.isnan(a).any(), (j0, i)
            scale = max(1.0, float(b.abs().max()))
            err = float((a.to(b.dtype) - b).abs().max())
            assert err <= tol * scale, (j0, i, err)


# ---------------------------------------------- K14-K17: rows C and D

ROWS_CD_CASES = {
    "plain": ("(.....)", {}), "softmax": ("(.....)", {"theta_softmax": True}),
    "no_theta": ("(.....)", {"no_theta": True}),
    "no_prf": ("(.....)", {"no_prf": True}),
    "fix_rss": ("(.....)", {"fix_rss": True}),
    "no_rss": ("..*..", {"no_rss": True}),
    "no_rss_softmax": ("..*..", {"no_rss": True, "theta_softmax": True})}


def _rows_cd_inputs(pattern, opts, dtype, n, seed=31, Lp=40, span=24,
                    iloop=12):
    """(config, SeqData, pair masks, per-read weights [singles, pairs,
    lam], each read its own) on the card."""
    cfg = J.ModelConfig(pattern=pattern, Lp=Lp, max_span=span,
                        max_iloop=iloop, min_bpp=0.0, tau=0.1, dtype=dtype,
                        **opts)
    reads = _ep_reads(cfg, n, seed)
    sd = J.stack_seqdata([J.make_seqdata(cfg, *r) for r in reads], "cuda")
    bp = None if cfg.no_rss else J.effective_bp_mask_batch(cfg, sd,
                                                           "cuda")[0]
    p = J.init_params(J.kernels(cfg, "cpu").g, cfg, device="cpu",
                      dtype="float64")
    rng = np.random.RandomState(seed)
    dt = torch.float32 if dtype == "float32" else torch.float64
    f = lambda x: torch.as_tensor(x, dtype=dt, device="cuda")
    w = [f(p.singles.numpy()[None] + 0.5 * rng.randn(n, *p.singles.shape)),
         f(p.pairs.numpy()[None] + 0.5 * rng.randn(n, *p.pairs.shape)),
         f(0.5 + rng.rand(n, 2))]
    return cfg, sd, bp, w


def _factors(cfg, sd, bp, w, cots, plain):
    """(the factors, the weights' cotangents) of K14/K15 or the plain
    version and its autograd."""
    k = J.kernels(cfg, "cuda")
    leaves = [x.detach().clone().requires_grad_(True) for x in w[:2]]
    pw = J.Params(leaves[0], leaves[1], w[2])
    with torch.enable_grad():
        if cfg.no_rss:
            outs = [J.right_emissions(cfg, k, pw, sd, plain=plain)]
        else:
            d, _ = J.batch_factors_pr(cfg, pw, sd, bp, "cuda", plain=plain)
            outs = [d.eR, d.eL, d.bg2, d.pv]
        live = [o.requires_grad for o in outs]
        grads = [None, None]
        if cots is not None and any(live):
            grads = list(torch.autograd.grad(
                [o for o, l_ in zip(outs, live) if l_], leaves,
                [c_ for c_, l_ in zip(cots, live) if l_], allow_unused=True))
    return [o.detach() for o in outs], grads


def _rel_ok(a, b, tol):
    scale = float(b.abs().max())
    return float((a - b).abs().max()) <= tol * max(scale, 1e-300)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(ROWS_CD_CASES))
@pytest.mark.parametrize("dtype,tol,n", [("float64", 1e-12, 16),
                                         ("float32", 1e-6, 64)])
def test_factor_kernels_match_plain(case, dtype, tol, n):
    """K14 (the factors) and K15 (their adjoint into the per-read weights)
    against the plain version and its autograd, relative in the max norm;
    without the log-softmax K15 is bitwise the plain autograd (its sums
    follow read_sum's order); two runs give the same bits; every launch
    goes through the kernels."""
    _need_cuda()
    pattern, opts = ROWS_CD_CASES[case]
    cfg, sd, bp, w = _rows_cd_inputs(pattern, opts, dtype, n)
    outs_p, _ = _factors(cfg, sd, bp, w, None, True)
    rng = np.random.RandomState(3)
    cots = [torch.as_tensor(rng.randn(*o.shape), dtype=o.dtype,
                            device="cuda") for o in outs_p]
    outs_p, g_p = _factors(cfg, sd, bp, w, cots, True)
    K.reset_counts()
    outs_k, g_k = _factors(cfg, sd, bp, w, cots, False)
    assert K.KERNELS["factors"].launches == 1
    assert K.KERNELS["factors_adj"].launches == (0 if cfg.no_prf else 1)
    outs_2, g_2 = _factors(cfg, sd, bp, w, cots, False)
    for a, b, a2 in zip(outs_k, outs_p, outs_2):
        assert torch.equal(a, a2) and _rel_ok(a, b, tol)
    for a, b, a2 in zip(g_k, g_p, g_2):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, a2) and _rel_ok(a, b, tol)
            if not cfg.theta_softmax:
                assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12), ("float32", 1e-6)])
@pytest.mark.parametrize("n", [1, 7, 16, 64, 600])
def test_hoisted_kernels_match_plain(dtype, tol, n):
    """K16 (the hoisted exp-space tensors) and K17 (lambda's cotangent)
    against hoisted_plain and its autograd for per-read lambdas (a
    strided view, as the DP's copies are), at B = 1, 7 (one read a
    thread), 16, 64 and 600 (16 bytes a thread); lam_total launches K17
    alone (no second K16) and equals the autograd route; two runs give
    the same bits, and so do K16's scalar path (inputs off a 16-byte
    boundary) and its vector path."""
    _need_cuda()
    cfg, sd, bp, w = _rows_cd_inputs("(.....)", {}, dtype, n)
    k = J.kernels(cfg, "cuda")
    d, c = J.batch_factors(cfg, J.Params(*[x[0] for x in w]), sd, bp, "cuda")
    lam = w[2].T
    rng = np.random.RandomState(4)
    with torch.no_grad():
        want = DP.hoisted_plain(d._replace(lam=lam), c, k.dp.st)
    cots = [torch.as_tensor(rng.randn(*want[n_].shape), dtype=lam.dtype,
                            device="cuda") for n_ in DP.HOISTED]
    got = []
    for route in (DP.hoisted_plain, DP.hoisted, DP.hoisted):
        leaf = lam.detach().clone().requires_grad_(True)
        with torch.enable_grad():
            h = route(d._replace(lam=leaf), c, k.dp.st)
            (g,) = torch.autograd.grad([h[n_] for n_ in DP.HOISTED], [leaf],
                                       cots)
        got.append(([h[n_].detach() for n_ in DP.HOISTED], g))
    (hp, gp), (hk, gk), (hk2, gk2) = got
    for a, b, a2 in zip(hk, hp, hk2):
        assert torch.equal(a, a2) and _rel_ok(a, b, tol)
    assert torch.equal(gk, gk2) and _rel_ok(gk, gp, tol)
    direct = torch.zeros_like(gk)
    grads = (None,) * 4 + (direct, None) + tuple(cots)
    K.reset_counts()
    total = DP.lam_total(grads, d._replace(lam=lam), c, k.dp.st)
    assert (K.KERNELS["hoisted"].launches,
            K.KERNELS["hoisted_adj"].launches) == (0, 1)
    assert torch.equal(total, direct + gk)
    # the same inputs 4 bytes off a 16-byte boundary take the scalar path
    def shifted(x):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        y = buf[1:].view(x.shape)
        y.copy_(x)
        return y
    c1 = c._replace(ep=dict(c.ep, misA=shifted(c.ep["misA"]),
                            misB=shifted(c.ep["misB"])))
    K.reset_counts()
    h1 = K.hoisted(k.dp.st, lam, c1)
    assert K.KERNELS["hoisted"].variants == {"V=1": 1}
    for a, b in zip(h1, hk):
        assert torch.equal(a, b)


def _same_fields(ours, plain, tol):
    """Every field of two DiffFactors or ConstFactors (a dict field by
    key) of one dtype and shape; identical where ``tol`` is None or the
    field is not floating, else within ``tol`` relative (max norm)."""
    for f in ours._fields:
        a, b = getattr(ours, f), getattr(plain, f)
        if isinstance(b, dict):
            assert sorted(a) == sorted(b), f
            pairs = [(a[k_], b[k_]) for k_ in sorted(b)]
        else:
            assert (a is None) == (b is None), f
            pairs = [] if b is None else [(a, b)]
        for x, y in pairs:
            assert (x.dtype, x.shape) == (y.dtype, y.shape), f
            if tol is None or not y.is_floating_point():
                assert torch.equal(x, y), f
            else:
                assert _rel_ok(x, y, tol), f


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12),
                                       ("float32", 1e-6)])
def test_null_factor_kernels_match_plain(dtype, tol):
    """The masks' motif-free factors at their shapes (the S = 1 grammar,
    B = 128): K14 in mode "null" (one launch) against the plain
    _null_batch_factors, every constant identical and every factor within
    ``tol``; K16 there (lambda 1) against hoisted_plain and K17 against
    its autograd."""
    _need_cuda()
    cfg, sd, _, _ = _rows_cd_inputs("(.....)", {}, dtype, 128)
    k = J.kernels(cfg, "cuda")
    bp0 = J._candidate_pairs(cfg, k, sd)
    K.reset_counts()
    dk, ck = J._null_batch_factors(cfg, k, sd, bp0)
    assert K.KERNELS["factors"].launches == 1
    dp_, cp_ = J._null_batch_factors(cfg, k, sd, bp0, plain=True)
    _same_fields(ck, cp_, None)
    _same_fields(dk, dp_, tol)
    st = k.dp_null.st
    with torch.no_grad():
        want = DP.hoisted_plain(dp_, cp_, st)
    rng = np.random.RandomState(6)
    cots = [torch.as_tensor(rng.randn(*want[n_].shape), dtype=dk.lam.dtype,
                            device="cuda") for n_ in DP.HOISTED]
    got = []
    for route, d, c in ((DP.hoisted_plain, dp_, cp_), (DP.hoisted, dk, ck)):
        leaf = d.lam.detach().clone().requires_grad_(True)
        with torch.enable_grad():
            h = route(d._replace(lam=leaf), c, st)
            (g,) = torch.autograd.grad([h[n_] for n_ in DP.HOISTED], [leaf],
                                       cots)
        got.append(([h[n_].detach() for n_ in DP.HOISTED], g))
    (hp, gp), (hk, gk) = got
    for a, b in zip(hk, hp):
        assert _rel_ok(a, b, tol)
    assert _rel_ok(gk, gp, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_rows_cd_kernels_do_not_depend_on_the_batch(dtype):
    """K14-K17's outputs for the first 8 reads of 16 are bitwise those of
    the 8 alone: nothing is summed across reads."""
    _need_cuda()
    cfg, sd, bp, w = _rows_cd_inputs("(.....)", {"theta_softmax": True},
                                     dtype, 16)
    outs, _ = _factors(cfg, sd, bp, w, None, False)
    rng = np.random.RandomState(5)
    cots = [torch.as_tensor(rng.randn(*o.shape), dtype=o.dtype,
                            device="cuda") for o in outs]
    outs, g = _factors(cfg, sd, bp, w, cots, False)
    sd8 = J.SeqData(*[x[:8] for x in sd])
    outs8, g8 = _factors(cfg, sd8, bp[:8], [x[:8] for x in w],
                         [c_[..., :8] for c_ in cots], False)
    for a, b in zip(outs8, outs):
        assert torch.equal(a, b[..., :8])
    for a, b in zip(g8, g):
        assert torch.equal(a, b[:8])
    st = J.kernels(cfg, "cuda").dp.st
    _, c = J.batch_factors(cfg, J.Params(*[x[0] for x in w]), sd, bp, "cuda")
    lam = w[2].T
    h = K.hoisted(st, lam, c)
    hc = [torch.as_tensor(rng.randn(*x.shape), dtype=x.dtype, device="cuda")
          for x in h]
    gl = K.hoisted_adj(st, lam, c, hc)
    c8 = c._replace(C=c.C[:8].contiguous(),
                    ep={n_: v[..., :8].contiguous() for n_, v in c.ep.items()})
    lam8 = w[2][:8].T
    h8 = K.hoisted(st, lam8, c8)
    for a, b in zip(h8, h):
        assert torch.equal(a, b[..., :8])
    assert torch.equal(K.hoisted_adj(st, lam8, c8, [x[..., :8] for x in hc]),
                       gl[:, :8])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("B", [1, 7, 33, 128])
def test_factors_kernel_every_tile_gives_the_same_bits(B, dtype):
    """K14 in modes dp, eR and null: every tile of positions factors_plan
    can take, forced, and the scalar path (V = 1) give the shape's plan's
    outputs bit for bit, and each run counts its plan's variant."""
    _need_cuda()
    for pattern, opts, mode in (("(.....)", {"fix_rss": True}, "dp"),
                                ("..*..", {"no_rss": True}, "eR"),
                                ("(.....)", {}, "null")):
        cfg, sd, bp, w = _rows_cd_inputs(pattern, opts, dtype, B)
        k = J.kernels(cfg, "cuda")
        st = k.dp_null.st if mode == "null" else k.dp.st
        reads = J._card_reads(k, sd)
        kw = {} if mode == "null" else dict(
            singles=w[0], pairs=w[1] if mode == "dp" else None)
        base = K.factors(st, cfg, mode, *reads, **kw)
        S = st.dims.S
        Tp = w[1].shape[1] if mode == "dp" else 1
        ns = 1 if mode == "null" else w[0].shape[1]
        for P in K.FAC_TILES:
            for aligned in (True, False):
                plan = K.factors_plan(cfg.Lp, st.dims.Wp, S, Tp, ns, B,
                                      st.dtype, aligned, P)
                K.reset_counts()
                got = K.factors(st, cfg, mode, *reads, plan=plan, **kw)
                assert K.KERNELS["factors"].variants == {plan.name: 1}
                for n_ in base:
                    assert torch.equal(got[n_], base[n_]), (mode, P, n_)


def _adj_case(pattern, dtype, n, seed=41):
    """K15's and K17's inputs on the card for n reads, each its own
    weights and cotangents: (config, DPStatic, inputs by name)."""
    cfg, sd, bp, w = _rows_cd_inputs(pattern, {}, dtype, n, seed)
    k = J.kernels(cfg, "cuda")
    st = k.dp.st
    _, c = J.batch_factors(cfg, J.Params(*[x[0] for x in w]), sd, bp, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=gen, dtype=st.dtype,
                                    device="cuda")
    Lp, S, W1, C1 = cfg.Lp, st.dims.S, st.dims.Wp + 1, st.dims.Cp + 1
    x = dict(seq=J._card_reads(k, sd)[0], singles=w[0], pairs=w[1],
             lam=w[2], C=c.C, misA=c.ep["misA"], misB=c.ep["misB"],
             geR=rn(Lp, S, n), geL=rn(Lp, S, n), gbg2=rn(Lp, n),
             gpv=rn(Lp + 1, W1, w[1].shape[1], n),
             eSZ=rn(2, st.n_cls, C1, C1, n), eSZg=rn(2, 4, C1, C1, n),
             emisA=rn(2, 4, Lp + 1, W1, n),
             emisB=rn(2, Lp + 1 + st.PAD, W1, 4, n))
    return cfg, st, sd, x


def _adj_slice(x, a, b):
    first = ("seq", "singles", "pairs", "lam")
    return {n_: (v[a:b] if n_ in first else v[..., a:b]).contiguous()
            for n_, v in x.items()}


def _adj_run(cfg, st, x, fsplit=None, hsplit=None):
    """(g_singles, g_pairs) of K15 and lambda's cotangent of K17, each on
    its plan or forced to a split."""
    gs, gp = K.factors_adj(st, cfg, "dp", x["seq"], x["singles"], x["pairs"],
                           x["geR"], x["geL"], x["gbg2"], x["gpv"],
                           split=fsplit)
    c = types.SimpleNamespace(C=x["C"], ep={"misA": x["misA"],
                                            "misB": x["misB"]})
    gl = K.hoisted_adj(st, x["lam"].T, c, [x[n_] for n_ in DP.HOISTED],
                       split=hsplit)
    return [gs, gp, gl]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_adjoint_sums_do_not_depend_on_the_batch_or_the_split(
        dtype, monkeypatch):
    """K15's and K17's cotangents of each read are bitwise equal in a
    batch of 600 and in batches of 1, 7 and 128 taken at other places
    (each B its own split), in a repeat, and under every split their host
    plans can take, forced; each split counts as its plan's variant; a
    split the plan cannot take is refused, and so is a layout that is not
    the kernel's (the launcher's check)."""
    _need_cuda()
    cfg, st, _, x = _adj_case("(.....)", dtype, 600)
    ref = _adj_run(cfg, st, x)
    for a, b in zip(_adj_run(cfg, st, x), ref):
        assert torch.equal(a, b)
    for B, at in ((1, 3), (7, 11), (128, 200)):
        got = _adj_run(cfg, st, _adj_slice(x, at, at + B))
        want = [ref[0][at:at + B], ref[1][at:at + B], ref[2][:, at:at + B]]
        for i, (a, b) in enumerate(zip(got, want)):
            assert torch.equal(a, b), (B, i)
    x128 = _adj_slice(x, 200, 328)
    base = _adj_run(cfg, st, x128)
    Tp = x["pairs"].shape[1]
    fp = K.factors_adj_plan(st.dims.S, cfg.Lp, st.dims.Wp, Tp, 128, st.dtype)
    hp = K.hoisted_adj_plan(st.dims.Lp, st.dims.Wp, st.dims.Cp, st.n_cls,
                            128, st.dtype)
    K.reset_counts()
    for k_ in fp.splits():
        got = _adj_run(cfg, st, x128, fsplit=k_)
        assert all(torch.equal(a, b) for a, b in zip(got, base)), k_
    for k_ in hp.splits():
        got = _adj_run(cfg, st, x128, hsplit=k_)
        assert torch.equal(got[2], base[2]), k_
    variants = K.KERNELS["hoisted_adj"].variants
    assert all(variants.get("K=%d" % k_, 0) >= 1 for k_ in hp.splits())
    assert K.KERNELS["factors_adj"].variants["K=%d" % fp.K] >= 1
    with pytest.raises(ValueError, match="split"):
        _adj_run(cfg, st, x128, hsplit=3)
    with pytest.raises(ValueError, match="split"):
        _adj_run(cfg, st, x128, fsplit=2 * fp.k_max)
    # a layout that is not the kernel's: a row of half the reads, one
    # state block too many (its blocks would write past the workspace)
    monkeypatch.setattr(K, "hoisted_adj_plan", lambda *a: hp._replace(
        RL=hp.RL // 2, groups=2 * hp.groups))
    with pytest.raises(RuntimeError, match="hoisted_adj failed"):
        _adj_run(cfg, st, x128)
    monkeypatch.setattr(K, "factors_adj_plan", lambda *a: fp._replace(
        grid_y=fp.grid_y + 1))
    with pytest.raises(RuntimeError, match="factors_adj failed"):
        _adj_run(cfg, st, x128)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_factors_adjoint_past_1024_states_every_split(dtype):
    """K15 at 44 dots (S = 1,081: 136 state blocks a group of reads): the
    weights' cotangents bitwise the plain autograd (no log-softmax) under
    every split of the pair tables."""
    _need_cuda()
    try:
        cfg, sd, bp, w = _rows_cd_inputs("." * 44, {}, dtype, 6, Lp=50,
                                         span=40, iloop=10)
        k = J.kernels(cfg, "cuda")
        st = k.dp.st
        assert st.dims.S == 1081
        outs_p, _ = _factors(cfg, sd, bp, w, None, True)
        rng = np.random.RandomState(8)
        cots = [torch.as_tensor(rng.randn(*o.shape), dtype=o.dtype,
                                device="cuda") for o in outs_p]
        _, g_p = _factors(cfg, sd, bp, w, cots, True)
        seq = J._card_reads(k, sd)[0]
        fp = K.factors_adj_plan(st.dims.S, cfg.Lp, st.dims.Wp,
                                w[1].shape[1], 6, st.dtype)
        for k_ in fp.splits():
            got = K.factors_adj(st, cfg, "dp", seq, w[0], w[1], *cots,
                                split=k_)
            for a, b in zip(got, g_p):
                assert torch.equal(a, b), k_
    finally:
        J._kernels_cached.cache_clear()
        torch.cuda.empty_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_m_chain_and_chain_past_1024_states(dtype):
    """44 dots (S = 1,081): the M chain (K2's band_m, K5's e_adj and
    band_adj) at one column against its plain version, the block's
    threads striding over the states (2 a thread), f64 within 1e-9 and
    f32 within 1e-4 relative, and bitwise the build of 4 cells a thread
    (a forced plan); K8/K9 (1,024 threads striding over the
    states) against the plain chain.  The plain DP's dense matrices are
    freed after."""
    _need_cuda()
    try:
        cfg = J.ModelConfig(pattern="." * 44, Lp=50, max_span=40,
                            max_iloop=10, min_bpp=0.0, tau=0.1, dtype=dtype)
        tol = 1e-9 if dtype == "float64" else 1e-4
        dp, d, c, h, fs, gbar = _band_inputs(cfg, _ep_reads(cfg, 3, 19))
        st, j0 = dp.st, 40
        r = j0 + st.PAD
        assert st.dims.S == 1081
        for kn in ("inside_band", "outside_band"):
            assert K.band_plan(kn, st.dims.S, st.dtype).cells == 2
        four = {kn: K.band_plan(kn, st.dims.S, st.dtype, cells=4)
                for kn in ("inside_band", "outside_band")}
        ks, ps = DP.clone_state(fs), DP.clone_state(fs)
        k4 = DP.clone_state(fs)
        K.band_m(ks, j0, d, c, h, st)
        K.band_m(k4, j0, d, c, h, st, plan=four["inside_band"])
        DP.band_m_plain(ps, j0, d, c, h, st)
        a, b = ks["M"][r], ps["M"][r]
        assert torch.equal(k4["M"][r], a)
        fin = torch.isfinite(b)
        assert torch.equal(torch.isfinite(a), fin)
        assert _rel_ok(a[fin], b[fin], tol)
        gs = DP.init_grads(fs, d, c, h)
        DP.seed_parts(gs, gbar, c, st)
        dp.outside_columns(fs, gs, d, c, h, cfg.Lp + 1, j0 + 1)
        kg, pg = DP.clone_state(gs), DP.clone_state(gs)
        K.e_adj(fs, kg, j0, d, c, h, st)
        kg4 = DP.clone_state(kg)
        K.band_adj(fs, kg, j0, d, c, h, st)
        K.band_adj(fs, kg4, j0, d, c, h, st, plan=four["outside_band"])
        DP.e_adj_plain(fs, pg, j0, d, c, h, st)
        DP.band_adj_plain(fs, pg, j0, d, c, h, st)
        for k_ in DP.GRAD_TABLES:
            assert _rel_ok(kg[k_][:r], pg[k_][:r], tol), k_
            assert torch.equal(kg4[k_], kg[k_]), k_
        for k_ in ("eR", "eL", "bg2", "pv", "gM"):
            assert _rel_ok(kg[k_], pg[k_], tol), k_
            assert torch.equal(kg4[k_], kg[k_]), k_
        st_c, eR, L, gp = _chain_inputs("." * 44, 0.1, dtype, n=3)
        parts, rows = K.chain_fwd(st_c, eR, L)
        g = K.chain_adj(st_c, eR, L, rows, gp)
        leaf = eR.detach().clone().requires_grad_(True)
        want = LIN.chain_plain(st_c, leaf, L)
        (gw,) = torch.autograd.grad(want, leaf, gp)
        fin = torch.isfinite(want)
        assert torch.equal(fin, torch.isfinite(parts))
        assert _rel_ok(parts[fin], want.detach()[fin], tol)
        assert _rel_ok(g, gw, tol)
    finally:
        J._kernels_cached.cache_clear()
        torch.cuda.empty_cache()
