"""Rows C and D on the CPU: the port's plain factors (the version K14 and
K15 are held to on the card) against the JAX package's, K14's and K15's
host-built arguments against what the plain version uses, K16's and
K17's size classes, and the M chain's launch plans past 1,024 states.

The per-read VJP of batch_factors_pr (cotangents of singles, pairs and
lambda from random cotangents of eR, eL, bg2 and pv) is held to jax.vjp
of JAX's batch_factors_pr at f64 within 1e-12 (relative, max norm): the
one-hot lookups are exact, so both sides add the same terms."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rnaelem_tpu.model import joint as JJ
from rnaelem_tpu_torch.alphabet import BP, seq_to_ints
from rnaelem_tpu_torch.grammar.profile import compile_pattern
from rnaelem_tpu_torch.model import joint as TJ
from rnaelem_tpu_torch.ops import dp as DP
from rnaelem_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

CSRC = Path(K.__file__).resolve().parent.parent / "csrc"
LP = 24
OPTS = {"plain": {}, "softmax": {"theta_softmax": True},
        "no_theta": {"no_theta": True}, "no_prf": {"no_prf": True},
        "fix_rss": {"fix_rss": True},
        "softmax_no_theta": {"theta_softmax": True, "no_theta": True}}


def _rss(rng, L):
    rss = ["."] * L
    m = int(rng.randint(1, 4))
    i0 = int(rng.randint(0, L - 2 * m - 3))
    for k in range(m):
        rss[i0 + k], rss[i0 + 2 * m + 2 - k] = "(", ")"
    return "".join(rss)


def _case(pattern, opts, seed=7):
    """Both packages' configs and batches (B=3 reads of ragged lengths, one
    with an N), per-read weights (each read its own) and the pair masks."""
    kw = dict(pattern=pattern, Lp=LP, max_span=12, max_iloop=6, min_bpp=0.0,
              tau=0.1, dtype="float64", **opts)
    cj, ct = JJ.ModelConfig(**kw), TJ.ModelConfig(**kw)
    rng = np.random.RandomState(seed)
    sj, st_ = [], []
    for i, L in enumerate((LP, 17, 9)):
        s = "".join("ACGU"[c] for c in rng.randint(0, 4, L))
        if i == 1:
            s = s[:5] + "N" + s[6:]
        q = rng.randint(0, 40, L + 1)
        q[-1] = 0 if i != 1 else 5
        rss = _rss(rng, L) if ct.fix_rss else ""
        sj.append(JJ.make_seqdata(cj, seq_to_ints(s), q, rss))
        st_.append(TJ.make_seqdata(ct, seq_to_ints(s), q, rss))
    sd_j = JJ.SeqData(*[jnp.asarray(np.stack(x)) for x in zip(*sj)])
    sd_t = TJ.stack_seqdata(st_, "cpu")
    kt = TJ.kernels(ct, "cpu")
    bp = sd_t.rss_pair if ct.fix_rss else TJ._complementary_bp(ct, kt, sd_t)
    p = TJ.init_params(kt.g, ct, device="cpu")
    B = len(st_)
    w = [p.singles.numpy()[None] + 0.5 * rng.randn(B, *p.singles.shape),
         p.pairs.numpy()[None] + 0.5 * rng.randn(B, *p.pairs.shape),
         0.5 + rng.rand(B, 2)]
    return cj, ct, sd_j, sd_t, bp.numpy(), w, rng


def _rel(a, b):
    scale = float(np.abs(b).max())
    err = float(np.abs(a - b).max())
    return err / scale if scale > 0 else err


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_plain_factors_vjp_matches_jax(opt):
    """batch_factors_pr's outputs and per-read VJP (the plain version, the
    reference of K14/K15 on the card) against JAX's within 1e-12."""
    cj, ct, sd_j, sd_t, bp, w, rng = _case("(.....)", OPTS[opt])

    def jax_f(pb):
        d, _ = JJ.batch_factors_pr(cj, pb, sd_j, jnp.asarray(bp))
        return d.eR, d.eL, d.bg2, d.pv, d.lam

    outs_j, vjp = jax.vjp(jax_f, JJ.Params(*[jnp.asarray(x) for x in w]))
    cots = [rng.randn(*np.shape(o)) for o in outs_j]
    g_j = vjp(tuple(jnp.asarray(c) for c in cots))[0]
    leaves = [torch.as_tensor(x).requires_grad_(True) for x in w]
    with torch.enable_grad():
        d, _ = TJ.batch_factors_pr(ct, TJ.Params(*leaves), sd_t,
                                   torch.as_tensor(bp), device="cpu")
        outs_t = (d.eR, d.eL, d.bg2, d.pv, d.lam)
        live = [i for i, o in enumerate(outs_t) if o.requires_grad]
        g_t = torch.autograd.grad([outs_t[i] for i in live], leaves,
                                  [torch.as_tensor(cots[i]) for i in live],
                                  allow_unused=True)
    for name, a, b in zip(("eR", "eL", "bg2", "pv", "lam"), outs_t, outs_j):
        assert a.shape == tuple(np.shape(b)), name
        assert _rel(a.detach().numpy(), np.asarray(b)) <= 1e-12, name
    for name, a, b in zip(("singles", "pairs", "lam"), g_t, g_j):
        a = np.zeros(np.shape(b)) if a is None else a.numpy()
        assert _rel(a, np.asarray(b)) <= 1e-12, (opt, name)


@pytest.mark.parametrize("pattern", ["(.....)", "..*..", ".(..*).", "." * 12])
def test_factor_lists_are_what_the_plain_version_indexes(pattern):
    """K14/K15's slot and flag lists (kernels.factor_lists): gathered with
    them, the per-read weights give the plain version's eR and eL (the
    slot of each state's node, a negative one taken from the end as torch
    indexing takes it, and the positional-weight flags)."""
    _, ct, _, sd_t, _, w, _ = _case(pattern, {})
    k = TJ.kernels(ct, "cpu")
    ns = w[0].shape[1]
    lists = K.factor_lists(k.dp.st, ns)
    assert all(v.dtype == torch.int32 and v.shape == (k.g.S,)
               for v in lists.values())
    assert int(lists["slot_r"].min()) >= 0 and int(lists["slot_r"].max()) < ns
    singles = torch.as_tensor(w[0])
    d = TJ._diff_factors(ct, k, TJ.Params(singles, torch.as_tensor(w[1]),
                                          torch.as_tensor(w[2])), sd_t)
    seq = sd_t.seq.long()
    base = torch.clamp(seq - 1, 0, 3)
    ws = sd_t.ws
    for key, out in (("r", d.eR), ("l", d.eL)):
        slot = lists["slot_" + key].long()
        flag = lists["ws_" + key].bool()
        th = singles[:, slot][torch.arange(3)[:, None, None],
                             torch.arange(k.g.S)[None, None, :],
                             base[:, :, None]]               # [B, Lp, S]
        want = torch.where((seq > 0)[:, :, None], th, torch.zeros(())) + \
            torch.where(flag[None, None, :], ws[:, :, None], torch.zeros(()))
        assert torch.equal(torch.movedim(want, 0, -1), out), key


def _c_struct(src, name):
    """The field names of C struct ``name`` in a csrc source."""
    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    out = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            out += [re.sub(r"[^\w]", "", x.split()[-1]) if " " in x.strip()
                    else x.strip() for x in decl.split(",")]
    return out


def test_the_kernels_argument_structs_match_their_c_layout():
    """FacDims, FacIdx, FacOut, FacAdjArgs (csrc/factors.cu) and HoistDims,
    HoistIn, HoistOut (csrc/hoisted.cu) as ctypes builds them, field by
    field; the pair-type table K14/K15 hold is alphabet.BP."""
    fac = (CSRC / "factors.cu").read_text()
    hoi = (CSRC / "hoisted.cu").read_text()
    for src, cname, py in ((fac, "FacDims", K.FacDims), (fac, "FacIdx",
                                                        K.FacIdx),
                           (fac, "FacOut", K.FacOut),
                           (fac, "FacAdjArgs", K.FacAdjArgs),
                           (hoi, "HoistDims", K.HoistDims),
                           (hoi, "HoistIn", K.HoistIn),
                           (hoi, "HoistOut", K.HoistOut)):
        assert _c_struct(src, cname) == [f[0] for f in py._fields_], cname
    table = re.search(r"c_fac_bp\[25\] = \{([^}]*)\}", fac).group(1)
    assert [int(x) for x in table.split(",")] == list(np.ravel(BP))


def test_the_one_hot_rows_are_the_plain_versions():
    """K15's literal one-hot rows (c_fac_onehot in csrc/factors.cu): the
    base of codes 0..4 and the index of pair types 0..6, as the plain
    version's one-hot of clip(x - 1, 0, 3) and clip(x - 1, 0, 5)."""
    fac = (CSRC / "factors.cu").read_text()
    table = re.search(r"c_fac_onehot\[62\] = \{([^}]*)\}", fac).group(1)
    got = [int(x) for x in table.split(",")]
    one_hot = torch.nn.functional.one_hot
    want = torch.cat([
        one_hot(torch.clamp(torch.arange(5) - 1, 0, 3), 4).ravel(),
        one_hot(torch.clamp(torch.arange(7) - 1, 0, 5), 6).ravel()])
    assert got == want.tolist()


@pytest.mark.parametrize("pattern", ["(.....)", ".(..*).", "." * 12])
def test_hoisted_size_classes_are_the_plain_versions(pattern):
    """K16/K17's size classes (kernels.hoist_static): SZT is the plain
    version's transpose of the size weights, grp its groups; the plain
    adjoint of the hoisted tensors (finish_grads' autograd on the CPU) sums
    each tensor's terms per read."""
    ct = TJ.ModelConfig(pattern=pattern, Lp=LP, max_span=12, max_iloop=6,
                        min_bpp=0.0, tau=0.1, dtype="float64")
    st = TJ.kernels(ct, "cpu").dp.st
    SZT, grp = K.hoist_static(st)
    assert torch.equal(SZT, torch.as_tensor(np.transpose(st.SZ, (0, 2, 1))))
    assert grp.dtype == torch.int32
    assert grp.tolist() == [int(x) for x in st.grp]
    assert 0 <= int(grp.min()) and int(grp.max()) < 4


@pytest.mark.parametrize("dots", [43, 44, 50])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kernel", ["inside_band", "outside_band"])
def test_band_plan_takes_grammars_past_1024_states(kernel, dtype, dots):
    """All-dot patterns of 43, 44 and 50 dots (S = 1,035, 1,081, 1,378):
    the M chain's plan holds one read a block (G = 1), its threads stride
    over the states (2 a thread, at most 1024 threads), the ring in shared
    memory where the G = 1 ring of 4 or 2 fits, else the device variant
    (K5's m_adj at f64 past 1,263 states); it never raises."""
    S = compile_pattern("." * dots).S
    assert S == {43: 1035, 44: 1081, 50: 1378}[dots]
    plan = K.band_plan(kernel, S, dtype)
    assert (plan.G, plan.cells) == (1, 2)
    per_thread = -(-S // 2)
    assert plan.threads == -(-per_thread // 32) * 32
    assert plan.threads <= K.MAX_THREADS < S
    assert plan.threads * plan.cells >= S
    shared = [r for r in (K.BAND_RING, K.BAND_RING_SMALL)
              if K.band_smem_bytes(kernel, S, dtype, 1, r) <= K.SMEM_LIMIT]
    if shared:
        assert plan.variant == "shared" and plan.R == shared[0]
        assert plan.smem == K.band_smem_bytes(kernel, S, dtype, 1, plan.R)
    else:
        assert plan.variant == "device" and plan.smem == 0
        assert plan.block_bytes >= K.band_smem_bytes(kernel, S, dtype, 1,
                                                     K.BAND_RING)
        assert plan.block_bytes % K.EP_WS_ALIGN == 0
    device = K.band_plan(kernel, S, dtype, variant="device")
    assert (device.variant, device.G, device.R) == ("device", 1, K.BAND_RING)
    assert device.name.endswith(",device")
    expect_device = kernel == "outside_band" and dtype == torch.float64 \
        and S > 1263
    assert (plan.variant == "device") == expect_device


def test_band_plan_refuses_a_forced_group_past_1024_threads():
    """Past 1,024 states only G = 1 strides over the states: a forced
    group of more reads has no block, and a forced shared variant whose
    ring does not fit raises."""
    S = compile_pattern("." * 50).S
    with pytest.raises(ValueError, match="no M-chain block"):
        K.band_plan("inside_band", S, torch.float32, G=2)
    with pytest.raises(ValueError, match="no M-chain block"):
        K.band_plan("outside_band", S, torch.float64, variant="shared")
    with pytest.raises(ValueError, match="neither"):
        K.band_plan("outside_band", S, torch.float64, variant="global")


@pytest.mark.parametrize("dots", [44, 50])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kernel", ["inside_band", "outside_band"])
def test_band_plan_forces_four_cells_a_thread(kernel, dtype, dots):
    """``cells`` forces the states a thread of a G = 1 block strides over
    (so the build of 4 cells a thread runs at a grammar whose own plan
    takes 2): a quarter of the states' threads in whole warps, the ring
    and variant the natural plan takes, the same layout; fewer cells than
    the states need, or more than one at G > 1, raise."""
    S = compile_pattern("." * dots).S
    plan = K.band_plan(kernel, S, dtype)
    four = K.band_plan(kernel, S, dtype, cells=4)
    assert (four.G, four.cells) == (1, 4)
    per_thread = -(-S // 4)
    assert four.threads == -(-per_thread // 32) * 32
    assert four.threads * 4 >= S and four.threads < plan.threads
    assert (four.R, four.smem, four.variant, four.block_bytes) == (
        plan.R, plan.smem, plan.variant, plan.block_bytes)
    assert four.name == plan.name.replace("cells=2", "cells=4")
    with pytest.raises(ValueError, match="no M-chain block"):
        K.band_plan(kernel, S, dtype, cells=1)
    with pytest.raises(ValueError, match="no M-chain block"):
        K.band_plan(kernel, 171, dtype, G=2, cells=2)
    with pytest.raises(ValueError, match="not one of"):
        K.band_plan(kernel, S, dtype, cells=3)
    assert K.band_plan(kernel, 29, dtype, cells=4).threads == 32


def test_lam_total_on_the_cpu_is_the_hoisted_autograd():
    """Lambda's whole cotangent from ops/dp.finish_grads on CPU tensors:
    the direct term plus autograd through hoisted_plain, per read (what
    K17 replaces on the card)."""
    _, ct, _, sd_t, bp, w, rng = _case("(.....)", {})
    k = TJ.kernels(ct, "cpu")
    st = k.dp.st
    d, c = TJ.batch_factors(ct, TJ.Params(*[torch.as_tensor(x[0]) for x in w]),
                            sd_t, torch.as_tensor(bp), device="cpu")
    h = DP.hoisted(d, c, st)
    cots = [torch.as_tensor(rng.randn(*h[n].shape)) for n in DP.HOISTED]
    direct = torch.as_tensor(rng.randn(2, 3))
    DL = torch.zeros((st.dims.Lp + 1, st.dims.Wp + 1, st.dims.S, 3),
                     dtype=direct.dtype)

    def lam_of(cots, direct, DL, d, c):
        gs = dict(zip(("eSZ", "GSZ", "emisA", "emisB"), cots), lam=direct,
                  DL=DL, **{n: None for n in ("eR", "eL", "bg2", "pv",
                                              "alphaP")})
        return DP.finish_grads(gs, d, c, st)[4]

    got = lam_of(cots, direct, DL, d, c)
    lam = d.lam.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        hp = DP.hoisted_plain(d._replace(lam=lam), c, st)
        (g,) = torch.autograd.grad([hp[n] for n in DP.HOISTED], [lam], cots)
    assert torch.equal(got, direct + g)
    # with K5's/K7's partials, K20's twin over the same term (its order)
    DL = torch.as_tensor(rng.randn(*DL.shape))
    got = lam_of(cots, direct, DL, d, c)
    assert torch.equal(got, DP.lam_sum_plain(DL, direct, st, g))
    # each read's cotangent is its own: the first read alone gives its bits
    c1 = c._replace(C=c.C[:1], ep={n: v[..., :1] for n, v in c.ep.items()})
    one = lam_of([x[..., :1] for x in cots], direct[:, :1], DL[..., :1],
                 d._replace(lam=d.lam[:, :1]), c1)
    assert torch.equal(one, got[:, :1])
