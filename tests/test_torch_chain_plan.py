"""K8's and K9's launch plan and K9's order of work on the CPU.

ops/kernels.chain_plan picks, before any launch, the block of the no-rss
chain kernels (csrc/chain.cuh): one read a block, the cells a thread owns,
K8's ring and K9's tile of steps, in shared memory or a device
workspace.  The tests below hold the plans to the card's limits and check
that every (state, read) cell has one owner, that the ctypes structs name
the C structs' fields, and that K9's three phases (every softmax weight of
a tile, then the walk, then the class sums) compute what jax.vjp of the
JAX package's _linear_parts_one computes and what a per-step order (each
step's weights formed inside the walk) computes.  No GPU is needed."""
import math
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rnaelem_tpu.alphabet import seq_to_ints
from rnaelem_tpu.model import joint as JJ
from rnaelem_tpu_torch.model import joint as TJ
from rnaelem_tpu_torch.ops import dp as DP
from rnaelem_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

DTYPES = (torch.float32, torch.float64)
STATES = (28, 29, 91, 136, 1081, 1378)
BATCHES = (1, 7, 128, 600)


# ------------------------------------------------------------ the plans

def _cells_of(plan, S, B):
    """The (state, read) cells each walker of each block owns, as arrays
    [blocks, walkers, cells] of the state s and the read b (-1 where the
    thread holds no live cell): csrc/chain.cuh's block b = the read, its
    cell s = tid + k walkers."""
    c = (np.arange(plan.walkers)[:, None]
         + plan.walkers * np.arange(plan.cells)[None, :])
    s = np.broadcast_to(c, (B,) + c.shape)
    b = np.broadcast_to(np.arange(B)[:, None, None], s.shape)
    live = s < S
    return np.where(live, s, -1), np.where(live, b, -1)


def _owners(plan, S, B):
    """How many threads own each (state, read) cell of a launch."""
    s, b = _cells_of(plan, S, B)
    live = s >= 0
    count = np.zeros((S, B), dtype=np.int64)
    np.add.at(count, (s[live], b[live]), 1)
    return count


@pytest.mark.parametrize("S", STATES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("aux", [False, True])
def test_chain_plan_fits_the_card_and_owns_every_cell_once(S, dtype, aux):
    """Both kernels' plans, the shape's and K9's device variant: at most
    MAX_THREADS threads, at most SMEM_LIMIT bytes of shared memory (the
    layout chain_smem_bytes sizes), K9's tile within Lp, and every
    (state, read) cell of B = 1, 7, 128 and 600 reads owned by exactly one
    thread."""
    nnz = 2 * S
    for kernel in K.CHAIN_KERNELS:
        for variant in (None, "device") if kernel == "linear_adj" else (
                None,):
            for B in BATCHES:
                plan = K.chain_plan(kernel, S, 100, B, dtype, aux, nnz,
                                    variant)
                assert plan.aux == aux and plan.kernel == kernel
                assert plan.walkers <= plan.threads <= K.MAX_THREADS
                assert plan.threads % plan.walkers == 0
                assert plan.walkers % 32 == 0
                assert plan.smem <= K.SMEM_LIMIT
                assert plan.cells in (1, 2, 4)
                assert plan.cells == 1 or S > K.MAX_THREADS
                if plan.variant == "shared":
                    assert variant is None
                    assert plan.smem == K.chain_smem_bytes(
                        kernel, S, dtype, plan.R, plan.nnz, aux)
                else:
                    assert kernel == "linear_adj" and plan.smem == 0
                    assert plan.block_bytes >= K.chain_smem_bytes(
                        kernel, S, dtype, plan.R, nnz, aux)
                    assert plan.block_bytes % K.EP_WS_ALIGN == 0
                if kernel == "linear_adj":
                    assert 1 <= plan.R <= 100 and plan.nnz == nnz
                else:
                    assert plan.R == K.CHAIN_RING
                if kernel == "linear_fwd":
                    assert plan.threads == plan.walkers
                else:                 # helpers up to 128 threads
                    assert plan.threads == max(plan.walkers, 128 // (
                        plan.walkers) * plan.walkers)
                if S <= 32:
                    assert plan.walkers == 32     # the one-warp walk
                assert (_owners(plan, S, B) == 1).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_chain_plan_tiles_wide_grammars_and_refuses_past_4096_states(dtype):
    """44 and 50 dots no-rss (S = 1,081 and 1,378, about 2 S transitions)
    take a tile of a few steps in shared memory (f64 too); the main shape
    takes the whole read; the device variant can be forced and keeps its
    tiles short; past 4,096 states no block is planned."""
    it = torch.empty((), dtype=dtype).element_size()
    main = K.chain_plan("linear_adj", 28, 100, 128, dtype, False, 52)
    assert (main.cells, main.R, main.walkers, main.threads,
            main.variant) == (1, 100, 32, 128, "shared")
    for S, nnz in ((1081, 2116), (1378, 2704)):
        p = K.chain_plan("linear_adj", S, 40, 3, dtype, True, nnz)
        assert p.variant == "shared" and 1 <= p.R < 40
        assert p.cells == 2 and p.threads == p.walkers == 32 * -(-S // 64)
        nxt = K.chain_smem_bytes("linear_adj", S, dtype, p.R + 1, nnz, True)
        assert nxt > K.SMEM_LIMIT
        d = K.chain_plan("linear_adj", S, 40, 3, dtype, True, nnz,
                         variant="device")
        assert d.variant == "device" and d.R == K.CHAIN_DEV_TILE
    big = K.chain_plan("linear_fwd", 4096, 100, 2, dtype)
    assert big.cells == 4 and big.threads == 1024
    assert big.smem == (2 + K.CHAIN_RING) * 4096 * it
    for kernel in K.CHAIN_KERNELS:
        with pytest.raises(ValueError, match="at most 4096"):
            K.chain_plan(kernel, 4097, 100, 2, dtype, False, 8194)
    with pytest.raises(ValueError, match="variant"):
        K.chain_plan("linear_fwd", 28, 100, 2, dtype, variant="device")


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


@pytest.mark.parametrize("cname", ["ChainDims", "ChainIdx", "ChainGrid"])
def test_the_chain_structs_match_their_c_layout(cname):
    """ChainDims, ChainIdx and ChainGrid (csrc/chain.cuh) as ctypes builds
    them, field by field, and a plan's grid_args fill ChainGrid."""
    src = (K.CSRC / "chain.cuh").read_text()
    py = getattr(K, cname)
    assert _c_struct(src, cname) == [f[0] for f in py._fields_]
    if cname == "ChainGrid":
        for kernel in K.CHAIN_KERNELS:
            plan = K.chain_plan(kernel, 28, 100, 128, torch.float32, True, 52)
            assert len(plan.grid_args) == len(py._fields_)
            grid = py(*plan.grid_args)
            assert (grid.NC, grid.R, grid.nnz, grid.threads, grid.smem) == (
                plan.cells, plan.R, plan.nnz, plan.threads, plan.smem)
    # the kernels' exports take the plan's struct after Aux
    for fn, src_name in (("rnaelem_chain_fwd_f32", "linear_fwd.cu"),
                         ("rnaelem_chain_adj_f64", "linear_adj.cu")):
        text = (K.CSRC / src_name).read_text()
        sig = re.search(r"%s\((.*?)\)" % fn, text, re.S).group(1)
        assert "Aux ax,\n" in sig and "ChainGrid pg" in sig


def test_a_forced_plan_must_be_the_launchs():
    """chain_fwd / chain_adj refuse a plan of the other kernel, of the
    other instantiation or of another grammar's transitions."""
    cfg = TJ.ModelConfig(pattern="..*..", Lp=12, max_span=8, max_iloop=4,
                         min_bpp=0.0, tau=0.1, no_rss=True, dtype="float64")
    st = TJ.kernels(cfg, "cpu").dp.st
    D = K.ChainDims(12, st.dims.S, 3)
    nnz = int(st.k["rtr_t"].numel())
    good = K.chain_plan("linear_adj", st.dims.S, 12, 3, torch.float64, True,
                        nnz)
    assert K._chain_plan_for("linear_adj", st, D, True, good) is good
    assert K._chain_plan_for("linear_adj", st, D, True, None) == good
    for bad in (K.chain_plan("linear_fwd", st.dims.S, 12, 3, torch.float64,
                             True),
                K.chain_plan("linear_adj", st.dims.S, 12, 3, torch.float64,
                             False, nnz),
                good._replace(nnz=nnz + 1)):
        with pytest.raises(ValueError, match="not this launch's"):
            K._chain_plan_for("linear_adj", st, D, True, bad)


# ---------------------------------------------- K9's order, in numpy f64

LP = 24


def _setup(pattern, tau, pinned, seed):
    """The JAX and port configs, B = 4 reads of ragged lengths (one of 2
    nt), random emissions, a parts cotangent and, if ``pinned``, a pin
    per read (the start class at a random base; one read unpinned)."""
    kw = dict(pattern=pattern, Lp=LP, max_span=12, max_iloop=6,
              min_bpp=1e-4, tau=tau, no_rss=True, dtype="float64")
    cj, ct = JJ.ModelConfig(**kw), TJ.ModelConfig(**kw)
    rng = np.random.RandomState(seed)
    pj = JJ.init_params(JJ.kernels(cj).g, cj, jnp.float64)
    pj = pj._replace(
        singles=pj.singles + jnp.asarray(0.5 * rng.randn(*pj.singles.shape)))
    sdj = []
    for L in (LP, 17, 9, 2):
        s = seq_to_ints("".join("ACGU"[c] for c in rng.randint(0, 4, L)))
        q = rng.randint(0, 40, L + 1)
        sdj.append(JJ.make_seqdata(cj, s, q))
    sdj = jax.tree.map(lambda *x: jnp.asarray(np.stack(x)), *sdj)
    B = 4
    pos = rng.randint(0, 12, B) if pinned else np.full(B, -1)
    if pinned:
        pos[1] = -1
    gp = rng.rand(B, 3)
    return cj, ct, pj, sdj, pos, gp


def _lists(ct):
    """The port's CSR lists (by target and by source, with their log
    weights) and class codes [S, S] (target, source) of the R kind."""
    st = TJ.kernels(ct, "cpu").dp.st
    a = {k: st.k[k].numpy() for k in ("rt_off", "rt_s", "rt_w", "rtr_off",
                                      "rtr_t", "rtr_w", "cls_code")}
    a["code"] = a.pop("cls_code")[0]
    a["end"] = np.asarray(st.end_states)
    a["S"] = st.dims.S
    return a


def _emissions(cj, pj, sdj):
    """eR [B, Lp, S] as _linear_parts_one forms it (default theta)."""
    g = JJ.kernels(cj).g
    base = np.asarray(sdj.seq)
    b1 = np.clip(base - 1, 0, 3)
    sidx = np.asarray(g.single_table_index)[np.asarray(g.tid_r)]
    th = np.asarray(pj.singles)
    v = np.where((base > 0)[..., None], th[sidx[None, None, :],
                                           b1[..., None]], 0.0)
    return v + np.where(np.asarray(g.ws_r)[None, None, :],
                        np.asarray(sdj.ws)[..., None], 0.0), sidx, b1, base


def _req(pos, p):
    return DP.CLS_START if pos == p else 0


def _vetoed(req, code):
    return req != 0 and (code & req) != req


def _forward(a, eR, Lb, pos):
    """K8's rows o_0 .. o_Lb of one read: each target's max, then its sum
    in list order, m + log(sum) + eR."""
    S = a["S"]
    O = np.full((Lb + 1, S), -np.inf)
    O[0, a["end"][0]] = 0.0
    for p in range(Lb):
        req = _req(pos, p)
        for t in range(S):
            ks = [k for k in range(a["rt_off"][t], a["rt_off"][t + 1])
                  if not _vetoed(req, a["code"][t, a["rt_s"][k]])]
            m = -math.inf
            for k in ks:
                m = max(m, O[p, a["rt_s"][k]] + a["rt_w"][k])
            if m > -math.inf:
                s = 0.0
                for k in ks:
                    s += math.exp(O[p, a["rt_s"][k]] + a["rt_w"][k] - m)
                O[p + 1, t] = m + math.log(s) + eR[p, t]
    return O


def _seed(a, gp):
    g = np.zeros(a["S"])
    for e in range(3):
        g[a["end"][e]] += gp[e]
    return g


def _per_step_adjoint(a, eR, O, Lb, pos, gp, Lp):
    """K9 of one read in the per-step order: from the read's end, each
    source's terms x = g[t] exp(o_p[s] + w + eR[p, t] - o_{p+1}[t]) in
    list order, their class partials per source, then the sources in
    ascending order.  (g_eR [Lp, S], class sums [4, Lp], the terms [Lp,
    S(t), S(s)])."""
    S = a["S"]
    g = _seed(a, gp)
    gE, cls = np.zeros((Lp, S)), np.zeros((4, Lp))
    post = np.zeros((Lp, S, S))
    for p in range(Lb - 1, -1, -1):
        req = _req(pos, p)
        gn, part = np.zeros(S), np.zeros((4, S))
        for s in range(S):
            gE[p, s] = g[s]
            if not O[p, s] > -math.inf:
                continue
            for k in range(a["rtr_off"][s], a["rtr_off"][s + 1]):
                t = a["rtr_t"][k]
                if g[t] == 0 or _vetoed(req, a["code"][t, s]):
                    continue
                on = O[p + 1, t]
                if not on > -math.inf:
                    continue
                x = g[t] * math.exp(O[p, s] + a["rtr_w"][k] + eR[p, t] - on)
                gn[s] += x
                post[p, t, s] = x
                for c in range(4):
                    if a["code"][t, s] >> c & 1:
                        part[c, s] += x
        for c in range(4):
            tot = 0.0
            for s in range(S):
                tot += part[c, s]
            cls[c, p] = tot
        g = gn
    return gE, cls, post


def _three_phases(a, eR, O, Lb, pos, gp, Lp, R):
    """K9 as csrc/linear_adj.cu runs one read, tiles of R steps from the
    end: (a) every weight W[p, k] of the tile (-1 where the entry takes no
    part), (b) the walk over the tile's steps with W, keeping the
    cotangent rows, (c) the class sums of the tile's steps from those rows
    and W."""
    S, nnz = a["S"], len(a["rtr_t"])
    gE, cls = np.zeros((Lp, S)), np.zeros((4, Lp))
    rows = {Lb: _seed(a, gp)}
    hi = Lb
    while hi > 0:
        lo = max(0, hi - R)
        W = np.full((hi - lo, nnz), -1.0)
        for p in range(lo, hi):                                   # (a)
            req = _req(pos, p)
            for s in range(S):
                for k in range(a["rtr_off"][s], a["rtr_off"][s + 1]):
                    t = a["rtr_t"][k]
                    if O[p, s] > -math.inf and not _vetoed(
                            req, a["code"][t, s]) and O[p + 1, t] > -math.inf:
                        W[p - lo, k] = math.exp(O[p, s] + a["rtr_w"][k]
                                                + eR[p, t] - O[p + 1, t])
        for p in range(hi - 1, lo - 1, -1):                       # (b)
            gin = rows[p + 1]
            gE[p] = gin
            gout = np.zeros(S)
            for s in range(S):
                for k in range(a["rtr_off"][s], a["rtr_off"][s + 1]):
                    gt, wt = gin[a["rtr_t"][k]], W[p - lo, k]
                    if gt == 0 or not wt >= 0:
                        continue
                    gout[s] += gt * wt
            rows[p] = gout
        for p in range(lo, hi):                                   # (c)
            tot = np.zeros(4)
            for s in range(S):
                acc = np.zeros(4)
                for k in range(a["rtr_off"][s], a["rtr_off"][s + 1]):
                    t = a["rtr_t"][k]
                    gt, wt = rows[p + 1][t], W[p - lo, k]
                    if gt == 0 or not wt >= 0:
                        continue
                    x = gt * wt
                    for c in range(4):
                        if a["code"][t, s] >> c & 1:
                            acc[c] += x
                tot += acc
            cls[:, p] = tot
        hi = lo
    return gE, cls


@pytest.mark.parametrize("pattern,tau,pinned", [
    ("..*..", 0.1, False), ("..*..", 0.1, True), ("..*..", 0.0, True),
    ("....*....", 0.1, False), ("....*....", 0.1, True)])
def test_k9_phases_match_jax_vjp_and_the_per_step_order(pattern, tau,
                                                        pinned):
    """K9's three phases (numpy, f64, tiles of 5 and of the whole read)
    against jax.vjp of _linear_parts_one (the cotangent of the emission
    table through eR, and of a dense auxR holding the pin's vetoes, whose
    class sums are the scanner's probe) within 1e-12, and against the
    per-step order within 1e-13."""
    cj, ct, pj, sdj, pos, gp = _setup(pattern, tau, pinned, seed=3)
    a = _lists(ct)
    S, B = a["S"], len(pos)
    eR, sidx, b1, base = _emissions(cj, pj, sdj)
    code = a["code"]
    auxR = np.zeros((B, LP, S, S))
    for b in range(B):
        if pos[b] >= 0:
            auxR[b, pos[b]] = np.where((code & DP.CLS_START) == 0, -np.inf,
                                       0.0)

    def parts(p, aux):
        return jax.vmap(lambda sd, x: JJ._linear_parts_one(
            cj, p, sd, {"auxR": x}))(sdj, aux)

    want, vjp = jax.vjp(parts, pj, jnp.asarray(auxR))
    fin = np.isfinite(np.asarray(want))
    d_p, d_aux = vjp(jnp.asarray(np.where(fin, gp, 0.0)))
    d_aux = np.asarray(d_aux)
    mask = np.stack([(code >> c) & 1 for c in range(4)])      # [4, S, S]
    d_singles = np.zeros(np.asarray(pj.singles).shape)
    L = np.asarray(sdj.L)
    for b in range(B):
        Lb = min(int(L[b]), LP)
        g_b = np.where(fin[b], gp[b], 0.0)
        O = _forward(a, eR[b], Lb, pos[b])
        np.testing.assert_allclose(O[Lb, a["end"]], np.asarray(want)[b],
                                   rtol=1e-12)
        gE, cls, post = _per_step_adjoint(a, eR[b], O, Lb, pos[b], g_b, LP)
        scale = max(np.abs(gE).max(), 1e-300)
        for R in (5, LP):
            gE3, cls3 = _three_phases(a, eR[b], O, Lb, pos[b], g_b, LP, R)
            assert np.abs(gE3 - gE).max() <= 1e-13 * scale
            assert np.abs(cls3 - cls).max() <= 1e-13 * max(
                np.abs(cls).max(), 1e-300)
        # the transition posteriors are the cotangent of auxR, and their
        # class sums the probe's
        np.testing.assert_allclose(post, d_aux[b], rtol=0,
                                   atol=1e-12 * max(np.abs(post).max(), 1))
        want_cls = np.einsum("pts,cts->cp", d_aux[b], mask)
        assert np.abs(cls3 - want_cls).max() <= 1e-12 * max(
            np.abs(want_cls).max(), 1)
        for p in range(LP):
            if base[b, p] > 0:
                np.add.at(d_singles, (sidx, b1[b, p]), gE3[p])
    ds = np.asarray(d_p.singles)
    assert np.abs(ds).max() > 0
    assert np.abs(d_singles - ds).max() <= 1e-12 * np.abs(ds).max()
