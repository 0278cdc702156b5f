"""K14's launch plan and block tiling on the CPU.

ops/kernels.factors_plan lays K14 (csrc/factors.cu factors_kernel) out
before any launch: groups of G reads (a 128-byte line of a float plane)
in the grid's y, tiles of P positions of three index ranges and one
block of per-read constants in its x, blocks of TY rows x TX threads, V
reads a thread.  The model below forms every offset a thread writes as
the kernel does (its rows from the incremental (position, state) and (j,
w) walks, its 64-bit bases and 32-bit offsets, the staged windows) and
the values it writes (the effective weight rows built once per block):
every element of every output must be written exactly once, for B = 1,
7, 128 and 600 and odd Lp, and the differentiable factors must equal the
plain version's (model/joint._diff_factors).  No GPU is needed."""
import re

import numpy as np
import pytest
import torch

from rnaelem_tpu_torch.alphabet import BP
from rnaelem_tpu_torch.model import joint as TJ
from rnaelem_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

DTYPES = (torch.float32, torch.float64)
BATCHES = (1, 7, 128, 600)


def _walk(ty, TY, n_inner, n_outer):
    """The kernel's incremental row walk: thread row ty visits (outer,
    inner) = divmod(ty, n_inner), then steps by TY rows."""
    out = []
    o, i = ty // n_inner, ty - (ty // n_inner) * n_inner
    while o < n_outer:
        out.append(o * n_inner + i)
        i += TY
        while i >= n_inner:
            i -= n_inner
            o += 1
    return out


@pytest.mark.parametrize("TY", [1, 8, 32, 256])
def test_the_row_walk_visits_every_row_once(TY):
    """The (position, state) and (j, w) walks of K14's threads: rows ty,
    ty + TY, ... below the tile's rows, each row by one thread."""
    rng = np.random.RandomState(TY)
    for _ in range(40):
        n_inner, n_outer = rng.randint(1, 60), rng.randint(1, 33)
        seen = []
        for ty in range(TY):
            rows = _walk(ty, TY, n_inner, n_outer)
            assert rows == list(range(ty, n_inner * n_outer, TY))
            seen += rows
        assert sorted(seen) == list(range(n_inner * n_outer))


def _theta(x, softmax, no_theta):
    """effective_theta of weight rows x [..., K] (row_lse's arithmetic)."""
    if no_theta:
        return np.zeros_like(x)
    if not softmax:
        return x
    m = x.max(-1, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    s = np.exp(x - m).sum(-1, keepdims=True)
    return x - np.where(s > 0, np.log(s) + m, -np.inf)


def k14_model(plan, mode, g, Lp, Wp, B, seq, ws, dots, L, singles, pairs,
              flags):
    """K14's writes on ``plan``: {output: (values, write counts)} as flat
    arrays in the outputs' layouts, each element's value and how many
    threads wrote it.  ``g``: the slot and flag lists; ``flags``: (no_prf,
    theta_softmax, no_theta, fix_rss, turn, max_span, max_iloop)."""
    no_prf, softmax, no_theta, fix_rss, turn, max_span, max_iloop = flags
    S, W1 = len(g["slot_r"]), Wp + 1
    Tp = pairs.shape[1] if pairs is not None else 1
    V, TX, TY, G, P = plan.V, plan.TX, plan.TY, plan.G, plan.P
    n1, n2, n3, n4 = plan.tiles
    prf = mode != "null" and not no_prf
    sizes = dict(eR=Lp * S * B, eL=Lp * S * B, pv=(Lp + 1) * W1 * Tp * B,
                 alphaP=(Lp + 1) * W1 * B, bg2=Lp * B, seqT=Lp * B,
                 gate=Lp * B, wsp=Lp * B, seq64=B * Lp, dcum=B * (Lp + 1),
                 dcumT=(Lp + 1) * B, L64=B, C=B, lam=2 * B)
    out = {k: [np.zeros(n), np.zeros(n, np.int64)] for k, n in sizes.items()}

    def put(name, idx, val):
        idx = np.asarray(idx, np.int64)
        val = np.broadcast_to(np.asarray(val, np.float64), idx.shape).ravel()
        idx = idx.ravel()
        assert idx.min() >= 0 and idx.max() < sizes[name], name
        out[name][0][idx] = val
        np.add.at(out[name][1], idx, 1)

    def scan_block(b0, nb):
        """The block of the running dot counts and per-read constants."""
        rr = np.arange(nb)
        cum = np.cumsum(dots[b0 + rr], axis=1)
        for p0 in range(0, Lp, 32):
            p = np.arange(p0, min(p0 + 32, Lp))
            put("dcum", (b0 + rr[:, None]) * (Lp + 1) + p[None] + 1,
                cum[:, p])
            e = np.arange(32 * G)
            q, r = e >> (G.bit_length() - 1), e & (G - 1)
            ok = (r < nb) & (p0 + q < Lp)
            put("dcumT", (p0 + q[ok] + 1) * B + b0 + r[ok],
                cum[r[ok], p0 + q[ok]])
        b = b0 + rr
        put("dcum", b * (Lp + 1), 0)
        put("dcumT", b, 0)
        put("L64", b, L[b])
        W = np.minimum(L[b], max_span)
        put("C", b, np.minimum(W - 2 - (2 if turn == 0 else 5),
                               max_iloop))
        if mode == "null":
            put("lam", b, 1.0)
            put("lam", B + b, 1.0)

    thS = None if singles is None else _theta(singles, softmax, no_theta)
    thP = None if pairs is None else _theta(pairs, softmax, no_theta)
    clamp = lambda x, a, b: np.minimum(np.maximum(x, a), b)
    nx = n1 if mode == "eR" else n1 + n2 + n3 + n4
    for gy in range(plan.groups):
        b0 = gy * G
        nb = min(G, B - b0)
        r0 = np.arange(TX) * V
        r0 = r0[r0 < nb]
        reads = (b0 + r0[:, None] + np.arange(V)[None]).ravel()  # [thr V]
        for rb in range(nx):
            if rb >= n1 + n2 + n3:                     # the last block
                scan_block(b0, nb)
                continue
            if rb < n1:                                # (p, s)
                p0 = rb * P
                np_ = min(P, Lp - p0)
                rows = np.concatenate([_walk(ty, TY, S, np_)
                                       for ty in range(TY)]).astype(int)
                pp, s = rows // S, rows % S
                base = p0 * S * B
                off = base + (pp * S + s)[:, None] * B + reads[None]
                p = (p0 + pp)[:, None]
                code = seq[reads[None], p]
                k = clamp(code - 1, 0, 3)
                wsv = ws[reads[None], p]
                for name, slot, wf in (("eR", "slot_r", "ws_r"),
                                       ("eL", "slot_l", "ws_l")):
                    if name == "eL" and mode == "eR":
                        continue
                    v = np.zeros(code.shape)
                    if prf:
                        t = thS[reads[None], g[slot][s][:, None], k]
                        v = np.where(code > 0, t, 0.0)
                    v = v + np.where(g[wf][s][:, None] != 0, wsv, 0.0)
                    put(name, off, 0.0 if mode == "null" else v)
                continue
            if rb < n1 + n2:                           # (j, w)
                j0 = (rb - n1) * P
                nj = min(P, Lp + 1 - j0)
                lo = clamp(j0 - max(Wp, 1), 0, Lp - 1)
                nc = clamp(j0 + nj - 1, 0, Lp - 1) - lo + 1
                assert nc <= P + W1                    # the staged window
                rows = np.concatenate([_walk(ty, TY, W1, nj)
                                       for ty in range(TY)]).astype(int)
                jj, w = rows // W1, rows % W1
                j = (j0 + jj)[:, None]
                cell = (jj * W1 + w)[:, None]
                put("alphaP", j0 * W1 * B + cell * B + reads[None], 0.0)
                bt = np.zeros((len(rows), len(reads)), np.int64)
                if prf:
                    i = clamp(j - w[:, None], 0, Lp - 1)
                    jl = clamp(j - 1, 0, Lp - 1)
                    for x in (i, jl):
                        assert ((x >= lo) & (x < lo + nc)).all()
                    a = seq[reads[None], i]
                    c = seq[reads[None], np.broadcast_to(jl, i.shape)]
                    bt = BP[clamp(a, 0, 4), clamp(c, 0, 4)]
                for t in range(Tp):
                    v = np.zeros(bt.shape)
                    if prf:
                        v = np.where(bt > 0, thP[reads[None], t,
                                                 clamp(bt - 1, 0, 5)], 0.0)
                    put("pv", j0 * W1 * Tp * B + (cell * Tp + t) * B
                        + reads[None], v)
                continue
            if rb < n1 + n2 + n3:                      # (p, b)
                p0 = (rb - n1 - n2) * P
                np_ = min(P, Lp - p0)
                e = np.arange(G * P)
                r, pp = e >> (P.bit_length() - 1), e & (P - 1)
                ok = (r < nb) & (pp < np_)
                put("seq64", (b0 + r[ok]) * Lp + p0 + pp[ok],
                    seq[b0 + r[ok], p0 + pp[ok]])
                pp = np.arange(np_)[:, None]
                off = p0 * B + pp * B + reads[None]
                code = seq[reads[None], p0 + pp]
                bg = np.zeros(code.shape)
                if prf:
                    bg = np.where(code > 0, thS[reads[None], 0,
                                                clamp(code - 1, 0, 3)], 0.0)
                put("bg2", off, bg)
                put("seqT", off, code)
                put("gate", off, np.where(fix_rss & ~dots[reads[None],
                                                          p0 + pp],
                                          -np.inf, 0.0))
                put("wsp", off, 0.0 if mode == "null"
                    else ws[reads[None], p0 + pp])
                continue
    return out


def _reads(B, Lp, seed):
    rng = np.random.RandomState(seed)
    L = rng.randint(max(1, Lp // 2), Lp + 1, B)
    L[0] = Lp
    seq = rng.randint(1, 5, (B, Lp))
    seq[np.arange(Lp)[None] >= L[:, None]] = 0
    ws = np.round(rng.randn(B, Lp), 3)
    dots = rng.rand(B, Lp) < 0.7
    return seq, ws, dots, L


def _written(mode, Lp, Wp, B, Tp):
    """The outputs K14 writes in ``mode``."""
    if mode == "eR":
        return ("eR",)
    return ("eR", "eL", "pv", "alphaP", "bg2", "seqT", "gate", "wsp",
            "seq64", "dcum", "dcumT", "L64", "C") + (
        ("lam",) if mode == "null" else ())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("Lp,Wp", [(37, 20), (101, 50), (8, 8)])
def test_factors_plan_writes_every_element_once(Lp, Wp, B, dtype):
    """On factors_plan's layout for the three modes (S = 29, 6 single and 1
    pair tables; the null grammar's S = 1), each forced tile too at B = 7:
    every element of every output written exactly once (the vector path's
    V reads whole), the staged windows holding what the rows read."""
    rng = np.random.RandomState(B + Lp)
    seq, ws, dots, L = _reads(B, Lp, B)
    for mode, S, ns, Tp in (("dp", 29, 6, 1), ("eR", 28, 5, 1),
                            ("null", 1, 1, 1), ("dp", 29, 6, 3)):
        g = dict(slot_r=rng.randint(0, ns, S), slot_l=rng.randint(0, ns, S),
                 ws_r=rng.randint(0, 2, S), ws_l=rng.randint(0, 2, S))
        singles = rng.randn(B, ns, 4) if mode != "null" else None
        pairs = rng.randn(B, Tp, 6) if mode == "dp" else None
        tiles = K.FAC_TILES if B == 7 else (None,)
        for P in tiles:
            plan = K.factors_plan(Lp, Wp, S, Tp, ns, B, dtype, True, P)
            it = torch.empty((), dtype=dtype).element_size()
            assert plan.TX * plan.TY == K.FAC_THREADS
            assert plan.G == plan.TX * plan.V <= K.FAC_ROW_BYTES // it
            assert plan.V == (16 // it if B % (16 // it) == 0 else 1)
            assert plan.smem == K.factors_smem_bytes(Wp, Tp, ns, plan.G,
                                                     plan.P, dtype)
            assert plan.smem <= K.SMEM_LIMIT
            assert plan.groups == -(-B // plan.G)
            got = k14_model(plan, mode, g, Lp, Wp, B, seq, ws, dots, L,
                            singles, pairs,
                            (False, True, False, True, 0, 50, 30))
            for name in _written(mode, Lp, Wp, B, Tp):
                assert (got[name][1] == 1).all(), (name, mode, P)
            for name in set(got) - set(_written(mode, Lp, Wp, B, Tp)):
                assert (got[name][1] == 0).all(), (name, mode)


@pytest.mark.parametrize("opt", [{}, {"theta_softmax": True},
                                 {"no_theta": True}, {"no_prf": True},
                                 {"fix_rss": True}])
def test_the_tiling_writes_the_plain_factors(opt):
    """The model's values on the plan's layout equal the plain version's
    differentiable factors (eR, eL, bg2, pv of _diff_factors at f64,
    per-read weights) and constants (the codes, wsp, the gate, the dot
    counts, C), for (.....) at B = 7 x 37 nt."""
    cfg = TJ.ModelConfig(pattern="(.....)", Lp=37, max_span=20,
                         max_iloop=12, min_bpp=1e-4, tau=0.1,
                         dtype="float64", **opt)
    k = TJ.kernels(cfg, "cpu")
    B = 7
    seq, ws, dots, L = _reads(B, cfg.Lp, 3)
    rng = np.random.RandomState(4)
    p = TJ.per_read(TJ.init_params(k.g, cfg, device="cpu"), B)
    p = p._replace(singles=p.singles + torch.as_tensor(
        0.4 * rng.randn(*p.singles.shape)), pairs=p.pairs + torch.as_tensor(
        0.4 * rng.randn(*p.pairs.shape)))
    sds = []
    for b in range(B):
        q = np.full(L[b] + 1, 10)
        q[-1] = 0
        rss = "".join("." if x else "(" for x in dots[b, :L[b]]) \
            if cfg.fix_rss else ""
        sds.append(TJ.make_seqdata(cfg, seq[b, :L[b]], q, rss))
    sd = TJ.stack_seqdata(sds, "cpu")
    seq_, ws_, L_, dots_ = (x.numpy() for x in TJ._card_reads(k, sd))
    d = TJ._diff_factors(cfg, k, p, sd)
    st = k.dp.st
    lists = K.factor_lists(st, p.singles.shape[1])
    g = {n: lists[n].numpy() for n in ("slot_r", "slot_l", "ws_r", "ws_l")}
    Wp, Tp, ns = cfg.Wp, p.pairs.shape[1], p.singles.shape[1]
    plan = K.factors_plan(cfg.Lp, Wp, st.dims.S, Tp, ns, B, torch.float64)
    got = k14_model(plan, "dp", g, cfg.Lp, Wp, B, seq_.astype(np.int64),
                    ws_, dots_, L_.astype(np.int64), p.singles.numpy(),
                    p.pairs.numpy(), (cfg.no_prf, cfg.theta_softmax,
                                      cfg.no_theta, cfg.fix_rss, cfg.turn,
                                      cfg.max_span, cfg.max_iloop))
    for name in ("eR", "eL", "bg2", "pv"):
        want = getattr(d, name).detach().numpy().ravel()
        np.testing.assert_array_equal(got[name][0], want, err_msg=name)
    np.testing.assert_array_equal(got["seqT"][0], seq_.T.ravel())
    np.testing.assert_array_equal(got["seq64"][0], seq_.ravel())
    np.testing.assert_array_equal(got["wsp"][0], ws_.T.ravel())
    dc = np.concatenate([np.zeros((B, 1)), np.cumsum(dots_, 1)], 1)
    np.testing.assert_array_equal(got["dcum"][0], dc.ravel())
    np.testing.assert_array_equal(got["dcumT"][0], dc.T.ravel())
    gate = np.where(cfg.fix_rss & ~dots_, -np.inf, 0.0)
    np.testing.assert_array_equal(got["gate"][0], gate.T.ravel())


def test_factors_plan_picks_tiles_and_refuses_what_overflows():
    """The main shape (B=128 x 100 nt, -w 50) takes tiles of 4 positions
    at f32 (a group of 32 reads, 16 bytes a thread) and 8 at f64; the
    grid reaches FAC_TARGET_BLOCKS there; a forced tile outside FAC_TILES,
    32-bit overflow and an oversized layout are refused."""
    p32 = K.factors_plan(100, 50, 29, 1, 6, 128, torch.float32)
    assert (p32.V, p32.G, p32.P, p32.groups) == (4, 32, 4, 4)
    assert sum(p32.tiles) * p32.groups >= K.FAC_TARGET_BLOCKS
    assert p32.tiles == (25, 26, 25, 1)
    p64 = K.factors_plan(100, 50, 29, 1, 6, 128, torch.float64)
    assert (p64.V, p64.G, p64.P) == (2, 16, 8)
    assert K.factors_plan(100, 50, 29, 1, 6, 128, torch.float32,
                          aligned=False).V == 1
    with pytest.raises(ValueError, match="tile"):
        K.factors_plan(100, 50, 29, 1, 6, 128, torch.float32, P=64)
    with pytest.raises(ValueError, match="32-bit"):
        K.factors_plan(100, 1000, 29, 10, 6, 2 ** 20, torch.float32)
    with pytest.raises(ValueError, match="no block fits"):
        K.factors_plan(100, 50, 29, 1, 6, 2 ** 25, torch.float32)
    with pytest.raises(ValueError, match="no block fits"):
        K.factors_plan(100, 50, 29, 1, 10 ** 5, 128, torch.float64)


def test_the_factor_grid_matches_its_c_layout():
    """FacGrid (csrc/factors.cu) as ctypes builds it, field by field; a
    plan's grid_args fill it; the launcher and the plan name the same
    threads and tiles."""
    src = (K.CSRC / "factors.cu").read_text()
    body = re.search(r"struct FacGrid \{(.*?)\};", src, re.S).group(1)
    fields = [f.strip() for f in body.replace("int", "").replace(";", "")
              .split(",")]
    assert fields == [f[0] for f in K.FacGrid._fields_]
    K.FacGrid(*K.factors_plan(100, 50, 29, 1, 6, 128,
                              torch.float32).grid_args)
    assert "static const int kFacThreads = %d;" % K.FAC_THREADS in src
