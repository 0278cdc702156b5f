"""K16's and K1's launch plans and K1's per-diagonal walk on the CPU.

K16 (csrc/hoisted.cu) takes its coordinates from the grid: the rows of
its outputs (each B values long) in three ranges of row blocks, the reads
along the threads, V of them a thread.  The model below forms the
offsets as the kernel does from ops/kernels.hoisted_plan and must write
every element of eSZ, eSZg, emisA and emisB exactly once.

K1 (csrc/score_tables.cu) stages, per block of J diagonals i = j - w and
G reads, the codes its cells read, bp_ok's cells of its diagonals and the
one before, and dots_cum; left_pair_cum along a diagonal is its first
pair.  The models below mirror the staging and the cells' reads: the
masks must equal energy.tables.band_masks (and JAX's left_pair_cum), and
every position and cell a cell formula reads must lie in the staged
window (ops/kernels.ScorePlan.window).  No GPU is needed."""
import re

import numpy as np
import pytest
import torch

from rnaelem_tpu.energy import tables as JT
from rnaelem_tpu_torch.energy import tables as ET
from rnaelem_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

DTYPES = (torch.float32, torch.float64)


# ------------------------------------------------------------------ K16

def hoisted_rows(plan, Lp, Wp, Cp):
    """The rows (row index inside each output's row space) the kernel's
    row blocks x threadIdx.y write, by range: eSZ/eSZg's (dl, u1) rows
    dl * C1 + u1, emisA's rows, emisB's rows q = (row, w) (4 rows of its
    groups each)."""
    C1, W1, Lp1, PAD = Cp + 1, Wp + 1, Lp + 1, Wp + 1
    ty = np.arange(plan.TY)
    nb1, nb2, nb3 = plan.blocks
    rb = np.arange(nb1)[:, None]
    dl = rb // plan.nub
    u1 = (rb - dl * plan.nub) * plan.TY + ty[None]
    dl = np.broadcast_to(dl, u1.shape)
    r1 = (dl * C1 + u1)[u1 < C1]
    r2 = (np.arange(nb2)[:, None] * plan.TY + ty[None]).ravel()
    r2 = r2[r2 < 4 * Lp1 * W1]
    r3 = (np.arange(nb3)[:, None] * plan.TY + ty[None]).ravel()
    r3 = r3[r3 < (Lp1 + PAD) * W1]
    return r1, r2, r3


def hoisted_reads(plan, B):
    """The reads the threads (blockIdx.y, threadIdx.x) write in a row:
    V from b0 = (y TX + x) V, threads with b0 >= B idle."""
    b0 = ((np.arange(plan.groups)[:, None] * plan.TX
           + np.arange(plan.TX)[None]) * plan.V).ravel()
    b0 = b0[b0 < B]
    return (b0[:, None] + np.arange(plan.V)[None]).ravel()


def _once(idx, n):
    """Every index of range(n) exactly once in ``idx``."""
    idx = np.asarray(idx, np.int64).ravel()
    return idx.min() >= 0 and idx.max() < n and np.array_equal(
        np.bincount(idx, minlength=n), np.ones(n, np.int64))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 2, 3, 7, 128, 600])
@pytest.mark.parametrize("Lp", [20, 100, 400])
def test_hoisted_plan_writes_every_element_once(Lp, B, dtype):
    """For Cp in 4, 30, 40 (Wp = min(Lp, 50)): the reads of a row are
    0..B-1 once each (the vector path's V reads whole: B a multiple of V,
    every row 16-byte aligned), every range's rows once each, so every
    element of the four outputs is written once; where the outputs are
    small, by their element offsets as the kernel forms them."""
    Wp = min(Lp, 50)
    it = torch.empty((), dtype=dtype).element_size()
    for Cp in (4, 30, 40):
        for aligned in (True, False):
            plan = K.hoisted_plan(Lp, Wp, Cp, B, dtype, aligned)
            assert plan.TX * plan.TY == K.HOIST_THREADS
            assert plan.V == (16 // it if aligned and B % (16 // it) == 0
                              else 1)
            if plan.V > 1:
                assert (B * it) % 16 == 0
            reads = hoisted_reads(plan, B)
            assert _once(reads, B)
            C1, W1, Lp1, PAD = Cp + 1, Wp + 1, Lp + 1, Wp + 1
            r1, r2, r3 = hoisted_rows(plan, Lp, Wp, Cp)
            assert _once(r1, C1 * C1)
            assert _once(r2, 4 * Lp1 * W1)
            assert _once(r3, (Lp1 + PAD) * W1)
            assert plan.grid == (sum(plan.blocks), plan.groups)
            n_cls = 3
            if 2 * (Lp1 + PAD) * W1 * 4 * B > 4_000_000:
                continue
            # element offsets, as the kernel forms them
            rows = lambda r: (r[:, None] * B + reads[None]).ravel()
            c2B = C1 * C1 * B
            eSZ = np.concatenate([(bu * n_cls + x) * c2B + rows(r1)
                                  for bu in range(2) for x in range(n_cls)])
            eSZg = np.concatenate([(bu * 4 + k) * c2B + rows(r1)
                                   for bu in range(2) for k in range(4)])
            emisA = np.concatenate([bu * 4 * Lp1 * W1 * B + rows(r2)
                                    for bu in range(2)])
            nq = (Lp1 + PAD) * W1
            emisB = np.concatenate([bu * nq * 4 * B + rows(r3 * 4 + k)
                                    for bu in range(2) for k in range(4)])
            assert _once(eSZ, 2 * n_cls * c2B)
            assert _once(eSZg, 2 * 4 * c2B)
            assert _once(emisA, 2 * 4 * Lp1 * W1 * B)
            assert _once(emisB, 2 * nq * 4 * B)


def test_hoisted_plan_refuses_what_overflows():
    """A batch whose block offsets or grid pass 32 bits is refused."""
    with pytest.raises(ValueError, match="32-bit"):
        K.hoisted_plan(100, 50, 30, 2 ** 28, torch.float32)
    K.hoisted_plan(100, 50, 30, 2 ** 20, torch.float32)


# ------------------------------------------------------------------- K1

def k1_plan(Lp, Wp, B, J=None):
    """score_plan's plan, or with J diagonals a block forced."""
    plan = K.score_plan(Lp, Wp, B, torch.float32)
    if J is None:
        return plan
    return plan._replace(J=J, bands=-(-(Lp + Wp + 1) // J),
                         smem=K.score_smem_bytes(Wp, plan.G, J))


def k1_masks(plan, bp, L, max_span, turn):
    """okP, okE, okM, okB [Lp+1, Wp+1, B] as K1 forms them: per block of
    diagonals, bp_ok's cells of diagonals i0 - 1 .. i0 + J - 1 staged by
    rows (a pair on a block diagonal lowering its first pair), then each
    cell's masks from the staged cells and the first pair."""
    B, Lp1, W1 = bp.shape
    Lp, Wp, J = Lp1 - 1, W1 - 1, plan.J
    W = np.minimum(L, max_span)
    m_min = 4 if turn == 0 else 2 * (2 + turn)
    out = {k: np.zeros((Lp1, W1, B), bool)
           for k in ("okP", "okE", "okM", "okB")}
    seen = np.zeros((Lp1, W1), np.int64)
    for band in range(plan.bands):
        i0 = plan.window(band)["i0"]
        s_bp = np.zeros((J + 1, W1, B), bool)
        first = np.full((J, B), W1)
        for rr in range(J + Wp + 1):
            r = i0 - 1 + rr
            for o in range(J + 1):
                w = rr - o
                if w < 0 or w > Wp:
                    continue
                v = bp[:, r, w] if 0 <= r <= Lp else np.zeros(B, bool)
                s_bp[o, w] = v
                if o > 0:
                    first[o - 1] = np.where(v, np.minimum(first[o - 1], w),
                                            first[o - 1])
        for o in range(J):
            for w in range(W1):
                i = i0 + o
                j = i + w
                if j < 0 or j > Lp:
                    continue
                seen[j, w] += 1
                out["okP"][j, w] = (i >= 0) & (w > 0) & (w <= W) & \
                    s_bp[o + 1, w]
                src = (j + 1 <= Lp) and (w + 2 <= Wp) and s_bp[o, w + 2]
                out["okE"][j, w] = (i > 0) & (w + 2 <= W) & src
                out["okM"][j, w] = (i > 0) & (j < L) & (w <= W) & \
                    (w >= m_min)
                out["okB"][j, w] = (w <= W) & (i >= 0) & (first[o] <= w)
    assert (seen == 1).all()  # every cell in exactly one block
    return out


@pytest.mark.parametrize("Lp,Wp,density,turn", [
    (16, 16, 0.15, 3), (16, 1, 0.5, 3), (40, 24, 0.02, 3), (40, 24, 0.15, 0),
    (40, 24, 0.5, 3), (40, 8, 0.15, 3), (40, 40, 0.05, 0), (33, 20, 0.3, 3)])
@pytest.mark.parametrize("J", [None, 3, 1])
def test_k1_masks_from_the_diagonals_match_band_masks(Lp, Wp, density, turn,
                                                      J):
    """The model of K1's masks (the running OR of left_pair_cum as each
    diagonal's first pair, okP and okE from the staged diagonals) equals
    energy.tables.band_masks on random bp_ok and lengths (reads shorter
    than Lp, and of length Lp), and okB equals JAX's left_pair_cum."""
    rng = np.random.RandomState(Lp * 100 + Wp + int(density * 1000) + turn)
    B = 5
    bp = rng.rand(B, Lp + 1, Wp + 1) < density
    L = rng.randint(1, Lp + 1, B)
    L[0] = Lp
    max_span = min(Wp, 30)
    plan = k1_plan(Lp, Wp, B, J)
    got = k1_masks(plan, bp, L, max_span, turn)
    W = np.minimum(L, max_span)
    want = ET.band_masks(torch.as_tensor(bp), torch.as_tensor(L),
                         torch.as_tensor(W), Wp, turn)
    for k_, t in zip(("okP", "okE", "okM", "okB"), want):
        np.testing.assert_array_equal(got[k_], np.moveaxis(t.numpy(), 0, -1),
                                      err_msg=k_)
    for b in range(B):
        lbp = np.asarray(JT.left_pair_cum(bp[b], Lp, Wp))
        w = np.arange(Wp + 1)[None, :]
        np.testing.assert_array_equal(got["okB"][..., b], (w <= W[b]) & lbp)


def cell_reads(i, j, w, Lp, Wp):
    """The sequence positions a cell's formulas read, before sg()'s clamp
    (score_tables.cu: hairpin and its loop keys, stack, the two
    sum_ext_m, misA, misB, tin_at's six cells and the specials), the
    dots_cum entries under fix_rss, and the bp_ok cells (row, w)."""
    seq = [i - 1, j, i, j - 1]                        # hairpin pair, mish
    n_key = {3: 5, 4: 6, 6: 8}.get(w, 0)
    seq += [i - 1 + k for k in range(n_key)]          # the loop key
    seq += [i, j - 1, j - 2, i + 1]                   # stack
    seq += [i, j - 1, i - 1, j]                       # sum_ext_m(i, j-1)
    seq += [j, i - 1, j - 1, i]                       # sum_ext_m(j, i-1)
    seq += [i - 1, j, i, j - 1, j - 1, j - w, j, j - w - 1]  # misA, misB
    for joff, woff in ((1, 1), (0, 1), (1, 2), (2, 3), (1, 3), (2, 4)):
        jj = min(max(j - joff, 0), Lp)
        ww = min(max(w - woff, 0), Wp)
        seq += [jj - 1, jj - ww]
    seq += [i + 1, j - 2]
    dots = [j, max(i, 0)]
    bp = [(j, w)]
    if j + 1 <= Lp and w + 2 <= Wp:
        bp.append((j + 1, w + 2))
    if i >= 0:
        bp += [(i + v, v) for v in range(w + 1)]
    return seq, dots, bp


@pytest.mark.parametrize("Lp,Wp", [(16, 16), (16, 1), (20, 2), (40, 24),
                                   (48, 48), (100, 50)])
@pytest.mark.parametrize("J", [None, 3, 1])
def test_score_plan_window_holds_what_the_cells_read(Lp, Wp, J):
    """Every position a block's cells read (clamped to 0..Lp-1 as sg()
    clamps it) lies in its staged codes lo..hi, every dots_cum entry in
    dlo..dhi, every bp_ok cell on a staged diagonal i0 - 1 .. i0 + J - 1
    inside the table, and the windows fit the shared layout (J + Wp + 4
    codes, J + Wp dots_cum entries a read)."""
    plan = k1_plan(Lp, Wp, 3, J)
    for band in range(plan.bands):
        win = plan.window(band)
        i0, lo, hi = win["i0"], win["lo"], win["hi"]
        assert hi - lo + 1 <= plan.J + Wp + 4
        assert win["dhi"] - win["dlo"] + 1 <= plan.J + Wp
        for o in range(plan.J):
            for w in range(Wp + 1):
                i = i0 + o
                j = i + w
                if j < 0 or j > Lp:
                    continue
                seq, dots, bp = cell_reads(i, j, w, Lp, Wp)
                for x in seq:
                    assert lo <= min(max(x, 0), Lp - 1) <= hi, (band, o, w, x)
                for x in dots:
                    assert win["dlo"] <= x <= win["dhi"], (band, o, w, x)
                for r, v in bp:
                    assert 0 <= r <= Lp and 0 <= v <= Wp
                    assert i0 - 1 <= r - v <= i0 + plan.J - 1, (band, r, v)


@pytest.mark.parametrize("dtype", DTYPES)
def test_score_plan_fits_every_band_the_cli_admits(dtype):
    """Lp is a multiple of 16 and Wp = min(Lp, -w): K1's shared bytes fit
    SMEM_LIMIT for every such pair up to the eCLIP scale of 400 nt and
    -w up to Lp, and beyond, down to one read and one diagonal a block
    for bands of 16,384; its grid fits the card's."""
    spans = (1, 10, 30, 50, 100, 200, 400)
    for Lp in range(16, 401, 16):
        for span in spans:
            Wp = min(Lp, span)
            for B in (1, 7, 128, 600):
                plan = K.score_plan(Lp, Wp, B, dtype)
                assert plan.smem == K.score_smem_bytes(Wp, plan.G, plan.J)
                assert plan.smem <= K.SMEM_LIMIT
                assert plan.groups * plan.G >= B
                assert plan.bands * plan.J >= Lp + Wp + 1
                assert plan.G & (plan.G - 1) == 0 and plan.J in \
                    K.SCORE_DIAGONALS
    it = torch.empty((), dtype=dtype).element_size()
    main = K.score_plan(100, 50, 128, dtype)
    assert (main.G, main.J) == (128 // it, 1)
    wide = K.score_plan(16384, 16384, 7, dtype)
    assert wide.smem <= K.SMEM_LIMIT
    with pytest.raises(ValueError, match="no block fits"):
        K.score_plan(40000, 40000, 7, dtype)


@pytest.mark.parametrize("src,cname,py", [
    ("hoisted.cu", "HoistGrid", "HoistGrid"),
    ("score_tables.cu", "ScoreGrid", "ScoreGrid")])
def test_the_plans_reach_the_kernels_field_by_field(src, cname, py):
    """The plans' ctypes structs (HoistPlan.grid_args, ScorePlan.grid_args)
    name the C structs' fields in their order, one int each."""
    text = (K.CSRC / src).read_text()
    body = re.search(r"struct %s \{(.*?)\};" % cname, text, re.S).group(1)
    fields = [f.strip() for f in body.replace("int", "").replace(";", "")
              .split(",")]
    assert fields == [f[0] for f in getattr(K, py)._fields_]
    plan = K.hoisted_plan(100, 50, 30, 128, torch.float32) if \
        py == "HoistGrid" else K.score_plan(100, 50, 128, torch.float32)
    assert len(plan.grid_args) == len(fields)
    getattr(K, py)(*plan.grid_args)
