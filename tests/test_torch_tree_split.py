"""The order of K15's and K17's per-read sums on the CPU.

A read's long sums in K15 (factors_adj) and K17 (hoisted_adj) are cut
over several blocks: block k of K takes the residue class k of K, its
columns the residue classes of its columns, each walked in bit-reversed
order in chunks (csrc/common.cuh tree_walk), then the block halves its
columns (block_tree: the levels across warps after one barrier, the rest
by shuffles) and the group's last block halves the K partials.  The model
below does the same additions in the same order in numpy and must give
ops/dp.read_sum's bits for every split the host plans can pick.  The
plans themselves (ops/kernels.factors_adj_plan, hoisted_adj_plan) must
fit the card's limits.  No GPU is needed."""
import numpy as np
import pytest
import torch

from rnaelem_tpu_torch.ops import dp as DP
from rnaelem_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

SIZES = (1, 2, 3, 5, 8, 9, 31, 100, 101, 4805, 5151, 20604, 65536, 70000)
DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def _brev(q, bits):
    return int(format(q, "0%db" % bits)[::-1], 2) if bits else 0


def tree_walk(f, Q, chunk=K.TREE_CHUNK):
    """common.cuh tree_walk: the values f(q), q < Q, taken in bit-reversed
    order of q, ``chunk`` at a time, each chunk added as a complete
    subtree, the chunks' sums on a stack (arrays: every lane at once)."""
    lq = (Q - 1).bit_length()
    n = min(Q, chunk)
    stack = []
    for m, q0 in enumerate(range(0, Q, n)):
        xs = [f(_brev(q0 + u, lq)) for u in range(n)]
        w = 1
        while w < n:
            for u in range(0, n, 2 * w):
                xs[u] = xs[u] + xs[u + w]
            w *= 2
        x = xs[0]
        while m & 1:
            x = stack.pop() + x
            m >>= 1
        stack.append(x)
    return stack[0]


def block_tree(x, cc, RL, NT):
    """common.cuh block_tree on the columns' sums x [C, reads] of a block
    of NT threads, RL reads a warp's row: the halving over the first cc
    columns, the levels pairing two warps in one step (warp 0 halves its
    columns' values of every warp), then the warp's levels by shuffles
    (lane offset RL h: column c pairs c ^ h)."""
    CW = 32 // RL
    x = list(x)
    if cc > CW:
        nw = cc // CW
        for c in range(CW):
            w8 = [x[c + CW * i] for i in range(nw)]
            h = nw // 2
            while h >= 1:
                for i in range(h):
                    w8[i] = w8[i] + w8[i + h]
                h //= 2
            x[c] = w8[0]
    h = CW // 2
    while h >= 1:
        if h < cc:
            x = [x[c] + x[c ^ h] if c ^ h < len(x) else x[c]
                 for c in range(len(x))]
        h //= 2
    return x[0]


def split_sum(x, K_, RL, NT, cut_finish=False):
    """The kernels' sum over x's first axis (x [n, reads]) cut into K_
    blocks of NT threads (NT / RL columns), as K17's trees and K15's pair
    tables add it: per block its residue class of K_, per column the
    class of the block's columns, then the finish over the K_ partials:
    one walk (K15), or with ``cut_finish`` cut over the columns as a
    block's class is (K17)."""
    n = x.shape[0]
    P = 1 << max(0, n - 1).bit_length()
    Kt = min(K_, P)
    Q = P // Kt
    C = NT // RL
    cc = min(Q, C)
    xp = np.zeros((P,) + x.shape[1:], x.dtype)
    xp[:n] = x
    parts = []
    for k in range(Kt):
        y = xp[k::Kt].reshape(Q // cc, cc, *x.shape[1:])   # [q, c, reads]
        cols = tree_walk(lambda q: y[q], Q // cc)            # [c, reads]
        cols = np.concatenate(
            [cols, np.zeros((C - cc,) + cols.shape[1:], x.dtype)])
        parts.append(block_tree(cols, cc, RL, NT))
    if not cut_finish:
        return tree_walk(lambda q: parts[q], Kt)
    fc = min(Kt, C)
    y = np.stack(parts).reshape(Kt // fc, fc, *x.shape[1:])
    cols = tree_walk(lambda q: y[q], Kt // fc)
    cols = np.concatenate(
        [cols, np.zeros((C - fc,) + cols.shape[1:], x.dtype)])
    return block_tree(cols, fc, RL, NT)


def warp_sum(x, RL):
    """K15's state warps: a warp of RL reads x 32 / RL columns walks a
    read's positions (x [Lp, reads]), then shuffles (no barrier)."""
    n = x.shape[0]
    P = 1 << max(0, n - 1).bit_length()
    CW = 32 // RL
    cc = min(P, CW)
    xp = np.zeros((P,) + x.shape[1:], x.dtype)
    xp[:n] = x
    y = xp.reshape(P // cc, cc, *x.shape[1:])
    cols = tree_walk(lambda q: y[q], P // cc)
    cols = np.concatenate([cols, np.zeros((CW - cc,) + cols.shape[1:],
                                          x.dtype)])
    return block_tree(cols, cc, RL, 32)


def _data(n, dt, seed):
    """Values of mixed sign and scale (so that the order shows in the
    bits), a few exact zeros of either sign, for 3 reads."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 3) * np.exp(rng.uniform(-8, 8, (n, 3)))
    x[rng.rand(n, 3) < 0.05] = 0.0
    x[rng.rand(n, 3) < 0.02] = -0.0
    return x.astype(dt)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


def _read_sum(x):
    return DP.read_sum(torch.from_numpy(x), 1).numpy()


def _rl(kernel, dtype):
    it = torch.empty((), dtype=dtype).element_size()
    return K.ADJ_ROW_BYTES[kernel] // it


@pytest.mark.parametrize("kernel", ["factors_adj", "hoisted_adj"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", SIZES)
def test_split_sum_is_read_sum_bitwise(n, dtype, kernel):
    """Every split 1, 2, ..., ADJ_MAX_SPLIT (all a plan may take) of a
    sum of n values, in blocks of the kernel's shape at this type, then
    the same cut over the split's partials (K17's finish), gives
    read_sum's bits for every read; so does K15's state warp's walk."""
    dt = DTYPES[dtype]
    x = _data(n, dt, n)
    want = _bits(_read_sum(x))
    RL = _rl(kernel, dtype)
    splits = [1 << i for i in range(K.ADJ_MAX_SPLIT.bit_length())]
    for k in splits:
        got = split_sum(x, k, RL, K.ADJ_THREADS, kernel == "hoisted_adj")
        assert np.array_equal(_bits(got), want), (n, k)
    if n <= 512 and kernel == "factors_adj":
        assert np.array_equal(_bits(warp_sum(x, RL)), want)


def test_the_order_shows_in_the_bits():
    """The data is order-sensitive: a plain sequential sum differs from
    read_sum's in some read (so the bitwise checks above test an
    order)."""
    for n in (4805, 20604, 70000):
        x = _data(n, np.float32, n)
        seq = np.zeros(x.shape[1:], np.float32)
        for v in x:
            seq = seq + v
        assert not np.array_equal(_bits(seq), _bits(_read_sum(x)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 128, 1024])
@pytest.mark.parametrize("Lp,Wp,Cp", [(40, 24, 12), (100, 50, 30),
                                      (400, 50, 30), (400, 400, 40)])
def test_adjoint_plans_fit_the_card(Lp, Wp, Cp, B, dtype):
    """K15's and K17's host plans for B reads, Lp <= 400 and up to 4,096
    states: a split among the plan's own (powers of two up to
    ADJ_MAX_SPLIT), a grid within CUDA's limits, K15's shared memory
    within a block's and every workspace within the card's memory; K17
    aims at ADJ_TARGET_BLOCKS blocks; a forced split off the list
    raises."""
    it = torch.empty((), dtype=dtype).element_size()
    n_m = 4 * (Lp + 1) * (Wp + 1)
    h = K.hoisted_adj_plan(Lp, Wp, Cp, 5, B, dtype)
    RL = K.ADJ_ROW_BYTES["hoisted_adj"] // it
    assert h.RL == RL and h.groups == -(-B // RL)
    assert h.K in h.splits() and h.splits()[-1] == h.k_max
    assert h.k_max <= K.ADJ_MAX_SPLIT
    assert h.K == h.k_max or h.groups * h.K >= K.ADJ_TARGET_BLOCKS
    assert h.K == 1 or h.groups * h.K // 2 < K.ADJ_TARGET_BLOCKS
    assert h.groups < 2 ** 31 and h.grid_y == h.K <= K.MAX_GRID_Y
    assert h.ws_elems == 6 * h.K * B
    assert n_m < 2 ** 31
    RL = K.ADJ_ROW_BYTES["factors_adj"] // it
    for S in (1, 29, 1081, 1378, 4096):
        for Tp in (0, 1, 3):
            f = K.factors_adj_plan(S, Lp, Wp, Tp, B, dtype)
            assert f.K in f.splits() and f.k_max <= K.ADJ_MAX_SPLIT
            assert f.groups == -(-B // RL) and f.groups < 2 ** 31
            assert f.grid_y == -(-(S + 1) // K.ADJ_WARPS) + Tp * f.K
            assert f.grid_y <= K.MAX_GRID_Y
            assert f.smem == 6 * K.ADJ_THREADS * it + 4 * RL * Lp
            assert f.smem <= K.SMEM_LIMIT
            assert f.ws_elems == ((S + 1) * 8 + Tp * f.K * 6) * B
            assert f.ws_elems * it < 80e9
            for k in f.splits():
                assert K.factors_adj_plan(S, Lp, Wp, Tp, B, dtype, k).K == k
    for bad in (0, 3, 2 * K.ADJ_MAX_SPLIT):
        with pytest.raises(ValueError, match="split"):
            K.hoisted_adj_plan(Lp, Wp, Cp, 5, B, dtype, bad)
        with pytest.raises(ValueError, match="split"):
            K.factors_adj_plan(29, Lp, Wp, 1, B, dtype, bad)


def test_main_path_plans():
    """At the main path's shapes ((.....), 128 x 100 nt, -w 50, -c 30,
    f32) K17 takes 512 blocks (4 groups of 32 reads x 128 slices) and
    K15 12 blocks a group of 8 reads (4 of the 30 state warps, 8 pair
    slices)."""
    h = K.hoisted_adj_plan(100, 50, 30, 5, 128, torch.float32)
    assert (h.groups, h.K) == (4, 128)
    f = K.factors_adj_plan(29, 100, 50, 1, 128, torch.float32)
    assert (f.groups, f.grid_y, f.K) == (16, 12, 8)


def test_factors_adj_plan_refuses_what_does_not_fit():
    """Codes past a block's shared memory raise, naming the limit."""
    with pytest.raises(ValueError, match="shared"):
        K.factors_adj_plan(29, 8000, 50, 1, 128, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_a_forced_split_changes_only_the_split(dtype):
    """The plan owns the launch layout (the launchers take it): a forced
    split moves K, K15's pair blocks and the workspace, and keeps the row
    of reads, the groups and the shared memory."""
    h = K.hoisted_adj_plan(100, 50, 30, 5, 128, dtype)
    for k in h.splits():
        g = K.hoisted_adj_plan(100, 50, 30, 5, 128, dtype, k)
        assert g._replace(K=h.K, grid_y=h.grid_y, ws_elems=h.ws_elems) == h
        assert (g.K, g.grid_y, g.ws_elems, g.name) == (k, k, 6 * k * 128,
                                                       "K=%d" % k)
    f = K.factors_adj_plan(29, 100, 50, 1, 128, dtype)
    n_sc = -(-30 // K.ADJ_WARPS)
    for k in f.splits():
        g = K.factors_adj_plan(29, 100, 50, 1, 128, dtype, k)
        assert g._replace(K=f.K, grid_y=f.grid_y, ws_elems=f.ws_elems) == f
        assert (g.K, g.grid_y, g.name) == (k, n_sc + k, "K=%d" % k)
        assert g.ws_elems == (30 * 8 + k * 6) * 128


def test_slot_states_list_each_slots_states_in_order():
    """K15's finish lists (kernels.slot_states): for every slot the states
    whose right (left) node takes it, ascending."""
    from rnaelem_tpu_torch.model import joint as TJ
    for pattern in ("(.....)", ".(..*).", "." * 12):
        cfg = TJ.ModelConfig(pattern=pattern, Lp=24, max_span=12,
                             max_iloop=6, min_bpp=0.0, tau=0.1,
                             dtype="float64")
        k = TJ.kernels(cfg, "cpu")
        ns = int((k.g.single_table_index >= 0).sum())
        lists = K.factor_lists(k.dp.st, ns)
        csr = K.slot_states(k.dp.st, ns)
        for key, slot in (("rs", "slot_r"), ("ls", "slot_l")):
            off, st_ = csr[key + "_off"].tolist(), csr[key + "_s"].tolist()
            sl = lists[slot].tolist()
            assert len(off) == ns + 1 and off[-1] == len(sl)
            for u in range(ns):
                assert st_[off[u]:off[u + 1]] == [
                    s for s in range(len(sl)) if sl[s] == u]
