"""Per-sequence energy score grids and band masks (PyTorch).

Turns the parsed parameter arrays (params.py) plus encoded sequences into
the [Lp+1, Wp+1] log-score grids the DP consumes, replicating the
reference scoring functions:

* ``hairpin_scores``  <- hairpin_energy (energy_param.hpp:710-742)
* ``stack_scores``    <- loop_energy stack case for TT_P_P
  (energy_model.hpp:350-355)
* ``exterior_scores`` / ``ml2_scores`` / ``mlE_scores`` <- sum_ext_m
  (energy_param.hpp:686-708) with the mlintern/mlclosing combinations of
  energy_model.hpp:371-405
* ``pair_mask_jw`` / ``left_pair_cum`` / ``band_masks`` <- the
  is_parsable band masks (energy_model.hpp:203-218, 289-338).

Every plain function takes ``seq`` as ``[..., Lp]`` (any leading batch
shape, per-read scalars ``L``/``W`` of that leading shape) and returns
``[..., Lp+1, Wp+1]``.  ``score_tables`` is the batched entry point: on a
CUDA tensor it launches the hand-written kernel ``csrc/score_tables.cu``
and on a CPU tensor it runs ``score_tables_plain``; both return the
batch-minor layout ([..., B] trailing) the DP kernels read.

Cell conventions: a (j, w) cell covers the half-open span (i, j) with
i = j - w over bases i..j-1; ``pair(j, w)`` refers to the base pair
(i, j-1).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..alphabet import BP
from . import params as P

MAXLOOP = P.MAXLOOP
NEG = -math.inf

# float tables of device_tables, in the order they are packed for K1
FLOAT_TABLES = (
    "stack", "hairpin", "bulge", "internal", "ninio", "mismatch_h",
    "mismatch_i", "mismatch_1n", "mismatch_23", "mismatch_m", "mismatch_e",
    "dangle5", "dangle3", "int11", "int21", "int22", "tri", "tetra", "hexa",
    "term_au", "mlintern", "mlclosing", "lxc")


def _encode_loopstr(s: str) -> int:
    code = {"A": 1, "C": 2, "G": 3, "U": 4}
    key = 0
    for k, ch in enumerate(s):
        key += code[ch] * (5 ** k)
    return key


@functools.lru_cache(maxsize=8)
def _host_tables(name: str):
    ep = P.load(name)
    tri = np.full(5 ** 5, -np.inf)
    for s, v in ep.triloops.items():
        tri[_encode_loopstr(s)] = v
    tetra = np.full(5 ** 6, -np.inf)
    for s, v in ep.tetraloops.items():
        tetra[_encode_loopstr(s)] = v
    hexa = np.full(5 ** 8, -np.inf)
    for s, v in ep.hexaloops.items():
        hexa[_encode_loopstr(s)] = v
    loops = dict(tri=tri, tetra=tetra, hexa=hexa)
    return {k: loops[k] if k in loops else np.asarray(getattr(ep, k),
                                                      np.float64)
            for k in FLOAT_TABLES}


@functools.lru_cache(maxsize=8)
def _device_tables_cached(name: str, dtype: torch.dtype, device: str):
    host = _host_tables(name)
    tab = {k: torch.as_tensor(v, dtype=dtype, device=device)
           for k, v in host.items()}
    tab["bp"] = torch.as_tensor(BP, dtype=torch.int64, device=device)
    # K1 reads every float table from one buffer at these offsets
    flat = [np.ravel(host[k]) for k in FLOAT_TABLES]
    offs = np.cumsum([0] + [a.size for a in flat])[:-1]
    tab["packed"] = torch.as_tensor(np.concatenate(flat), dtype=dtype,
                                    device=device)
    tab["packed_offsets"] = tuple(int(o) for o in offs)
    return tab


def device_tables(name: str, dtype=torch.float64, device="cpu"):
    """Energy tables as tensors on ``device``: one tensor per table, the
    pair-type matrix ``bp``, and ``packed`` / ``packed_offsets`` (all
    float tables in FLOAT_TABLES order) for the score-table kernel."""
    return _device_tables_cached(name, dtype, str(torch.device(device)))


def _grid(Lp: int, Wp: int, device):
    j = torch.arange(Lp + 1, device=device)[:, None]
    w = torch.arange(Wp + 1, device=device)[None, :]
    return j, w


def _sgather(seq, idx):
    """seq[..., idx] with clipping (masked out-of-range reads give the
    clipped base; callers gate validity separately)."""
    return seq[..., torch.clamp(idx, 0, seq.shape[-1] - 1)]


def _lead(x, nd=2):
    """Per-read scalar [...] -> [..., 1, 1] for broadcasting on the grid."""
    x = torch.as_tensor(x)
    return x.reshape(x.shape + (1,) * nd)


def pair_mask_jw(tab, seq, L, W, Wp: int, turn: int):
    """bp_ok from complementarity + band + hairpin turn
    (energy_model.hpp:211-218): mask[j, w] <=> pair (i=j-w, j-1)
    allowed."""
    Lp = seq.shape[-1]
    j, w = _grid(Lp, Wp, seq.device)
    i = j - w
    wmin = 1 if turn == 0 else turn + 2
    t = tab["bp"][_sgather(seq, i), _sgather(seq, j - 1)]
    L, W = _lead(L).to(seq.device), _lead(W).to(seq.device)
    return (i >= 0) & (w >= wmin) & (j <= L) & (w <= W) & (t > 0)


def left_pair_cum(bp_jw, Lp: int, Wp: int):
    """left_bp_ok (energy_model.hpp:203-209): in (i, w) layout, cumulative
    OR over w; returned in (j, w) layout."""
    j, w = _grid(Lp, Wp, bp_jw.device)
    i = torch.clamp(j - w, 0, Lp)
    rows = torch.arange(Lp + 1, device=bp_jw.device)[:, None]
    iw_rows = torch.clamp(rows + w, 0, Lp)
    bp_iw = bp_jw[..., iw_rows, w] & (rows + w <= Lp)
    cum_iw = torch.cumsum(bp_iw.to(torch.int32), dim=-1) > 0
    return cum_iw[..., i, w] & (j - w >= 0)


def band_masks(bp_ok, L, W, Wp: int, turn: int):
    """okP, okE, okM, okB in (j, w) layout (energy_model.hpp:289-338)."""
    Lp = bp_ok.shape[-2] - 1
    j, w = _grid(Lp, Wp, bp_ok.device)
    i = j - w
    L, W = _lead(L).to(bp_ok.device), _lead(W).to(bp_ok.device)
    # w > 0: the O column reads P at width 0, which must be zero-weighted
    okP = (i >= 0) & (w > 0) & (w <= W) & bp_ok
    # okE: pair (i-1, j) => bp cell (j+1, w+2)
    src = torch.nn.functional.pad(bp_ok, (0, 2, 0, 1))[..., 1:, 2:]
    okE = (i > 0) & (w + 2 <= W) & src
    m_min = 4 if turn == 0 else 2 * (2 + turn)
    okM = (i > 0) & (j < L) & (w <= W) & (w >= m_min)
    okB = (w <= W) & left_pair_cum(bp_ok, Lp, Wp)
    return okP, okE, okM, okB


def hairpin_scores(tab, seq, Wp: int, no_ene: bool):
    """hp[j, w] = hairpin_energy(i-1, j, seq) for the E(i, j) cell:
    closing pair (i-1, j), loop bases i..j-1, d = w."""
    Lp = seq.shape[-1]
    j, w = _grid(Lp, Wp, seq.device)
    i = j - w
    d = w
    t = tab["bp"][_sgather(seq, i - 1), _sgather(seq, j)]
    hpt = tab["hairpin"]
    dt = hpt.dtype
    big = hpt[MAXLOOP] - tab["lxc"] * torch.log(
        torch.clamp(d, min=1).to(dt) / MAXLOOP) * 10.0 / P.KT
    hp_base = torch.where(d <= MAXLOOP, hpt[torch.clamp(d, 0, MAXLOOP)], big)
    zero = torch.zeros((), dtype=dt, device=seq.device)
    au = torch.where(t > 2, tab["term_au"], zero)
    mish = tab["mismatch_h"][t, _sgather(seq, i), _sgather(seq, j - 1)]

    # special loops: window = bases i-1 .. j (d+2 long), little-endian key
    def window_key(nbases):
        key = torch.zeros_like(_sgather(seq, i))
        for k in range(nbases):
            key = key + _sgather(seq, i - 1 + k) * (5 ** k)
        return key

    tri_v = tab["tri"][torch.clamp(window_key(5), 0, 5 ** 5 - 1)]
    tetra_v = tab["tetra"][torch.clamp(window_key(6), 0, 5 ** 6 - 1)]
    hexa_v = tab["hexa"][torch.clamp(window_key(8), 0, 5 ** 8 - 1)]

    z3 = torch.where(torch.isfinite(tri_v), tri_v, hp_base + au)
    z4 = torch.where(torch.isfinite(tetra_v), tetra_v, hp_base + mish)
    z6 = torch.where(torch.isfinite(hexa_v), hexa_v, hp_base + mish)
    zother = torch.where(d > 3, hp_base + mish, hp_base)
    hp = torch.where(d == 3, z3,
                     torch.where(d == 4, z4, torch.where(d == 6, z6,
                                                         zother)))
    hp = torch.where(d < 1, torch.full_like(hp, NEG), hp)
    if no_ene:
        hp = torch.zeros_like(hp)
    return hp


def stack_scores(tab, seq, Wp: int, no_ene: bool):
    """stk[j, w] = loop_energy(i, j-1, i+1, j-2): stack of pair (i, j-1)
    on inner pair (i+1, j-2), used by TT_P_P."""
    Lp = seq.shape[-1]
    j, w = _grid(Lp, Wp, seq.device)
    i = j - w
    t = tab["bp"][_sgather(seq, i), _sgather(seq, j - 1)]
    t2 = tab["bp"][_sgather(seq, j - 2), _sgather(seq, i + 1)]
    stk = tab["stack"][t, t2]
    if no_ene:
        stk = torch.zeros_like(stk)
    return stk


def _sum_ext_m(tab, seq, L, ii, jj, ext: bool):
    """sum_ext_m(ii, jj, ext) for pair (seq[ii], seq[jj]) with dangling
    neighbors seq[ii-1] / seq[jj+1] (energy_param.hpp:686-708)."""
    t = tab["bp"][_sgather(seq, ii), _sgather(seq, jj)]
    five_ok = ii - 1 >= 0
    three_ok = jj + 1 < _lead(L).to(seq.device)
    five = _sgather(seq, ii - 1)
    three = _sgather(seq, jj + 1)
    mm = tab["mismatch_e"] if ext else tab["mismatch_m"]
    both = mm[t, five, three]
    zero = torch.zeros((), dtype=both.dtype, device=seq.device)
    d5 = torch.where(five_ok, tab["dangle5"][t, five], zero)
    d3 = torch.where(three_ok, tab["dangle3"][t, three], zero)
    z = torch.where(five_ok & three_ok, both, d5 + d3)
    return z + torch.where(t > 2, tab["term_au"], zero)


def exterior_scores(tab, seq, L, Wp: int, no_ene: bool):
    """ext[j, w] for TT_O_OP: sum_ext_m(i, j-1, ext=True)."""
    j, w = _grid(seq.shape[-1], Wp, seq.device)
    z = _sum_ext_m(tab, seq, L, j - w, j - 1, True)
    return torch.zeros_like(z) if no_ene else z


def ml2_scores(tab, seq, L, Wp: int, no_ene: bool):
    """ml2[j, w] for TT_2_P: sum_ext_m(i, j-1, False) + mlintern."""
    j, w = _grid(seq.shape[-1], Wp, seq.device)
    z = _sum_ext_m(tab, seq, L, j - w, j - 1, False) + tab["mlintern"]
    return torch.zeros_like(z) if no_ene else z


def mlE_scores(tab, seq, L, Wp: int, no_ene: bool):
    """mlE[j, w] for TT_E_M: sum_ext_m(j, i-1, False) + mlclosing +
    mlintern — the multiloop closing pair seen from inside
    (energy_model.hpp:398-405)."""
    j, w = _grid(seq.shape[-1], Wp, seq.device)
    z = (_sum_ext_m(tab, seq, L, j + 0 * w, j - w - 1, False)
         + tab["mlclosing"] + tab["mlintern"])
    return torch.zeros_like(z) if no_ene else z


def all_dots_mask(dots_cum, Lp: int, Wp: int):
    """[..., Lp+1, Wp+1]: span (i, j) holds only rss '.' marks."""
    j, w = _grid(Lp, Wp, dots_cum.device)
    i = torch.clamp(j - w, 0, Lp)
    return (dots_cum[..., torch.clamp(j, 0, Lp)] - dots_cum[..., i]) == w


# ---- K1: batched score tables (rows A and B of the kernel table) ----

SCORE_KEYS = ("hp", "stk", "ext", "ml2", "mlE", "misA", "misB", "t_out",
              "t_in", "spec_il", "okP", "okE", "okM", "okB")


def score_tables_plain(tab, seq, L, bp_ok, dots_cum, Wp: int, max_span: int,
                       turn: int, no_ene: bool, fix_rss: bool):
    """Plain PyTorch version of the score-table kernel.

    seq [B, Lp] int64, L [B], bp_ok [B, Lp+1, Wp+1] bool, dots_cum
    [B, Lp+1] int.  Returns SCORE_KEYS -> batch-minor tensors:
    [Lp+1, Wp+1, B] grids, [4 | 6, Lp+1, Wp+1, B] for misA/misB/spec_il.
    """
    from ..ops.ep_fast import seq_tables
    Lp = seq.shape[-1]
    dtype = tab["hairpin"].dtype
    W = torch.clamp(L, max=max_span)
    hp = hairpin_scores(tab, seq, Wp, no_ene)
    if fix_rss:
        hp = torch.where(all_dots_mask(dots_cum, Lp, Wp), hp,
                         torch.full_like(hp, NEG))
    out = dict(hp=hp, stk=stack_scores(tab, seq, Wp, no_ene),
               ext=exterior_scores(tab, seq, L, Wp, no_ene),
               ml2=ml2_scores(tab, seq, L, Wp, no_ene),
               mlE=mlE_scores(tab, seq, L, Wp, no_ene))
    out.update(seq_tables(tab, seq, Lp, Wp, no_ene, dtype))
    okP, okE, okM, okB = band_masks(bp_ok, L, W, Wp, turn)
    out.update(okP=okP, okE=okE, okM=okM, okB=okB)
    return {k: torch.movedim(v, 0, -1).contiguous() for k, v in out.items()}


def score_tables(tab, seq, L, bp_ok, dots_cum, Wp: int, max_span: int,
                 turn: int, no_ene: bool, fix_rss: bool):
    """Score tables + band masks for a batch (see score_tables_plain).
    CUDA tensors launch csrc/score_tables.cu; CPU tensors run the plain
    version."""
    if seq.device.type == "cpu":
        return score_tables_plain(tab, seq, L, bp_ok, dots_cum, Wp,
                                  max_span, turn, no_ene, fix_rss)
    from ..ops import kernels as K
    return K.score_tables(tab, seq, L, bp_ok, dots_cum, Wp, max_span, turn,
                          no_ene, fix_rss)
