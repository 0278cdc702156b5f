"""Launch plans of the M chain's read-group blocks (K2's and K10's
band_m, K5's m_adj; ops/kernels.band_plan): a block holds G reads (8 at
f32 or 4 at f64 where they fit, else 4, 2 or 1), one thread per (state,
read), and a ring of the chain's inputs in shared memory, sized on the
host, so the plan picks a block the card takes before any launch.  It
depends on the grammar's S and the type, never on the span Wp or the
batch."""
import os

import pytest
import torch

from rnaelem_tpu_torch.grammar.profile import compile_pattern, null_grammar
from rnaelem_tpu_torch.model import joint as J
from rnaelem_tpu_torch.ops import kernels as K

PATTERNS = os.path.join(os.path.dirname(__file__), "fixtures",
                        "pattern_list")
KERNELS = ("inside_band", "outside_band")


def _states():
    """(pattern, S) of every parseable pattern of the list, and the
    masks' null grammar (S=1)."""
    out = []
    with open(PATTERNS) as f:
        for line in f:
            pat = line.strip()
            if not pat:
                continue
            try:
                out.append((pat, compile_pattern(pat).S))
            except ValueError:
                continue
    out.append(("null", null_grammar().S))
    return out


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_every_pattern_fits_a_block(kernel, dtype):
    """Every grammar of the pattern list (S up to 91) and the masks' fit
    an M-chain block of 32 bytes' worth of reads (8 f32, 4 f64) with a
    ring of 4 stages: shared memory within the 232,448 bytes an H100
    block may take, threads within 1024."""
    states = _states()
    assert len(states) >= 130 and max(S for _, S in states) == 91
    assert min(S for _, S in states) == 1
    G = 32 // torch.empty((), dtype=dtype).element_size()
    for pat, S in states:
        plan = K.band_plan(kernel, S, dtype)
        smem = K.band_smem_bytes(kernel, S, dtype, G)
        assert 0 < smem <= K.SMEM_LIMIT == 232448, (pat, smem)
        assert plan == K.BandPlan(kernel, G, 4, -(-S * G // 32) * 32,
                                  smem), pat


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_every_wide_grammar_has_a_plan(kernel, dtype):
    """Every all-dot pattern of 1 to 16 dots (S up to 171), `.....*.....`
    and the list's patterns, and S = 300, 691, 1024: the plan takes the
    largest group of reads (8 f32, 4 f64, then 4, 2, 1) whose S x G
    threads are at most 1024 and whose layout fits a block, with a ring
    of 4 stages, or of 2 at G = 1 where 4 does not fit; it never
    raises."""
    it = torch.empty((), dtype=dtype).element_size()
    states = _states() + [("." * n, compile_pattern("." * n).S)
                          for n in range(1, 17)]
    states += [(".....*.....", 91), ("300", 300), ("691", 691),
               ("1024", 1024)]
    assert max(S for _, S in states[:-3]) == 171
    for pat, S in states:
        plan = K.band_plan(kernel, S, dtype)
        assert plan.threads == -(-S * plan.G // 32) * 32 <= K.MAX_THREADS
        assert plan.smem == K.band_smem_bytes(kernel, S, dtype, plan.G,
                                              plan.R) <= K.SMEM_LIMIT
        bigger = [g for g in (8, 4, 2) if plan.G < g and g * it <= 32]
        for g in bigger:   # no larger group fits
            assert S * g > K.MAX_THREADS or K.band_smem_bytes(
                kernel, S, dtype, g) > K.SMEM_LIMIT, (pat, g)
        if plan.R != 4:
            assert plan.G == 1 and plan.R == 2 and K.band_smem_bytes(
                kernel, S, dtype, 1, 4) > K.SMEM_LIMIT
    assert K.band_plan("outside_band", 1024, torch.float64).R == 2


@pytest.mark.parametrize("kernel,S,dtype,nbytes", [
    ("inside_band", 29, torch.float32, 18560),
    ("inside_band", 91, torch.float64, 52416),
    ("outside_band", 29, torch.float32, 40832),
    ("outside_band", 91, torch.float64, 122304),
])
def test_shared_memory_follows_the_layout(kernel, S, dtype, nbytes):
    """The sizes of csrc/mchain.cuh MLayout: n = S x G cells, two slots
    of the published row (band_m: M(w-1) and eL; m_adj: the cotangent
    and the value of M(w)) and four ring stages of the step's inputs
    (band_m: Bt, eL, gate_M; m_adj nine) with one 4-byte okM word per
    cell."""
    G = 32 // torch.empty((), dtype=dtype).element_size()
    assert K.band_smem_bytes(kernel, S, dtype, G) == nbytes
    assert K.band_plan(kernel, S, dtype).smem == nbytes


def test_a_forced_group_is_checked():
    """The plan's keywords force G (and R at G = 1): a group the type
    does not take, or a block that does not fit, raises ValueError."""
    assert K.band_plan("outside_band", 91, torch.float32, G=2) == \
        K.BandPlan("outside_band", 2, 4, 192, K.band_smem_bytes(
            "outside_band", 91, torch.float32, 2))
    assert K.band_plan("inside_band", 29, torch.float64, G=1, R=2).R == 2
    with pytest.raises(ValueError, match="not one of"):
        K.band_plan("inside_band", 29, torch.float64, G=8)
    with pytest.raises(ValueError, match="not one of"):
        K.band_plan("inside_band", 29, torch.float32, G=4, R=2)
    with pytest.raises(ValueError, match="no M-chain block"):
        K.band_plan("inside_band", 171, torch.float32, G=8)


def _wrapper_args(wrapper, st):
    """Placeholder arguments: the plan is made before the wrapper looks
    at its tensors."""
    if wrapper == "band_adj":
        return (None, None, 1, None, None, None, st)
    if wrapper == "max_band_m":
        return (None, 1, None, None, type("MaxStatic", (), {"st": st})())
    return (None, 1, None, None, None, st)


def _planned(monkeypatch, wrapper, st):
    """The plan the wrapper makes (recorded from band_plan), and the
    error it then raises on its placeholder tensors."""
    seen = []
    plan = K.band_plan

    def spy(*args, **kw):
        seen.append(plan(*args, **kw))
        return seen[-1]

    monkeypatch.setattr(K, "band_plan", spy)
    with pytest.raises(Exception) as e:
        getattr(K, wrapper)(*_wrapper_args(wrapper, st))
    assert len(seen) == 1
    return seen[0], e.value


@pytest.mark.parametrize("wrapper", ["band_m", "band_adj"])
@pytest.mark.parametrize("span", [50, 400])
def test_the_span_does_not_bound_a_block(monkeypatch, wrapper, span):
    """-w as wide as the reads (Wp=400) gets the plan -w 50 gets for S=91
    at f64 (4 reads, a ring of 4); the wrapper then fails on its
    placeholder tensors, not on the plan."""
    cfg = J.ModelConfig(pattern=".....*.....", Lp=span, max_span=span,
                        max_iloop=30, min_bpp=0.0, tau=0.1, dtype="float64")
    st = J.kernels(cfg, "cpu").dp.st
    assert (st.dims.Wp, st.dims.S) == (span, 91)
    plan, err = _planned(monkeypatch, wrapper, st)
    assert (plan.G, plan.R) == (4, 4)
    assert not isinstance(err, ValueError)


@pytest.mark.parametrize("wrapper,dots,dtype,what", [
    ("band_m", 15, "float32", (4, 4)),
    ("band_adj", 15, "float32", (4, 4)),
    ("max_band_m", 15, "float32", (4, 4)),
    ("band_adj", 18, "float64", (2, 4)),
])
def test_a_block_beyond_the_card_raises_in_the_wrapper(monkeypatch, wrapper,
                                                      dots, dtype, what):
    """Grammars of 153 states (15 dots) and 210 (18 dots): 8 reads x 153
    states are more threads than a block may take at f32, and K5's ring
    of 4 reads x 210 states at f64 more shared memory than the card
    gives; the wrapper plans smaller groups (4 reads, 2 reads) before it
    looks at its tensors, and what it then raises on its placeholders is
    not a refusal of the grammar."""
    cfg = J.ModelConfig(pattern="." * dots, Lp=40, max_span=30,
                        max_iloop=12, min_bpp=0.0, tau=0.1, dtype=dtype)
    st = J.kernels(cfg, "cpu").dp.st
    assert st.dims.S == {15: 153, 18: 210}[dots]
    plan, err = _planned(monkeypatch, wrapper, st)
    assert (plan.G, plan.R) == what
    assert not isinstance(err, ValueError)
