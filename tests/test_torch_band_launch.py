"""Launch limits of the M chain's read-group blocks (K2's and K10's
band_m, K5's m_adj; ops/kernels.band_check): a block holds 8 reads at
f32 or 4 at f64, one thread per (state, read), and a ring of the chain's
inputs in shared memory, sized on the host, so a block the card would
refuse raises before any launch.  It depends on the grammar's S and the
type, never on the span Wp or the batch."""
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
    an M-chain block: shared memory within the 232,448 bytes an H100
    block may take, threads within 1024."""
    states = _states()
    assert len(states) >= 130 and max(S for _, S in states) == 91
    assert min(S for _, S in states) == 1
    for pat, S in states:
        K.band_check(kernel, S, dtype)
        smem = K.band_smem_bytes(kernel, S, dtype)
        assert 0 < smem <= K.SMEM_LIMIT == 232448, (pat, smem)


@pytest.mark.parametrize("kernel,S,dtype,nbytes", [
    ("inside_band", 29, torch.float32, 16704),
    ("inside_band", 91, torch.float64, 46592),
    ("outside_band", 29, torch.float32, 40832),
    ("outside_band", 91, torch.float64, 122304),
])
def test_shared_memory_follows_the_layout(kernel, S, dtype, nbytes):
    """The sizes of csrc/mchain.cuh MLayout: n = S x G cells, two slots
    of the published row (band_m: y; m_adj: the cotangent and the value
    of M(w)) and four ring stages of the step's inputs (band_m: Bt, eL,
    gate_M; m_adj nine) with one 4-byte okM word per cell."""
    assert K.band_smem_bytes(kernel, S, dtype) == nbytes


def _wrapper_args(wrapper, st):
    """Placeholder arguments: the limit is checked before the wrapper
    looks at its tensors."""
    if wrapper == "band_adj":
        return (None, None, 1, None, None, None, st)
    if wrapper == "max_band_m":
        return (None, 1, None, None, type("MaxStatic", (), {"st": st})())
    return (None, 1, None, None, None, st)


@pytest.mark.parametrize("wrapper", ["band_m", "band_adj"])
@pytest.mark.parametrize("span", [50, 400])
def test_the_span_does_not_bound_a_block(wrapper, span):
    """-w as wide as the reads (Wp=400) passes the wrappers' limit for
    S=91 at f64, as -w 50 does: whatever the wrapper then raises on its
    placeholder tensors, it is not the shared-memory limit."""
    cfg = J.ModelConfig(pattern=".....*.....", Lp=span, max_span=span,
                        max_iloop=30, min_bpp=0.0, tau=0.1, dtype="float64")
    st = J.kernels(cfg, "cpu").dp.st
    assert (st.dims.Wp, st.dims.S) == (span, 91)
    with pytest.raises(Exception) as e:
        getattr(K, wrapper)(*_wrapper_args(wrapper, st))
    assert not isinstance(e.value, K.SharedMemoryLimit)


@pytest.mark.parametrize("wrapper,dots,dtype,what", [
    ("band_m", 15, "float32", "1248 threads"),
    ("band_adj", 15, "float32", "1248 threads"),
    ("max_band_m", 15, "float32", "1248 threads"),
    ("band_adj", 18, "float64", "282240 bytes"),
])
def test_a_block_beyond_the_card_raises_in_the_wrapper(wrapper, dots, dtype,
                                                      what):
    """Grammars of 153 states (15 dots) and 210 (18 dots): 8 reads x 153
    states are more threads than a block may take at f32, and K5's ring
    of 4 reads x 210 states at f64 more shared memory than the card
    gives; the wrapper raises before it looks at its tensors."""
    cfg = J.ModelConfig(pattern="." * dots, Lp=40, max_span=30,
                        max_iloop=12, min_bpp=0.0, tau=0.1, dtype=dtype)
    st = J.kernels(cfg, "cpu").dp.st
    assert st.dims.S == {15: 153, 18: 210}[dots]
    with pytest.raises(K.SharedMemoryLimit, match=what):
        getattr(K, wrapper)(*_wrapper_args(wrapper, st))
