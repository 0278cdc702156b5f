"""Launch limits of the fused internal-loop kernels K3, K6 and K11
(ops/kernels.ep_check): the shared memory a block takes is sized on the
host, so a block the card would refuse raises before any launch.  It
depends on the grammar (S, n_ar), the max internal loop Cp and the type,
never on the span Wp."""
import os

import pytest
import torch

from rnaelem_tpu_torch import cli
from rnaelem_tpu_torch.grammar.profile import compile_pattern, null_grammar
from rnaelem_tpu_torch.model import joint as J
from rnaelem_tpu_torch.ops import dp as DP
from rnaelem_tpu_torch.ops import dp_maxb as DMB
from rnaelem_tpu_torch.ops import kernels as K

PATTERNS = os.path.join(os.path.dirname(__file__), "fixtures",
                        "pattern_list")


def _grammars():
    """(pattern, S, n_ar) of every parseable pattern of the list, and the
    masks' null grammar (S=1)."""
    out = []
    with open(PATTERNS) as f:
        for line in f:
            pat = line.strip()
            if not pat:
                continue
            try:
                g = compile_pattern(pat)
            except ValueError:
                continue
            out.append((pat, g.S, len(DP.chain_lists(g)[1])))
    g = null_grammar()
    out.append(("null", g.S, len(DP.chain_lists(g)[1])))
    return out


@pytest.mark.parametrize("kernel", ["inside_ep", "outside_ep",
                                    "inside_ep_max"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_every_pattern_fits_a_block(kernel, dtype):
    """At the default max internal loop (Cp=30) and up to Cp=32 a block
    of one read fits in the 232,448 bytes of shared memory an H100 block
    may take, for every grammar of the pattern list (S up to 91) and the
    masks'."""
    gs = _grammars()
    assert len(gs) >= 130 and max(S for _, S, _ in gs) == 91
    for Cp in (30, 32):
        for pat, S, n_ar in gs:
            K.ep_check(kernel, S, n_ar, Cp, dtype)
            smem = K.ep_smem_bytes(kernel, S, n_ar, Cp, dtype)
            assert smem <= K.SMEM_LIMIT == 232448, (pat, Cp, smem)


def test_the_first_max_internal_loop_a_pattern_exceeds_is_33():
    """K6 at f64 binds: `.....*.....` (S = n_ar = 91) takes 228,456
    bytes at Cp=32 and more than a block may take at Cp=33; the message
    names the -c that fits."""
    assert K.ep_smem_bytes("outside_ep", 91, 91, 32, torch.float64) \
        == 228456
    with pytest.raises(K.SharedMemoryLimit,
                       match="max-internal-loop 32 fits"):
        K.ep_check("outside_ep", 91, 91, 33, torch.float64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_cyk_kernel_fits_wherever_the_adjoint_fits(dtype):
    """The scan runs K6 (the posteriors' outside pass) before K11 (the
    CYK tables): for every grammar of the list and the masks', at every
    max internal loop K6 accepts, K11 accepts too; past the -c where K11
    stops fitting it raises SharedMemoryLimit naming the largest -c that
    fits."""
    for pat, S, n_ar in _grammars():
        fit = None
        for Cp in range(1, 1000):
            k6 = K.ep_smem_bytes("outside_ep", S, n_ar, Cp, dtype)
            k11 = K.ep_smem_bytes("inside_ep_max", S, n_ar, Cp, dtype)
            if k6 <= K.SMEM_LIMIT:
                assert k11 <= K.SMEM_LIMIT, (pat, Cp, k6, k11)
            if k11 > K.SMEM_LIMIT:
                fit = Cp - 1
                break
            K.ep_check("inside_ep_max", S, n_ar, Cp, dtype)
        assert fit is not None and fit >= 32, (pat, fit)
        with pytest.raises(K.SharedMemoryLimit,
                           match="max-internal-loop %d fits" % fit):
            K.ep_check("inside_ep_max", S, n_ar, fit + 1, dtype)


def test_the_cyk_block_layout_at_the_widest_pattern():
    """K11 at f64 for `.....*.....` (S = n_ar = 91): 229,544 bytes at
    Cp=32, the widest -c K6 takes there; 236,768 at Cp=33, beyond a
    block."""
    assert K.ep_smem_bytes("inside_ep_max", 91, 91, 32, torch.float64) \
        == 229544
    assert K.ep_smem_bytes("inside_ep_max", 91, 91, 33, torch.float64) \
        > K.SMEM_LIMIT
    with pytest.raises(K.SharedMemoryLimit,
                       match="max-internal-loop 32 fits"):
        K.ep_check("inside_ep_max", 91, 91, 33, torch.float64)


def test_the_cyk_block_holds_a_thread_per_state():
    """K11's block of 256 threads gives each target state and each AR
    pair a thread: a grammar with more raises before any launch."""
    K.ep_check("inside_ep_max", 256, 256, 2, torch.float32)
    with pytest.raises(K.SharedMemoryLimit, match="too many states"):
        K.ep_check("inside_ep_max", 257, 100, 2, torch.float32)


def _wrapper_args(wrapper, st):
    """Placeholder arguments: the limit is checked before the wrapper
    looks at its tensors."""
    if wrapper == "max_ep_stage":
        return (None, 1, None, None, DMB.MaxStatic.of(st))
    return (None,) * (2 if wrapper == "ep_adj" else 1) + (1, None, None,
                                                           None, st)


@pytest.mark.parametrize("wrapper", ["ep_stage", "ep_adj", "max_ep_stage"])
@pytest.mark.parametrize("span", [50, 400])
def test_the_span_does_not_bound_a_block(wrapper, span):
    """-w as wide as the reads (Wp=400) passes the wrappers' limit for
    S=91 at f64 and Cp=30, as -w 50 does: whatever the wrapper then
    raises on its placeholder tensors, it is not the shared-memory
    limit."""
    cfg = J.ModelConfig(pattern=".....*.....", Lp=span, max_span=span,
                        max_iloop=30, min_bpp=0.0, tau=0.1, dtype="float64")
    st = J.kernels(cfg, "cpu").dp.st
    assert (st.dims.Wp, st.dims.Cp, st.dims.S) == (span, 30, 91)
    with pytest.raises(Exception) as e:
        getattr(K, wrapper)(*_wrapper_args(wrapper, st))
    assert not isinstance(e.value, K.SharedMemoryLimit)


@pytest.mark.parametrize("wrapper,dtype", [
    ("ep_stage", "float64"), ("ep_adj", "float64"), ("ep_adj", "float32"),
    ("max_ep_stage", "float64"),
])
def test_a_block_beyond_the_card_raises_in_the_wrapper(wrapper, dtype):
    """Max internal loop 50 (Cp=50): S=91 needs more shared memory than
    the card gives, in K3 and K11 at f64 and in K6 at either type; the
    wrapper raises before it looks at its tensors."""
    cfg = J.ModelConfig(pattern=".....*.....", Lp=60, max_span=60,
                        max_iloop=50, min_bpp=0.0, tau=0.1, dtype=dtype)
    st = J.kernels(cfg, "cpu").dp.st
    assert st.dims.Cp == 50
    with pytest.raises(K.SharedMemoryLimit, match="shared memory"):
        getattr(K, wrapper)(*_wrapper_args(wrapper, st))


def test_the_cli_reports_the_limit(monkeypatch):
    """The CLI turns the limit into an error message naming the -c that
    fits, not a traceback."""
    def too_wide(args, also_scan=False):
        K.ep_check("outside_ep", 91, 91, 40, torch.float64)

    monkeypatch.setattr(cli, "do_train", too_wide)
    with pytest.raises(SystemExit, match="max-internal-loop 32 fits"):
        cli.main(["train", "-f", "x.fq", "-m", ".....*.....", "-c", "40"])
