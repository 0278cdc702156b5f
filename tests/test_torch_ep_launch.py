"""Launch plans of the fused internal-loop kernels K3, K6 and K11
(ops/kernels.ep_plan): the bytes a block's layout takes are sized on the
host, and a layout past the shared memory an H100 block may take runs in
the device variant (the same kernel body with its layout in a device
workspace), chosen before any launch.  The plan depends on the grammar
(S, n_ar), the max internal loop Cp and the type, never on the span Wp;
nothing refuses a shape.  Also the CLI's `develop` mode."""
import os
import subprocess
import sys

import pytest
import torch

from rnaelem_tpu_torch import cli
from rnaelem_tpu_torch.grammar.profile import compile_pattern, null_grammar
from rnaelem_tpu_torch.model import joint as J
from rnaelem_tpu_torch.ops import dp as DP
from rnaelem_tpu_torch.ops import dp_maxb as DMB
from rnaelem_tpu_torch.ops import kernels as K

HERE = os.path.dirname(__file__)
PATTERNS = os.path.join(HERE, "fixtures", "pattern_list")
EP_KERNELS = ("inside_ep", "outside_ep", "inside_ep_max")


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


def _wide_grammars():
    """The grammars the card must take besides the list's: every all-dot
    pattern of 1 to 16 dots (S up to 171) and `.....*.....` (S=91)."""
    out = []
    for pat in ["." * n for n in range(1, 17)] + [".....*....."]:
        g = compile_pattern(pat)
        out.append((pat, g.S, len(DP.chain_lists(g)[1])))
    return out


@pytest.mark.parametrize("kernel", EP_KERNELS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_every_pattern_fits_a_block(kernel, dtype):
    """At the default max internal loop (Cp=30) and up to Cp=32 a block
    of one read fits in the 232,448 bytes of shared memory an H100 block
    may take, for every grammar of the pattern list (S up to 91) and the
    masks': the plan keeps the shared variant."""
    gs = _grammars()
    assert len(gs) >= 130 and max(S for _, S, _ in gs) == 91
    for Cp in (30, 32):
        for pat, S, n_ar in gs:
            plan = K.ep_plan(kernel, S, n_ar, Cp, dtype)
            smem = K.ep_smem_bytes(kernel, S, n_ar, Cp, dtype)
            assert smem <= K.SMEM_LIMIT == 232448, (pat, Cp, smem)
            assert plan == (kernel, "shared", smem, 0), (pat, Cp)


@pytest.mark.parametrize("kernel", EP_KERNELS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_every_wide_shape_has_a_plan(kernel, dtype):
    """Every all-dot pattern of 1 to 16 dots, `.....*.....` and every
    pattern of the list, at each -c from 4 to 40, and a synthetic grammar
    of S = n_ar = 300: the plan names the shared variant where the layout
    fits a block and the device variant (a slice of the layout's bytes,
    rounded up to 256, per block) where it does not; it never raises."""
    device = 0
    for pat, S, n_ar in _grammars() + _wide_grammars() + [
            ("synthetic", 300, 300)]:
        for Cp in range(4, 41):
            plan = K.ep_plan(kernel, S, n_ar, Cp, dtype)
            layout = K.ep_smem_bytes(kernel, S, n_ar, Cp, dtype)
            if layout <= K.SMEM_LIMIT:
                assert plan == (kernel, "shared", layout, 0), (pat, Cp)
            else:
                device += 1
                assert plan.variant == "device" and plan.smem == 0
                assert plan.block_bytes % 256 == 0
                assert 0 <= plan.block_bytes - layout < 256, (pat, Cp)
    assert device > 0


def test_the_first_max_internal_loop_a_pattern_exceeds_is_33():
    """K6 at f64 binds: `.....*.....` (S = n_ar = 91) takes 228,456
    bytes at Cp=32, in shared memory, and more than a block may take at
    Cp=33, where the plan takes the device variant: 237,056 bytes of
    workspace per block (the layout's 237,008, rounded up to 256)."""
    assert K.ep_smem_bytes("outside_ep", 91, 91, 32, torch.float64) \
        == 228456
    assert K.ep_plan("outside_ep", 91, 91, 32, torch.float64).variant \
        == "shared"
    assert K.ep_smem_bytes("outside_ep", 91, 91, 33, torch.float64) \
        == 237008
    assert K.ep_plan("outside_ep", 91, 91, 33, torch.float64) == (
        "outside_ep", "device", 0, 237056)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_cyk_kernel_fits_wherever_the_adjoint_fits(dtype):
    """The scan runs K6 (the posteriors' outside pass) before K11 (the
    CYK tables): for every grammar of the list and the masks', at every
    max internal loop where K6 keeps its shared variant, K11 keeps its
    own; past the -c where K11's layout stops fitting (at least 33) its
    plan takes the device variant, as K6's does."""
    for pat, S, n_ar in _grammars():
        fit = None
        for Cp in range(1, 1000):
            k6 = K.ep_plan("outside_ep", S, n_ar, Cp, dtype)
            k11 = K.ep_plan("inside_ep_max", S, n_ar, Cp, dtype)
            if k6.variant == "shared":
                assert k11.variant == "shared", (pat, Cp, k6, k11)
            if k11.variant == "device":
                fit = Cp - 1
                break
        assert fit is not None and fit >= 32, (pat, fit)
        assert K.ep_plan("outside_ep", S, n_ar, fit + 1, dtype).variant \
            == "device", (pat, fit)


def test_the_cyk_block_layout_at_the_widest_pattern():
    """K11 at f64 for `.....*.....` (S = n_ar = 91): 229,544 bytes at
    Cp=32, the widest -c K6 takes there in shared memory; 236,768 at
    Cp=33, beyond a block: the device variant."""
    assert K.ep_smem_bytes("inside_ep_max", 91, 91, 32, torch.float64) \
        == 229544
    assert K.ep_plan("inside_ep_max", 91, 91, 32, torch.float64).variant \
        == "shared"
    assert K.ep_smem_bytes("inside_ep_max", 91, 91, 33, torch.float64) \
        == 236768
    assert K.ep_plan("inside_ep_max", 91, 91, 33, torch.float64) == (
        "inside_ep_max", "device", 0, 236800)


def test_the_cyk_block_holds_a_thread_per_state():
    """K11's block of 256 threads takes each target state and each AR
    pair on a thread, striding over them where a grammar has more: 257
    states, or 300 states and AR pairs, plan like 256 (the shared variant
    at a small -c, the device variant where the layout outgrows shared
    memory), never a refusal."""
    for S, n_ar in ((256, 256), (257, 100), (300, 300)):
        assert K.ep_plan("inside_ep_max", S, n_ar, 2,
                         torch.float32).variant == "shared", (S, n_ar)
    assert K.ep_plan("inside_ep_max", 300, 300, 30,
                     torch.float64).variant == "device"


def test_a_forced_variant_is_checked():
    """The plan's keyword forces a variant: the device variant for any
    shape, the shared one only where it fits."""
    plan = K.ep_plan("inside_ep", 29, 29, 30, torch.float32,
                     variant="device")
    assert plan.variant == "device" and plan.block_bytes >= \
        K.ep_smem_bytes("inside_ep", 29, 29, 30, torch.float32)
    with pytest.raises(ValueError, match="shared variant"):
        K.ep_plan("outside_ep", 91, 91, 40, torch.float64, variant="shared")
    with pytest.raises(ValueError, match="neither"):
        K.ep_plan("outside_ep", 91, 91, 30, torch.float64, variant="smem")


def _wrapper_args(wrapper, st):
    """Placeholder arguments: the plan is made before the wrapper looks
    at its tensors."""
    if wrapper == "max_ep_stage":
        return (None, 1, None, None, DMB.MaxStatic.of(st))
    return (None,) * (2 if wrapper == "ep_adj" else 1) + (1, None, None,
                                                           None, st)


_WRAPPER_KERNEL = {"ep_stage": "inside_ep", "ep_adj": "outside_ep",
                   "max_ep_stage": "inside_ep_max"}


def _planned(monkeypatch, wrapper, st):
    """The plan the wrapper makes for its grammar (recorded from ep_plan),
    and the error it then raises on its placeholder tensors."""
    seen = []
    plan = K.ep_plan

    def spy(*args, **kw):
        seen.append(plan(*args, **kw))
        return seen[-1]

    monkeypatch.setattr(K, "ep_plan", spy)
    with pytest.raises(Exception) as e:
        getattr(K, wrapper)(*_wrapper_args(wrapper, st))
    assert len(seen) == 1 and seen[0].kernel == _WRAPPER_KERNEL[wrapper]
    return seen[0], e.value


@pytest.mark.parametrize("wrapper", ["ep_stage", "ep_adj", "max_ep_stage"])
@pytest.mark.parametrize("span", [50, 400])
def test_the_span_does_not_bound_a_block(monkeypatch, wrapper, span):
    """-w as wide as the reads (Wp=400) gets the plan -w 50 gets for S=91
    at f64 and Cp=30 (the shared variant); the wrapper then fails on its
    placeholder tensors, not on the plan."""
    cfg = J.ModelConfig(pattern=".....*.....", Lp=span, max_span=span,
                        max_iloop=30, min_bpp=0.0, tau=0.1, dtype="float64")
    st = J.kernels(cfg, "cpu").dp.st
    assert (st.dims.Wp, st.dims.Cp, st.dims.S) == (span, 30, 91)
    plan, err = _planned(monkeypatch, wrapper, st)
    assert plan.variant == "shared"
    assert not isinstance(err, ValueError)


@pytest.mark.parametrize("wrapper,dtype", [
    ("ep_stage", "float64"), ("ep_adj", "float64"), ("ep_adj", "float32"),
    ("max_ep_stage", "float64"),
])
def test_a_block_beyond_the_card_raises_in_the_wrapper(monkeypatch, wrapper,
                                                      dtype):
    """Max internal loop 50 (Cp=50): S=91 needs more shared memory than
    a block may take, in K3 and K11 at f64 and in K6 at either type; the
    wrapper plans the device variant before it looks at its tensors, and
    what it then raises on its placeholders is not a refusal of the
    shape."""
    cfg = J.ModelConfig(pattern=".....*.....", Lp=60, max_span=60,
                        max_iloop=50, min_bpp=0.0, tau=0.1, dtype=dtype)
    st = J.kernels(cfg, "cpu").dp.st
    assert st.dims.Cp == 50
    plan, err = _planned(monkeypatch, wrapper, st)
    assert plan.variant == "device"
    assert plan.block_bytes >= K.ep_smem_bytes(
        plan.kernel, 91, 91, 50, st.dtype) > K.SMEM_LIMIT
    assert not isinstance(err, ValueError)


def test_the_cli_reports_the_limit(monkeypatch):
    """A pattern whose blocks outgrow shared memory (`.....*.....` at -c
    40, f64) is no longer a limit the CLI reports: its run goes on, with
    K6 and K11 planned in the device variant (K3's block still fits)."""
    seen = []

    def too_wide(args, also_scan=False):
        for kernel in EP_KERNELS:
            seen.append(K.ep_plan(kernel, 91, 91, args.max_internal_loop,
                                  torch.float64))

    monkeypatch.setattr(cli, "do_train", too_wide)
    assert cli.main(["train", "-f", "x.fq", "-m", ".....*.....", "-c",
                     "40"]) is None
    assert [p.variant for p in seen] == ["shared", "device", "device"]


def test_develop_parses_and_exits_0(tmp_path):
    """`develop` is a mode of the port's CLI, a no-op as in the JAX
    package's: it exits 0 and writes nothing."""
    fq = tmp_path / "x.fq"
    fq.write_text("@r\nACGU\n+\nIIIII\n")
    run = subprocess.run(
        [sys.executable, "-m", "rnaelem_tpu_torch.cli", "develop", "-f",
         str(fq)], cwd=str(tmp_path), capture_output=True, text=True,
        timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.dirname(HERE)))
    assert run.returncode == 0, run.stderr
    assert run.stdout == "" and sorted(os.listdir(tmp_path)) == ["x.fq"]
    assert cli.main(["develop", "-f", str(fq)]) is None
