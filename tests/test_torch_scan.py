"""The port's scanner (kernel row K: the posterior pass with aux factors,
plain versions on the CPU, f64) against the JAX package and the RNAelem
C++ goldens: the DP with dense aux and its aux/weight cotangents, the
class probe against masked sums of those cotangents, scan_posteriors_batch
on the four fixture models, Scanner.scan and the scan command line of the
--no-rss model 2 (tests/test_torch_cyk_scan.py scans the structure
models)."""
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rnaelem_tpu.alphabet import seq_to_ints
from rnaelem_tpu.io.fastq import FastqReader
from rnaelem_tpu.model import io as JIO
from rnaelem_tpu.model import joint as JJ
from rnaelem_tpu.scan import driver as JD
from rnaelem_tpu.scan import scanner as JS
from rnaelem_tpu_torch import cli as CLI
from rnaelem_tpu_torch.model import io as TIO
from rnaelem_tpu_torch.model import joint as TJ
from rnaelem_tpu_torch.model.convert import params_from_numpy
from rnaelem_tpu_torch.ops import dp as DP
from rnaelem_tpu_torch.scan import driver as TD
from rnaelem_tpu_torch.scan import scanner as TS

from tests.test_scan_golden import parse_raw, vec

# the CPU path is many small torch ops: one thread per test process
# (xdist worker) keeps parallel workers from oversubscribing the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")
GOLD = os.path.join(ROOT, "tests", "golden")
FQ = os.path.join(FIX, "0.fq")
AUX = ("auxR", "auxL", "auxPL", "auxPR")


# ---------------------------------------------- (a) the DP with dense aux

AUX_CASES = {"(.*)": ("(.*)", False), "(.....)": ("(.....)", False),
             "..*.. no-rss": ("..*..", True)}
KEYS = ("parts", "singles", "pairs", "lam")


def _aux_setup(pattern, no_rss, seed=2):
    """Both packages' configs (Lp 20, W 12, C 6), three ragged reads,
    random weights, random dense aux [B, Lp, S, S] per kind with the
    end pass's -inf vetoes at one base of read 0, a parts cotangent."""
    kw = dict(pattern=pattern, Lp=20, max_span=12, max_iloop=6,
              min_bpp=0.0, tau=0.1, no_rss=no_rss, dtype="float64")
    cj, ct = JJ.ModelConfig(**kw, with_aux=True), TJ.ModelConfig(**kw)
    rng = np.random.RandomState(seed)
    pj = JJ.init_params(JJ.kernels(cj).g, cj, jnp.float64)
    pj = JJ.Params(
        singles=pj.singles + jnp.asarray(0.3 * rng.randn(*pj.singles.shape)),
        pairs=pj.pairs + jnp.asarray(0.3 * rng.randn(*pj.pairs.shape)),
        lam=jnp.asarray([0.8, 1.2]))
    pt = params_from_numpy(*[np.asarray(x) for x in pj], device="cpu")
    sdj, sdt = [], []
    for L in (20, 15, 9):
        s = seq_to_ints("".join("ACGU"[c] for c in rng.randint(0, 4, L)))
        q = rng.randint(0, 40, L + 1)
        sdj.append(JJ.make_seqdata(cj, s, q))
        sdt.append(TJ.make_seqdata(ct, s, q))
    sdj = jax.tree.map(lambda *x: jnp.asarray(np.stack(x)), *sdj)
    S = JJ.kernels(cj).g.S
    codes = DP.class_codes(TJ.kernels(ct, "cpu").g)
    aux = {}
    for kind, k in enumerate(AUX):
        a = 0.3 * rng.randn(3, 20, S, S)
        a[0, 5][(codes[kind] & DP.CLS_START) == 0] = -np.inf
        aux[k] = a
    gbar = rng.rand(3, 3)
    return cj, ct, pj, pt, sdj, TJ.stack_seqdata(sdt, "cpu"), aux, gbar


@pytest.fixture(scope="module")
def aux_case(request):
    """(parts, aux cotangents, weight cotangents) of JAX and of the port's
    plain DP for one case, and the port's class-probe check."""
    cj, ct, pj, pt, sdj, sdt, aux, gbar = _aux_setup(*AUX_CASES[
        request.param])
    auxj = {k: jnp.asarray(v) for k, v in aux.items()}
    if cj.no_rss:
        auxj = {"auxR": auxj["auxR"]}
    parts_j, vjp = jax.vjp(
        lambda a, p: JJ._batch_logZ_parts_jit(cj, p, sdj, a, None), auxj, pj)
    fin = np.isfinite(np.asarray(parts_j))
    gaux_j, gp_j = vjp(jnp.asarray(np.where(fin, gbar, 0.0)))

    leaves = TJ.Params(*[x.clone().requires_grad_(True) for x in pt])
    auxt = {k: torch.tensor(v, requires_grad=True) for k, v in aux.items()
            if k in auxj}
    parts_t = TJ.batch_logZ_parts(ct, leaves, sdt, device="cpu", aux_b=auxt)
    gw = torch.as_tensor(np.where(fin, gbar, 0.0))
    gr = torch.autograd.grad(parts_t, list(leaves) + list(auxt.values()), gw,
                             allow_unused=True)
    want = dict(parts=np.asarray(parts_j), **{
        k: np.asarray(v) for k, v in gaux_j.items()}, **{
        n: np.asarray(getattr(gp_j, n)) for n in ("singles", "pairs", "lam")})
    got = dict(parts=parts_t.detach().numpy())
    for n, g in zip(("singles", "pairs", "lam") + tuple(auxt), gr):
        got[n] = np.zeros_like(want[n]) if g is None else g.numpy()

    # the class probe (what the kernels emit) against masked sums of the
    # dense cotangents of the same evaluation, under a pin
    B, Lp = 3, ct.Lp
    cls = torch.zeros((4, Lp, B), dtype=torch.float64, requires_grad=True)
    pin = DP.Pin(torch.tensor([7, 3, -1], dtype=torch.int32), DP.CLS_START)
    auxp = {k: v.detach().clone().requires_grad_(True)
            for k, v in auxt.items()}
    parts_p = TJ.batch_logZ_parts(ct, pt, sdt, device="cpu",
                                  aux_b=dict(auxp, cls=cls, pin=pin))
    gw = torch.where(torch.isfinite(parts_p), gw, 0.0)
    g = torch.autograd.grad(parts_p, [cls] + list(auxp.values()), gw)
    masks = TJ.kernels(ct, "cpu").dp.st.cls_mask        # [kind, class, S, S]
    summed = sum(torch.einsum("bpts,cts->cpb", ga, masks[AUX.index(k)])
                 for k, ga in zip(auxp, g[1:]))
    return want, got, (g[0], summed)


@pytest.mark.parametrize("aux_case,key", [
    (case, key) for case in AUX_CASES
    for key in KEYS + (("auxR",) if "no-rss" in case else AUX)],
    indirect=["aux_case"])
def test_dense_aux_dp_matches_jax(aux_case, key):
    """[B, 3] parts (1e-9 relative, same -inf pattern) and every
    cotangent (1e-9 of its max norm) of the plain DP with dense aux (the
    no-rss chain reads auxR alone)."""
    want, got, _ = aux_case
    a, b = got[key], want[key]
    if key == "parts":
        np.testing.assert_array_equal(np.isneginf(a), np.isneginf(b))
        fin = np.isfinite(b)
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-9, atol=0)
        return
    assert not np.isnan(a).any()
    scale = max(np.abs(b).max(), 1e-300)
    assert np.abs(a - b).max() <= 1e-9 * scale, key


@pytest.mark.parametrize("aux_case", list(AUX_CASES), indirect=True)
def test_class_probe_is_masked_aux_cotangent(aux_case):
    """The probe's cotangent [4, Lp, B] equals the class-masked sums of
    the dense aux cotangents under a pin (1e-12 of the max norm)."""
    _, _, (probe, summed) = aux_case
    assert probe.abs().max() > 0
    assert float((probe - summed).abs().max()) <= \
        1e-12 * float(summed.abs().max())


# ------------------------------- (b, d) posteriors of the fixture models

def _reads():
    return list(FastqReader(FQ).reads())


@pytest.fixture(scope="module", params=["0", "1", "2", "3"])
def posteriors(request):
    """JAX and port scan_posteriors_batch of one fixture model at Lp 45
    on 0.fq, plus a padding row (read 0 again, valid 0)."""
    x = request.param
    path = os.path.join(FIX, x + ".model")
    cj, pj = JD.scan_config(*JIO.read_model(path, Lp=45), 45)
    ct, pt = TD.scan_config(*TIO.read_model(path, Lp=45, device="cpu"), 45)
    reads = _reads()
    rows = [(r.seq, r.qual) for r in reads] + [(reads[0].seq, reads[0].qual)]
    valid = np.array([1.0, 1.0, 0.0])
    sdj = jax.tree.map(lambda *xs: np.stack(xs),
                       *[JJ.make_seqdata(cj, s, q) for s, q in rows])
    rj = JS.scan_posteriors_batch(cj, pj, sdj, valid)
    sdt = TJ.stack_seqdata([TJ.make_seqdata(ct, s, q) for s, q in rows],
                           "cpu")
    rt = TS.scan_posteriors_batch(ct, pt, sdt, valid, device="cpu")
    return x, rj, rt


@pytest.mark.parametrize("key", ["Pys", "Pyi", "Pye", "PyN", "Z", "Ze", "EN",
                                 "Ys", "Ye"])
def test_scan_posteriors_match_jax(posteriors, key):
    """Each output of scan_posteriors_batch against JAX: floats to 1e-9
    of their max norm (E[N]'s tables each), Ys and Ye equal; the padding
    row has zero posteriors."""
    x, rj, rt = posteriors
    if key == "EN":
        pairs = [(getattr(rt["EN"], n).numpy(),
                  np.asarray(getattr(rj["EN"], n)))
                 for n in ("singles", "pairs", "lam")]
    else:
        pairs = [(rt[key].detach().numpy(), np.asarray(rj[key]))]
    for a, b in pairs:
        assert a.shape == b.shape, key
        if key in ("Ys", "Ye"):
            np.testing.assert_array_equal(a, b)
            continue
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        fin = np.isfinite(b)
        assert np.abs(a[fin] - b[fin]).max() <= \
            1e-9 * max(np.abs(b[fin]).max(), 1e-300), (x, key)
    if key in ("Pys", "Pyi", "Pye"):
        assert not rt[key][2].any()


def test_posterior_lines_match_golden(posteriors):
    """The start, end, inner, motif region and exist prob lines of every
    read against the RNAelem C++ scan (test_scan_golden's rules)."""
    x, _, rt = posteriors
    gold = parse_raw(open(os.path.join(GOLD, "scan_%s.raw" % x)).read())
    for t, (r, g) in enumerate(zip(_reads(), gold)):
        L = len(r.seq)
        out = {k: rt[k][t].detach().numpy() for k in ("Pys", "Pye", "Pyi")}
        lines = dict(line.split(": ", 1) for line in TD.posterior_lines(
            out["Pys"][:L], out["Pye"][:L + 1], out["Pyi"][:L],
            int(rt["Ys"][t]), int(rt["Ye"][t])))
        for key in ("start", "end", "inner"):
            a, b = vec(lines[key]), vec(g[key])
            assert a.shape == b.shape, key
            np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
            both = np.isfinite(a) & np.isfinite(b)
            np.testing.assert_allclose(a[both], b[both], atol=2e-4,
                                       rtol=1e-3, err_msg=key)
        assert lines["motif region"] == g["motif region"]
        assert float(lines["exist prob"]) == pytest.approx(
            float(g["exist prob"]), abs=1e-3)


# -------------------------------------- (c, f) the --no-rss model 2 scan

@pytest.fixture(scope="module")
def jax_scan2(tmp_path_factory):
    """`python -m rnaelem_tpu.cli scan` of model 2 on 0.fq (CPU, f64):
    (its --out1 bytes, its stderr)."""
    tmp = tmp_path_factory.mktemp("jax_scan2")
    out = tmp / "scan.raw"
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               HOME=str(tmp), JAX_COMPILATION_CACHE_DIR=str(tmp / "cache"))
    run = subprocess.run(
        [sys.executable, "-m", "rnaelem_tpu.cli", "scan", "-q",
         os.path.join(FIX, "2.model"), "-f", FQ, "--out1", str(out)],
        cwd=str(tmp), env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr
    return out.read_bytes(), run.stderr


def _en_line(text):
    return [line for line in text.splitlines() if line.startswith("E[N]:")]


def test_scanner_scan_norss_matches_golden(jax_scan2):
    """Every line of Scanner.scan of model 2 against scan_2.raw (the
    posteriors at test_scan_golden's tolerances, the rest equal), and
    its E[N] line equal to the JAX driver's."""
    cfg, params = TIO.read_model(os.path.join(FIX, "2.model"), Lp=48,
                                 device="cpu")
    buf, log = io.StringIO(), io.StringIO()
    TD.Scanner(cfg, params, "cpu").scan(FQ, buf, log=log)
    mine = parse_raw(buf.getvalue())
    gold = parse_raw(open(os.path.join(GOLD, "scan_2.raw")).read())
    assert len(mine) == len(gold) == 2
    for m, g in zip(mine, gold):
        assert set(m) == set(g)
        for key in ("start", "end", "inner"):
            a, b = vec(m[key]), vec(g[key])
            assert a.shape == b.shape
            np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
            both = np.isfinite(a)
            np.testing.assert_allclose(a[both], b[both], atol=2e-4,
                                       rtol=1e-3, err_msg=key)
        assert float(m["exist prob"]) == pytest.approx(
            float(g["exist prob"]), abs=1e-3)
        for key in ("id", "psihat", "motif region", "seq", "rss", "mot"):
            assert m[key] == g[key], key
    assert _en_line(log.getvalue()) == _en_line(jax_scan2[1]) != []


def test_cli_scan_norss_equals_jax_cli(jax_scan2, tmp_path):
    """`python -m rnaelem_tpu_torch.cli scan --device cpu` writes the JAX
    command line's records byte for byte (f64)."""
    out = tmp_path / "scan.raw"
    CLI.main(["scan", "-q", os.path.join(FIX, "2.model"), "-f", FQ,
              "--out1", str(out), "--device", "cpu"])
    assert out.read_bytes() == jax_scan2[0]
