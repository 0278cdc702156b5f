"""The port's objective value and gradient against the RNAelem C++ goldens,
and its model files and weight carry-over against the JAX package.

Golden values in tests/golden/eval_{0,1,2,3}.{fn,gr} come from the
reference's eval path (motif_eval.hpp, TR_NORMAL|TR_NO_SHUFFLE) on
fixtures {0,1,2,3}.model x 0.fq, the same bar as test_grad_golden.py.  The
port computes its own min-BPP pruning masks; model 2 is the no-rss model
(the forward chain of kernel row J).
"""
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rnaelem_tpu.model import io as JIO
from rnaelem_tpu_torch import cli as TCLI
from rnaelem_tpu_torch.model import io as TIO
from rnaelem_tpu_torch.model.convert import params_from_numpy
from rnaelem_tpu_torch.train import objective as OBJ

# the CPU path is many small torch ops: one thread per test process
# (xdist worker) keeps parallel workers from oversubscribing the cores
torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
FIX = os.path.join(HERE, "fixtures")
GOLD = os.path.join(HERE, "golden")
ROOT = os.path.dirname(HERE)
LP = 48


def _golden(x):
    with open(os.path.join(GOLD, "eval_%s.fn" % x)) as f:
        fn = float(f.read().split(":")[1])
    with open(os.path.join(GOLD, "eval_%s.gr" % x)) as f:
        s = f.read()
        gr = np.array([float(v) for v in
                       s[s.find("[") + 1: s.rfind("]")].split(",")])
    return fn, gr


@pytest.mark.parametrize("x", ["0", "1", "2", "3"])
def test_fn_matches_reference(x):
    """fn and gr of eval_file (the port's own masks) to 1e-6."""
    fn_g, gr_g = _golden(x)
    cfg, params = TIO.read_model(os.path.join(FIX, "%s.model" % x), Lp=LP,
                                 device="cpu")
    fn, gr, eff = OBJ.eval_file(cfg, params, os.path.join(FIX, "0.fq"),
                                device="cpu")
    assert fn == pytest.approx(fn_g, abs=1e-6)
    assert gr.shape == gr_g.shape
    np.testing.assert_allclose(gr, gr_g, rtol=0, atol=1e-6)
    assert 0 < eff <= 2


def test_cli_eval_matches_reference(tmp_path):
    """python -m rnaelem_tpu_torch.cli eval writes the JAX CLI's fn:/gr:
    lines (%.17g), and their values meet the goldens."""
    fn_g, gr_g = _golden("1")
    out1, out2 = tmp_path / "fn.txt", tmp_path / "gr.txt"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "rnaelem_tpu_torch.cli", "eval",
         "-f", os.path.join(FIX, "0.fq"), "-q", os.path.join(FIX, "1.model"),
         "--out1", str(out1), "--out2", str(out2), "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=600)
    assert r.returncode == 0, r.stderr
    fn_line, = out1.read_text().splitlines()
    gr_line, = out2.read_text().splitlines()
    assert fn_line.startswith("fn: ") and gr_line.startswith("gr: [")
    fn = float(fn_line[4:])
    gr = np.array([float(v) for v in gr_line[5:-1].split(",")])
    assert fn_line == "fn: %.17g" % fn
    assert gr_line == "gr: [" + ",".join("%.17g" % v for v in gr) + "]"
    assert fn == pytest.approx(fn_g, abs=1e-6)
    np.testing.assert_allclose(gr, gr_g, rtol=0, atol=1e-6)


@pytest.mark.parametrize("flag,warning", [
    (["-t", "4"], "--thread is ignored"),
    (["--font", "Arial.ttf"], "--font is ignored"),
    (["--pict", "motif.png"], None)], ids=["thread", "font", "pict"])
def test_cli_takes_the_reference_flags(flag, warning, tmp_path, capsys):
    """-t/--thread, --font and --pict parse as the JAX CLI takes them:
    --thread and --font warn that they are ignored (--thread points at
    --mesh), --pict is silent (the reference parses it and never reads
    it); eval's output is the golden's."""
    fn_g, _ = _golden("2")
    out1 = tmp_path / "fn.txt"
    TCLI.main(["eval", "-f", os.path.join(FIX, "0.fq"), "-q",
               os.path.join(FIX, "2.model"), "--out1", str(out1),
               "--out2", "~NULL~", "--device", "cpu"] + flag)
    err = capsys.readouterr().err
    if warning is None:
        assert "warning" not in err
    else:
        assert "warning: " + warning in err
        assert ("--mesh" in err) == (flag[0] == "-t")
    assert float(out1.read_text().split(":")[1]) == pytest.approx(
        fn_g, abs=1e-6)


@pytest.mark.parametrize("x", ["0", "1", "2", "3"])
def test_model_io_matches_jax(x):
    """params_from_numpy of the JAX reader's params equals the port's own
    reader, and the port writes the same bytes as the JAX writer.  The
    port's config has every field of JAX's but the scanning flag
    with_aux (the port takes aux as an argument), which the reader
    leaves off."""
    path = os.path.join(FIX, "%s.model" % x)
    cj, pj = JIO.read_model(path, Lp=LP)
    ct, pt = TIO.read_model(path, Lp=LP, device="cpu")
    assert set(cj.__dict__) - set(ct.__dict__) == {"with_aux"}
    assert cj.with_aux is False
    assert ct.__dict__ == {k: cj.__dict__[k] for k in ct.__dict__}
    conv = params_from_numpy(np.asarray(pj.singles), np.asarray(pj.pairs),
                             np.asarray(pj.lam), device="cpu")
    for a, b in zip(conv, pt):
        assert a.dtype == b.dtype == torch.float64
        assert torch.equal(a, b)
    fj, ft = io.StringIO(), io.StringIO()
    JIO.write_model(fj, cj, pj)
    TIO.write_model(ft, ct, pt)
    assert ft.getvalue() == fj.getvalue()
    assert TIO.interim_line(ct, pt) == JIO.interim_line(cj, pj)
