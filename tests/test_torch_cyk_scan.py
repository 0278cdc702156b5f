"""The port's structure-model scan through CYK (plain versions on the
CPU, f64) against the RNAelem C++ goldens and the JAX command line: the
full scan records of the fixture structure models against
scan_{0,1,3}.raw, `scan` of a structure model against the JAX CLI byte
for byte, and the `normal` mode (train, then scan)."""
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rnaelem_tpu.model import io as JIO
from rnaelem_tpu_torch import cli as CLI
from rnaelem_tpu_torch.model import io as TIO
from rnaelem_tpu_torch.scan import driver as TD

from tests.test_scan_golden import _chain_path_score, parse_raw, vec, vecint

# the CPU path is many small torch ops: one thread per test process
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")
GOLD = os.path.join(ROOT, "tests", "golden")
FQ = os.path.join(FIX, "0.fq")


# ------------------------ (a) full scan records vs the C++ goldens

@pytest.mark.parametrize("x", ["0", "1", "3"])
def test_scan_structure_model_matches_golden(x):
    """Every line of Scanner.scan of fixture model x on 0.fq against the
    C++ scan_x.raw: posteriors at test_scan_golden's tolerances, psihat
    equal or of equal chain score, rss, mot and the rest equal."""
    cfg, params = TIO.read_model(os.path.join(FIX, x + ".model"), Lp=48,
                                 device="cpu")
    assert not cfg.no_rss
    buf, log = io.StringIO(), io.StringIO()
    TD.Scanner(cfg, params, "cpu").scan(FQ, buf, log=log)
    mine = parse_raw(buf.getvalue())
    gold = parse_raw(open(os.path.join(GOLD, "scan_%s.raw" % x)).read())
    assert len(mine) == len(gold) == 2
    cj, pj = JIO.read_model(os.path.join(FIX, x + ".model"), Lp=48)
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
        if m["psihat"] != g["psihat"]:
            assert _chain_path_score(cj, pj, m["seq"], vecint(
                m["psihat"])) == pytest.approx(_chain_path_score(
                    cj, pj, g["seq"], vecint(g["psihat"])), abs=1e-9)
        for key in ("id", "motif region", "seq", "rss", "mot"):
            assert m[key] == g[key], key
    assert "E[N]:" in log.getvalue()


# ------------------------------------------- (b) the command line

def test_cli_scan_structure_model_equals_jax_cli(tmp_path):
    """`python -m rnaelem_tpu_torch.cli scan` of structure model 0 writes
    the JAX command line's records byte for byte (CPU, f64)."""
    jout = tmp_path / "jax.raw"
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               HOME=str(tmp_path),
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
    model = os.path.join(FIX, "0.model")
    run = subprocess.run(
        [sys.executable, "-m", "rnaelem_tpu.cli", "scan", "-q", model, "-f",
         FQ, "--out1", str(jout)], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=900)
    assert run.returncode == 0, run.stderr
    out = tmp_path / "scan.raw"
    CLI.main(["scan", "-q", model, "-f", FQ, "--out1", str(out),
              "--device", "cpu"])
    assert out.read_bytes() == jout.read_bytes()


def test_cli_normal_equals_train_then_scan(tmp_path):
    """`normal` (the default mode) writes train's model to --out1 and
    the scan of the FASTQ file with it to --out2: the model bytes equal a
    `train` run's, the records those of `scan` on the written model (the
    model file keeps 6 digits of each weight: posteriors within the
    golden tolerances, every other line equal)."""
    common = ["-f", FQ, "-m", "(...)", "-i", "2", "--batch-size", "2",
              "-w", "16", "-c", "8", "--device", "cpu"]
    CLI.main(["train", *common, "--out1", str(tmp_path / "train.model")])
    CLI.main([*common, "--out1", str(tmp_path / "normal.model"),
              "--out2", str(tmp_path / "normal.raw")])
    assert (tmp_path / "normal.model").read_bytes() == \
        (tmp_path / "train.model").read_bytes()
    CLI.main(["scan", "-q", str(tmp_path / "train.model"), "-f", FQ,
              "--out1", str(tmp_path / "scan.raw"), "--device", "cpu"])
    a = parse_raw((tmp_path / "normal.raw").read_text())
    b = parse_raw((tmp_path / "scan.raw").read_text())
    assert len(a) == len(b) == 2
    for m, g in zip(a, b):
        for key in ("start", "end", "inner"):
            x, y = vec(m[key]), vec(g[key])
            np.testing.assert_array_equal(np.isfinite(x), np.isfinite(y))
            fin = np.isfinite(x)
            np.testing.assert_allclose(x[fin], y[fin], atol=2e-4, rtol=1e-3)
        for key in ("id", "psihat", "motif region", "seq", "rss", "mot"):
            assert m[key] == g[key], key
