"""The port's file-array evaluation (rnaelem_tpu_torch/parallel/arrayjob.py,
the reference's TR_ARRAY protocol): the master spawns `array-eval` slaves
of the port's CLI, parses their 17-digit `tmp-<tid>` files with the
reference's field and duplicate checks, and sums to the fn/gr/eff of one
full-file evaluation, the port's and the JAX package's (the ports of
tests/test_arrayjob.py, on the CPU)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rnaelem_tpu.model import io as JIO
from rnaelem_tpu.train import objective as JO
from rnaelem_tpu_torch.model import io as TIO
from rnaelem_tpu_torch.parallel import arrayjob as AJ
from rnaelem_tpu_torch.train.objective import eval_file

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures")
ROOT = os.path.dirname(HERE)


def _env():
    return dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")


def _local(argv, n):
    AJ.submit_local(argv, n, _env())


def _master_vs_local(tmp_path, submit, **kw):
    """fn, gr, eff of the master against eval_file of the model snapshot
    it wrote, the port's and the JAX package's (the snapshot writer
    rounds to 6 significant digits, the reference's own broadcast
    precision, so the local evaluations read the same rounded weights
    back)."""
    fq = os.path.join(FIX, "0.fq")
    cfg, params = TIO.read_model(os.path.join(FIX, "0.model"), Lp=48,
                                 dtype="float64", device="cpu")
    tmp = str(tmp_path / "tmp")
    ev = AJ.ArrayEvaluator(cfg, 2, tmp, fq, submit=submit, device="cpu",
                           **kw)
    assert ev.slave_argv()[1:4] == ["-m", "rnaelem_tpu_torch.cli",
                                    "array-eval"]
    fn, gr, eff = ev(params)
    assert (tmp_path / "tmp-1").exists() and (tmp_path / "tmp-2").exists()
    cfg_rt, params_rt = TIO.read_model(tmp, Lp=48, dtype="float64",
                                       device="cpu")
    fn_ref, gr_ref, eff_ref = eval_file(cfg_rt, params_rt, fq, device="cpu")
    assert fn == pytest.approx(fn_ref, rel=1e-9, abs=1e-9)
    np.testing.assert_allclose(gr, gr_ref, rtol=1e-9, atol=1e-9)
    assert eff == pytest.approx(eff_ref, rel=1e-9)
    cfg_j, params_j = JIO.read_model(tmp, Lp=48, dtype="float64")
    fn_j, gr_j, eff_j = JO.eval_file(cfg_j, params_j, fq)
    assert fn == pytest.approx(float(fn_j), rel=1e-9, abs=1e-9)
    np.testing.assert_allclose(gr, np.asarray(gr_j), rtol=1e-9, atol=1e-9)
    assert eff == pytest.approx(float(eff_j), rel=1e-9)


def test_array_master_matches_local(tmp_path):
    _master_vs_local(tmp_path, _local)


def test_duplicate_and_missing_field_checks(tmp_path):
    p1 = tmp_path / "t-1"
    p2 = tmp_path / "t-2"
    p1.write_text("index: 1 / 2\nfn: 1.5\ngr: [1,2]\nsum eff: 0.5\n")
    p2.write_text("index: 1 / 2\nfn: 2.5\ngr: [3,4]\nsum eff: 0.25\n")
    with pytest.raises(ValueError, match="duplicate"):
        AJ.collect_fn_gr_eff(str(tmp_path / "t"), 2)
    p2.write_text("index: 2 / 2\nfn: 2.5\ngr: [3,4]\nsum eff: 0.25\n")
    fn, gr, eff = AJ.collect_fn_gr_eff(str(tmp_path / "t"), 2)
    assert fn == 4.0 and eff == 0.75
    np.testing.assert_array_equal(gr, [4.0, 6.0])
    p2.write_text("index: 2 / 2\nfn: 2.5\nsum eff: 0.25\n")
    with pytest.raises(ValueError, match="broken"):
        AJ.collect_fn_gr_eff(str(tmp_path / "t"), 2)


def test_grid_engine_options_parse_and_cmd():
    """Template parsing and the submit line (arrayjob_manager.hpp:32-141:
    $from/$to substituted, all eight keys required)."""
    ge = AJ.GridEngineOptions.load("~DEFAULT~")
    assert ge.task_id_env == "SGE_TASK_ID"
    cmd = ge.submit_cmd("RNAelem train", 7)
    assert cmd.startswith("qsub -t 1-7 -b y -sync y -cwd -V ")
    assert cmd.endswith('"RNAelem train"')
    with pytest.raises(ValueError, match="grid_engine_opt broken"):
        AJ.GridEngineOptions.parse("command: qsub\narray: -t $from-$to\n")


def test_template_value_with_colon_is_kept():
    """F7 fixed in the port: a line is split on its first ':' only, so a
    value that holds one (a wall-clock limit, a path) is kept (the JAX
    copy drops such a line and then refuses the template)."""
    text = "\n".join("%s: %s" % kv for kv in dict(
        AJ.DEFAULT_GRID_OPTIONS,
        other="-l h_rt=01:30:00 -o host:/var/log").items())
    ge = AJ.GridEngineOptions.parse(text)
    assert ge.opts["other"] == "-l h_rt=01:30:00 -o host:/var/log"
    assert ge.submit_cmd("job", 2).endswith(
        '-l h_rt=01:30:00 -o host:/var/log "job"')


def _fake_scheduler(tmp_path):
    """A stand-in scheduler: parses `-t 1-N`, logs the submit line, and
    runs the quoted job N times with FAKE_TASK_ID set, one after another
    (`-sync y`)."""
    sched = tmp_path / "fake_qsub.py"
    sched.write_text("""\
import os, subprocess, sys
args = sys.argv[1:]
open(os.environ["FAKE_SCHED_LOG"], "a").write(" ".join(args) + "\\n")
n = int(args[args.index("-t") + 1].split("-")[1])
for tid in range(1, n + 1):
    env = dict(os.environ, FAKE_TASK_ID=str(tid))
    r = subprocess.run(args[-1], shell=True, env=env)
    if r.returncode:
        sys.exit(r.returncode)
""")
    tmpl = tmp_path / "grid_opt"
    tmpl.write_text(f"""\
command
command: {sys.executable} {sched}
task id: FAKE_TASK_ID
array: -t $from-$to
binary:
sync:
cwd:
environment:
other:
""")
    return str(tmpl)


def test_template_submission_e2e(tmp_path, monkeypatch):
    """--sge-option-file drives a submission through the fake scheduler:
    the slaves read their rank from the template's task-id variable and
    the master sums their files."""
    tmpl = _fake_scheduler(tmp_path)
    log = tmp_path / "sched.log"
    for k, v in _env().items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("FAKE_SCHED_LOG", str(log))
    ge = AJ.GridEngineOptions.load(tmpl)
    _master_vs_local(tmp_path, ge.submitter(), sge_option_file=tmpl)
    sub_lines = log.read_text().strip().splitlines()
    assert len(sub_lines) == 1 and "-t 1-2" in sub_lines[0]
    assert "--sge-option-file" in sub_lines[0]


def test_array_train_e2e(tmp_path):
    """`train --array 2` end to end: L-BFGS-B (-i 2) with the distributed
    objective gives a model close to the local run's (the 6-digit
    snapshot perturbs the trajectory slightly, as in the reference)."""
    fq = os.path.join(FIX, "0.fq")

    def run(tag, extra):
        out1 = str(tmp_path / f"train.{tag}.model")
        r = subprocess.run(
            [sys.executable, "-m", "rnaelem_tpu_torch.cli", "train",
             "-f", fq, "-m", "(.*)", "--no-shuffle", "-i", "2",
             "--batch-size", "-1", "-w", "20", "-c", "8", "--device", "cpu",
             "--dtype", "float64", "--out1", out1, "--out3", "~NULL~"]
            + extra, env=_env(), capture_output=True, text=True,
            timeout=300, cwd=str(tmp_path))
        assert r.returncode == 0, r.stderr[-3000:]
        return out1, r.stderr

    local, _ = run("local", [])
    arr, err = run("arr", ["--array", "2", "--tmp", str(tmp_path / "tmp")])
    assert "considered BP (sum eff):" in err
    _, p_l = TIO.read_model(local, Lp=48, dtype="float64", device="cpu")
    _, p_a = TIO.read_model(arr, Lp=48, dtype="float64", device="cpu")
    np.testing.assert_allclose(p_a.lam.numpy(), p_l.lam.numpy(), atol=2e-3)
    np.testing.assert_allclose(p_a.singles.numpy(), p_l.singles.numpy(),
                               atol=2e-3)
