"""The control on the card (gpu marker; skips without one): the plain
reference put in the program's place and computed in the nearest
precision below the configuration's is read as not correct under the
cell's limits, at the cells' widths on fewer reads (readings.py reads it
at the cells' own sizes).  Run on the card with

    python3 -m pytest --noconftest -m gpu portbench/tests -q
"""
import json
import shutil
import tempfile

import pytest
import torch

from portbench import check as CHK
from portbench import readings as RD
from portbench import run as R

SPEC = json.load(open(R.os.path.join(R.ROOT, "BENCHMARK.json")))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    R.cache_env()
    torch.backends.cuda.matmul.allow_tf32 = False


def _over(checks, limits):
    return [k for k in limits if not checks[k] <= limits[k]["limit"]]


@pytest.mark.gpu
def test_training_control_fails_a_limit():
    _card()
    w, conf, mix, limits = R.cell(SPEC, "hairpin7.adam")
    mix = dict(mix, reads=256)
    tmp = tempfile.mkdtemp()
    try:
        prog = RD.program_run("adam", conf, mix, 2 ** 31 + 5, "cuda", tmp)
        CHK.free_program("cuda")
        ref = CHK.follow_train(conf, mix, prog, "cuda")
        assert not _over(CHK.compare_train(prog, ref), limits)
        assert _over(RD.control_train(conf, mix, prog, ref, "cuda"), limits)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


@pytest.mark.gpu
def test_scan_control_fails_a_limit():
    _card()
    w, conf, mix, limits = R.cell(SPEC, "insert11.scan")
    mix = dict(mix, reads=128, sample=2)
    seed = 2 ** 31 + 6
    tmp = tempfile.mkdtemp()
    try:
        prog = RD.program_run("scan", conf, mix, seed, "cuda", tmp)
        CHK.free_program("cuda")
        ref = CHK.reference_scan(conf, prog, seed, mix, "cuda")
        assert not _over(CHK.check_scan(conf, mix, prog, seed, "cuda", ref),
                         limits)
        assert _over(RD.control_scan(conf, mix, prog, seed, "cuda", ref),
                     limits)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
