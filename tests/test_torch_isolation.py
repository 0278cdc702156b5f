"""The port stands alone: importing every module of rnaelem_tpu_torch (the
command line and parallel/ included) pulls in neither JAX nor the JAX
package, and its entry points run on CUDA unless the caller passes
device="cpu"."""
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import rnaelem_tpu_torch
from rnaelem_tpu_torch import cli as CLI
from rnaelem_tpu_torch.model import io as TIO
from rnaelem_tpu_torch.model import joint as TJ
from rnaelem_tpu_torch.model.convert import params_from_numpy
from rnaelem_tpu_torch.parallel import mesh as MESH
from rnaelem_tpu_torch.pipeline.ushuffle import negative_for
from rnaelem_tpu_torch.scan import scanner as SC
from rnaelem_tpu_torch.scan.driver import Scanner
from rnaelem_tpu_torch.train import objective as OBJ
from rnaelem_tpu_torch.train.trainer import Trainer

# the CPU path is many small torch ops: one thread per test process
# (xdist worker) keeps parallel workers from oversubscribing the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        rnaelem_tpu_torch.__path__, "rnaelem_tpu_torch."))


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "rnaelem_tpu_torch.ops.kernels" in mods and len(mods) >= 15
    for m in ("cli", "native", "pipeline.ushuffle", "train.optim",
              "train.trainer", "ops.linear", "scan.scanner", "scan.driver",
              "parallel.mesh", "parallel.arrayjob"):
        assert "rnaelem_tpu_torch." + m in mods
    code = ("import importlib, sys\n"
            "for m in %r:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'rnaelem_tpu' or "
            "k.startswith('rnaelem_tpu.'))\n"
            "print(bad)\n" % (mods,))
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def _entry_points():
    cfg = TJ.ModelConfig(pattern="(.)", Lp=12, max_span=12, max_iloop=4,
                         min_bpp=0.0)
    fix = os.path.join(ROOT, "tests", "fixtures", "0.model")
    norss = os.path.join(ROOT, "tests", "fixtures", "2.model")
    fq = os.path.join(ROOT, "tests", "fixtures", "0.fq")
    reads = [(np.array([1, 2, 3, 4, 1, 2]), np.full(7, 10))]
    return [
        ("init_params", lambda: TJ.init_params(
            TJ.kernels(cfg, "cpu").g, cfg)),
        ("kernels", lambda: TJ.kernels(cfg)),
        ("JointModel", lambda: TJ.JointModel(cfg)),
        ("read_model", lambda: TIO.read_model(fix, Lp=12)),
        ("params_from_numpy", lambda: params_from_numpy(
            np.zeros((2, 4)), np.zeros((1, 6)), np.ones(2))),
        ("stack_reads", lambda: OBJ.stack_reads(cfg, reads)),
        ("batch_fn_grad", lambda: OBJ.batch_fn_grad(
            cfg, TJ.init_params(TJ.kernels(cfg, "cpu").g, cfg, device="cpu"),
            OBJ.stack_reads(cfg, reads, device="cpu"))),
        ("batch_fn_grad_pr", lambda: OBJ.batch_fn_grad_pr(
            cfg, TJ.init_params(TJ.kernels(cfg, "cpu").g, cfg, device="cpu"),
            OBJ.stack_reads(cfg, reads, device="cpu"))),
        ("Trainer", lambda: Trainer(cfg, TJ.init_params(
            TJ.kernels(cfg, "cpu").g, cfg, device="cpu"))),
        ("eval_file", lambda: OBJ.eval_file(cfg, None, fq)),
        ("bpp_posterior", lambda: TJ.bpp_posterior(
            cfg, TJ.make_seqdata(cfg, reads[0][0]))),
        ("cli eval", lambda: CLI.main(["eval", "-f", fq, "-q", fix])),
        ("cli train", lambda: CLI.main(["train", "-f", fq, "-m", "(.)"])),
        ("Scanner", lambda: Scanner(cfg, TJ.init_params(
            TJ.kernels(cfg, "cpu").g, cfg, device="cpu"))),
        ("scan_posteriors_batch", lambda: SC.scan_posteriors_batch(
            cfg, TJ.init_params(TJ.kernels(cfg, "cpu").g, cfg, device="cpu"),
            TJ.stack_seqdata([TJ.make_seqdata(cfg, reads[0][0])], "cpu"))),
        ("cli scan", lambda: CLI.main(["scan", "-f", fq, "-q", norss])),
        ("init_group", lambda: MESH.init_group("file:///nonexistent", 1, 0)),
    ]


@pytest.mark.parametrize("name", [n for n, _ in _entry_points()])
def test_entry_points_default_to_cuda(name):
    """Without device= an entry point asks for CUDA: without a GPU it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    fn = dict(_entry_points())[name]
    with pytest.raises(RuntimeError, match="CUDA"):
        fn()


def test_negative_for_is_host_work():
    """The shuffled negatives are drawn on the host (the native walk): no
    device, and the same string for the same read and iteration."""
    s = "GGACUACGUAGCUAGCUAGGCAUCG"
    a = negative_for(s, 2, 3)
    assert a == negative_for(s, 2, 3) and sorted(a) == sorted(s)
