"""The frozen work counts against the bound column of PERF.md's kernel
table: K1-K7 at the main path's shapes (128 reads x 100 nt as bench.py
makes them, (.....), W=50, C=30, f32, column 75), with the masks from the
reference's plain path on the CPU."""
import numpy as np
import pytest
import torch

from portbench.reference.alphabet import seq_to_ints
from portbench.reference.model import joint as J
from portbench.reference.train import objective as OBJ
from portbench.work import counts as W


def _main_reads():
    rng = np.random.RandomState(0)
    reads = []
    for i in range(128):
        s = "".join("ACGU"[x] for x in rng.randint(0, 4, 100))
        q = np.full(101, 10 + (i % 3))
        q[-1] = 0
        reads.append((seq_to_ints(s), q))
    return reads


@pytest.fixture(scope="module")
def bounds_ms():
    torch.set_num_threads(4)
    cfg = J.ModelConfig(pattern="(.....)", Lp=100, max_span=50,
                        max_iloop=30, min_bpp=1e-4, tau=0.1, dtype="float32")
    k = J.kernels(cfg, "cpu")
    b = OBJ.stack_reads(cfg, _main_reads(), device="cpu")
    c = J._const_factors(cfg, k, b.sd, b.bp_ok)
    hc = W.host_consts(c)
    q = W.batch_counts(cfg, k.dp.st, hc, 128)
    work = W.column_work(cfg, k.dp.st, hc, q, 75, 4, ("weights", "lam"))
    work["score_tables"] = W.score_work(cfg, hc, k.tab, 128, 4)
    return {n: 1e3 * W.least_s(by, ops, "float32")
            for n, (by, ops) in work.items()}


@pytest.mark.parametrize("kernel,ms", [
    ("outside_ep", 0.0341), ("inside_ep", 0.0109), ("score_tables", 0.0177),
    ("inside_band", 0.0071), ("outside_band", 0.0213),
    ("outside_ext", 0.0007), ("inside_ext", 0.0002)])
def test_bound_column_of_the_kernel_table(bounds_ms, kernel, ms):
    assert bounds_ms[kernel] == pytest.approx(ms, rel=0.05, abs=5e-5)
