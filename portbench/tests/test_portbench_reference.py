"""The reference's pieces that stand apart from the port's code: the
Python k-let shuffle against the port's native walk, and the plain
reference against the port's plain path (the same arithmetic, so the
same bits at f64 on the CPU)."""
import random

import numpy as np
import torch

from portbench.reference import shuffle
from portbench.reference.model import joint as RJ
from portbench.reference.train import objective as ROBJ


def test_shuffle_equals_the_native_walk():
    from rnaelem_tpu_torch.pipeline.ushuffle import negative_for
    r = random.Random(7)
    for _ in range(200):
        s = "".join(r.choice("ACGU") for _ in range(r.randint(1, 130)))
        for k in (1, 2, 3):
            it = r.randint(0, 10 ** 7)
            assert shuffle.negative_for(s, k, it) == negative_for(s, k, it)


def test_mt19937_64_first_output():
    # the C++ standard's 10000th output of a default-seeded mt19937_64
    rng = shuffle.MT19937_64(5489)
    for _ in range(9999):
        rng()
    assert rng() == 9981545732273789042


def test_plain_reference_equals_the_ports_plain_path():
    from rnaelem_tpu_torch.model import joint as J
    from rnaelem_tpu_torch.train import objective as OBJ
    torch.set_num_threads(2)
    rng = np.random.default_rng(3)
    rows = [(rng.integers(1, 5, rng.integers(20, 31)).astype(np.int32),)
            for _ in range(4)]
    reads = [(s, np.r_[np.full(len(s), 10), 0]) for (s,) in rows]
    out = []
    for JJ, O in ((RJ, ROBJ), (J, OBJ)):
        cfg = JJ.ModelConfig(pattern="(...)", Lp=32, max_span=16,
                             max_iloop=8)
        p = JJ.init_params(JJ.kernels(cfg, "cpu").g, cfg, device="cpu")
        b = O.stack_reads(cfg, reads[:2], [s for s, _ in reads[2:]],
                          device="cpu")
        out.append(O.batch_fn_grad_pr(cfg, p, b, device="cpu"))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)
