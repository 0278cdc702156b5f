"""The port's data parallelism (rnaelem_tpu_torch/parallel/mesh.py) on the
CPU: two gloo ranks, each a subprocess joined through a file store under
the test's own directory, against one rank and against the JAX package
(the ports of test_mesh_parallel, test_mesh_trainer and
test_multiprocess).

Every sum over a read's own cells runs in a fixed order (ops/dp.py
read_sum), so a read's outputs have the same bits in any batch and two
ranks are bitwise one rank, here as on the card (chip_smoke N2).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rnaelem_tpu.alphabet import seq_to_ints
from rnaelem_tpu.model import joint as JJ
from rnaelem_tpu.train import objective as JO
from rnaelem_tpu_torch.model import joint as TJ
from rnaelem_tpu_torch.model.convert import params_from_numpy
from rnaelem_tpu_torch.ops import dp as DP
from rnaelem_tpu_torch.parallel import mesh as MESH
from rnaelem_tpu_torch.train import objective as TO
from rnaelem_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TIMEOUT = 300
CFG = dict(pattern="(...)", Lp=24, max_span=12, max_iloop=8, min_bpp=1e-4,
           tau=0.1, dtype="float64")

# one rank: the batch's rows from the inputs file, the sharded per-read
# step, fn+grad and masks, each gathered or reduced over the group
WORKER = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from rnaelem_tpu_torch.model import joint as J
from rnaelem_tpu_torch.model.convert import params_from_numpy
from rnaelem_tpu_torch.parallel import mesh as MESH
from rnaelem_tpu_torch.train import objective as O
store, rank, inputs, out = sys.argv[1:]
z = np.load(inputs)
cfg = J.ModelConfig(**{k: z["cfg_" + k].item() for k in %r})
reads = [(z["seq%%d" %% i], z["q%%d" %% i]) for i in range(int(z["n_reads"]))]
negs = [z["neg%%d" %% i] for i in range(int(z["n_negs"]))]
params = params_from_numpy(z["singles"], z["pairs"], z["lam"], device="cpu")
g = MESH.init_group("file://" + store, 2, int(rank), device="cpu")
try:
    rows = O.host_rows(cfg, reads, negs)
    f, gr, eff = MESH.make_sharded_per_read(cfg, g)(params, rows)
    fn, gs, es = MESH.make_sharded_fn_grad(cfg, g)(params, rows)
    keep, me = MESH.make_sharded_bp_masks(cfg, g)(cfg, rows.sds)
    np.savez(out, f=f.numpy(), eff=eff.numpy(), fn=fn.numpy(),
             es=es.numpy(), keep=keep.numpy(), me=me.numpy(),
             **{"g_" + k: x.numpy() for k, x in zip(J.Params._fields, gr)},
             **{"s_" + k: x.numpy() for k, x in zip(J.Params._fields, gs)})
finally:
    g.close()
""" % (tuple(CFG),)


def _env():
    return dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")


def _run_ranks(cmds, cwd):
    """Start every rank, wait for all with a timeout, kill the rest when
    one fails; returns each rank's stderr."""
    procs = [subprocess.Popen(c, cwd=cwd, env=_env(),
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            errs.append(err)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return errs


def _inputs(n_reads, n_negs, seed=3):
    """Reads (flagged and not), shuffled-negative-like rows and non-flat
    weights, from a numpy seed."""
    rng = np.random.RandomState(seed)
    reads = []
    for i in range(n_reads):
        L = int(rng.randint(CFG["Lp"] - 6, CFG["Lp"] - 1))
        s = "".join("ACGU"[c] for c in rng.randint(0, 4, L))
        q = rng.randint(5, 30, L + 1)
        q[-1] = 0 if i % 2 == 0 else 5
        reads.append((seq_to_ints(s), q))
    negs = [seq_to_ints("".join("ACGU"[c] for c in rng.randint(0, 4, 20)))
            for _ in range(n_negs)]
    cj = JJ.ModelConfig(**CFG)
    p = JJ.init_params(JJ.kernels(cj).g, cj, jnp.float64)
    w = dict(singles=np.asarray(p.singles) + 0.3 * rng.randn(
        *p.singles.shape), pairs=np.asarray(p.pairs) + 0.3 * rng.randn(
        *p.pairs.shape), lam=np.array([0.7, 1.3]))
    return reads, negs, w


@pytest.fixture(scope="module", params=[(6, 2), (4, 1)], ids=["8rows",
                                                              "5rows"])
def two_ranks(request, tmp_path_factory):
    """Both ranks' gathered outputs for 8 rows (6 reads + 2 negatives)
    and 5 (4 + 1, padded to 6)."""
    n_reads, n_negs = request.param
    tmp = tmp_path_factory.mktemp("mesh")
    reads, negs, w = _inputs(n_reads, n_negs)
    arrs = {"cfg_" + k: np.array(v) for k, v in CFG.items()}
    arrs.update({"seq%d" % i: s for i, (s, _) in enumerate(reads)})
    arrs.update({"q%d" % i: q for i, (_, q) in enumerate(reads)})
    arrs.update({"neg%d" % i: s for i, s in enumerate(negs)})
    np.savez(tmp / "inputs.npz", n_reads=len(reads), n_negs=len(negs),
             **arrs, **w)
    _run_ranks([[sys.executable, "-c", WORKER, str(tmp / "store"), str(r),
                 str(tmp / "inputs.npz"), str(tmp / ("out%d.npz" % r))]
                for r in range(2)], str(tmp))
    outs = [dict(np.load(tmp / ("out%d.npz" % r))) for r in range(2)]
    for k in outs[0]:
        assert np.array_equal(outs[0][k], outs[1][k]), k
    cfg = TJ.ModelConfig(**CFG)
    params = params_from_numpy(w["singles"], w["pairs"], w["lam"],
                               device="cpu")
    rows = TO.host_rows(cfg, reads, negs)
    return dict(out=outs[0], cfg=cfg, params=params, rows=rows,
                reads=reads, negs=negs, w=w)


def _per_read(cfg, params, rows):
    f, g, e = TO.batch_fn_grad_pr(cfg, params, TO.device_batch(
        cfg, rows, device="cpu"), device="cpu")
    return {"f": f.numpy(), "eff": e.numpy(),
            **{"g_" + k: x.numpy() for k, x in zip(TJ.Params._fields, g)}}


def _rel(a, b):
    return float(np.abs(a - b).max() / max(1e-300, np.abs(b).max()))


def test_two_ranks_gather_each_shard_exactly(two_ranks):
    """The gathered per-read f, gradient leaves and eff are the bits of
    each rank's shard (padding rows trimmed, rank order = read order)."""
    t = two_ranks
    n = len(t["rows"].valid)
    shards = [MESH._shard(t["rows"], MESH.DataGroup(r, 2, torch.device(
        "cpu"), "gloo", None)) for r in range(2)]
    assert sum(v for s in shards for v in s.valid) == n
    parts = [_per_read(t["cfg"], t["params"], s) for s in shards]
    for k, v in t["out"].items():
        if k == "f" or k == "eff" or k.startswith("g_"):
            ref = np.concatenate([p[k] for p in parts])[:n]
            assert np.array_equal(v, ref), k


def test_two_ranks_match_one_rank_and_jax(two_ranks):
    """Per read, the two ranks' f, every gradient leaf and eff: bitwise
    equal to one rank's batch_fn_grad_pr over the whole batch, and within
    1e-9 of JAX's batch_fn_grad_pr on the same batch and masks."""
    t = two_ranks
    one = _per_read(t["cfg"], t["params"], t["rows"])
    for k, v in one.items():
        assert t["out"][k].shape == v.shape, k
        assert np.array_equal(t["out"][k], v), k
    cj = JJ.ModelConfig(**CFG)
    masks = TO.device_batch(t["cfg"], t["rows"], device="cpu")
    bj = JO.stack_reads(cj, t["reads"], t["negs"], bp_fn=lambda c, sd: (
        jnp.asarray(masks.bp_ok.numpy()), jnp.asarray(masks.eff.numpy())))
    pj = JJ.Params(*[jnp.asarray(t["w"][k]) for k in JJ.Params._fields])
    fj, gj, ej = JO.batch_fn_grad_pr(cj, pj, bj)
    assert _rel(t["out"]["f"], np.asarray(fj)) <= 1e-9
    assert _rel(t["out"]["eff"], np.asarray(ej)) <= 1e-9
    for k, x in zip(JJ.Params._fields, gj):
        assert _rel(t["out"]["g_" + k], np.asarray(x)) <= 1e-9, k


def test_psum_grad_equals_single_device(two_ranks):
    """make_sharded_fn_grad's all_reduce over two ranks: fn, every
    gradient leaf and eff within 1e-10 of batch_fn_grad on one device."""
    t = two_ranks
    fn, g, eff = TO.batch_fn_grad(t["cfg"], t["params"], TO.device_batch(
        t["cfg"], t["rows"], device="cpu"), device="cpu")
    o = t["out"]
    assert float(o["fn"]) == pytest.approx(float(fn), rel=1e-10)
    assert float(o["es"]) == pytest.approx(float(eff), rel=1e-10)
    for k, x in zip(TJ.Params._fields, g):
        np.testing.assert_allclose(o["s_" + k], x.numpy(), rtol=1e-10,
                                   atol=1e-12)


def test_sharded_bp_masks_equal_batch_masks(two_ranks):
    """make_sharded_bp_masks over two ranks: the min-BPP masks and eff of
    one batch_bp_masks over every read."""
    t = two_ranks
    keep, eff = TO.batch_bp_masks(t["cfg"], TJ.stack_seqdata(
        t["rows"].sds, "cpu"), "cpu")
    assert np.array_equal(t["out"]["keep"], keep.numpy())
    assert np.array_equal(t["out"]["me"], eff.numpy())
    # min_bpp pruned some candidate pairs of every read
    assert keep.any() and bool((eff < 1).all())


@pytest.mark.parametrize("B", [1, 3, 5, 8])
def test_row_scale_cotangent_is_batch_invariant(B):
    """The P stage's per-(w, read) factor (ops/dp.py _RowScale): its
    cotangents are the same bits for the first read in a batch of B as
    alone.  torch's own sum over t (the backward of the broadcast product
    it replaces) is not on the CPU: with x [13, 18, B] and B from 2 to 16
    it changes the first read's last bits for most seeds, and it changed
    d bg2 of the (...) model between batches of 5 and 3 reads."""
    rng = np.random.RandomState(B)
    x, g = (torch.tensor(rng.randn(13, 18, B)) for _ in range(2))
    l, r = torch.tensor(rng.randn(13, B)), torch.tensor(rng.randn(B))

    def grads(n):
        xs, ls, rs = (v[..., :n].clone().requires_grad_(True)
                      for v in (x, l, r))
        y = DP._RowScale.apply(xs, ls, rs)
        return torch.autograd.grad(y, (xs, ls, rs), g[..., :n])

    for a, b in zip(grads(B), grads(1)):
        assert torch.equal(a[..., :1], b)
    # the same function as the broadcast product it replaces
    xs, ls, rs = (v.clone().requires_grad_(True) for v in (x, l, r))
    y = xs * torch.exp(ls + rs[None])[:, None, :]
    for a, b in zip(torch.autograd.grad(y, (xs, ls, rs), g),
                    grads(B)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-13)


def test_padded_batch_rows_are_inert():
    """pad_batch's rows (L=1, invalid) change neither fn nor any gradient
    (within 1e-12) and get empty masks."""
    cfg = TJ.ModelConfig(**CFG)
    reads, negs, w = _inputs(5, 0)
    params = params_from_numpy(w["singles"], w["pairs"], w["lam"],
                               device="cpu")
    rows = TO.host_rows(cfg, reads)
    padded = MESH.pad_batch(rows, 8)
    assert len(padded.valid) == 8 and padded.valid[5:] == [False] * 3
    assert MESH.pad_batch(padded, 8) is padded
    b1 = TO.device_batch(cfg, rows, device="cpu")
    b2 = TO.device_batch(cfg, padded, device="cpu")
    assert not b2.bp_ok[5:].any() and float(b2.eff[5:].abs().sum()) == 0
    fn1, gr1, _ = TO.batch_fn_grad(cfg, params, b1, device="cpu")
    fn2, gr2, _ = TO.batch_fn_grad(cfg, params, b2, device="cpu")
    assert float(fn2) == pytest.approx(float(fn1), rel=1e-12)
    for a, b in zip(gr1, gr2):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-12,
                                   atol=1e-14)


def test_group_device_reaches_trainer_and_step(tmp_path, monkeypatch):
    """init_group gives the rank its device as a torch.device, and the
    Trainer and the sharded step hand that same device to
    batch_fn_grad_pr."""
    g = MESH.init_group("file://" + str(tmp_path / "store"), 1, 0,
                        device="cpu")
    try:
        assert g.device == torch.device("cpu") and g.backend == "gloo"
        assert isinstance(g.device, torch.device)
        cfg = TJ.ModelConfig(**CFG)
        reads, negs, w = _inputs(3, 1)
        params = params_from_numpy(w["singles"], w["pairs"], w["lam"],
                                   device="cpu")
        tr = Trainer(cfg, params, group=g)
        assert isinstance(tr.device, torch.device) and tr.device == g.device
        seen = []
        real = TO.batch_fn_grad_pr

        def spy(cfg_, p, batch, lik_ratio=False, device=None):
            seen.append(device)
            return real(cfg_, p, batch, lik_ratio, device)

        monkeypatch.setattr(TO, "batch_fn_grad_pr", spy)
        f, _, _ = tr._funcs_for(cfg)(params, TO.host_rows(cfg, reads, negs))
        assert len(f) == 4 and isinstance(seen[0], torch.device)
        assert seen == [g.device]
    finally:
        g.close()


# ------------------------------------------------------- the train command

def _write_fq(path, n, L, seed=7):
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for i in range(n):
            s = "".join("ACGU"[c] for c in rng.randint(0, 4, L))
            qual = "".join(chr(33 + int(q)) for q in rng.randint(5, 25, L))
            sentinel = "!" if i % 2 == 0 else chr(33 + 5)
            f.write(f"@r{i}\n{s}\n+\n{qual}{sentinel}\n")


def _train_cmd(fq, out1, extra):
    return [sys.executable, "-m", "rnaelem_tpu_torch.cli", "train", "-f", fq,
            "-m", "(...)", "-i", "3", "--batch-size", "8", "-w", "12", "-c",
            "8", "-p", "0", "--device", "cpu", "--dtype", "float64",
            "--out1", out1, "--out3", "~NULL~"] + extra


def test_train_two_processes_and_mesh_byte_identical(tmp_path):
    """`train` as two processes joined by --coordinator (a file store),
    and as one command with --mesh 2, each write the model of --mesh 0
    byte for byte; rank 0 names the group on stderr."""
    fq = str(tmp_path / "train.fq")
    _write_fq(fq, 8, 14)
    out = {k: str(tmp_path / ("%s.model" % k))
           for k in ("single", "multi", "mesh")}
    _run_ranks([_train_cmd(fq, out["single"], ["--mesh", "0"])],
               str(tmp_path))
    coord = "file://" + str(tmp_path / "store")
    errs = _run_ranks([_train_cmd(fq, out["multi"], [
        "--coordinator", coord, "--num-processes", "2", "--process-id",
        str(r)]) for r in range(2)], str(tmp_path))
    assert "mesh: 2 ranks (data-parallel), backend gloo, devices cpu cpu" \
        in errs[0]
    (err,) = _run_ranks([_train_cmd(fq, out["mesh"], ["--mesh", "2"])],
                        str(tmp_path))
    assert "mesh: 2 ranks" in err
    single = open(out["single"], "rb").read()
    assert b"pattern" in single and len(single) > 100
    assert open(out["multi"], "rb").read() == single
    assert open(out["mesh"], "rb").read() == single
