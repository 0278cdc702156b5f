"""The port's training path against the JAX package on the CPU (f64):
per-read gradients, the shuffled negatives and gen-neg, the Trainer
(Adam over shuffled negatives, --no-shuffle L-BFGS-B, frozen parameters,
length buckets) and the train command line."""
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rnaelem_tpu import cli as JCLI
from rnaelem_tpu.alphabet import seq_to_ints
from rnaelem_tpu.model import io as JIO
from rnaelem_tpu.model import joint as JJ
from rnaelem_tpu.pipeline import ushuffle as JU
from rnaelem_tpu.train import objective as JO
from rnaelem_tpu.train.trainer import Trainer as JTrainer
from rnaelem_tpu_torch import cli as TCLI
from rnaelem_tpu_torch.model import io as TIO
from rnaelem_tpu_torch.model import joint as TJ
from rnaelem_tpu_torch.model.convert import params_from_numpy
from rnaelem_tpu_torch.pipeline import ushuffle as TU
from rnaelem_tpu_torch.train import objective as TO
from rnaelem_tpu_torch.train.trainer import Trainer as TTrainer

# the CPU path is many small torch ops: one thread per test process
# (xdist worker) keeps parallel workers from oversubscribing the cores
torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
ROOT = os.path.dirname(HERE)
NAMES = ("singles", "pairs", "lam")


# ------------------------------------------------------ per-read gradients

def _pr_setup(pattern, seed=2, **opts):
    kw = dict(pattern=pattern, Lp=32, max_span=16, max_iloop=8,
              min_bpp=1e-4, tau=0.1, dtype="float64")
    kw.update(opts)
    cj, ct = JJ.ModelConfig(**kw), TJ.ModelConfig(**kw)
    rng = np.random.RandomState(seed)
    reads = []
    for i, L in enumerate((32, 23, 4, 27)):
        s = "".join("ACGU"[c] for c in rng.randint(0, 4, L))
        q = rng.randint(0, 40, L + 1)
        q[-1] = 0 if i != 1 else 5
        reads.append((seq_to_ints(s), q))
    negs = [seq_to_ints("".join("ACGU"[c] for c in rng.randint(0, 4, 30)))]
    pj = JJ.init_params(JJ.kernels(cj).g, cj, jnp.float64)
    pj = pj._replace(
        singles=pj.singles + jnp.asarray(0.3 * rng.randn(*pj.singles.shape)),
        pairs=pj.pairs + jnp.asarray(0.3 * rng.randn(*pj.pairs.shape)),
        lam=jnp.asarray([0.7, 1.3]))
    pt = params_from_numpy(np.asarray(pj.singles), np.asarray(pj.pairs),
                           np.asarray(pj.lam), device="cpu")
    bj = JO.stack_reads(cj, reads, negs)
    # both sides on the JAX package's masks (the port's own are held to
    # them in test_torch_bpp)
    masks = (torch.as_tensor(np.array(bj.bp_ok)),
             torch.as_tensor(np.array(bj.eff)))
    bt = TO.stack_reads(ct, reads, negs, device="cpu",
                        bp_fn=lambda cfg, sd, dev: masks)
    return cj, ct, pj, pt, bj, bt


@pytest.mark.parametrize("pattern,lik_ratio,opts", [
    ("(.*)", False, {}), ("(.*)", True, {}),
    ("..*..", False, dict(no_rss=True))], ids=["rss", "lik_ratio", "no_rss"])
def test_batch_fn_grad_pr_matches_jax(pattern, lik_ratio, opts):
    """f, eff and every gradient leaf per read to 1e-9 relative; their
    read-order sum equals batch_fn_grad."""
    cj, ct, pj, pt, bj, bt = _pr_setup(pattern, **opts)
    fj, gj, ej = JO.batch_fn_grad_pr(cj, pj, bj, lik_ratio)
    ft, gt, et = TO.batch_fn_grad_pr(ct, pt, bt, lik_ratio, device="cpu")
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-12)
    for name, a, b in zip(NAMES, gt, gj):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, name
        assert not np.isnan(a).any(), name
        for r in range(a.shape[0]):
            scale = max(1.0, float(np.abs(b[r]).max()))
            assert np.abs(a[r] - b[r]).max() <= 1e-9 * scale, (name, r)
    fn, gsum, eff = TO.reduce_per_read(ft, gt, et)
    fb, gb, eb = TO.batch_fn_grad(ct, pt, bt, lik_ratio, device="cpu")
    assert fn == pytest.approx(float(fb), rel=1e-12)
    assert eff == pytest.approx(float(eb), rel=1e-12)
    for name, a, b in zip(NAMES, gsum, gb):
        scale = max(1.0, float(b.abs().max()))
        assert np.abs(a - b.numpy()).max() <= 1e-12 * scale, name


# ------------------------------------------------------------- negatives

@pytest.mark.parametrize("k", [2, 3])
def test_negative_for_matches_jax(k):
    rng = np.random.RandomState(k)
    for n in range(50):
        s = "".join("ACGU"[c] for c in rng.randint(0, 4, 20 + n))
        for it in range(4):
            got = TU.negative_for(s, k, it)
            assert got == JU.negative_for(s, k, it)
            assert sorted(got) == sorted(s)
            kl = lambda x: sorted(x[i:i + k] for i in range(len(x) - k + 1))
            assert kl(got) == kl(s)


def test_negative_for_edge_cases_match_jax():
    """Short reads, k = 1 (a plain shuffle) and k at or past the length
    (the read itself): the same strings as the JAX package."""
    for s in ("", "A", "AC", "ACG", "GGGGCCCC", "ACGUACGUAC"):
        for k in (1, 2, 3, 10, 12):
            for it in range(2):
                got = TU.negative_for(s, k, it)
                assert got == JU.negative_for(s, k, it), (s, k, it)
                assert sorted(got) == sorted(s)


# ---------------------------------------------------------------- trainer

@pytest.fixture(scope="module")
def toy_fq(tmp_path_factory):
    """The 6 tRNA reads of test_trainer_smoke.py (flat quality, positive
    sentinel), cut to 48 nt to keep the CPU runs short."""
    path = tmp_path_factory.mktemp("fq") / "toy.fq"
    seqs = []
    with open(os.path.join(HERE, "fixtures", "material",
                           "positive.fa")) as f:
        for line in f:
            if not line.startswith(">"):
                seqs.append(line.strip())
            if len(seqs) >= 6:
                break
    with open(path, "w") as f:
        for i, s in enumerate(seqs[:6]):
            s = s.replace("T", "U")[:48]
            f.write(f"@r{i}\n{s}\n+\n{'+' * len(s)}!\n")
    return str(path)


def _mixed_fq(path, lens=(14, 18, 20, 44, 15, 41), seed=5):
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for i, L in enumerate(lens):
            s = "".join("ACGU"[c] for c in rng.randint(0, 4, L))
            f.write(f"@r{i}\n{s}\n+\n{'+' * L}!\n")
    return str(path)


def _train_both(fq, pattern, Lp, **kw):
    """Train the JAX and the port Trainer from the same flat start; the
    parameter vector of every evaluation, the final one and the interim
    text of each."""
    base = dict(pattern=pattern, Lp=Lp, max_span=16, max_iloop=8,
                min_bpp=1e-4, tau=0.1, rho_theta=0.1, rho_lambda=0.1,
                dtype="float64")
    out = []
    for J, T, dev in ((JJ, JTrainer, None), (TJ, TTrainer, "cpu")):
        cfg = J.ModelConfig(**base)
        if dev is None:
            params = J.init_params(J.kernels(cfg).g, cfg, np.float64)
            extra = {}
        else:
            params = J.init_params(J.kernels(cfg, dev).g, cfg, device=dev)
            extra = dict(device=dev)
        interim = io.StringIO()
        tr = T(cfg, params, interim_out=interim, **kw, **extra)
        tr.set_fq(fq)
        xs, obj = [], tr._objective

        def rec(x, it, obj=obj, xs=xs):
            xs.append(np.array(x))
            return obj(x, it)

        tr._objective = rec
        p = tr.train()
        out.append((xs, J.pack_params(tr.g, p), interim.getvalue(), tr))
    return out


def _close(a, b, rel):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x, float), np.asarray(y, float)
        assert np.abs(x - y).max() <= rel * max(1.0, np.abs(y).max())


def test_trainer_adam_matches_jax(toy_fq):
    """Adam over shuffled negatives, 3 iterations of 3 reads + 3
    negatives (the third starts a new epoch): the parameter vector after
    each step to 1e-9 relative, the interim (epoch-end) lines equal."""
    (xj, pj, ij, _), (xt, pt, it, _) = _train_both(
        toy_fq, "(.....)", 48, max_iter=3, lambda_init=0.1, batch_size=3)
    assert len(xt) == 3
    _close(xt + [pt], xj + [pj], 1e-9)
    assert it == ij and it.count("interim") == 1


def test_trainer_lbfgsb_matches_jax(toy_fq):
    """--no-shuffle L-BFGS-B over the whole file, 3 iterations: every
    evaluated vector and the best one to 1e-6."""
    (xj, pj, ij, _), (xt, pt, it, _) = _train_both(
        toy_fq, "(.....)", 48, max_iter=3, batch_size=-1, no_shuffle=True)
    assert len(xt) >= 3
    _close(xt + [pt], xj + [pj], 1e-6)
    assert it.count("interim") == len(xt) - 1


def test_trainer_mask_indices_frozen(toy_fq):
    """--param-set: only the chosen indices move (both packages alike),
    one Adam step."""
    keep = [0, 1, 2, 3, 20, 21]
    (xj, pj, _, _), (xt, pt, _, _) = _train_both(
        toy_fq, "(.....)", 48, max_iter=1, lambda_init=0.1, batch_size=3,
        mask_indices=keep)
    _close(xt + [pt], xj + [pj], 1e-9)
    frozen = np.ones(len(pt), bool)
    frozen[keep] = False
    np.testing.assert_array_equal(pt[frozen], xt[0][frozen])
    assert np.abs(pt[~frozen] - xt[0][~frozen]).max() > 0


def test_trainer_length_buckets_match_jax(tmp_path):
    """Mixed lengths train through the 32 and 48 buckets (one batch
    each), as the JAX package's bucketed run does, to the same
    parameters."""
    fq = _mixed_fq(tmp_path / "mixed.fq")
    (xj, pj, _, _), (xt, pt, _, tt) = _train_both(
        fq, "(.....)", 48, max_iter=2, batch_size=3, kmer_shuf=2)
    _close(xt + [pt], xj + [pj], 1e-9)
    lps = sorted(k[0] for k in tt._bp_cache._d)
    assert lps[0] == 32 and lps[-1] == 48


def test_cli_train_writes_a_model(toy_fq, tmp_path):
    """python -m rnaelem_tpu_torch.cli train --device cpu writes a model
    that read_model loads back, and its gen-neg output is the JAX CLI's
    byte for byte."""
    out1 = tmp_path / "m.model"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "rnaelem_tpu_torch.cli", "train", "-f",
         toy_fq, "-m", "..._...", "-i", "2", "--batch-size", "3",
         "--out1", str(out1), "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=600)
    assert r.returncode == 0, r.stderr
    for line in ("motif pattern:", "considered BP:", "iter: 1 , y: ",
                 "wall clock time per eval:"):
        assert line in r.stderr, line
    cfg, p = TIO.read_model(str(out1), Lp=48, device="cpu")
    assert cfg.no_rss and cfg.pattern == "......."
    assert all(torch.isfinite(x).all() for x in p)
    assert float(p.lam.min()) >= 0


def test_gen_neg_matches_jax_cli(toy_fq, tmp_path):
    a, b = tmp_path / "t.txt", tmp_path / "j.txt"
    TCLI.main(["gen-neg", "-f", toy_fq, "-i", "3", "--kmer-shuf", "3",
               "--out1", str(a)])
    JCLI.do_genneg(JCLI.build_parser().parse_args(
        ["gen-neg", "-f", toy_fq, "-i", "3", "--kmer-shuf", "3",
         "--out1", str(b)]))
    assert a.read_bytes() == b.read_bytes()
    assert a.read_text().count(">iter:") == 18
