"""The comparison that decides ``correct``: what the timed path produced,
held against the plain reference (portbench/reference) at the timed sizes.

Training: the reference follows the trainer's first steps from the same
file and weights; the numbers compared are each step's loss, the first
gradient's norm and the parameters' change over the steps, the last two
by the worst leaf (singles, pairs, lambda).  Scan: the reference scans a
sample of the last call's reads drawn from the seed (a whole chunk, for
its E[N], and the call's longest read among them); the numbers compared
are the posteriors with the motif region's posterior gap, the
alignment's score gap and E[N]."""
from __future__ import annotations

import numpy as np
import torch

from .reference import scan_ref, train_ref
from .reference.io.fastq import FastqReader
from .reference.model import joint as RJ


def ref_config(conf: dict, Lp: int, dtype: str):
    keys = ("max_span", "max_iloop", "min_bpp", "tau", "rho_s", "rho_theta",
            "rho_lambda", "lambda_prior", "theta_softmax")
    return RJ.ModelConfig(pattern=conf["pattern"], Lp=Lp, dtype=dtype,
                          **{k: conf[k] for k in keys if k in conf})


def _np64(t):
    return np.asarray(t.detach().cpu().double().numpy(), np.float64)


def leaf_gap(prog, ref, leaves, keep=None):
    """max over the leaves of | |prog_leaf| - |ref_leaf| | / max(|ref_leaf|,
    the median leaf's |ref|)."""
    nr = {n: float(np.linalg.norm(ref[i])) for n, i in leaves.items()}
    med = float(np.median(list(nr.values())))
    gaps = [abs(float(np.linalg.norm(prog[i])) - nr[n]) / max(nr[n], med)
            if max(nr[n], med) > 0 else 0.0
            for n, i in leaves.items() if keep is None or n in keep]
    return max(gaps) if gaps else 0.0


def compare_train(prog: dict, ref: dict) -> dict:
    """{loss_gap, grad_gap, change_gap} of the program's first steps
    against the reference's; leaves whose reference gradient is under a
    thousandth of the median leaf's are left out of the change."""
    n = len(ref["fn"])
    fp, fr = np.asarray(prog["fn"][:n]), np.asarray(ref["fn"])
    loss = float(np.max(np.abs(fp - fr) / np.maximum(np.abs(fr), 1e-300)))
    leaves = ref["tables"]
    g_p, g_r = prog["gr"][0], ref["gr"][0]
    grad = leaf_gap(g_p, g_r, leaves)
    gn = {k: float(np.linalg.norm(g_r[i])) for k, i in leaves.items()}
    med = float(np.median(list(gn.values())))
    keep = {k for k, v in gn.items() if v >= 1e-3 * med}
    dx_p = prog["x"][n] - prog["x"][0]
    dx_r = ref["x"] - ref["x0"]
    change = leaf_gap(dx_p, dx_r, leaves, keep)
    if not np.all(np.isfinite(fp)):
        loss = float("inf")
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def follow_train(conf: dict, mix: dict, prog: dict, dev, dtype=None):
    """The reference's first steps of the program's run ``prog``
    (drive.run_adam's "program"): float64 unless ``dtype``."""
    cfg = ref_config(conf, prog["cfg"].Lp, dtype or "float64")
    return train_ref.follow(cfg, prog["fq"], _np64(prog["singles"]),
                            _np64(prog["pairs"]), len(prog["fn"]),
                            mix["batch"], conf["kmer_shuf"], dev,
                            prog["lambda_init"])


def check_train(conf, mix, prog, dev):
    return compare_train(prog, follow_train(conf, mix, prog, dev))


# ---------------------------------------------------------------- scan

def scan_sample(reads, mix: dict, seed: int, chunk: int = 64):
    """Indices of the compared reads: the call's smallest chunk of its
    widest bucket, whole (its E[N] is compared), and ``mix["sample"]``
    more of that bucket drawn from the seed, the bucket's longest read
    among the compared ones.  Returns (chunk indices, all indices)."""
    buckets = {}
    for i, (s, _) in enumerate(reads):
        buckets.setdefault(scan_ref.bucket_of(len(s)), []).append(i)
    idx = buckets[max(buckets)]
    chunks = [idx[k:k + chunk] for k in range(0, len(idx), chunk)]
    small = min(chunks, key=len)
    rest = [i for i in idx if i not in small]
    rng = np.random.Generator(np.random.PCG64([seed, 2]))
    extra = list(rng.choice(rest, size=min(mix["sample"], len(rest)),
                            replace=False)) if rest else []
    longest = max(idx, key=lambda i: len(reads[i][0]))
    if longest not in small and longest not in extra:
        extra[-1:] = [longest]
    return small, sorted(small + [int(i) for i in extra])


def compare_scan(prog_res, ref_out, en_prog, en_ref, path_gaps):
    """{post_gap, path_gap, en_gap}.  post_gap: the widest gap of a
    posterior (start, end, inner), and of the reference's posterior at the
    program's motif start Ys (end Ye) below its best: a sound argmax of
    posteriors that are each within e of the reference's lies within 2e.
    path_gap: the widest score gap of the program's alignment below the
    reference's best under the program's pins, an exact comparison (the
    CYK tables are the plain max DP's bit for bit, so the path the
    program traces scores the reference's maximum exactly, ties
    included).  en_gap: E[N]'s widest gap relative to the largest
    count."""
    post = 0.0
    for pr, rf in zip(prog_res, ref_out):
        Pys, Pye, Pyi, Ys, Ye, _ = pr
        for a, b in ((Pys, rf["Pys"]), (Pye, rf["Pye"]), (Pyi, rf["Pyi"])):
            a = np.asarray(a, np.float64)
            if a.shape != b.shape or not np.all(np.isfinite(a)):
                post = float("inf")
            else:
                post = max(post, float(np.max(np.abs(a - b))))
        post = max(post, float(rf["Pys"].max() - rf["Pys"][Ys])
                   if 0 <= Ys < len(rf["Pys"]) else float("inf"),
                   float(rf["Pye"].max() - rf["Pye"][Ye])
                   if 0 <= Ye < len(rf["Pye"]) else float("inf"))
    path = max([0.0] + [g for g in path_gaps])
    scale = max(float(np.max(np.abs(e))) for e in en_ref)
    en = max(float(np.max(np.abs(np.asarray(a, np.float64) - b)))
             for a, b in zip(en_prog, en_ref)) / max(scale, 1e-300)
    return {"post_gap": post, "path_gap": path, "en_gap": en}


def reference_scan(conf, prog, seed, mix, dev, dtype=None):
    """The reference's posteriors of the sampled reads of the program's
    last call: (reads, chunk indices, sample indices, per sampled read
    its posteriors and E[N], their masks by bucket, the configuration)."""
    reads = [(r.seq, r.qual) for r in FastqReader(prog["fq"]).reads()]
    small, idx = scan_sample(reads, mix, seed)
    cfg = ref_config(conf, prog["cfg"].Lp, dtype or "float64")
    p = [_np64(prog[k]) for k in ("singles", "pairs", "lam")]
    out, masks = scan_ref.posteriors(cfg, *p, [reads[i] for i in idx], dev)
    return reads, small, idx, out, masks, cfg


def judge_scan(ref, res, en_prog, prog, dev):
    """The numbers compared for the answers ``res`` (per sampled read:
    Pys, Pye, Pyi, Ys, Ye, (psihat, rss)) and the E[N] ``en_prog`` of the
    chunk: the reference's alignments under the answers' own pins, and
    for those that differ the reference's score gap of the answer's."""
    reads, small, idx, out, masks, cfg = ref
    p = [_np64(prog[k]) for k in ("singles", "pairs", "lam")]
    sample = [reads[i] for i in idx]
    pins = [(r[3], r[4]) for r in res]
    aln = scan_ref.align(cfg, *p, sample, pins, masks, dev)
    paths = [None] * len(res)
    for t, r in enumerate(res):
        if r[5] is not None and aln[t] is not None and (
                not np.array_equal(np.asarray(r[5][0]), aln[t][0])
                or r[5][1] != aln[t][1]):
            paths[t] = (np.asarray(r[5][0]), r[5][1])
    gaps = []
    if any(x is not None for x in paths):
        gaps = [g for g in scan_ref.path_gaps(cfg, *p, sample, pins, paths,
                                              masks, dev) if g is not None]
    pos = {i: t for t, i in enumerate(idx)}
    en_ref = [sum(out[pos[i]]["EN"][k] for i in small) for k in (0, 1)]
    if en_prog is None:
        en_prog = [np.full_like(e, np.inf) for e in en_ref]
    return compare_scan(res, out, en_prog, en_ref, gaps)


def check_scan(conf, mix, prog, seed, dev, ref=None):
    """The scan's numbers for the program's last call ``prog``
    (drive.run_scan's "program"); ``ref`` as reference_scan gives it."""
    ref = ref or reference_scan(conf, prog, seed, mix, dev)
    reads, small, idx = ref[:3]
    res = prog["results"]
    # the program's E[N] of that chunk (its chunks in the driver's order)
    en_prog = None
    Lmax = scan_ref.bucket_of(max(len(reads[i][0]) for i in small))
    for Lp, lengths, EN in prog["chunks"]:
        if Lp == Lmax and lengths == [len(reads[i][0]) for i in small]:
            en_prog = [_np64(EN.singles), _np64(EN.pairs)]
    return judge_scan(ref, [res[i] for i in idx], en_prog, prog, dev)


def free_program(dev):
    """Release what the program's state held before the reference runs."""
    import gc
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
