"""Command line of the port: ``python -m rnaelem_tpu_torch.cli <mode>``.

Modes of the rnaelem binary (application.hpp:76-301, main.cpp:20-163):

* ``normal`` (the default): ``train``, then ``scan`` the same FASTQ file
  with the trained model, the records to --out2 (JAX cli.py do_train
  with also_scan);
* ``train``: learn a motif model from a FASTQ file (Adam over minibatches
  with k-let shuffled negatives, or L-BFGS-B over the whole file with
  --no-shuffle); the model goes to --out1, interim snapshots to --out3;
* ``eval``: the objective's value over a FASTQ file (motif_eval.hpp:23-54,
  no shuffle) to --out1 as ``fn: %.17g`` and its gradient, in the
  reference's parameter order, to --out2 as ``gr: [...]``;
* ``scan``: scan a FASTQ file with a model (-q): the 10-line record of
  every read (motif start/end/inner posteriors, the Viterbi motif path
  psihat and structure rss, region, exist prob) to --out1 and the E[N]
  line to stderr (motif_scanner.hpp);
* ``gen-neg``: the shuffled negatives the trainer draws, -i iterations
  of the whole file, as FASTA to --out1.

Models are read with Lp rounded up from the file's longest read.  Work
runs on CUDA unless --device says otherwise.  Training and evaluation
default to float32 on CUDA; scanning (``scan`` and the scan half of
``normal``) defaults to float64 everywhere: the reference scans in
double, and at float32 the posterior lines below about e^-87 miss it.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

LATER = "--array, --mesh and 'array-eval' wait for the multi-GPU port"


def _round_up(n, m=16):
    return ((n + m - 1) // m) * m


def _fq_maxlen(path):
    from .io.fastq import FastqReader
    return max((len(r.seq) for r in FastqReader(path).reads()), default=16)


def _out_stream(name):
    if name == "~COUT~":
        return sys.stdout
    if name == "~CERR~":
        return sys.stderr
    if name == "~NULL~":
        import os
        return open(os.devnull, "w")
    return open(name, "w")


def _close(o):
    if o not in (sys.stdout, sys.stderr):
        o.close()


def build_parser():
    p = argparse.ArgumentParser(
        prog="rnaelem-torch",
        description="RNA sequence-structure motif learning (PyTorch/CUDA). "
                    "Not ported yet: " + LATER + ".")
    p.add_argument("mode", nargs="?", default="normal",
                   choices=["normal", "train", "eval", "scan", "gen-neg"])
    p.add_argument("-f", "--fastq", dest="seq_fname", required=True)
    p.add_argument("-m", "--motif-pattern", dest="pattern",
                   default="~NONE~")
    p.add_argument("-q", "--motif-model", dest="model_fname",
                   default="~NONE~")
    p.add_argument("-i", "--max-iter", type=int, default=100)
    p.add_argument("--out1", default="~COUT~")
    p.add_argument("--out2", default="~COUT~")
    p.add_argument("--out3", default="~COUT~")
    p.add_argument("--energy-param", dest="ene_param", default="~T2004~")
    p.add_argument("-w", "--max-span", type=int, default=50)
    p.add_argument("-c", "--max-internal-loop", type=int, default=30)
    p.add_argument("--epsilon", type=float, default=1e-5)
    p.add_argument("--rho-s", type=float, default=1e-1)
    p.add_argument("--rho-theta", type=float, default=1e-1)
    p.add_argument("--rho-lambda", type=float, default=1e-1)
    p.add_argument("--tau", type=float, default=1e-1)
    p.add_argument("--lambda-init", type=float, default=0.0)
    p.add_argument("--lambda-prior", type=float, default=0.0)
    p.add_argument("-p", "--min-bpp", type=float, default=1e-4)
    p.add_argument("--param-set", default="")
    p.add_argument("--no-rss", action="store_true")
    p.add_argument("--no-profile", dest="no_prf", action="store_true")
    p.add_argument("--no-energy", dest="no_ene", action="store_true")
    p.add_argument("--no-shuffle", action="store_true")
    p.add_argument("--theta-softmax", action="store_true")
    p.add_argument("--kmer-shuf", type=int, default=2)
    p.add_argument("--lik-ratio", action="store_true")
    p.add_argument("--batch-size", type=int, default=None,
                   help="reads per minibatch (train: default 100, -1 the "
                        "whole file; eval: default 0, the whole file)")
    p.add_argument("--dtype", default=None,
                   help="float32 or float64; train and eval default to "
                        "float32 on CUDA and float64 on the CPU, scan to "
                        "float64 (at float32 its posterior lines below about "
                        "e^-87 miss the reference's)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p


def _dtype(args):
    return args.dtype or ("float64" if args.device == "cpu" else "float32")


def _scan_dtype(args):
    return args.dtype or "float64"


def _build_cfg(args, Lp):
    from .model import joint as J
    pattern = args.pattern
    no_rss = args.no_rss
    if "_" in pattern:
        if "(" in pattern or ")" in pattern:
            raise SystemExit("pattern cannot mix _ and base pairs")
        no_rss = True
        pattern = pattern.replace("_", ".")
    return J.ModelConfig(
        pattern=pattern, Lp=Lp, max_span=args.max_span,
        max_iloop=args.max_internal_loop, min_bpp=args.min_bpp,
        energy=args.ene_param, theta_softmax=args.theta_softmax,
        no_ene=args.no_ene, no_rss=no_rss, no_prf=args.no_prf,
        tau=args.tau, rho_s=args.rho_s, rho_theta=args.rho_theta,
        rho_lambda=args.rho_lambda, lambda_prior=args.lambda_prior,
        dtype=_dtype(args))


def _load_or_build_model(args, Lp):
    from .model import io as MIO
    from .model import joint as J
    if args.model_fname != "~NONE~":
        return MIO.read_model(args.model_fname, Lp=Lp, dtype=_dtype(args),
                              device=args.device)
    if args.pattern == "~NONE~":
        raise SystemExit("require motif pattern or model")
    cfg = _build_cfg(args, Lp)
    params = J.init_params(J.kernels(cfg, args.device).g, cfg,
                           device=args.device)
    return cfg, params


def _parse_param_set(s):
    out = []
    for r in s.split(","):
        if not r:
            continue
        se = r.split("-")
        if len(se) == 1:
            out.append(int(se[0]))
        else:
            out.extend(range(int(se[0]), int(se[1]) + 1))
    return out or None


def do_train(args, also_scan=False):
    from .model import io as MIO
    from .train.trainer import Trainer
    Lp = _round_up(_fq_maxlen(args.seq_fname))
    cfg, params = _load_or_build_model(args, Lp)
    if cfg.Lp < Lp:
        import dataclasses
        cfg = dataclasses.replace(cfg, Lp=Lp)
    batch_size = 100 if args.batch_size is None else args.batch_size
    print("motif pattern:", cfg.pattern, file=sys.stderr)
    print("batch size:", batch_size, file=sys.stderr)
    interim = _out_stream(args.out3) if args.out3 != "~COUT~" else None
    try:
        tr = Trainer(cfg, params, max_iter=args.max_iter, eps=args.epsilon,
                     lambda_init=args.lambda_init, kmer_shuf=args.kmer_shuf,
                     batch_size=batch_size, no_shuffle=args.no_shuffle,
                     lik_ratio=args.lik_ratio, interim_out=interim,
                     mask_indices=_parse_param_set(args.param_set),
                     device=args.device)
        tr.set_fq(args.seq_fname)
        params = tr.train()
    finally:
        if interim is not None:
            _close(interim)
    out1 = _out_stream(args.out1)
    MIO.write_model(out1, cfg, params)
    _close(out1)
    if also_scan:
        import dataclasses
        from . import device as DEV
        from .model import joint as J
        dt = _scan_dtype(args)
        params = J.Params(*[x.detach().to(DEV.torch_dtype(dt))
                            for x in params])
        _scan_to(args.out2, dataclasses.replace(cfg, dtype=dt), params, args)


def do_eval(args):
    from .model import io as MIO
    from .train.objective import eval_file
    if args.model_fname == "~NONE~":
        raise SystemExit("require sequence and model filenames")
    Lp = _round_up(_fq_maxlen(args.seq_fname))
    cfg, params = MIO.read_model(args.model_fname, Lp=Lp, dtype=_dtype(args),
                                 device=args.device)
    fn, gr, _ = eval_file(cfg, params, args.seq_fname, args.lik_ratio,
                          batch_size=args.batch_size or 0,
                          device=args.device)
    o1, o2 = _out_stream(args.out1), _out_stream(args.out2)
    print("fn: %.17g" % fn, file=o1)
    print("gr: [" + ",".join("%.17g" % v for v in gr) + "]", file=o2)
    for o in (o1, o2):
        _close(o)


def _scan_to(name, cfg, params, args):
    from .scan.driver import Scanner
    out = _out_stream(name)
    try:
        Scanner(cfg, params, args.device).scan(args.seq_fname, out)
    finally:
        _close(out)


def do_scan(args):
    from .model import io as MIO
    if args.model_fname == "~NONE~":
        raise SystemExit("require sequence and model filenames")
    Lp = _round_up(_fq_maxlen(args.seq_fname))
    cfg, params = MIO.read_model(args.model_fname, Lp=Lp,
                                 dtype=_scan_dtype(args), device=args.device)
    _scan_to(args.out1, cfg, params, args)


def do_genneg(args):
    from .alphabet import ints_to_seq
    from .io.fastq import FastqReader
    from .pipeline.ushuffle import negative_for
    out = _out_stream(args.out1)
    qr = FastqReader(args.seq_fname)
    for i in range(args.max_iter):
        qr.clear()
        for cnt, r in enumerate(qr.reads(), 1):
            neg = negative_for(ints_to_seq(r.seq), args.kmer_shuf, i)
            out.write(f">iter:{i};seq:{cnt};orig:\"{r.id}\"\n{neg}\n")
    _close(out)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.mode == "normal":
        do_train(args, also_scan=True)
        return
    {"train": do_train, "eval": do_eval, "scan": do_scan,
     "gen-neg": do_genneg}[args.mode](args)


if __name__ == "__main__":
    main()
