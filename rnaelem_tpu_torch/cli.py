"""Command line of the port: ``python -m rnaelem_tpu_torch.cli eval``.

The ``eval`` mode of the rnaelem binary (motif_eval.hpp:23-54, no
shuffle): the objective's function value over a FASTQ file goes to
--out1 as ``fn: %.17g`` and its gradient, in the reference's parameter
order, to --out2 as ``gr: [...]``.  The model is read with Lp rounded up
from the file's longest read.  It runs on CUDA unless --device says
otherwise.  The other modes of the JAX package's CLI (train, scan,
array-eval, gen-neg) are not ported yet.
"""
from __future__ import annotations

import argparse
import sys


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
    return open(name, "w")


def build_parser():
    p = argparse.ArgumentParser(
        prog="rnaelem-torch",
        description="RNA sequence-structure motif evaluation (PyTorch)")
    p.add_argument("mode", choices=["eval"])
    p.add_argument("-f", "--fastq", dest="seq_fname", required=True)
    p.add_argument("-q", "--motif-model", dest="model_fname", required=True)
    p.add_argument("--out1", default="~COUT~")
    p.add_argument("--out2", default="~COUT~")
    p.add_argument("--lik-ratio", action="store_true")
    p.add_argument("--batch-size", type=int, default=0,
                   help="reads per device batch (0: the whole file)")
    p.add_argument("--dtype", default=None,
                   help="float32 (CUDA default) or float64 (CPU default)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p


def do_eval(args):
    from .model import io as MIO
    from .train.objective import eval_file
    dtype = args.dtype or ("float64" if args.device == "cpu"
                           else "float32")
    Lp = _round_up(_fq_maxlen(args.seq_fname))
    cfg, params = MIO.read_model(args.model_fname, Lp=Lp, dtype=dtype,
                                 device=args.device)
    fn, gr, _ = eval_file(cfg, params, args.seq_fname, args.lik_ratio,
                          batch_size=args.batch_size, device=args.device)
    o1, o2 = _out_stream(args.out1), _out_stream(args.out2)
    print("fn: %.17g" % fn, file=o1)
    print("gr: [" + ",".join("%.17g" % v for v in gr) + "]", file=o2)
    for o in (o1, o2):
        if o not in (sys.stdout, sys.stderr):
            o.close()


def main(argv=None):
    args = build_parser().parse_args(argv)
    do_eval(args)


if __name__ == "__main__":
    main()
