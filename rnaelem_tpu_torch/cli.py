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
  of the whole file, as FASTA to --out1;
* ``array-eval``: one slave of the file-array evaluation (-a/--array >
  1, the reference's TR_ARRAY protocol, parallel/arrayjob.py): the
  objective over its slice of the FASTQ file into ``<--tmp>-<task id>``.

Training runs data-parallel over a torch.distributed group
(parallel/mesh.py) with ``--mesh N`` (N ranks on the first N cards of
this host, or N processes on the CPU; -1, the default, every card when
there is more than one), or as one rank of a group that spans hosts with
``--coordinator host:port --num-processes P --process-id i`` on every
host.  Only rank 0 writes --out1 and --out3 and runs ``normal``'s scan.

Models are read with Lp rounded up from the file's longest read.  Work
runs on CUDA unless --device says otherwise.  Training and evaluation
default to float32 on CUDA; scanning (``scan`` and the scan half of
``normal``) defaults to float64 everywhere: the reference scans in
double, and at float32 the posterior lines below about e^-87 miss it.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np


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
        description="RNA sequence-structure motif learning (PyTorch/CUDA)")
    p.add_argument("mode", nargs="?", default="normal",
                   choices=["normal", "train", "eval", "array-eval", "scan",
                            "gen-neg", "develop"])
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
    p.add_argument("-a", "--array", type=int, default=1,
                   help="evaluate the objective through this many "
                        "array-eval slaves (the reference's TR_ARRAY file "
                        "protocol); > 1 turns the group off")
    p.add_argument("--tmp", default="~NULL~",
                   help="file prefix of the array's model snapshot and "
                        "slave files (default tmp<pid> here)")
    p.add_argument("--sge-option-file", default="~DEFAULT~",
                   help="cluster submit template for --array "
                        "(arrayjob_manager.hpp:32-108 format); "
                        "~DEFAULT~ runs slaves as local subprocesses")
    p.add_argument("--font", default="~DEFAULT~")
    p.add_argument("-t", "--thread", type=int, default=1)
    # parsed but unused, as the reference binary does: its --pict is
    # stored and never consumed (application.hpp:98-100, 323)
    p.add_argument("--pict", dest="pic_fname", default="~NONE~",
                   help="accepted for reference CLI compatibility")
    p.add_argument("--mesh", type=int, default=-1,
                   help="data-parallel ranks: -1 every local CUDA device "
                        "when there is more than one, 0 off, N the first N "
                        "devices (N processes with --device cpu)")
    p.add_argument("--coordinator", default="",
                   help="join a group as one rank: host:port (or a "
                        "file:// store) that every rank reaches")
    p.add_argument("--num-processes", type=int, default=0,
                   help="ranks in the --coordinator group")
    p.add_argument("--process-id", type=int, default=-1,
                   help="this process's rank in the --coordinator group")
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


def _load_or_build_model(args, Lp, device):
    from .model import io as MIO
    from .model import joint as J
    if args.model_fname != "~NONE~":
        return MIO.read_model(args.model_fname, Lp=Lp, dtype=_dtype(args),
                              device=device)
    if args.pattern == "~NONE~":
        raise SystemExit("require motif pattern or model")
    cfg = _build_cfg(args, Lp)
    params = J.init_params(J.kernels(cfg, device).g, cfg, device=device)
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


def _group(args):
    """This process's rank of the --coordinator group, or None (no
    coordinator, or --array > 1)."""
    if not args.coordinator or args.array > 1:
        return None
    if args.num_processes < 1 or \
            not 0 <= args.process_id < args.num_processes:
        raise SystemExit("--coordinator needs --num-processes P and "
                         "--process-id 0..P-1")
    import torch.distributed as dist
    from .parallel import mesh as MESH
    group = MESH.init_group(args.coordinator, args.num_processes,
                            args.process_id, device=args.device)
    devs = [None] * group.world_size
    dist.all_gather_object(devs, str(group.device), group=group.pg)
    if group.rank == 0:
        print("mesh: %d ranks (data-parallel), backend %s, devices %s"
              % (group.world_size, group.backend, " ".join(devs)),
              file=sys.stderr)
    return group


def _array_evaluator(args, cfg):
    """The master of --array N slaves (the reference's TR_ARRAY file
    protocol): local subprocesses, or the --sge-option-file template's
    scheduler."""
    from .parallel import arrayjob as AJ
    tmp = args.tmp if args.tmp not in ("~NULL~", "~COUT~", "~CERR~") \
        else "tmp%d" % os.getpid()
    submit = AJ.submit_local
    if args.sge_option_file != "~DEFAULT~":
        submit = AJ.GridEngineOptions.load(
            args.sge_option_file).submitter(show=True)
    return AJ.ArrayEvaluator(cfg, args.array, tmp, args.seq_fname,
                             args.lik_ratio, submit=submit,
                             sge_option_file=args.sge_option_file,
                             device=args.device)


def do_train(args, also_scan=False):
    from .model import io as MIO
    from .train.trainer import Trainer
    group = _group(args)
    try:
        dev = args.device if group is None else group.device
        Lp = _round_up(_fq_maxlen(args.seq_fname))
        cfg, params = _load_or_build_model(args, Lp, dev)
        if cfg.Lp < Lp:
            import dataclasses
            cfg = dataclasses.replace(cfg, Lp=Lp)
        batch_size = 100 if args.batch_size is None else args.batch_size
        print("motif pattern:", cfg.pattern, file=sys.stderr)
        print("batch size:", batch_size, file=sys.stderr)
        # every rank trains the same numbers; rank 0 alone writes
        writer = group is None or group.rank == 0
        interim = _out_stream(args.out3) \
            if args.out3 != "~COUT~" and writer else None
        array_eval = _array_evaluator(args, cfg) if args.array > 1 else None
        try:
            tr = Trainer(cfg, params, max_iter=args.max_iter,
                         eps=args.epsilon, lambda_init=args.lambda_init,
                         kmer_shuf=args.kmer_shuf, batch_size=batch_size,
                         no_shuffle=args.no_shuffle,
                         lik_ratio=args.lik_ratio, interim_out=interim,
                         mask_indices=_parse_param_set(args.param_set),
                         device=dev, group=group, array_eval=array_eval)
            tr.set_fq(args.seq_fname)
            params = tr.train()
        finally:
            if interim is not None:
                _close(interim)
    finally:
        if group is not None:
            group.close()
    if not writer:
        return
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
        _scan_to(args.out2, dataclasses.replace(cfg, dtype=dt), params,
                 args, dev)


def _task_id(args) -> int:
    """The array-eval slave's 1-based rank: the template's task-id
    variable (arrayjob_manager.hpp:110-119), else SLURM_ARRAY_TASK_ID or
    SGE_TASK_ID."""
    tid_env = None
    if args.sge_option_file != "~DEFAULT~":
        from .parallel.arrayjob import GridEngineOptions
        tid_env = GridEngineOptions.load(args.sge_option_file).task_id_env
    if tid_env and tid_env in os.environ:
        return int(os.environ[tid_env])
    return int(os.environ.get("SLURM_ARRAY_TASK_ID",
                              os.environ.get("SGE_TASK_ID", "1")))


def do_eval(args):
    from .model import io as MIO
    from .train.objective import eval_file
    if args.model_fname == "~NONE~":
        raise SystemExit("require sequence and model filenames")
    Lp = _round_up(_fq_maxlen(args.seq_fname))
    cfg, params = MIO.read_model(args.model_fname, Lp=Lp, dtype=_dtype(args),
                                 device=args.device)
    if args.mode == "array-eval":
        # one slave: its slice of the file, 17 digits to <tmp>-<tid>
        # (motif_eval.hpp:23-54)
        tid = _task_id(args)
        fn, gr, eff = eval_file(cfg, params, args.seq_fname, args.lik_ratio,
                                batch_size=args.batch_size or 0,
                                shard=(tid - 1, args.array),
                                device=args.device)
        with open(args.tmp + "-" + str(tid), "w") as tmp:
            print("index:", tid, "/", args.array, file=tmp)
            print("fn: %.17g" % fn, file=tmp)
            print("gr: [" + ",".join("%.17g" % v for v in gr) + "]",
                  file=tmp)
            print("sum eff: %.17g" % eff, file=tmp)
        return
    fn, gr, _ = eval_file(cfg, params, args.seq_fname, args.lik_ratio,
                          batch_size=args.batch_size or 0,
                          device=args.device)
    o1, o2 = _out_stream(args.out1), _out_stream(args.out2)
    print("fn: %.17g" % fn, file=o1)
    print("gr: [" + ",".join("%.17g" % v for v in gr) + "]", file=o2)
    for o in (o1, o2):
        _close(o)


def _scan_to(name, cfg, params, args, device):
    from .scan.driver import Scanner
    out = _out_stream(name)
    try:
        Scanner(cfg, params, device).scan(args.seq_fname, out)
    finally:
        _close(out)


def do_scan(args):
    from .model import io as MIO
    if args.model_fname == "~NONE~":
        raise SystemExit("require sequence and model filenames")
    Lp = _round_up(_fq_maxlen(args.seq_fname))
    cfg, params = MIO.read_model(args.model_fname, Lp=Lp,
                                 dtype=_scan_dtype(args), device=args.device)
    _scan_to(args.out1, cfg, params, args, args.device)


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


def _mesh_size(args) -> int:
    """Ranks that --mesh asks for: -1 every local CUDA device (1 on the
    CPU), 0 off, N the first N devices (N processes on the CPU)."""
    if args.mesh == 0:
        return 1
    import torch
    if torch.device(args.device).type != "cuda":
        return max(1, args.mesh)
    count = torch.cuda.device_count()
    n = count if args.mesh < 0 else args.mesh
    if n > count:
        raise SystemExit("--mesh %d: this host has %d CUDA devices"
                         % (n, count))
    return n


def _watch_ranks(procs, tmpdir, stop):
    """Fail the whole command as soon as a spawned rank fails, rather than
    when rank 0's next collective times out."""
    while not stop.wait(0.5):
        for p, log in procs:
            if p.poll() not in (None, 0):
                print(_rank_failed(p, log), file=sys.stderr, flush=True)
                for q, _ in procs:
                    if q.poll() is None:
                        q.kill()
                shutil.rmtree(tmpdir, ignore_errors=True)
                os._exit(1)


def _rank_failed(p, log) -> str:
    log.flush()
    log.seek(0)
    return "a rank of --mesh failed (exit %s):\n%s" % (
        p.returncode, log.read()[-3000:])


def _run_mesh(argv, args, n: int):
    """--mesh N: this process becomes rank 0 and starts ranks 1..N-1 as
    subprocesses of the same command line, all joined through a file
    store in a fresh temporary directory (one code path with the
    multi-host --coordinator)."""
    import torch
    from .parallel.mesh import TIMEOUT_S
    tmpdir = tempfile.mkdtemp(prefix="rnaelem-mesh-")
    url = "file://" + os.path.join(tmpdir, "store")

    def rank_argv(r):
        return argv + ["--coordinator", url, "--num-processes", str(n),
                       "--process-id", str(r)]

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [x for x in [os.environ.get("PYTHONPATH")] if x]))
    if torch.device(args.device).type == "cpu" and \
            "OMP_NUM_THREADS" not in os.environ:
        # N ranks on one host's cores: each its share of the threads
        k = max(1, (os.cpu_count() or 1) // n)
        env["OMP_NUM_THREADS"] = str(k)
        torch.set_num_threads(k)
    procs, stop = [], threading.Event()
    try:
        for r in range(1, n):
            log = open(os.path.join(tmpdir, "rank%d.log" % r), "w+")
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "rnaelem_tpu_torch.cli"]
                + rank_argv(r), stdout=subprocess.DEVNULL, stderr=log,
                env=env), log))
        threading.Thread(target=_watch_ranks, args=(procs, tmpdir, stop),
                         daemon=True).start()
        main(rank_argv(0))
        stop.set()
        deadline = time.time() + TIMEOUT_S
        for p, log in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
            if p.returncode != 0:
                raise SystemExit(_rank_failed(p, log))
    finally:
        stop.set()
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        shutil.rmtree(tmpdir, ignore_errors=True)


def _warn_ignored(args):
    # loudly ignored reference flags (--pict, which the reference itself
    # parses and never consumes, stays silent)
    if args.font != "~DEFAULT~":
        print("warning: --font is ignored; figures are SVG (the elem "
              "pipeline's draw_motif), no FreeType font is needed",
              file=sys.stderr)
    if args.thread != 1:
        print("warning: --thread is ignored; sequences are batched "
              "through one device kernel — use --mesh for multi-GPU "
              "data parallelism", file=sys.stderr)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    _warn_ignored(args)
    if args.mode in ("normal", "train") and args.array <= 1 \
            and not args.coordinator:
        n = _mesh_size(args)
        if n > 1:
            _run_mesh(argv, args, n)
            return
    if args.mode == "normal":
        do_train(args, also_scan=True)
        return
    if args.mode == "develop":   # a no-op, as in the reference
        return
    {"train": do_train, "eval": do_eval, "array-eval": do_eval,
     "scan": do_scan, "gen-neg": do_genneg}[args.mode](args)


if __name__ == "__main__":
    main()
