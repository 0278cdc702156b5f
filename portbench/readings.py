"""The readings that a cell's limits are set from, on the chip at the
cell's own size, in one process per cell:

* the program's numbers on each of ``--seeds`` (sound runs: set-up and a
  window of one step or one call, then the comparison of a benchmark
  run);
* the control's on each of ``--control-seeds``: the plain reference put
  in the program's place, computed in the nearest precision below the
  configuration's (float32 for a float64 cell, float32 with TF32 matrix
  products for a float32 one), against the reference;
* with ``--faults``, each fault of portbench/faults.py planted in the
  program, on the control seeds.

    python3 portbench/readings.py --workload hairpin7.adam \\
        --seeds 11,12,13 --control-seeds 11,12,13 --faults

prints one JSON line per reading: {"seed", "kind", "checks"}."""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, ROOT)

from portbench import run as R  # noqa: E402


def program_run(mode, conf, mix, seed, dev, tmp):
    from portbench import drive
    out = drive.DRIVERS[mode](conf, mix, seed, 0.0, False, dev, tmp,
                              time.perf_counter())
    return out["program"]


def control_train(conf, mix, prog, ref, dev):
    """The reference in the precision below the configuration's, as the
    program: float32 for a float64 cell, float32 with TF32 products for
    a float32 one."""
    import torch
    from portbench import check as CHK
    torch.backends.cuda.matmul.allow_tf32 = conf["dtype"] == "float32"
    try:
        ctl = CHK.follow_train(conf, mix, prog, dev, dtype="float32")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    n = len(ctl["fn"])
    xs = [ctl["x0"]] * n + [ctl["x"]]
    return CHK.compare_train({"fn": ctl["fn"], "gr": ctl["gr"], "x": xs},
                             ref)


def control_scan(conf, mix, prog, seed, dev, ref):
    """The reference in float32 (its own masks, motif regions and
    alignments) as the program, judged against the float64 reference
    ``ref``."""
    from portbench import check as CHK
    from portbench.reference import scan_ref
    reads, small, idx, out64, masks64, cfg64 = ref
    cfg32 = CHK.ref_config(conf, cfg64.Lp, "float32")
    p = [CHK._np64(prog[k]) for k in ("singles", "pairs", "lam")]
    sample = [reads[i] for i in idx]
    out32, masks32 = scan_ref.posteriors(cfg32, *p, sample, dev)
    pins = [(o["Ys"], o["Ye"]) for o in out32]
    aln = scan_ref.align(cfg32, *p, sample, pins, masks32, dev)
    res = [(o["Pys"], o["Pye"], o["Pyi"], o["Ys"], o["Ye"], a)
           for o, a in zip(out32, aln)]
    pos = {i: t for t, i in enumerate(idx)}
    en_ctl = [sum(out32[pos[i]]["EN"][k] for i in small) for k in (0, 1)]
    return CHK.judge_scan(ref, res, en_ctl, prog, dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)
    R.cache_env()
    import torch
    from portbench import check as CHK
    from portbench import faults as F
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(4)
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    spec = R.load_json(ROOT, "BENCHMARK.json")
    w, conf, mix, limits = R.cell(spec, args.workload)
    mode = mix["mode"]
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = [int(s) for s in args.control_seeds.split(",") if s]

    def emit(seed, kind, checks, t0):
        print(json.dumps({"seed": seed, "kind": kind, "checks": checks,
                          "s": time.perf_counter() - t0}), flush=True)

    for seed in sorted(set(seeds) | set(ctl), key=(seeds + ctl).index):
        tmp = tempfile.mkdtemp(prefix="portbench-readings-")
        try:
            t0 = time.perf_counter()
            prog = program_run(mode, conf, mix, seed, dev, tmp)
            CHK.free_program(dev)
            if mode == "adam":
                ref = CHK.follow_train(conf, mix, prog, dev)
                emit(seed, "program", CHK.compare_train(prog, ref), t0)
            else:
                ref = CHK.reference_scan(conf, prog, seed, mix, dev)
                emit(seed, "program", CHK.check_scan(conf, mix, prog, seed,
                                                     dev, ref), t0)
            if seed not in ctl:
                continue
            t0 = time.perf_counter()
            if mode == "adam":
                emit(seed, "control", control_train(conf, mix, prog, ref,
                                                    dev), t0)
            else:
                emit(seed, "control", control_scan(conf, mix, prog, seed,
                                                   dev, ref), t0)
            if not args.faults:
                continue
            for name, fault in F.FAULTS[mode].items():
                t0 = time.perf_counter()
                with fault():
                    fp = program_run(mode, conf, mix, seed, dev, tmp)
                CHK.free_program(dev)
                if mode == "adam":
                    got = CHK.compare_train(fp, ref)
                else:
                    got = CHK.check_scan(conf, mix, fp, seed, dev, ref)
                emit(seed, "fault:" + name, got, t0)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
