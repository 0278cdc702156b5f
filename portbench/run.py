"""One run of one benchmark cell of the PyTorch and CUDA port.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cell (BENCHMARK.json's ``workloads``)
names a configuration (portbench/configs/<config>.json) and a traffic mix
(portbench/traffic/<traffic>.json); its limits are
portbench/limits/<workload>.json and each per-layer metric is read by
portbench/metrics/<metric>.py.  The run makes its inputs and weights from
the seed, sets up and warms the port, measures for ``--seconds``, checks
what the timed path produced against the plain reference, and prints one
JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` (each compared number beside its limit, also the last lines
of standard error).  Without a CUDA device, or with JAX or the JAX
package loaded by the end, it prints no result and exits 1."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
# the harness's modules by their package's name alone (run as a script,
# python puts this directory first, where trace.py would shadow the
# standard library's trace)
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, ROOT)
FORBIDDEN = ("jax", "jaxlib", "flax", "rnaelem_tpu")


def fail(msg, code=1):
    print("portbench: " + msg, file=sys.stderr, flush=True)
    sys.exit(code)


def cache_env(root=ROOT):
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = os.path.join(root, "build")
    os.environ["RNAELEM_KERNEL_BUILD_DIR"] = os.path.join(build, "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell(spec: dict, workload: str):
    """(workload entry, configuration, traffic mix, limits) by name."""
    w = {x["name"]: x for x in spec["workloads"]}.get(workload)
    if w is None:
        fail("no workload %r in BENCHMARK.json" % workload)
    cfgs = {c["name"]: c for c in spec["configs"]}
    conf = load_json(ROOT, cfgs[w["config"]]["file"])
    mix = load_json(HERE, "traffic", w["traffic"] + ".json")
    limits = load_json(HERE, "limits", workload + ".json")
    return w, conf, mix, limits


def metric_names(spec: dict, workload: str, kind: str):
    return [m for m in spec[kind]
            if workload in m.get("workloads", [workload])]


def reader(name: str):
    """The per-layer metric's reader: portbench/metrics/<name>.py's
    ``read(rec)``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def end_to_end(w: dict, out: dict, mix: dict) -> dict:
    """The cell's end-to-end numbers, from the host clock."""
    walls = out["walls"]
    vals = {"setup_s": out["setup_s"]}
    done = out["attempted"] - out["failed"]
    if mix["mode"] == "adam":
        vals["train_reads_per_s"] = done / out["window_s"]
        vals["train_step_p90_ms"] = 1e3 * (statistics.quantiles(
            list(walls), n=10, method="inclusive")[8] if len(walls) > 1
            else walls[0])
    else:
        vals["scan_reads_per_s"] = done / out["window_s"]
    return vals


def run(args, spec, dev, log=sys.stderr, files=None):
    """One run; returns the result's dict (``checks`` last).  ``files``
    (tests only) gives the cell's (workload, configuration, mix, limits)
    in place of the files BENCHMARK.json names."""
    import torch
    from portbench import check as CHK
    from portbench import drive
    from portbench.work import counts as WORK

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    w, conf, mix, limits = files or cell(spec, args.workload)
    traced = bool(args.trace)
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        if torch.device(dev).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        out = drive.DRIVERS[mix["mode"]](conf, mix, args.seed, args.seconds,
                                         traced, dev, tmp, T_START)
        prog = out.pop("program")
        CHK.free_program(dev)
        t_ref = time.perf_counter()
        if mix["mode"] == "adam":
            checks = CHK.check_train(conf, mix, prog, dev)
        else:
            checks = CHK.check_scan(conf, mix, prog, args.seed, dev)
        t_ref = time.perf_counter() - t_ref
        rec = None
        if traced:
            rec = dict(spans=out["spans"], profile=out["profile"],
                       walls=out["walls"], mix=mix, conf=conf,
                       dtype=conf["dtype"])
            ref_cfg = CHK.ref_config(conf, prog["cfg"].Lp, conf["dtype"])
            if mix["mode"] == "adam":
                rec["work"] = WORK.step_work(ref_cfg, out["batches"], dev)
            elif out["profile"] is not None:
                # one call's work, as many times as calls were profiled
                u = out["profile"]["units"]
                rec["work"] = {k: (b * u, o * u) for k, (b, o) in
                               WORK.scan_call_work(ref_cfg, out["batches"],
                                                   dev).items()}
                rec["chunks_per_call"] = out["chunks_per_call"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    correct = all(checks[k] <= limits[k]["limit"] for k in limits) and \
        set(checks) == set(limits) and out["failed"] == 0
    if traced:
        metrics = {}
        for m in metric_names(spec, args.workload, "per_layer"):
            v = reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        vals = end_to_end(w, out, mix)
        metrics = {m["name"]: {"value": vals[m["name"]], "unit": m["unit"]}
                   for m in metric_names(spec, args.workload, "end_to_end")}
    device = dict(platform="gpu" if torch.device(dev).type == "cuda"
                  else "cpu",
                  kind=torch.cuda.get_device_name(0)
                  if torch.device(dev).type == "cuda" else "cpu",
                  count=1, memory_peak_bytes=out["memory_peak_bytes"])
    result = dict(correct=bool(correct), attempted=int(out["attempted"]),
                  failed=int(out["failed"]), metrics=metrics, device=device)
    if traced and rec["profile"] is not None:
        p = rec["profile"]
        device.update(busy_s=p["busy_s"], window_s=p["wall_s"])
        result["breakdown"] = {"device_ops": p["device_ops"],
                               "idle_gaps": p["idle_gaps"]}
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]["limit"]}
                        for k in sorted(checks)}
    print("setup %.3f s, window %.3f s, reference %.3f s" % (
        out["setup_s"], out["window_s"], t_ref), file=log, flush=True)
    print("units %d, walls s: %s" % (out["units"], " ".join(
        "%.4f" % x for x in out["walls"])), file=log, flush=True)
    for k in sorted(checks):
        print("check %s: %.6g (limit %.6g)" % (
            k, checks[k], limits.get(k, {}).get("limit", float("nan"))),
            file=log, flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0, choices=(0, 1))
    args = ap.parse_args(argv)
    cache_env()
    spec = load_json(ROOT, "BENCHMARK.json")
    import torch
    w = {x["name"]: x for x in spec["workloads"]}.get(args.workload)
    if w is None:
        fail("no workload %r in BENCHMARK.json" % args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < w["chips"]:
        fail("the cell needs %d CUDA device(s); found %s" % (
            w["chips"], torch.cuda.device_count()
            if torch.cuda.is_available() else "none"))
    result = run(args, spec, "cuda")
    loaded = sorted({m.split(".")[0] for m in list(sys.modules)}
                    & set(FORBIDDEN))
    if loaded:
        fail("modules that must not load were loaded: %s" % ", ".join(
            loaded))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
