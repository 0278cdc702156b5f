"""A run of each cell's kind on the CPU at a tiny size, the port's plain
path standing in for its kernels: the last line's keys, a sound run
correct, and each fault planted under the timed path read as not
correct.  The harness's look for a card is skipped (run.run, not
run.main)."""
import json
import types

import pytest
import torch

from portbench import faults as F
from portbench import run as R

SPEC = json.load(open(R.os.path.join(R.ROOT, "BENCHMARK.json")))
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _cell(kind, dtype="float64"):
    if kind == "adam":
        w, conf, mix, lim = R.cell(SPEC, "hairpin7.adam")
        conf = dict(conf, pattern="(...)", max_span=16, max_iloop=8,
                    dtype=dtype)
        mix = dict(mix, reads=16, len_min=20, len_max=30, batch=4,
                   settle_steps=1, profile_steps=1)
    else:
        w, conf, mix, lim = R.cell(SPEC, "insert11.scan")
        conf = dict(conf, pattern="..*..", max_span=16, max_iloop=8)
        mix = dict(mix, reads=12, len_min=20, len_max=40, sample=2)
    return w, conf, mix, lim


def _run(kind, seconds=1.0, trace=0, dtype="float64"):
    torch.set_num_threads(2)
    w, conf, mix, lim = _cell(kind, dtype)
    args = types.SimpleNamespace(workload=w["name"], seed=2 ** 31 + 99,
                                 seconds=seconds, trace=trace)
    return R.run(args, SPEC, "cpu", files=(w, conf, mix, lim))


@pytest.mark.parametrize("kind", ["adam", "scan"])
def test_sound_run_is_correct_and_prints_the_contract_keys(kind):
    res = _run(kind)
    assert list(res) == KEYS              # no breakdown untraced
    assert res["correct"] is True and res["failed"] == 0
    assert all(v["value"] <= v["limit"] for v in res["checks"].values())
    names = {m["name"] for m in R.metric_names(SPEC, _cell(kind)[0]["name"],
                                               "end_to_end")}
    assert set(res["metrics"]) == names
    assert res["device"]["count"] == 1


@pytest.mark.parametrize("kind,fault", [(k, f) for k in F.FAULTS
                                        for f in F.FAULTS[k]])
def test_each_fault_reads_not_correct(kind, fault):
    with F.FAULTS[kind][fault]():
        res = _run(kind)
    assert res["correct"] is False, res["checks"]


def test_traced_run_reads_the_spans():
    res = _run("adam", seconds=16.0, trace=1)
    assert res["correct"] is True
    got = set(res["metrics"])
    assert {"negatives_ms", "masks_ms.train", "fn_grad_ms", "packing_ms",
            "optimizer_ms"} <= got
    # the profiler runs on the card alone: no device metric from the CPU
    assert not got & {"train_mfu", "idle_share.train", "launches_per_step",
                      "outside_ep_roofline.train"}
