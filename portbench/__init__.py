"""The benchmark of the PyTorch and CUDA port (rnaelem_tpu_torch): cells
named in BENCHMARK.json at the repository's root, each a configuration
(configs/), a traffic mix (traffic/) and its limits (limits/), per-layer
metric readers (metrics/), frozen work counts (work/) and the plain
reference (reference/).  Run ``python3 portbench/run.py --workload
<name> --seed <n> --seconds <s> --trace <0|1>`` from the root."""
