"""Frozen copy of rnaelem_tpu_torch/energy/__init__.py for the benchmark's plain
reference (portbench/reference): plain PyTorch and numpy only, the
CUDA kernel branches removed, imports kept inside this copy."""
