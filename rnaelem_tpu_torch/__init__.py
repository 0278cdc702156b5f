"""PyTorch/CUDA port of rnaelem_tpu: the objective's value and gradient,
per read, the no-rss chain and the trainer, on hand-written CUDA kernels.

The package imports torch, numpy and scipy only, never JAX or
rnaelem_tpu; its entry points take an explicit ``device`` (None means
CUDA).
"""
