"""PyTorch/CUDA port of rnaelem_tpu (forward inside DP, first slice).

The package imports torch and numpy only, never JAX or rnaelem_tpu; its
entry points take an explicit ``device`` (None means CUDA).
"""
