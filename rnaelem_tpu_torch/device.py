"""Device resolution for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU: a missing
``device`` means CUDA, and without a CUDA device that is an error rather
than a silent CPU run.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """None -> cuda (raises without a GPU); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device %s requested but CUDA is not available"
                           % dev)
    return dev


def torch_dtype(name) -> torch.dtype:
    """'float32'/'float64' (or a torch dtype) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return {"float32": torch.float32, "float64": torch.float64}[str(name)]
