"""Weight carry-over from the JAX package.

The JAX package keeps a model's parameters as ``Params(singles, pairs,
lam)`` arrays; handed over as numpy arrays they become the port's
parameters unchanged (same bank layout, same table order).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import device as DEV
from .joint import Params


def params_from_numpy(singles, pairs, lam, device=None,
                      dtype=torch.float64) -> Params:
    """Port Params on ``device`` from the JAX package's Params fields
    given as numpy arrays (singles [n_single, 4], pairs [n_pair, 6],
    lam [2])."""
    dev = DEV.resolve(device)
    dt = DEV.torch_dtype(dtype)
    as_t = lambda a: torch.tensor(np.array(a), dtype=dt, device=dev)
    return Params(singles=as_t(singles), pairs=as_t(pairs), lam=as_t(lam))
