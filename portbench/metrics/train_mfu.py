"""The whole training step: the least time of its counted work (masks,
K1-K7 of fn+grad) over the profiled steps' wall, %."""
from portbench.metrics import _common as C


def read(rec):
    return C.mfu(rec)
