"""The whole scan call: the least time of its counted work (masks, both
passes, K1, the CYK tables) over the profiled call's wall, %."""
from portbench.metrics import _common as C


def read(rec):
    return C.mfu(rec)
