"""Share of the profiled training steps' wall in which no operation ran on
the device, %."""
from portbench.metrics import _common as C


def read(rec):
    return C.idle(rec)
