"""K11 (csrc/inside_ep.cu ep_max_kernel): the least time of its counted
work over its device time in the profiled scan call, %."""
from portbench.metrics import _common as C

# the CUDA function of the stage
FUNCTIONS = ("ep_max_kernel",)


def read(rec):
    return C.roofline(rec, ("inside_ep_max",), FUNCTIONS)
