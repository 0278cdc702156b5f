"""K6 (csrc/outside_ep.cu): the least time of its counted work over its
device time in the profiled training steps, %."""
from portbench.metrics import _common as C

# the CUDA functions of the stage
FUNCTIONS = ("ep_adj_kernel", "ep_adj_red_kernel")


def read(rec):
    return C.roofline(rec, ("outside_ep",), FUNCTIONS)
