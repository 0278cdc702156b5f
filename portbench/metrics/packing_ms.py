"""Ms per training step in the host packing of the batch
(train/objective.stack_reads less its masks)."""
from portbench.metrics import _common as C


def read(rec):
    s, m = C.mean_ms(rec, "stack"), C.mean_ms(rec, "masks")
    return None if s is None or m is None else s - m
