"""Ms per scan chunk in the min-BPP masks inside
scan/scanner.scan_posteriors_batch (its masks stage), device
synchronised."""
from portbench.metrics import _common as C


def read(rec):
    return C.mean_ms(rec, "masks")
