"""Ms per scan chunk in the scanner's two passes and posteriors
(scan/scanner.scan_posteriors_batch less its masks)."""
from portbench.metrics import _common as C


def read(rec):
    p, m = C.mean_ms(rec, "posteriors"), C.mean_ms(rec, "masks")
    return None if p is None or m is None else p - m
