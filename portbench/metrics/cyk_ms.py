"""Ms per scan chunk in the Viterbi alignment (scan/cyk.cyk_batch: factors,
the CYK tables, the traceback)."""
from portbench.metrics import _common as C


def read(rec):
    return C.mean_ms(rec, "cyk")
