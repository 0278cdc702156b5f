"""Host ms per training step in the trainer's batch read and its k-let
negatives (Trainer._read_batch_host: pipeline/ushuffle, native/)."""
from portbench.metrics import _common as C


def read(rec):
    return C.mean_ms(rec, "negatives")
