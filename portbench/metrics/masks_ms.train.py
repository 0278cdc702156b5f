"""Ms per training step in the negatives' min-BPP masks
(train/objective.batch_bp_masks: model/joint.effective_bp_mask_batch),
device synchronised around it."""
from portbench.metrics import _common as C


def read(rec):
    return C.mean_ms(rec, "masks")
