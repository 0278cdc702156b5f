"""Ms per training step in the per-read objective and gradients
(train/objective.batch_fn_grad_pr: factors, the DP and its outside
pass), device synchronised around it."""
from portbench.metrics import _common as C


def read(rec):
    return C.mean_ms(rec, "fn_grad")
