"""Ms per training step outside the objective (train/trainer, train/optim:
the Adam update and the log): the step's wall less the objective's."""


def read(rec):
    obj = rec.get("spans", {}).get("objective")
    if not obj:
        return None
    walls = list(rec["walls"])[-len(obj):]
    return 1e3 * (sum(walls) - sum(obj)) / len(obj)
