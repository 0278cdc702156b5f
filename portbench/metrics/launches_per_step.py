"""Device operations (hand-written kernels, torch kernels, copies) per
training step in the profiled steps."""


def read(rec):
    p = rec.get("profile")
    return p["kernels"] / p["units"] if p and p["units"] else None
