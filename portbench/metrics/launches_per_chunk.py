"""Device operations (hand-written kernels, torch kernels, copies) per scan
chunk in the profiled call."""


def read(rec):
    p = rec.get("profile")
    n = rec.get("chunks_per_call")
    return p["kernels"] / (p["units"] * n) if p and p["units"] and n else None
