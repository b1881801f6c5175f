"""CUDA kernels a request: every kernel of the profiled requests over
their number.  Layer: Reload."""


def read(rec):
    n = rec.get("requests")
    if not n or not rec["kernels"]:
        return None
    return len(rec["kernels"]) / n
