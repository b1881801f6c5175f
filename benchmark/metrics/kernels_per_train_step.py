"""CUDA kernels a stacked train step: every kernel of the profiled
population pass (its evaluation batches' too) over its stacked train
steps.  Layer: Engine."""


def read(rec):
    steps = rec.get("train_steps")
    if not steps or not rec["kernels"]:
        return None
    return len(rec["kernels"]) / steps
