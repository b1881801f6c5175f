"""The window's useful FLOPs (each trial's own architecture, real windows
only: ``frozen.flops``) over the window's wall times the peak of the
cell's compute type (%), in the train cells.  Layer: Model."""


def read(rec):
    win = rec["window"]
    if win["wall_s"] <= 0 or win["useful_flops"] <= 0:
        return None
    return 100.0 * win["useful_flops"] / (win["wall_s"] * win["peak_flops"])
