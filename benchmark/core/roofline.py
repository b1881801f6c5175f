"""A kernel's share of its roofline in the traced stretch: the least time
the launches the stretch needed could take (``frozen.flops.bound`` at each
launch's trial count, rows, widths and operand type), over the summed
device time of the kernels whose names contain ``prefix``.  Nothing to
read (None) where the stretch launched none of them."""

from benchmark.frozen.flops import bound


def share(rec, prefix: str):
    spent = sum(e - s for name, s, e in rec["kernels"] if prefix in name)
    least = sum(n * bound(T, B, D0, D1, E, dt)[0]
                for n, T, B, D0, D1, E, dt in rec.get("launches", []))
    if spent <= 0 or least <= 0:
        return None
    return 100.0 * least / spent
