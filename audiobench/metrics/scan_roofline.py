"""scan_roofline (%): the least time of the traced scans' work (the frozen
count of ``audiobench/roofline.py``, from the shapes) over the device time
of every kernel the traced window ran, whatever their names."""

from audiobench import trace


def read(rec):
    kernel_s = trace.busy_s(rec, kernels_only=True)
    least_s = rec["counters"].get("least_s")
    if not least_s or kernel_s <= 0:
        return None
    return 100.0 * least_s / kernel_s
