"""idle_prelaunch_pct (%): the share of the traced window in which the
device is idle (no device operation runs: the union of the profiler's
device rows, as ``device_idle_pct`` takes it) while the host is between a
scan call's ``stream`` request start and its ``launch`` span's end (the
program's spans, aligned by ``audiobench/program.py``)."""

from audiobench import program, trace


def read(rec):
    if not rec["device"] or rec["window_s"] <= 0:
        return None
    pre = program.prelaunch_intervals(rec)
    if pre is None:
        return None
    busy = trace.union((a, b) for _, a, b in rec["device"])
    pre_s = sum(b - a for a, b in pre)
    return 100.0 * (pre_s - program.overlap_s(pre, busy)) / rec["window_s"]
