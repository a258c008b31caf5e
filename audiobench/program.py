"""The program's own spans and counters, as the per-layer readers take them.

The port records them (``opencl_fft_tpu_torch.utils.profiling``) in the
run's process while a torch profiler records, so in the traced window
alone. Their times are Unix-epoch ns, the profiler's clock; the records a
reader gets (``audiobench/trace.py``) are relative to the window's start,
whose absolute time they do not hold. Each scan call opens the harness's
``call`` span and, inside it, the program's ``stream`` request, so the
least of (``stream`` start, absolute) − (``call`` start, relative) over the
window's calls is the window's start, late by the least Python between the
two entries (a few µs). A program without spans (an older checkout) gives
None here, and its readers report nothing.
"""

from __future__ import annotations

from typing import Optional

from . import trace


def _profiling():
    from opencl_fft_tpu_torch.utils import profiling
    return profiling if hasattr(profiling, "spans") else None


def spans() -> Optional[list]:
    """The program's spans, or None where it records none."""
    prof = _profiling()
    return prof.spans() if prof else None


def counters() -> Optional[dict]:
    """The program's counters, or None where it records none."""
    prof = _profiling()
    return prof.counters() if prof else None


def window_calls(rec: dict) -> list:
    """(harness ``call`` span, program ``stream`` span, its ``launch`` span
    or None) of each call of the traced window, in order. The window's
    requests are the last ones recorded: nothing calls the program between
    the window's end and the readers."""
    sp = spans()
    if not sp:
        return []
    streams = sorted((s for s in sp if s.name == "stream" and s.parent is None),
                     key=lambda s: s.start_ns)
    launches = {s.request: s for s in sp if s.name == "launch" and s.parent == "stream"}
    calls = sorted((s for s in rec["spans"] if s[0] == "call"), key=lambda s: s[1])
    if len(streams) > len(calls):
        streams = streams[len(streams) - len(calls):]
    return [(c, s, launches.get(s.request)) for c, s in zip(calls, streams)]


def window_start_ns(calls: list) -> Optional[int]:
    """The traced window's start on the program's clock, from the calls of
    ``window_calls``: the least (``stream`` start) − (``call`` start)."""
    if not calls:
        return None
    return min(s.start_ns - round(c[1] * 1e9) for c, s, _ in calls)


def overlap_s(xs: list, ys: list) -> float:
    """Seconds in both of two lists of merged, sorted [start, end] intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def prelaunch_intervals(rec: dict) -> Optional[list]:
    """The merged intervals, relative to the window's start and inside it,
    from each window call's ``stream`` start to its ``launch`` end; None
    where the program records no such spans."""
    calls = [t for t in window_calls(rec) if t[2] is not None]
    w0 = window_start_ns(calls)
    if w0 is None:
        return None
    return trace.union((max(0.0, (s.start_ns - w0) * 1e-9),
                        min(rec["window_s"], (launch.end_ns - w0) * 1e-9))
                       for _, s, launch in calls)
