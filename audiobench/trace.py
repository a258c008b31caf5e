"""The traced run's records: harness spans on the host, device operations
from the profiler, and the harness's counters.

A span is opened by the harness around its calls into the program (named
``ab:<what>``); the program itself carries no spans yet. With tracing off a
span costs one attribute lookup. The profiler records the device's activity
and the harness's spans, and no operator of the program on the host, so
that tracing adds little host time to a call. The records a per-layer
reader gets:

    window_s   the traced window's length by the host clock (s)
    device     [(name, start_s, end_s)] device operations (kernels,
               copies, sets) inside the window, relative to its start
    spans      [(name, start_s, end_s)] harness spans, likewise
    counters   what the loop counted in the traced window (calls, blocks
               fired, least work)
    untraced   what it counted in the untraced window run just before
               (host seconds of its calls, by the host clock)
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np

PREFIX = "ab:"
_NULL = contextlib.nullcontext()


class Tracer:
    """Opens the harness's spans; records nothing unless ``enabled``."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.records: Optional[dict] = None
        if enabled:
            from torch.profiler import record_function
            self._rf = record_function

    def span(self, what: str):
        return self._rf(PREFIX + what) if self.enabled else _NULL

    @contextlib.contextmanager
    def window(self, device):
        """Profile the block (the harness's spans and, on a card, the
        device's activity), then keep its records."""
        if not self.enabled:
            yield
            return
        import torch
        from torch._C._profiler import RecordScope, _ExperimentalConfig
        from torch.autograd import (ProfilerActivity, ProfilerConfig, ProfilerState,
                                    _disable_profiler, _enable_profiler, _prepare_profiler)
        acts = {ProfilerActivity.CPU}
        if device.type == "cuda":
            acts.add(ProfilerActivity.CUDA)
        cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                             _ExperimentalConfig())
        _prepare_profiler(cfg, acts)
        # on the host, record_function spans only: no operator of the program
        _enable_profiler(cfg, acts, {RecordScope.USER_SCOPE})
        try:
            with self.span("window"):
                yield
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        finally:
            result = _disable_profiler()
        self.records = _records(result)


def _events(result):
    """(name, is_device, start_ns, end_ns) of every event the profiler
    kept, in one time base."""
    from torch.autograd import DeviceType
    out = []
    for e in result.events():
        try:
            start, dur = e.start_ns(), e.duration_ns()
        except AttributeError:
            start, dur = e.start_us() * 1000, e.duration_us() * 1000
        out.append((e.name(), e.device_type() != DeviceType.CPU, start, start + dur))
    return out


def _records(result) -> dict:
    events = _events(result)
    win = [e for e in events if not e[1] and e[0] == PREFIX + "window"]
    if not win:
        raise RuntimeError("the profiler kept no window span")
    w0, w1 = win[0][2], win[0][3]

    def rel(a, b):
        return (max(a, w0) - w0) * 1e-9, (min(b, w1) - w0) * 1e-9

    device = [(n,) + rel(a, b) for n, dev, a, b in events
              if dev and not n.startswith(PREFIX) and b > w0 and a < w1]
    spans = [(n[len(PREFIX):],) + rel(a, b) for n, dev, a, b in events
             if not dev and n.startswith(PREFIX) and n != PREFIX + "window"]
    return {"window_s": (w1 - w0) * 1e-9, "device": device, "spans": spans}


def union(intervals) -> list:
    """Merged [start, end] intervals, sorted."""
    merged = []
    for a, b in sorted((a, b) for a, b in intervals if b > a):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_s(rec: dict, kernels_only: bool = False) -> float:
    """Seconds in which some device operation (or kernel) ran."""
    ops = [(a, b) for n, a, b in rec["device"]
           if not (kernels_only and is_copy(n))]
    return sum(b - a for a, b in union(ops))


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def idle_pct(rec: dict) -> Optional[float]:
    """100 (1 - busy / window), or None where no device operation ran."""
    if not rec["device"] or rec["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - busy_s(rec) / rec["window_s"])


def breakdown(rec: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the device's idle
    time by the innermost harness span open on the host in each gap."""
    by_op: dict = {}
    for n, a, b in rec["device"]:
        by_op[n] = by_op.get(n, 0.0) + (b - a)
    busy = union((a, b) for _, a, b in rec["device"])
    gaps, t = [], 0.0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if rec["window_s"] > t:
        gaps.append((t, rec["window_s"]))
    spans = sorted(rec["spans"], key=lambda s: s[1])
    starts = np.array([s[1] for s in spans])
    longest = max((s[2] - s[1] for s in spans), default=0.0)
    by_span: dict = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        name = "outside any span"
        # the innermost span holding the gap's middle: the latest to start
        i = int(np.searchsorted(starts, mid, side="right")) - 1
        while i >= 0 and starts[i] >= mid - longest:
            if spans[i][2] >= mid:
                name = spans[i][0]
                break
            i -= 1
        by_span[name] = by_span.get(name, 0.0) + (b - a)

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_span)}


class Reservoir:
    """A uniform sample of ``k`` of the answers offered (algorithm R),
    drawn from the run's seed."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1
