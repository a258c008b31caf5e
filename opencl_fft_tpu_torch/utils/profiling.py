"""Profiling / timing helpers (the JAX package's ``utils/profiling.py``).

The reference has none (queues created without CL_QUEUE_PROFILING_ENABLE);
external wall-clock timing only. Here:

* ``trace(path)`` — a context manager around ``torch.profiler`` (CPU and,
  where there is a card, CUDA activity); the trace is written as Chrome
  trace JSON to ``<path>/trace.json``, with the program's spans recorded
  meanwhile on a row of their own, and the profile is yielded, so its
  ``key_averages()`` can be read.
* Program spans and counters — ``span``, ``request``, ``add``, ``count``
  and their readers ``spans``, ``counters``, ``reset``: recorded exactly
  while a torch profiler records (``enabled``), on the profiler's clock.
* ``chain_seconds`` / ``device_timer`` — seconds of a chain of
  applications of a step (the sweep's ``timed``), and per application
  after a warm-up: CUDA events on a card, ``perf_counter`` on the CPU.
* ``median_chain_delta`` — the sweep's estimator, floor-guarded medians of
  long-minus-short chain deltas (pure logic, as in the JAX package).
* FLOP conventions used by the benchmarks (5 N log2 N per FFT, the
  BASELINE.json convention).
"""

from __future__ import annotations

import contextlib
import importlib
import itertools
import json
import os
import threading
import time
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "opencl_fft_tpu_torch" / "trace"


@contextlib.contextmanager
def trace(path: Optional[str] = None):
    """Profile the enclosed block with ``torch.profiler`` (CUDA activity
    too when a card is present) and write ``<path>/trace.json`` (Chrome
    trace format) with the program's spans of the block on a row of their
    own (``SPAN_TID``, "program spans") beside the device rows; ``path``
    defaults to ``build/opencl_fft_tpu_torch/trace`` at the repository
    root (git-ignored). Yields the profile."""
    from torch.profiler import ProfilerActivity, profile

    out = Path(path) if path is not None else TRACE_DIR
    out.mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    since = time.time_ns()
    with profile(activities=acts) as prof:
        yield prof
    file = out / "trace.json"
    prof.export_chrome_trace(os.fspath(file))
    _merge_spans(file, [s for s in spans() if s.start_ns >= since])


# ---------------------------------------------------------------------------
# Program spans and counters.
#
# A top-level entry (``Convolver.stream``, ``TVConvolver.stream``, a
# processor's ``process``) asks ``enabled()`` once: whether a torch profiler
# records now (the harness's traced window, ``trace()``). It opens its
# ``request`` with the answer; the sites below it open ``span``s and
# ``add`` to counters only while a request is open on their thread, so the
# answer is carried down without another check. With tracing off a site
# costs one lookup and returns the shared null context. Times are
# ``time.time_ns()``: Unix-epoch ns, the clock of the profiler's events
# (``start_ns()``), so spans and device rows line up.

SPAN_CAPACITY = 1 << 16      # spans kept (a span a thread more at most); later ones
                             # are counted in spans.dropped
SPAN_TID = 0                 # the Chrome trace row of the program's spans

_NULL = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


class Span(NamedTuple):
    """A finished program span."""
    name: str
    start_ns: int              # Unix-epoch ns, the profiler's clock
    end_ns: int
    parent: Optional[str]      # the enclosing span's name; None for a request
    request: int               # the number of the top-level call it belongs to


class _Local(threading.local):
    def __init__(self):
        self.open = []         # the spans open on this thread, the request first
        self.counts = None     # this thread's counters, registered on first use


_local = _Local()
_lock = threading.Lock()     # guards the registry of the threads' counters
_thread_counts: list = []    # each counting thread's dict: no lock on the hot path
_spans: list = []            # appended without a lock: list.append is atomic
_ids = itertools.count(1)


class _Open:
    """A span being recorded."""
    __slots__ = ("name", "parent", "request", "start_ns")

    def __init__(self, name: str, parent: Optional[str], request: int):
        self.name, self.parent, self.request = name, parent, request

    def __enter__(self):
        _local.open.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _local.open.pop()
        if len(_spans) < SPAN_CAPACITY:
            _spans.append(Span(self.name, self.start_ns, end, self.parent, self.request))
        else:
            count(("spans.dropped", 1))
        return False


def enabled() -> bool:
    """Whether a torch profiler records now: a top-level entry's one check."""
    return _profiler_enabled()


def request(name: str, on: bool):
    """A top-level span (a stream call, a block firing) under a new request
    number if ``on`` (the entry's ``enabled()``), else the null context."""
    return _Open(name, None, next(_ids)) if on else _NULL


def span(name: str):
    """A span inside the span open on this thread (and its request), or the
    null context where none is open."""
    open_ = _local.open
    if not open_:
        return _NULL
    top = open_[-1]
    return _Open(name, top.name, top.request)


def add(name: str, n: int = 1) -> None:
    """Add n to a counter if a request is open on this thread."""
    if _local.open:
        count((name, n))


def count(*items) -> None:
    """Add each (name, n) of ``items`` to its counter; for an entry that
    has found ``enabled()``. Each thread counts in a dict of its own, which
    ``counters()`` sums."""
    c = _local.counts
    if c is None:
        c = _local.counts = {}
        with _lock:
            _thread_counts.append(c)
    for name, n in items:
        c[name] = c.get(name, 0) + n


def spans() -> list:
    """The spans recorded since the last ``reset``, in the order they ended."""
    return list(_spans)


_LAUNCH_MODULES = ("blockstep", "dstream", "mac", "slidemac", "splitstep", "streamstep",
                   "vmemfft")


def counters() -> dict:
    """The program's counters, and each ``*_LAUNCHES`` count of the kernel
    wrappers (``ops/cuda/``) by qualified name, read where it stands."""
    with _lock:
        per_thread = [dict(c) for c in _thread_counts]
    out: dict = {}
    for c in per_thread:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    for m in _LAUNCH_MODULES:
        mod = importlib.import_module(f"..ops.cuda.{m}", __package__)
        out.update((f"{mod.__name__}.{k}", v) for k, v in vars(mod).items()
                   if k.endswith("LAUNCHES"))
    return out


def reset() -> None:
    """Forget the spans and counters recorded (not the launch counts)."""
    global _ids
    _spans.clear()
    with _lock:
        for c in _thread_counts:
            c.clear()
    _ids = itertools.count(1)


def _merge_spans(file: Path, spans_: list) -> None:
    """Write program spans into an exported Chrome trace, on its time base
    (``ts`` in µs from ``baseTimeNanoseconds``, 0 where the export has
    none), on a row of their own."""
    data = json.loads(file.read_text())
    base = int(data.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = data.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": SPAN_TID,
                   "args": {"name": "program spans"}})
    events.extend({"ph": "X", "cat": "program", "name": s.name, "pid": pid, "tid": SPAN_TID,
                   "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                   "args": {"parent": s.parent, "request": s.request}} for s in spans_)
    file.write_text(json.dumps(data))


def fft_flops(n: int, batch: int = 1) -> float:
    """5 N log2 N convention (BASELINE.json:2)."""
    return 5.0 * n * np.log2(n) * batch


def pconv_flops_per_block(pts: int, nparts: int) -> float:
    """Two rFFTs (~half-size complex) + 8-flop complex MAC per partition bin."""
    return 2 * fft_flops(pts) + 8.0 * nparts * pts


def median_chain_delta(timed: Callable[[int], float], reps: int,
                       floor: float, *, short: int = 1, samples: int = 3,
                       min_samples: int = 2, tries: int = 5,
                       pair: int = 2, min_chain_s: float = 0.0,
                       max_reps_scale: int = 256):
    """Median of floor-guarded long-minus-short chain deltas, the sweep's
    estimator (the JAX package's, unchanged).

    Each delta is (timed(short + reps) - timed(short)) / reps, short and
    long each the min of ``pair`` readings; deltas at or below ``floor`` (a
    physical bound, ~5x generous, so only impossible values are rejected)
    are discarded and the chain doubled; the estimate is the median of up
    to ``samples`` surviving deltas.

    ``min_chain_s``: the least long-minus-short span the chain must carry;
    a physically valid delta whose span is below it grows ``reps`` toward
    it and is retried (not counted as a sample, and not consuming a try),
    the growth capped at ``max_reps_scale`` times the starting reps.

    Returns (delta_seconds_per_call, n_valid). n_valid below
    ``min_samples`` returns (None, n_valid): callers treat it as
    unmeasurable and omit the point, never clamp it.
    """
    deltas = []
    reps_cap = reps * max_reps_scale
    grows = 0
    t = 0
    while t < tries:
        t_short = min(timed(short) for _ in range(pair))
        t_long = min(timed(short + reps) for _ in range(pair))
        span = t_long - t_short
        d = span / reps
        if d <= floor:
            reps = min(reps * 2, reps_cap)   # longer chain, retry
            t += 1
            continue
        if span < min_chain_s and reps < reps_cap and grows < 8:
            # physically valid but too short to out-divide the clock's
            # jitter: grow toward the target span (own budget)
            grow = int(np.ceil(min_chain_s / max(span, min_chain_s / 16)))
            reps = min(reps * max(grow, 2), reps_cap)
            grows += 1
            continue
        deltas.append(d)
        t += 1
        if len(deltas) >= samples:
            break
    n = len(deltas)
    if n < min_samples:
        return None, n
    return float(np.median(deltas)), n


def _device_of(x) -> torch.device:
    if isinstance(x, torch.Tensor):
        return x.device
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        for v in x:
            d = _device_of(v)
            if d.type != "cpu":
                return d
    return torch.device("cpu")


def chain_seconds(step: Callable, x0, iters: int) -> float:
    """Seconds of ``iters`` chained applications of ``step`` (x -> x of the
    same structure) from ``x0``, no warm-up: CUDA events on the current
    stream when ``x0`` holds a tensor on a card, ``perf_counter`` on the
    CPU."""
    dev = _device_of(x0)
    x = x0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        stream = torch.cuda.current_stream(dev)
        start.record(stream)
        for _ in range(iters):
            x = step(x)
        end.record(stream)
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(iters):
        x = step(x)
    return time.perf_counter() - t0


def device_timer(step: Callable, x0, iters: int = 20) -> float:
    """Seconds per application of ``step`` (x -> x of the same structure),
    from ``iters`` chained applications after two warm-up ones
    (``chain_seconds``)."""
    return chain_seconds(step, step(step(x0)), iters) / iters
