"""Profiling / timing helpers (the JAX package's ``utils/profiling.py``).

The reference has none (queues created without CL_QUEUE_PROFILING_ENABLE);
external wall-clock timing only. Here:

* ``trace(path)`` — a context manager around ``torch.profiler`` (CPU and,
  where there is a card, CUDA activity); the trace is written as Chrome
  trace JSON to ``<path>/trace.json`` and the profile is yielded, so its
  ``key_averages()`` can be read.
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
import os
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "opencl_fft_tpu_torch" / "trace"


@contextlib.contextmanager
def trace(path: Optional[str] = None):
    """Profile the enclosed block with ``torch.profiler`` (CUDA activity
    too when a card is present) and write ``<path>/trace.json`` (Chrome
    trace format); ``path`` defaults to ``build/opencl_fft_tpu_torch/trace``
    at the repository root (git-ignored). Yields the profile."""
    from torch.profiler import ProfilerActivity, profile

    out = Path(path) if path is not None else TRACE_DIR
    out.mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.fspath(out / "trace.json"))


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
