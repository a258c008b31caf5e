"""zl_step_us_per_callback (us): the zero-latency scheduler's host time to
enqueue a callback's work (``ZeroLatencyConvolver._step``: the direct
head, the segments' bookkeeping and the firings' launches), over its
steps, by the program's counters (``zl.step_ns``, ``zl.steps``) in the
traced window."""

from audiobench import program


def read(rec):
    c = program.counters()
    n = c.get("zl.steps") if c else None
    return 1e-3 * c["zl.step_ns"] / n if n else None
