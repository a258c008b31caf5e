"""feed_us_per_callback (us): the accumulator's host time (``feed``, the
native C++ accumulator through ctypes) in the processor callbacks that fire
no block, over those callbacks, by the program's counters
(``feed.accumulate_ns``, ``process.accumulate_callbacks``) in the traced
window."""

from audiobench import program


def read(rec):
    c = program.counters()
    n = c.get("process.accumulate_callbacks") if c else None
    return 1e-3 * c["feed.accumulate_ns"] / n if n else None
