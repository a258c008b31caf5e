"""process_us_per_callback (us): the host time of a processor callback that
fires no block, from ``process``'s entry to its return, over those
callbacks, by the program's counters (``process.accumulate_ns``,
``process.accumulate_callbacks``) in the traced window."""

from audiobench import program


def read(rec):
    c = program.counters()
    n = c.get("process.accumulate_callbacks") if c else None
    return 1e-3 * c["process.accumulate_ns"] / n if n else None
