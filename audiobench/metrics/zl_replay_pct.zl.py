"""zl_replay_pct (%): the share of the zero-latency steps that a captured
CUDA graph served (``ZeroLatencyConvolver.process`` on a card, one graph a
cadence phase), by the program's counters (``zl.replays``, ``zl.steps``)
in the traced window. A program that counts no ``zl.replays`` (one without
the graph path, or the CPU) gives nothing to read."""

from audiobench import program


def read(rec):
    c = program.counters()
    if not c or "zl.replays" not in c or not c.get("zl.steps"):
        return None
    return 100.0 * c["zl.replays"] / c["zl.steps"]
