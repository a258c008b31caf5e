"""step_replay_pct (%): the share of the per-block steps that the replay of
a captured CUDA graph served (``ops/pconv.StepGraph``, the engine's own
step above pts 2048 on a card), by the program's counters
(``step.replays``, ``step.blocks``) in the traced window. A program that
counts no ``step.replays`` (one without step graphs) gives nothing to
read."""

from audiobench import program


def read(rec):
    c = program.counters()
    if not c or "step.replays" not in c or not c.get("step.blocks"):
        return None
    return 100.0 * c["step.replays"] / c["step.blocks"]
