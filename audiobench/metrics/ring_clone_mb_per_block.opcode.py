"""ring_clone_mb_per_block (MB): the bytes of the rings the per-block step
clones (``step.ring_clone_bytes``: the TV coefficient ring, the doubled
input ring's writes, ``_rings_after``) over the steps (``step.blocks``), by
the program's counters in the traced window; 1 MB = 1e6 bytes."""

from audiobench import program


def read(rec):
    c = program.counters()
    n = c.get("step.blocks") if c else None
    return 1e-6 * c.get("step.ring_clone_bytes", 0) / n if n else None
