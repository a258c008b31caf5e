"""fan_mb_per_block.matrix (MB): the bytes the matrix layer moves to fan
its inputs out to the (out, in) pairs and back in (``matrix.fan_bytes``:
the tiled input written and the per-pair output reduced) over the blocks
it processed (``matrix.blocks``), by the program's counters in the traced
window; 1 MB = 1e6 bytes. None where no ``matrix.blocks`` is counted."""

from audiobench import program


def read(rec):
    c = program.counters()
    n = c.get("matrix.blocks") if c else None
    return 1e-6 * c.get("matrix.fan_bytes", 0) / n if n else None
