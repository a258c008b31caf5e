"""switch_us_per_block (us): the host time of the program's ``switch``
requests (``MatrixConvolver.switch``: the index, the bank to planes
gather, the crossfade's begin), over the fade blocks stepped
(``xfade.blocks``), by the program's spans and counters in the traced
window. None where the program records neither."""

from audiobench import program


def read(rec):
    c = program.counters()
    n = c.get("xfade.blocks") if c else None
    d = [s.end_ns - s.start_ns for s in program.spans() or ()
         if s.name == "switch" and s.parent is None]
    return 1e-3 * sum(d) / n if n and d else None
