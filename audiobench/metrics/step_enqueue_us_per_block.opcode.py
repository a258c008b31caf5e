"""step_enqueue_us_per_block (us): the mean host time of the program's
``step`` spans (``pconv_step{,_tv}`` inside a firing) in the traced window.
The step returns before the device finishes, so this is its enqueue."""

from audiobench import program


def read(rec):
    d = [s.end_ns - s.start_ns for s in program.spans() or () if s.name == "step"]
    return 1e-3 * sum(d) / len(d) if d else None
