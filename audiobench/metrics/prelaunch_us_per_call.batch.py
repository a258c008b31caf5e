"""prelaunch_us_per_call (us): the program's host time of a scan call up to
its kernels' enqueue, the mean over the traced window's calls of the end of
the ``launch`` span (``pconv_stream_batched{,_tv}``'s scan wrapper) less
the start of its ``stream`` request (``Convolver.stream`` /
``TVConvolver.stream``), by the program's spans."""

from audiobench import program


def read(rec):
    d = [launch.end_ns - s.start_ns for _, s, launch in program.window_calls(rec)
         if launch is not None]
    return 1e-3 * sum(d) / len(d) if d else None
