"""zl_download_us_per_callback (us): the host's wait on the device a
callback, the output's copy to the host in
``ZeroLatencyConvolver.process``, over the steps, by the program's
counters (``zl.download_ns``, ``zl.steps``) in the traced window."""

from audiobench import program


def read(rec):
    c = program.counters()
    n = c.get("zl.steps") if c else None
    return 1e-3 * c["zl.download_ns"] / n if n else None
