"""terminal_callback_us (us): the mean host wall of the callbacks in which
the zero-latency plan's terminal segment fires (one in 64 at pts 4096 and
64-sample callbacks), by the host clock around each, in the run's untraced
window. A live host has to fit its worst callback into its buffer's
time, and this is that callback."""


def read(rec):
    c = rec["untraced"]
    if not c.get("terminal_callbacks"):
        return None
    return 1e6 * c["terminal_s"] / c["terminal_callbacks"]
