"""accum_us_per_callback (us): the host wall of the callbacks that fire no
engine block, over their count, by the host clock around each callback, in
the run's untraced window."""


def read(rec):
    c = rec["untraced"]
    if not c.get("accumulate_callbacks"):
        return None
    return 1e6 * c["accumulate_s"] / c["accumulate_callbacks"]
