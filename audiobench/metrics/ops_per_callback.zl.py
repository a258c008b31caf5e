"""ops_per_callback (ops/callback): device operations (kernels, copies,
sets) the profiler saw in the traced window, over the callbacks the loop
made in it."""


def read(rec):
    n = rec["counters"].get("callbacks")
    if not rec["device"] or not n:
        return None
    return len(rec["device"]) / n
