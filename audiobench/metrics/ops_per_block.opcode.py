"""ops_per_block (ops/block): device operations (kernels, copies, sets) the
profiler saw in the traced window, over the engine blocks the processors
fired in it."""


def read(rec):
    blocks = rec["counters"].get("blocks_fired")
    if not rec["device"] or not blocks:
        return None
    return len(rec["device"]) / blocks
