"""Run one cell of the benchmark once.

    python3 -m audiobench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with a CUDA card. In order: build
the cell's program state and make its inputs on the card from the seed,
warm up the cell's shapes (set-up, ``setup_s``), measure for ``--seconds``
(with ``--trace 1`` untraced, then profiled for the last ``TRACE_SECONDS``
at most: the host-clock readers take the first window, the device readers
the second), read the device's peak memory, free the program's
state, compare the answers kept with the plain reference, check that no
module of JAX or of the JAX package was loaded, and print one JSON line
last on standard output. Without a card it exits 2 and prints no result.

``--control 1`` runs the cell's control in the program's place (the
program with bfloat16 rings for the scans, the reference computed in
bfloat16 for the opcode processors). The benchmark's own runs do not
use it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "opencl_fft_tpu")
TRACE_SECONDS = 4.0


def forbidden_modules() -> list:
    """Modules loaded whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _args(argv):
    p = argparse.ArgumentParser(prog="python3 -m audiobench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _power_limit() -> str:
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30)
        return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 else "unread"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unread"


def main(argv=None, root: Path | None = None, device=None) -> int:
    """One run; returns the exit code. ``device`` None takes the card (the
    command line); tests pass the CPU and a root of their own."""
    args = _args(argv)
    from . import catalog
    from .trace import Tracer, breakdown, busy_s
    root = Path(root) if root is not None else catalog.ROOT
    bench = catalog.benchmark(root)
    cell = catalog.cell(bench, args.workload)

    import torch
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"error: {cell['name']} needs {cell['chips']} CUDA card(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)

    cfg = catalog.config(root, cell["config"])
    mix = catalog.traffic(root, cell["traffic"])
    limits = catalog.limits(root, cell["name"])
    loop = catalog.loop(mix["loop"]).Loop(cfg, mix, args.seed, device, bool(args.control))

    loop.setup()
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - T_START
    tracer = Tracer(bool(args.trace))
    seconds, untraced = args.seconds, None
    if args.trace:
        seconds = min(TRACE_SECONDS, args.seconds / 2)
        untraced = loop.window(args.seconds - seconds, Tracer(False))
    with tracer.window(device):
        run = loop.window(seconds, tracer)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    loop.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    errors = loop.check()

    if args.trace:
        rec = dict(tracer.records, counters=run["counters"], untraced=untraced["counters"])
        wanted = [m for m in bench["per_layer"] if catalog.applies(m, cell["name"])]
        metrics = {}
        for m in wanted:
            value = catalog.reader(root, m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        run["metrics"]["setup_s"] = setup_s
        wanted = [m for m in bench["end_to_end"] if catalog.applies(m, cell["name"])]
        missing = [m["name"] for m in wanted if m["name"] not in run["metrics"]]
        if missing:
            raise RuntimeError(f"the loop measured no {missing}")
        metrics = {m["name"]: {"value": run["metrics"][m["name"]], "unit": m["unit"]}
                   for m in wanted}

    limit = limits["max_rel_err"]
    # a non-finite error (no answer kept, or a non-finite output) prints as
    # 1e300, so that the line stays strict JSON
    checks = {"max_rel_err": {"value": min(max(errors, default=float("inf")), 1e300),
                              "limit": limit}}
    failed = sum(not e <= limit for e in errors)
    correct = bool(errors) and failed == 0
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    attempted = run["attempted"] + (untraced["attempted"] if untraced else 0)
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed),
            "metrics": metrics, "device": dev_info}
    if args.trace:
        rec = tracer.records
        dev_info["busy_s"] = busy_s(rec)
        dev_info["window_s"] = rec["window_s"]
        line["breakdown"] = breakdown(rec)
    line["checks"] = checks

    found = forbidden_modules()
    if found:
        print(f"error: modules of JAX or of the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    card = _power_limit() if device.type == "cuda" else "cpu"
    for note in run.get("notes", []):
        print(f"# {note}")
    if untraced:
        for name, value in run["metrics"].items():
            print(f"# tracing: {name} untraced {untraced['metrics'][name]!r}, traced {value!r}")
    print(f"# card (name, power limit): {card}; setup_s {setup_s}; "
          f"answers compared {len(errors)}; control {bool(args.control)}")
    print(json.dumps(line), flush=True)
    for name, c in checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
