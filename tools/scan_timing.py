"""Device time of the whole-scan kernels by partition size, on one CUDA card.

    python3 tools/scan_timing.py [--root DIR] [--families S,SP] [--pts 64,128,512,2048]
                                 [--channels 1,64] [--plans G/TT/Q,...] [--tile-log-b B,...]
                                 [--out FILE]

For each pts, times the LTI and TV scans of one channel (1880 * 512 / pts
blocks) and of 64 channels (470 * 512 / pts blocks), both of a 2^17-tap IR
(nparts = 2^17 / pts): the same audio and IR at every pts, so the MAC does
the same 1.97 / 31.5 GFLOP throughout. The scans are those of the package
``opencl_fft_tpu_torch`` found under DIR (default: this checkout), through
the wrapper families ``S`` (``ops/cuda/streamstep.py``,
``stream_steps_fused_batched{,_tv}``) and ``SP`` (``ops/cuda/splitstep.py``,
``stream_steps_fused_split_batched{,_tv}``). Run it from another checkout
(``--root``) to time an older tree's kernels on the same card in the same
call.

Per scan it reports device microseconds from HBM (a CUDA graph over
rotating input sets that together outgrow the L2, replayed under CUDA
events) and, by ``torch.profiler``, each kernel's mean microseconds a
launch times its launches a scan, summed into forward / MAC / inverse /
rest, with the MAC's TFLOP/s. ``--plans`` times each scan again at other
shapes of the tiled MAC (``streamstep.mac_plan``: G warps a CTA, TT outputs
a thread, Q partitions a stage; a tree with a ``mac_plan``) in place of the
plan's own, and ``--tile-log-b`` with 2^B transforms a CTA of the in-CTA
transform kernels (``streamstep.fft_tile_log_b``). One JSON object a line on stdout (and into FILE), after a line
with the card's name and power limit from nvidia-smi. Needs a CUDA card;
exits non-zero without one.
"""

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

IR_LEN = 1 << 17
L2_BYTES = 50 * 2**20


def graph_us(fn, nsets, calls, reps=5):
    """Device microseconds per call of fn(i), i cycling over ``nsets``
    input sets, from a CUDA graph of ``calls`` calls replayed under CUDA
    events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(nsets):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i % nsets)
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) * 1e3 / calls)
    del graph
    return statistics.median(times)


def launch_us(fn, calls=3):
    """Mean device microseconds of one launch of each kernel fn()
    launches, and its launches a call, under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / e.count for e in prof.key_averages()
            if e.self_device_time_total > 0}


def part_of(kernel_name):
    """forward / MAC / inverse / rest of a scan kernel's name."""
    k = kernel_name
    if "inv" in k or "unpack" in k or "ola" in k:
        return "inverse"
    if "fwd" in k or "z_planes" in k or "pack" in k:
        return "forward"
    return "MAC" if "mac" in k else "rest"


@contextlib.contextmanager
def forced_plan(S, plan):
    """The scans of module S at ("mac", (G, TT, Q)): that tiled MAC plan,
    the ring the smallest that holds it; or ("tile", B): 2^B transforms a
    CTA; None: the module's own plans."""
    if plan is None:
        yield
        return
    kind, value = plan
    name = "mac_plan" if kind == "mac" else "fft_tile_log_b"
    own = getattr(S, name)
    if kind == "mac":
        g, tt, q = value
        setattr(S, name, lambda *a, **k: S.MacPlan(g, tt, q,
                                                   1 << (2 * q + g * tt - 2).bit_length()))
    else:
        setattr(S, name, lambda *a, **k: value)
    try:
        yield
    finally:
        setattr(S, name, own)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--families", default="S,SP")
    ap.add_argument("--pts", default="64,128,512,2048")
    ap.add_argument("--channels", default="1,64")
    ap.add_argument("--plans", default="")
    ap.add_argument("--tile-log-b", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from opencl_fft_tpu_torch.ops.cuda import splitstep as SP
    from opencl_fft_tpu_torch.ops.cuda import streamstep as S

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out = open(args.out, "a") if args.out else None
    families = {"S": (S.stream_steps_fused_batched, S.stream_steps_fused_batched_tv),
                "SP": (SP.stream_steps_fused_split_batched,
                       SP.stream_steps_fused_split_batched_tv)}
    rng = np.random.default_rng(0)

    def f(*shape, s=1.0):
        return torch.from_numpy((s * rng.standard_normal(shape)).astype(np.float32)).to(dev)

    for pts in map(int, args.pts.split(",")):
        nparts = IR_LEN // pts
        for nch in map(int, args.channels.split(",")):
            nb = (1880 if nch == 1 else 470) * 512 // pts

            def inputs():
                return (f(nb, nch, pts, s=0.1), f(nb, nch, pts, s=0.1),
                        (f(nch, nparts, pts), f(nch, nparts, pts)),
                        (f(nch, nparts, pts, s=0.05), f(nch, nparts, pts, s=0.05)),
                        f(nch, pts))

            first = inputs()
            set_bytes = sum(t.numel() * 4 for t in (first[0], first[1], *first[2], *first[3],
                                                    first[4]))
            nsets = 1 + -(-2 * L2_BYTES // set_bytes)
            sets = [first] + [inputs() for _ in range(nsets - 1)]
            mac_flops = 8.0 * nb * nch * nparts * pts
            plans = [None] + [("mac", tuple(map(int, p.split("/"))))
                              for p in args.plans.split(",") if p] \
                + [("tile", int(b)) for b in args.tile_log_b.split(",") if b]
            for fam, plan in ((f_, p_) for f_ in args.families.split(",") for p_ in plans):
                lti, tv = families[fam]
                for mode, fn in (("LTI", lti), ("TV", tv)):
                    if plan and plan[0] == "mac" and mode == "TV" \
                            and plan[1][0] * plan[1][1] > nparts:
                        continue          # a TV tile spans at most nparts blocks
                    if plan and plan[0] == "tile" \
                            and not 4 <= plan[1] + pts.bit_length() - 1 <= 13:
                        continue          # 16 to 2^13 values a transform CTA
                    if mode == "LTI":
                        def run(i):
                            bx, _, w0, h, tails = sets[i]
                            return fn(bx, w0, h, 2.0, tails, pts)
                    else:
                        def run(i):
                            bx, bh, w0, h, tails = sets[i]
                            return fn(bx, bh, w0, h, nparts - 1, 2.0, tails, pts)
                    calls = 8 if nch == 1 else 3
                    with forced_plan(S, plan):
                        us = graph_us(run, nsets, calls)
                        launched = launch_us(lambda: run(0))
                    parts = {"forward": 0.0, "MAC": 0.0, "inverse": 0.0, "rest": 0.0}
                    kernels = {}
                    for kn, k_us in launched.items():
                        part = part_of(kn)
                        n = 2 if (mode == "TV" and part == "forward") else 1
                        parts[part] += k_us * n
                        kernels[kn[:60]] = round(k_us, 3)
                    row = {"root": args.root, "family": fam, "forced": plan, "mode": mode,
                           "C": nch,
                           "pts": pts, "nparts": nparts, "nb": nb, "hbm_us": round(us, 3),
                           "parts_us": {k: round(v, 3) for k, v in parts.items()},
                           "mac_tflops": round(mac_flops / (parts["MAC"] * 1e-6) / 1e12, 3)
                           if parts["MAC"] else None,
                           "kernels_us_a_launch": kernels, "card": card}
                    line = json.dumps(row)
                    print(line, flush=True)
                    if out:
                        out.write(line + "\n")
                        out.flush()
            del sets, first
            torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
