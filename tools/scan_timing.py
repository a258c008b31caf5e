"""Device time of the whole-scan, per-block step and sliding-MAC kernels, on one
CUDA card.

    python3 tools/scan_timing.py [--root DIR] [--families S,STEP,SLIDE,MAC,PATHS,MATRIX]
                                 [--pts 64,128,512,2048] [--channels 1,64]
                                 [--plans G/TT/Q,...] [--tile-log-b B,...]
                                 [--step-nparts 1,256] [--step-tiles F/I,...]
                                 [--slide-routes tiled,split]
                                 [--mac-plans CL/W/T,...]
                                 [--matrix-plans G/TT/Q,...]
                                 [--matrix-shapes IN/OUT/PTS/NB,...]
                                 [--out FILE]

For each pts, times the LTI and TV scans of one channel (1880 * 512 / pts
blocks) and of 64 channels (470 * 512 / pts blocks), both of a 2^17-tap IR
(nparts = 2^17 / pts): the same audio and IR at every pts, so the MAC does
the same 1.97 / 31.5 GFLOP throughout. The scans are those of the package
``opencl_fft_tpu_torch`` found under DIR (default: this checkout), through
the family ``S``: the scan entries' wrappers ``stream_steps_fused_batched{,_tv}``
of ``ops/cuda/streamstep.py``, at every pts (above 2048 they stand for the
JAX package's split scans). Run it from another checkout
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
transform kernels (``streamstep.fft_tile_log_b``).

``STEP`` times the per-block step kernels of ``ops/cuda/blockstep.py``
(``block_step_fused``, ``block_step_fwd_fused``, ``block_step_fwd_fused_tv``)
at every pts of ``--pts`` (4096 too where the tree's block step takes it),
channel count of ``--channels`` (no channel axis at 1) and partition count
of ``--step-nparts``: device microseconds from rotating input sets by CUDA
graph (from HBM where the sets outgrow the L2), and by the profiler each
kernel's mean a launch, summed into forward / MAC / inverse. Above pts 2048
it also times one ``pconv_step`` of a card state through the
``block_mac_unpack`` route beside the same step through the block-step
kernel (``pconv._step_fused``), device microseconds under the profiler.
``--step-tiles`` times each step again with its transform tiles forced to
2^F values a CTA in the forward and 2^I in the inverse (at least one row;
``blockstep.step_plan``, a tree with one).

``SLIDE`` times the LTI sliding MAC (``ops/cuda/slidemac.py``, the entry of
``chunk_mac``, ``macflow_lti`` and ``macflow_lti_batched``: one kernel a
call) at its main-path shapes (nparts 256, bins 512: 1 x 1880, 16 x 470,
64 x 470 and the K = 8 chunk's 64 x 8) from HBM by CUDA graph, with its
TFLOP/s; ``--slide-routes`` times each shape again on each named route
(``slidemac.slide_route``; a tree with one).

``MAC`` times the one-block MACs, ``spectral_mac`` (``ops/cuda/mac.py``)
at C 1 and 64 and ``block_mac_unpack`` (``ops/cuda/blockstep.py``) at C 1
(nparts 255 and 256) and 16, their main paths' shapes: device
microseconds from HBM by CUDA graph beside the least-work bound (the
window and h planes read once, the output written once), and by the
profiler each kernel's mean a launch, summed into MAC and reduce (a tree
whose MAC is one launch has no reduce part), with the kernels a call; and
the method's floor, one launch a call of a one-float elementwise kernel.
``--mac-plans`` times each shape again at other plans of the one-launch
MAC (``mac.mac_plan``, a tree with one): CL CTAs a cluster (at most the
portable 8), W slices a CTA, T bins a CTA, qchunk the fewest partitions a
slice that cover them.

``PATHS`` times host-bound entry points by CUDA events (the median of 31
calls after 3): ``stream_decomposed`` and ``pconv_offline`` of 1880 blocks
of 512 on a 2^17-tap IR, ``stft`` / ``istft`` of 20 s at nfft 1024, hop
256, ``pconv_step`` of one block, ``Clpconv.convolution`` of one block at
pts 4096 on a 2^20-tap IR, and 64 blocks of 64 through the zero-latency
processor on that IR (one terminal fire a call). Run it from each of two trees in turn
to compare the paths without the other phases of ``chip_smoke.py`` around
them.

``MATRIX`` times the matrix scan entry (``stream_steps_fused_matrix``)
at each shape of ``--matrix-shapes`` (default the Ambisonic shape of
``mimo16x16_stream470``: 16 inputs x 16 outputs, pts 512, 470 blocks; a
2^17-tap IR) beside the route it replaced, the n_out n_in (out, in) pairs
through the batched scan with the input tiled before it and the outputs
summed over the inputs after it: device microseconds from HBM by CUDA
graph, each kernel's mean a launch by the profiler summed into forward /
MAC / inverse / rest, the MAC's TFLOP/s.
``--matrix-plans`` times the entry again at other plans of its MAC
(``streamstep.matrix_plan``: G warps a CTA, TT outputs a thread, Q
partitions a stage, the ring the smallest that holds a stage and the
next).

One JSON object a line on stdout (and into FILE), after a line with the
card's name and power limit from nvidia-smi. Needs a CUDA card; exits
non-zero without one.
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
    launches, and its launches a call, under torch.profiler (a session
    that records no kernel is taken again, twice at most)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = {e.key: e.self_device_time_total / e.count for e in prof.key_averages()
              if e.self_device_time_total > 0}
        if us:
            return us
    return us


def part_of(kernel_name):
    """forward / MAC / inverse / rest of a scan or block-step kernel's name."""
    k = kernel_name
    if "inv" in k or "unpack" in k or "ola" in k or "reduce" in k:
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


@contextlib.contextmanager
def forced_matrix_plan(S, plan):
    """The matrix scan of module S at its MAC plan (G, TT, Q); None: the
    module's own."""
    if plan is None:
        yield
        return
    own = S.matrix_plan
    g, tt, q = plan
    S.matrix_plan = lambda *a, **k: (*own(*a, **k)[:2], g, tt, q,
                                      1 << (2 * q + g * tt - 2).bit_length())
    try:
        yield
    finally:
        S.matrix_plan = own


def rotating_sets(make, cap=48):
    """Input sets made by make(), enough that together they outgrow the L2
    twice (at most ``cap``: smaller sets stay in the L2)."""
    first = make()
    size = sum(t.numel() * 4 for t in first)
    return [first] + [make() for _ in range(min(cap, 1 + -(-2 * L2_BYTES // size)) - 1)]


def parts_of(launched):
    """forward / MAC / inverse / rest microseconds of one call, and each
    kernel's mean a launch (name cut to 60 characters)."""
    parts = {"forward": 0.0, "MAC": 0.0, "inverse": 0.0, "rest": 0.0}
    for kn, k_us in launched.items():
        parts[part_of(kn)] += k_us
    return ({k: round(v, 3) for k, v in parts.items()},
            {kn[:60]: round(k_us, 3) for kn, k_us in launched.items()})


@contextlib.contextmanager
def forced_tiles(B, tiles):
    """The step kernels of module B with their transform tiles forced to
    (F, I): 2^F values a CTA in the forward, 2^I in the inverse (at least
    one row); None: the module's own plan."""
    if tiles is None:
        yield
        return
    own = B.step_plan

    def plan(pts):
        log_l = pts.bit_length() - 1
        return max(tiles[0] - log_l, 0), max(tiles[1] - log_l, 0)

    B.step_plan = plan
    try:
        yield
    finally:
        B.step_plan = own


def step_rows(args, f, dev, emit):
    """The STEP family: each per-block step kernel by (C, pts, nparts)."""
    from opencl_fft_tpu_torch.ops import pconv as P
    from opencl_fft_tpu_torch.ops.cuda import blockstep as B

    tilings = [None] + [tuple(map(int, t.split("/"))) for t in args.step_tiles.split(",")
                        if t and hasattr(B, "step_plan")]

    most = getattr(B, "STEP_MAX_PTS", 2048)
    for pts in sorted({*map(int, args.pts.split(",")), 4096}):
        if pts > most:
            continue
        for nch in map(int, args.channels.split(",")):
            lead = () if nch == 1 else (nch,)
            for nparts in map(int, args.step_nparts.split(",")):
                def make():
                    a, b_ = f(*lead, nparts, pts), f(*lead, nparts, pts)
                    return (torch.cat([a, a], -2), torch.cat([b_, b_], -2),
                            f(*lead, nparts, pts, s=0.05), f(*lead, nparts, pts, s=0.05),
                            f(*lead, pts), f(2, *lead, pts, s=0.1))

                sets = rotating_sets(make)
                rp, wp2 = 1 % nparts, nparts - 1
                kernels = {
                    "block_step_fused": lambda i: B.block_step_fused(
                        sets[i][:2], sets[i][2:4], rp, 2.0, sets[i][4], pts),
                    "block_step_fwd_fused": lambda i: B.block_step_fwd_fused(
                        sets[i][5][0], sets[i][:2], sets[i][2:4], rp, 2.0, sets[i][4], pts),
                    "block_step_fwd_fused_tv": lambda i: B.block_step_fwd_fused_tv(
                        sets[i][5], sets[i][:2], sets[i][2:4], rp, wp2, 2.0, sets[i][4], pts)}
                for (kname, fn), tiles in ((kf, t) for kf in kernels.items() for t in tilings):
                    with forced_tiles(B, tiles):
                        us = graph_us(fn, len(sets), 20 if nch == 1 else 5)
                        parts, per = parts_of(launch_us(lambda: fn(0)))
                    emit({"family": "STEP", "kernel": kname, "forced": tiles, "C": nch,
                          "pts": pts, "nparts": nparts, "graph_us": round(us, 3),
                          "sets_outgrow_l2": len(sets) < 48, "parts_us": parts,
                          "kernels_us_a_launch": per})
                del sets
                torch.cuda.empty_cache()
    # above pts 2048 the per-block functions take block_mac_unpack and the
    # inverse FFT; the block-step kernel on the same state beside it
    for pts in (4096,):
        nparts = 8
        cfg = P.PconvConfig(pts=pts, nparts=nparts)
        st = P.push_ir(cfg, P.pconv_init(cfg, dev), f(cfg.cvs, s=0.05))
        st = P.pconv_stream(cfg, st, f(nparts, pts, s=0.1))[0]
        block = f(pts, s=0.1)
        routes = {"block_mac_unpack route (pconv_step)": lambda: P.pconv_step(cfg, st, block)}
        if pts <= most:
            routes["block_step_fwd_fused"] = lambda: P._step_fused(cfg, st, block)
        for label, fn in routes.items():
            launched = launch_us(fn)
            parts, per = parts_of(launched)
            emit({"family": "STEP", "route": label, "C": 1, "pts": pts, "nparts": nparts,
                  "device_us": round(sum(launched.values()), 3), "parts_us": parts,
                  "kernels_us_a_launch": per})


@contextlib.contextmanager
def forced_mac_plan(M, B, plan):
    """The one-launch MACs of modules M (mac) and B (blockstep) at plan
    (cluster, ways, tile), qchunk the fewest partitions a slice that cover
    nparts; None: the module's own plan."""
    if plan is None:
        yield
        return
    own = M.mac_plan
    cl, ways, tile = plan

    def forced(nparts, bins):
        return M.ClusterPlan(cl, ways, -(-nparts // (cl * ways)), tile)

    M.mac_plan = B.mac_plan = forced
    try:
        yield
    finally:
        M.mac_plan = B.mac_plan = own


def mac_rows(args, f, emit):
    """The MAC family: #7 and #11 at their main paths' shapes."""
    from opencl_fft_tpu_torch.ops.cuda import blockstep as B
    from opencl_fft_tpu_torch.ops.cuda import mac as M

    plans = [None] + [tuple(map(int, p.split("/"))) for p in args.mac_plans.split(",")
                      if p and hasattr(M, "mac_plan")]
    kernels = {"spectral_mac": M.spectral_mac, "block_mac_unpack": B.block_mac_unpack}
    # the floor of the method: one launch a call of a one-float elementwise
    # kernel, timed the same way
    one = [f(1) for _ in range(2)]
    emit({"family": "MAC", "kernel": "floor: one elementwise launch a call",
          "graph_us": round(graph_us(lambda i: one[i].add_(1.0), 2, 20), 3)})
    for kname, nch, nparts, bins in (("block_mac_unpack", 1, 255, 4096),
                                     ("block_mac_unpack", 1, 256, 4096),
                                     ("block_mac_unpack", 16, 256, 4096),
                                     ("spectral_mac", 1, 256, 512),
                                     ("spectral_mac", 64, 256, 512)):
        lead = () if nch == 1 else (nch,)

        def make():
            a, b_ = f(*lead, nparts, bins), f(*lead, nparts, bins)
            return (torch.cat([a, a], -2), torch.cat([b_, b_], -2),
                    f(*lead, nparts, bins, s=0.05), f(*lead, nparts, bins, s=0.05))

        sets = rotating_sets(make)
        fn = kernels[kname]

        def run(i):
            return fn(sets[i][:2], sets[i][2:], 1, 2.0)

        # least work: the window and h planes in, the output planes out; the
        # MAC's 8 operations a bin and partition (and ~10 a bin to unpack)
        nbytes = 4 * (4 * nch * nparts * bins + 2 * nch * bins)
        flops = 8.0 * nch * nparts * bins + (10.0 * nch * bins if "unpack" in kname else 0.0)
        bound_us = 1e6 * max(nbytes / 3.35e12, flops / 67e12)
        for plan in plans:
            if plan is not None and (plan[2] * plan[1] > 512 or plan[0] > M.CLUSTER_PORTABLE):
                continue
            with forced_mac_plan(M, B, plan):
                us = graph_us(run, len(sets), 20 if nch == 1 else 5)
                launched = launch_us(lambda: run(0))
            parts = {"MAC": 0.0, "reduce": 0.0}
            for kn, k_us in launched.items():
                parts["reduce" if "reduce" in kn else "MAC"] += k_us
            emit({"family": "MAC", "kernel": kname, "forced": plan, "C": nch,
                  "nparts": nparts, "bins": bins, "graph_us": round(us, 3),
                  "bound_us": round(bound_us, 3), "of_bound": round(bound_us / us, 4),
                  "sets_outgrow_l2": len(sets) < 48,
                  "parts_us": {k: round(v, 3) for k, v in parts.items()},
                  "kernels_a_call": len(launched),
                  "kernels_us_a_launch": {kn[:60]: round(k_us, 3)
                                          for kn, k_us in launched.items()}})
        del sets
        torch.cuda.empty_cache()


def event_ms(fn, warmup=3, reps=31):
    """Median milliseconds of one fn() by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def path_rows(f, dev, emit):
    """The PATHS family: host-bound entry points by CUDA events."""
    import opencl_fft_tpu_torch as P
    from opencl_fft_tpu_torch.ops.decomposed import stream_decomposed

    cfg = P.PconvConfig.for_ir_length(IR_LEN, 512)
    state = P.push_ir(cfg, P.pconv_init(cfg, dev), f(IR_LEN, s=0.05))
    blocks = f(1880, 512, s=0.1)
    x = f(960000, s=0.1)
    spec = P.stft(x, 1024, 256)
    block = f(512, s=0.1)
    # cells 13/14: a 2^20-tap IR at pts 4096 (the block_mac_unpack route) and
    # the zero-latency processor in 64-sample blocks, one terminal fire a call
    quiet = lambda m, u: None  # noqa: E731
    ir4 = (f(1 << 20, s=0.05)).cpu().numpy()
    eng4 = P.Clpconv(0, 1 << 20, 4096, quiet, device="cuda")
    eng4.push_ir(ir4)
    out4, x4 = np.empty(4096, np.float32), f(4096, s=0.1).cpu().numpy()
    zl = P.ClconvProcessor(ir4, parts=0, block_size=64, pmax=4096, device="cuda",
                           on_message=quiet)
    xz = f(64, 64, s=0.1).cpu().numpy()
    paths = {"stream_decomposed 1880x512": lambda: stream_decomposed(cfg, state, blocks),
             "pconv_offline 1880x512": lambda: P.pconv_offline(cfg, state, blocks),
             "stft 960000 nfft 1024": lambda: P.stft(x, 1024, 256),
             "istft 960000 nfft 1024": lambda: P.istft(spec, 1024, 256, length=x.numel()),
             "pconv_step 512": lambda: P.pconv_step(cfg, state, block),
             "Clpconv.convolution pts 4096, 2^20 taps": lambda: eng4.convolution(out4, x4),
             "ClconvProcessor(parts=0, pmax=4096) 64 blocks of 64":
                 lambda: [zl.process(b) for b in xz]}
    for label, fn in paths.items():
        emit({"family": "PATHS", "path": label, "event_ms": round(event_ms(fn), 4)})


@contextlib.contextmanager
def forced_route(SM, route):
    """The sliding MAC of module SM on ``route`` ("tiled" or "split", a tree
    with ``slide_route``); None: the module's own choice."""
    if route is None:
        yield
        return
    own = SM.slide_route
    SM.slide_route = lambda *a, **k: own(*a, **k, force=route)
    try:
        yield
    finally:
        SM.slide_route = own


def slide_rows(args, f, emit):
    """The SLIDE family: the LTI sliding MAC at its main-path shapes."""
    from opencl_fft_tpu_torch.ops.cuda import slidemac as SM

    nparts, bins = 256, 512
    routes = [None] + [r for r in args.slide_routes.split(",")
                       if r and hasattr(SM, "slide_route")]
    for nch, nout in ((1, 1880), (16, 470), (64, 470), (64, 8)):
        def make():
            return (f(nch, nparts + nout, bins), f(nch, nparts + nout, bins),
                    f(nch, nparts, bins, s=0.05), f(nch, nparts, bins, s=0.05))

        sets = rotating_sets(make)
        flops = 8.0 * nch * nout * nparts * bins
        for route in routes:
            def run(i):
                return SM.macflow_lti_batched(sets[i][:2], sets[i][2:], nout, 2.0)

            with forced_route(SM, route):
                us = graph_us(run, len(sets), 20 if nout < 100 else 5)
            emit({"family": "SLIDE", "forced": route, "C": nch, "nout": nout,
                  "nparts": nparts, "bins": bins, "graph_us": round(us, 3),
                  "tflops": round(flops / (us * 1e-6) / 1e12, 3)})
        del sets
        torch.cuda.empty_cache()


def matrix_rows(args, S, f, emit):
    """The MATRIX family (see the module's doc)."""
    for shape in args.matrix_shapes.split(","):
        matrix_shape_rows(args, S, f, emit, *map(int, shape.split("/")))


def matrix_shape_rows(args, S, f, emit, n_in, n_out, pts, nb):
    nparts = IR_LEN // pts

    def make():
        return (f(nb, n_in, pts, s=0.1), f(n_in, nparts, pts), f(n_in, nparts, pts),
                f(n_out * n_in, nparts, pts, s=0.05), f(n_out * n_in, nparts, pts, s=0.05),
                f(n_out, pts))

    sets = rotating_sets(make)
    mac_flops = 8.0 * n_out * n_in * nb * nparts * pts

    def entry(i):
        blocks, wr, wi, hr, hi, tails = sets[i]
        return S.stream_steps_fused_matrix(blocks, (wr, wi), (hr, hi), 2.0, tails, pts)

    def pairs(i):
        blocks, wr, wi, hr, hi, tails = sets[i]
        outs, _, tf = S.stream_steps_fused_batched(
            blocks.repeat(1, n_out, 1), (wide[i][0], wide[i][1]), (hr, hi), 2.0, wide[i][2],
            pts)
        return outs.reshape(nb, n_out, n_in, pts).sum(2), tf

    wide = [(wr.repeat(n_out, 1, 1), wi.repeat(n_out, 1, 1), tails.repeat_interleave(n_in, 0))
            for _, wr, wi, _, _, tails in sets]
    plans = [("entry", None)] + [("entry", tuple(map(int, p.split("/"))))
                                 for p in args.matrix_plans.split(",") if p] + [("pairs", None)]
    for route, plan in plans:
        fn = entry if route == "entry" else pairs
        with forced_matrix_plan(S, plan):
            us = graph_us(fn, len(sets), 3)
            parts, kernels = parts_of(launch_us(lambda: fn(0)))
        emit({"family": "MATRIX", "route": route, "forced": plan, "n_in": n_in, "n_out": n_out,
              "pts": pts, "nparts": nparts, "nb": nb, "hbm_us": round(us, 3),
              "parts_us": parts,
              "mac_tflops": round(mac_flops / (parts["MAC"] * 1e-6) / 1e12, 3)
              if parts["MAC"] else None, "kernels_us_a_launch": kernels})
    del sets, wide
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--families", default="S")
    ap.add_argument("--pts", default="64,128,512,2048")
    ap.add_argument("--channels", default="1,64")
    ap.add_argument("--plans", default="")
    ap.add_argument("--tile-log-b", default="")
    ap.add_argument("--step-nparts", default="1,256")
    ap.add_argument("--step-tiles", default="")
    ap.add_argument("--slide-routes", default="")
    ap.add_argument("--mac-plans", default="")
    ap.add_argument("--matrix-plans", default="")
    ap.add_argument("--matrix-shapes", default="16/16/512/470")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from opencl_fft_tpu_torch.ops.cuda import streamstep as S

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out = open(args.out, "a") if args.out else None
    families = {"S": (S.stream_steps_fused_batched, S.stream_steps_fused_batched_tv)}
    rng = np.random.default_rng(0)

    def f(*shape, s=1.0):
        return torch.from_numpy((s * rng.standard_normal(shape)).astype(np.float32)).to(dev)

    def emit(row):
        row.update(root=args.root, card=card)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    chosen = args.families.split(",")
    if "STEP" in chosen:
        step_rows(args, f, dev, emit)
    if "SLIDE" in chosen:
        slide_rows(args, f, emit)
    if "MAC" in chosen:
        mac_rows(args, f, emit)
    if "PATHS" in chosen:
        path_rows(f, dev, emit)
    if "MATRIX" in chosen and hasattr(S, "stream_steps_fused_matrix"):
        matrix_rows(args, S, f, emit)
    for pts in map(int, args.pts.split(",")) if set(chosen) & set(families) else ():
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
            for fam, plan in ((f_, p_) for f_ in chosen if f_ in families for p_ in plans):
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
                    emit({"family": fam, "forced": plan, "mode": mode, "C": nch,
                          "pts": pts, "nparts": nparts, "nb": nb, "hbm_us": round(us, 3),
                          "parts_us": {k: round(v, 3) for k, v in parts.items()},
                          "mac_tflops": round(mac_flops / (parts["MAC"] * 1e-6) / 1e12, 3)
                          if parts["MAC"] else None,
                          "kernels_us_a_launch": kernels})
            del sets, first
            torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
