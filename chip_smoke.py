"""Smoke run of the PyTorch/CUDA port (opencl_fft_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout and holds
each against its plain PyTorch twin: the LTI and time-varying (TV) stream
kernels at the headline shape (2^17-tap IR in 512-sample partitions:
nparts=256, bins=512, 1880-block scans) and at small odd shapes, the direct
FIR kernel at 512 taps @ 512 and at other context depths, and the batched
(multi-channel) LTI and TV stream kernels at the serving shape (64
channels of 2^17-tap IRs, 470-block scans) and at small odd shapes. It
then drives the main paths on the card through the entry points a user
calls, against float64 scipy/numpy oracles: ``convolve`` and
``ClconvProcessor`` (LTI), ``pconv_stream_tv`` and ``CltvconvProcessor``
with the IR fed cyclically through the second operand (TV),
``convolve_direct`` with the direct processors (parts=1), and the serving
models ``Convolver``, ``TVConvolver`` and ``MatrixConvolver`` (64 channels;
true stereo). It times each stream, prints per stream the device time of
each kernel and copy under ``torch.profiler`` and the device's busy share
of the call. Then the FFT path: the batched FFT kernels (``fft_vmem``,
``fft_vmem_front2`` by their routes and at a split) against their twins at
the JAX FFT sweep's sizes (2^10..2^20 at 32 MB of planes a call), the FFT
main paths (``Clcfft``, ``Clrfft``, the ``clfft``/``clrfft`` processors,
``BatchedFFT``, Bluestein) against float64 numpy, and the sweep's times and
each kernel's device time (under the profiler and from device memory)
against cuFFT and, for the single pass, against the earlier single-pass
kernel. Then the offline and chunked paths: the sliding-MAC kernel (``chunk_mac``,
``macflow_lti``, ``macflow_lti_batched``) against its twin at the JAX
bench's offline shapes and odd shapes, on the route its shape picks (tiled
or q-split) and on the other; ``pconv_offline``,
``Convolver.render`` (16 and 64 channels), ``pconv_stream_batched_chunked``
(K = 8), ``Convolver.stream(chunk=8)``, ``pconv_chunk{,_tv}``, the LTI
``stream_decomposed`` and ``convolve_oneshot`` against float64 scipy and
the streaming paths; and their times under the JAX bench's metric names,
beside the kernel's (also from device memory by a CUDA graph), its twin's,
its bound and one cuDNN ``conv1d`` of the same correlation. Then the per-block path: the block-step kernels
(``spectral_mac``, ``block_step_fused``, ``block_step_fwd_fused``,
``block_step_fwd_fused_tv``) against their twins at one and 64 channels of
the headline ring and at odd shapes; ``Clpconv.convolution`` with a
crossfaded IR swap retargeted mid-fade, ``ClconvProcessor.set_ir``,
``CltvconvProcessor``, ``Convolver.set_ir`` on 16 of 64 channels (the
others bit-equal to an engine that never swapped) and a ``MatrixConvolver``
entry swap against float64 scipy blends; and their per-block times, each
step's forward / MAC / inverse stages by shape and its least-work bound. Then
the time-varying decomposed engine and the long-partition streams: the TV
sliding-MAC kernel (``macflow_tv``, ``macflow_tv_batched``; at the
q-slices its plan picks and at forced ones) and the scan kernels above pts 2048
(``stream_steps_fused_batched{,_tv}``, in-kernel FFTs, standing for the JAX
split scans ``stream_steps_fused_split{,_tv}``) against their twins at their
main-path shapes (the headline TV scan and the K = 8 chunk of 64 channels;
pts 4096 with a 2^20-tap IR, one and 16 channels) and at odd shapes; TV ``stream_decomposed``,
``TVConvolver.stream_chunked`` (K = 8, 64 channels, from the start and off
phase), ``convolve`` and ``pconv_stream_tv`` at pts 4096, the LTI and TV
decomposed engine at pts 4096 and ``Convolver``/``TVConvolver`` of 16
channels at pts 4096 against float64 scipy and the scans; and their times
beside the paths they are alternatives to. Then the zero-latency and
long-partition per-block paths: the MAC-and-unpack kernel
(``block_mac_unpack``, one launch, as ``spectral_mac`` is) against its twin,
bit for bit against ``unpack_inverse`` of the ``spectral_mac`` kernel, on a
second launch and channel by channel; ``ClconvProcessor(parts=0,
pmax=4096)`` and ``ZeroLatencyConvolver.render`` on a 2^20-tap IR in 64-sample
blocks, ``ClconvProcessor(parts=4096)``, ``pconv_step_tv`` and
``push_ir_xfade`` at pts 4096, ``Convolver(16).step`` chained into the scan and
the STFT round trip at 20 s against float64 scipy/numpy; and the
zero-latency host wall per block against its budget, #11's and the STFT's
times. Then scale-out (the sharded engines on one NCCL rank,
``dryrun_multichip(4)`` with its defaults), the precision fault's repair
(``convolve`` and ``convolve_direct`` with TF32 switched on, against float64
scipy; ``set_fast_math`` in every mode), the host layer (the native runtime,
``RealtimePipeline`` paced by ``VirtualHost`` at 48 kHz for 5 s at the
bench headline against the ``pconv_step`` chain, a TV pipeline,
``ProcessorPipeline`` around the zero-latency processor, ``CsoundHost`` on a
stub engine, a checkpoint on the card), the sweep harness's quick grid, and
the nine demo command lines of ``opencl_fft_tpu_torch/examples`` at their
default sizes (exit codes, wavs, each render against float64 scipy or the
CPU twins, each demo's launches by kernel), and a third-order Ambisonic
reverb matrix at full size (``MatrixConvolver(16, 16)`` of 2^17-tap IRs,
one matrix-scan launch a call) against its 256 pairs' single-channel scans
and float64 scipy, and head-tracked binaural room synthesis at full width
(``MatrixConvolver(24, 2)`` of 2^16-tap BRIRs: a bank of orientations,
a ``switch`` and a ``step`` every block, one launch each of
``spectral_mac``, ``block_step_fwd_fused`` and ``block_step_fused`` a
block) against the float64 blends of ``tests/brs_reference.py``, and the
three kernels against their twins at its 48 pairs. Last, one JSON line with every
kernel's launches, error, time and bound, the card's name and power limit, and
``{"ok": true, "device": {...}}``. Every phase prints one line; any
failure exits non-zero before the last line. Without a CUDA card, or
without the port beside this script, it fails.
"""

import contextlib
import ctypes
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SR = 48000.0
PTS = 512
IR_LEN = 1 << 17
SCAN_BLOCKS = 1880
SERVE_CH = 64        # the JAX bench's serving shape (bench.py:314-371)
SERVE_BLOCKS = 470
DIRECT_TAPS = 512
LONG_PTS = 4096      # a hall IR at a long partition (ROADMAP 15b's grid)
OPCODE_PTS, OPCODE_TAPS = 8192, 1 << 22   # CltvconvProcessor(8192, 2^22): the opcode's engine
LONG_IR = 1 << 20
LONG_BLOCKS = 470
LONG_CH = 16
SWEEP_LOG2 = tuple(range(10, 21))       # the JAX FFT sweep's range (bench.py:421-439)
# other two-pass splits timed beside the default route's (log2 n: splits)
FFT_ALT_SPLITS = {14: ((256, 64), (128, 128)), 18: ((512, 512), (1024, 256)),
                  19: ((512, 1024), (256, 2048)), 20: ((512, 2048),)}
SWEEP_BYTES = 32 << 20                  # rows = SWEEP_BYTES // (8 n)
TOL = 2e-5          # kernel vs twin, relative to max|twin| (JAX stream-vs-scan bound)
# the pipelined single-pass FFT and the q-split TV sliding MAC vs their
# twins: float32 sums in other orders, ~3e-7 measured
NEW_TOL = 1e-6
# the one-launch MACs (spectral_mac, block_mac_unpack) vs their twins: the
# partitions summed in slices, ~4e-7 measured
MAC_TOL = 3e-6
ORACLE_TOL = 5e-5   # relative max error vs the float64 scipy/numpy oracle
# H100 SXM published peaks at its full 700 W limit: FP32 outside the tensor
# cores (the kernels run plain FP32 FMA, no TF32) and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
L2_BYTES = 50 * 2**20


def check(ok, what):
    if not ok:
        raise RuntimeError(f"FAILED: {what}")


def rel_err(got, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - ref)) / np.max(np.abs(ref)))


def cuda_ms(fn, warmup=2, reps=7, calls=1):
    """Median milliseconds of one fn() over reps runs of ``calls`` calls
    back to back, by CUDA events (calls > 1 keeps the host's launch cost of
    a short call out of the device time)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    return statistics.median(times)


def bound(flops, nbytes):
    """Least milliseconds the card could take: the larger of the FLOPs over
    the FP32 peak and the bytes (each input read once, each output written
    once) over the HBM rate; and which of the two it is."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def rfft_flops(n):
    """Operations of one transform of n real points: half those of a
    complex one, 5 n log2 n."""
    return 2.5 * n * math.log2(n)


def stream_flops(nb, nparts, bins, pts, transforms):
    """Least operations of a partitioned scan of nb blocks: the FDL MAC (a
    complex multiply-add, 8 operations, per bin, partition and block) and
    ``transforms`` real transforms of 2*pts points."""
    return 8.0 * nb * nparts * bins + transforms * rfft_flops(2 * pts)


def scan_design_flops(nb, nch, nparts, m, tv):
    """Operations the scan kernels' design does (csrc/streamstep.cu): the
    MAC, an m-point complex FFT (5 m log2 m) for each block's frame (two in
    the TV scan) and each of the nb + 1 output rows of a channel, the pack
    (14 a bin) and the fold and unpack (18 a bin)."""
    nf = (2 if tv else 1) * nb * nch
    ni = (nb + 1) * nch
    return 8.0 * nb * nch * nparts * m + (nf + ni) * 5.0 * m * math.log2(m) \
        + nf * 14.0 * m + ni * 18.0 * m


def launch_profile(fn, calls=3):
    """Each kernel fn() launches: (mean device microseconds a launch,
    launches a call) under torch.profiler (a session that records no kernel
    is taken again, twice at most; a session can drop launches, so a count
    is a lower bound)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        found = {e.key: (e.self_device_time_total / e.count, e.count / calls)
                 for e in prof.key_averages() if e.self_device_time_total > 0}
        if found:
            return found
    return {}


def launch_us(fn, calls=3):
    """Mean device microseconds of one launch of each kernel fn() launches."""
    return {k: us for k, (us, _) in launch_profile(fn, calls).items()}


def graph_kernel_nodes(fn):
    """(kernel nodes, all nodes) of one fn() call captured into a CUDA graph,
    read through the driver's graph API on torch's cudaGraph_t: the exact
    launches of a call, where a profiler session can drop some."""
    cuda = ctypes.CDLL("libcuda.so.1")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0, "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0, "cuGraphGetNodes")
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0,
              "cuGraphNodeGetType")
        kinds.append(kind.value)
    del graph
    return sum(k == 0 for k in kinds), len(kinds)   # 0: CU_GRAPH_NODE_TYPE_KERNEL


def check_one_launch(fn, counter, kernel, what):
    """Check that a call of fn() makes one launch, of the __global__ kernel
    named ``kernel``: the wrapper's launch counter (``counter()``) rises by
    one a call, one call captured into a CUDA graph holds one kernel node,
    and the profiler's __global__ list holds that kernel and no other (a
    read that records no kernel is taken again, five reads at most; an empty
    last read fails). Returns what was read, for the phase's line."""
    before = counter()
    fn()
    torch.cuda.synchronize()
    check(counter() - before == 1, f"{what}: the launch counter rose by {counter() - before}")
    kernels, nodes = graph_kernel_nodes(fn)
    check(kernels == 1, f"{what}: one call's CUDA graph holds {kernels} kernel nodes")
    for _ in range(5):
        names = [(re.search(r"\w+_kernel(?:<\w*>)?", k) or re.search(".{0,60}", k)).group(0)
                 for k in launch_profile(fn, calls=10)]
        if names:
            break
    check(len(names) == 1 and kernel in names[0],
          f"{what} launches {kernel} alone, the profiler's __global__ list {names}")
    return f"1 kernel node of {nodes} in one call's CUDA graph, the profiler's list {names}"


def scan_parts(fn, tv):
    """Device microseconds of a scan call's forward transforms / MAC /
    inverse transforms / the rest: each kernel's mean a launch under
    torch.profiler (a profiler session can drop launches) times its
    launches a scan (the forward transform twice in the TV scan)."""
    parts = {"forward": 0.0, "MAC": 0.0, "inverse": 0.0, "rest": 0.0}
    for kn, us in launch_us(fn).items():
        part = ("inverse" if "inv" in kn or "unpack" in kn or "ola" in kn
                else "forward" if "fwd" in kn or "z_planes" in kn or "pack" in kn
                else "MAC" if "mac" in kn else "rest")
        parts[part] += us * (2 if tv and part == "forward" else 1)
    return parts


def fmt_parts(parts, mac_flops):
    """'fwd / MAC / inv / rest us (MAC x TFLOP/s)'."""
    return (" / ".join(f"{v:.1f}" for v in parts.values())
            + f" us (MAC {mac_flops / (parts['MAC'] * 1e-6) / 1e12:.2f} TFLOP/s)")


def ptxas_summary(log):
    """Per kernel (template argument as <n>), its ptxas register/smem line."""
    kernels, resources = [], []
    for ln in log.splitlines():
        found = re.search(r"Compiling entry function '\w*?\d+([a-z_]+_kernel)(?:IL\w*?(\d+)EE)?",
                          ln)
        if found:
            kernels.append(found.group(1) + (f"<{found.group(2)}>" if found.group(2) else ""))
        elif "Used" in ln:
            resources.append(ln.split(":", 1)[1].strip())
    return "; ".join(f"{k}: {r}" for k, r in zip(kernels, resources))


def device_us(fn, calls=10):
    """Device microseconds per call of fn(): the kernels' and copies' time
    under torch.profiler over ``calls`` calls (a session that records none
    is taken again, twice at most)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA) / calls
        if us > 0:
            return us
    return us


def graph_us(fn, nsets, calls=20, reps=7):
    """Device microseconds per call of fn(i): ``calls`` calls, i cycling
    over ``nsets`` input sets, captured into one CUDA graph and replayed
    under CUDA events, so no host launch cost is timed; with sets that
    together outgrow the L2, each call reads its inputs from HBM."""
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
    return statistics.median(times)


def profile_streams(streams, calls=10, phase=17):
    """Per (label, fn): device microseconds per call of each kernel and
    copy under torch.profiler (the 8 largest) and their sum, against the
    host wall per call of a synchronised run without the profiler; one
    line per label."""
    from torch.profiler import ProfilerActivity, profile

    for label, fn in streams:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) / calls * 1e6
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.self_device_time_total / calls) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
        rows.sort(key=lambda r: -r[1])
        busy = sum(us for _, us in rows)
        print(f"phase {phase} profile {label}: device busy {busy:.1f} us of {wall_us:.1f} us "
              f"host wall per call ({100 * busy / wall_us:.1f}%); {len(rows)} kinds; top: "
              + "; ".join(f"{k[:60]} {us:.1f} us" for k, us in rows[:8]), flush=True)


def direct_tv_model(irsize, vsize, xs, hs, off=1):
    """float64 model of the direct engine's time-varying blocks
    (cl_dconv.cpp:109-148): operand 2 goes into the coefficient ring and
    operand 1 into the delay line at the ring pointer, then output n is
    sum_h d[n + off + h] * coefs[irsize-1-h] over the rotated delay line."""
    ring = irsize + vsize
    dl, co, wp, outs = np.zeros(ring), np.zeros(ring), 0, []
    for x, h in zip(xs, hs):
        idx = (wp + np.arange(vsize)) % ring
        co[idx] = h
        dl[idx] = x
        wp = (wp + vsize) % ring
        d = np.roll(dl, -wp)
        k = co[:irsize][::-1]
        outs.append([d[n + off:n + off + irsize] @ k for n in range(vsize)])
    return np.concatenate(outs)


def zl_replayed_fires(segments, block, nblocks):
    """Each zero-latency segment's step-wrapper launches over nblocks
    callbacks of ``process`` from t = 0 on a card, whose graph path
    (``models/lowlatency._Phases``) fires the segments of one partition
    inside replayed graphs: theirs are the launches of the first, eager
    cycle of P blocks and of the capture (one cycle's more); a terminal
    segment of several partitions fires on its cadence, above pts 2048 by
    its step graph (``ops/pconv.StepGraph``: the eager cycle's firing, the
    graph's eager first and its capture launch, its replays do not), else
    eagerly."""
    from opencl_fft_tpu_torch.ops import pconv as PC

    period = max([s_.pts // block for s_ in segments] + [2])
    out = []
    for s_ in segments:
        r_ = s_.pts // block
        if s_.nparts > 1:
            fires_ = nblocks // r_
            out.append(min(fires_, 3) if s_.pts > PC._FWD_MM_MAX_PTS else fires_)
        else:
            out.append(min(nblocks, period) // r_ + (period // r_ if nblocks > period else 0))
    return out


def main():
    # phase 1: the card
    check(torch.cuda.is_available(), "torch.cuda.is_available()")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 1 card: torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{name}; nvidia-smi: {smi}; allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    from scipy import signal as sps

    import opencl_fft_tpu_torch as P
    from opencl_fft_tpu_torch.ops import dconv as D
    from opencl_fft_tpu_torch.ops.cuda import _build
    from opencl_fft_tpu_torch.ops.cuda import blockstep as BS
    from opencl_fft_tpu_torch.ops.cuda import dstream as K
    from opencl_fft_tpu_torch.ops.cuda import mac as MC
    from opencl_fft_tpu_torch.ops.cuda import slidemac as SM
    from opencl_fft_tpu_torch.ops.cuda import streamstep as S
    from opencl_fft_tpu_torch.ops.cuda import vmemfft as V

    def zero_counts():
        S.BATCHED_LAUNCHES = S.BATCHED_TV_LAUNCHES = S.MATRIX_LAUNCHES = 0
        K.LAUNCHES = 0
        V.LAUNCHES = V.FRONT2_LAUNCHES = 0
        SM.CHUNKMAC_LAUNCHES = SM.MACFLOW_LAUNCHES = SM.MACFLOW_BATCHED_LAUNCHES = 0
        SM.MACFLOW_TV_LAUNCHES = SM.MACFLOW_TV_BATCHED_LAUNCHES = 0
        MC.LAUNCHES = BS.STEP_LAUNCHES = BS.FWD_LAUNCHES = BS.FWD_TV_LAUNCHES = 0
        BS.MAC_UNPACK_LAUNCHES = 0

    def step_counts():
        """Launches of spectral_mac, block_step_fused, block_step_fwd_fused
        and block_step_fwd_fused_tv."""
        return MC.LAUNCHES, BS.STEP_LAUNCHES, BS.FWD_LAUNCHES, BS.FWD_TV_LAUNCHES

    def worst_channel(got, want):
        """max over channels of max|got - want| / max|want| on (nb, C, pts)."""
        return max(float((got[:, c] - want[:, c]).abs().max()) / float(want[:, c].abs().max())
                   for c in range(got.shape[1]))

    # phase 2: build from the checkout's sources, one nvcc per source at once
    libs = ("streamstep", "dstream", "fft", "slidemac", "blockstep")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as ex:
        list(ex.map(_build.load, libs))
    build_s = time.perf_counter() - t0
    print(f"phase 2 build: {', '.join(f'{n}.cu' for n in libs)} for sm_90a in "
          f"{build_s:.3f} s (parallel); ptxas: "
          + " | ".join(f"{n}.cu: {ptxas_summary(_build.build_log(n))}" for n in libs),
          flush=True)

    rng = np.random.default_rng(0)

    def f(*shape, s=1.0):
        return torch.from_numpy((s * rng.standard_normal(shape)).astype(np.float32)).to(dev)

    def compare(pairs, where, worst):
        """Each (label, kernel, twin): finite, and within TOL of max|twin|."""
        for label, g, w in pairs:
            check(bool(torch.isfinite(g).all()), f"{label} finite at {where}")
            rel = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            check(rel <= TOL, f"kernel vs twin {label} at {where}: {rel:.3e} > {TOL}")
            worst = max(worst, rel)
        return worst

    # phase 3: LTI kernel vs plain twin on the card
    def scan_inputs(pts, nparts, nb):
        return (f(nb, pts, s=0.1), (f(nparts, pts), f(nparts, pts)),
                (f(nparts, pts, s=0.05), f(nparts, pts, s=0.05)), f(pts))

    headline = (PTS, IR_LEN // PTS, SCAN_BLOCKS)
    # the headline; pts 64, 128 and 2048 of the same IR; nb not a multiple of
    # a MAC tile, nparts below MAC_TT and not a multiple of a MAC stage
    shapes = [headline, (PTS, IR_LEN // PTS, 21), (64, IR_LEN // 64, 40), (128, 37, 70),
              (2048, IR_LEN // 2048, 470), (64, 5, 21), (256, 63, 65), (8, 9, 200), (2, 3, 5),
              (16, 1, 1)]
    headline_err = 0.0
    worst = 0.0
    for pts, nparts, nb in shapes:
        blocks, w0, h, tail = scan_inputs(pts, nparts, nb)
        for b0 in (1.0, 2.0):
            n0 = S.BATCHED_LAUNCHES
            got = S.stream_steps_fused(blocks, w0, h, b0, tail, pts)
            again = S.stream_steps_fused(blocks, w0, h, b0, tail, pts)
            torch.cuda.synchronize()
            check(S.BATCHED_LAUNCHES == n0 + 2, "BATCHED_LAUNCHES counts the kernel launch")
            check(all(torch.equal(a_, b_) for a_, b_ in zip((got[0], *got[1], got[2]),
                                                           (again[0], *again[1], again[2]))),
                  f"the LTI scan repeats its bits at pts={pts} nparts={nparts} nb={nb}")
            want = S.stream_steps_fused_plain(blocks, w0, h, b0, tail, pts)
            worst = compare((("out", got[0], want[0]), ("window re", got[1][0], want[1][0]),
                             ("window im", got[1][1], want[1][1]),
                             ("tail", got[2], want[2])),
                            f"pts={pts} nparts={nparts} nb={nb} b0={b0}", worst)
            if (pts, nparts, nb) == headline:
                headline_err = max(headline_err, float((got[0] - want[0]).abs().max()))
    print(f"phase 3 kernel vs twin: shapes (pts,nparts,nb) {shapes} x b0 {{1,2}}, bit-equal "
          f"on a second launch; worst rel err {worst:.3e} (tol {TOL}); headline out "
          f"max_abs_err {headline_err:.3e}", flush=True)

    # phase 4: LTI main path, convolve() on the card, against scipy in float64
    x = (0.1 * rng.standard_normal(int(20 * SR))).astype(np.float32)
    decay = np.exp(-np.arange(IR_LEN) / (0.5 * SR))
    ir = (rng.standard_normal(IR_LEN) * decay).astype(np.float32)
    x_d, ir_d = torch.from_numpy(x).to(dev), torch.from_numpy(ir).to(dev)
    zero_counts()
    y = P.convolve(x_d, ir_d, PTS)
    torch.cuda.synchronize()
    main_launches = S.BATCHED_LAUNCHES
    check(main_launches > 0, "the main path launched the stream kernel")
    y = y.cpu().numpy()
    ref = sps.fftconvolve(x.astype(np.float64), ir.astype(np.float64))
    check(y.shape == ref.shape and bool(np.isfinite(y).all()), "convolve shape/finite")
    err4 = rel_err(y, ref)
    check(err4 <= ORACLE_TOL, f"convolve vs scipy {err4:.3e} > {ORACLE_TOL}")
    print(f"phase 4 main path: convolve({x.size} samples, {IR_LEN} taps, pts={PTS}) "
          f"on {dev}: rel err vs float64 scipy {err4:.3e} (tol {ORACLE_TOL}); "
          f"stream kernel launches {main_launches}", flush=True)

    # phase 5: opcode entry point, 64-sample host blocks for 2 s
    proc = P.ClconvProcessor(ir, parts=PTS, device="cuda", on_message=lambda m, u: None)
    xs = x[: int(2 * SR)]
    out = np.concatenate([proc.process(xs[i:i + 64]) for i in range(0, xs.size, 64)])
    lat = proc.latency
    ref5 = sps.fftconvolve(xs.astype(np.float64), ir.astype(np.float64))[: xs.size - lat]
    check(bool(np.isfinite(out).all()) and np.all(out[:lat] == 0), "processor output")
    err5 = rel_err(out[lat:], ref5)
    check(err5 <= ORACLE_TOL, f"ClconvProcessor vs scipy {err5:.3e} > {ORACLE_TOL}")
    print(f"phase 5 opcode: ClconvProcessor(parts={PTS}) fed {xs.size // 64} host "
          f"blocks of 64: latency {lat}, rel err vs scipy {err5:.3e} "
          f"(tol {ORACLE_TOL})", flush=True)

    # phase 6: timing at the bench shape
    cfg = P.PconvConfig.for_ir_length(IR_LEN, PTS)
    state = P.push_ir(cfg, P.pconv_init(cfg, dev), ir_d)
    blocks = f(SCAN_BLOCKS, PTS, s=0.1)
    stream_ms = cuda_ms(lambda: P.pconv_stream(cfg, state, blocks), reps=15)
    w0 = (state.spec_x_re[:cfg.nparts].contiguous(), state.spec_x_im[:cfg.nparts].contiguous())
    h = (state.spec_h_re, state.spec_h_im)
    kernel_ms = cuda_ms(lambda: S.stream_steps_fused(blocks, w0, h, 2.0, state.tail, PTS),
                        reps=15)
    plain_ms = cuda_ms(lambda: S.stream_steps_fused_plain(blocks, w0, h, 2.0, state.tail, PTS),
                       warmup=1, reps=5)
    audio_s = SCAN_BLOCKS * PTS / SR
    rtf = audio_s / (stream_ms / 1e3)
    nb, np_, b = SCAN_BLOCKS, cfg.nparts, cfg.bins
    # least work: the MAC and one forward and one inverse transform a block;
    # bytes: blocks, window and tail in and out, the IR spectra in
    lti_flops = stream_flops(nb, np_, b, PTS, 2 * nb)
    lti_bound = bound(lti_flops, 2 * nbytes(blocks, *w0, state.tail) + nbytes(*h))
    # what the design does: the MAC and FFT-sized transforms
    design_flops = scan_design_flops(nb, 1, np_, b, False)
    mac1_flops = 8.0 * nb * np_ * b

    def scan_sets(nb_, nch, n_h):
        """Input sets of a scan (blocks, then n_h more block sets, windows, h
        planes, tails) that together outgrow the L2 twice, for device time
        from HBM."""
        def one():
            return ([f(nb_, nch, PTS, s=0.1) for _ in range(1 + n_h)],
                    (f(nch, np_, PTS), f(nch, np_, PTS)),
                    (f(nch, np_, PTS, s=0.05), f(nch, np_, PTS, s=0.05)), f(nch, PTS))
        first = one()
        size = nbytes(*first[0], *first[1], *first[2], first[3])
        return [first] + [one() for _ in range(-(-2 * L2_BYTES // size))]

    sets6 = scan_sets(SCAN_BLOCKS, 1, 0)
    k1_hbm = graph_us(lambda i: S.stream_steps_fused(
        sets6[i][0][0][:, 0], (sets6[i][1][0][0], sets6[i][1][1][0]),
        (sets6[i][2][0][0], sets6[i][2][1][0]), 2.0, sets6[i][3][0], PTS), len(sets6))
    k1_parts = scan_parts(lambda: S.stream_steps_fused(blocks, w0, h, 2.0, state.tail, PTS),
                          False)
    del sets6
    print(f"phase 6 timing [{card}]: pconv_stream {SCAN_BLOCKS}x{PTS} blocks, {IR_LEN} taps: "
          f"{stream_ms:.4f} ms/scan = {rtf:.1f}x real time ({1e3 * stream_ms / SCAN_BLOCKS:.4f} "
          f"us/block); stream_steps_fused kernel {kernel_ms:.4f} ms/scan by events, {k1_hbm:.1f} "
          f"us from HBM by CUDA graph ({100 * lti_bound[0] * 1e3 / k1_hbm:.1f}% of the bound), "
          f"forward / MAC / inverse / rest {fmt_parts(k1_parts, mac1_flops)}; plain twin "
          f"{plain_ms:.4f} ms/scan (median CUDA-event times); bound {lti_bound[0]:.4f} ms "
          f"({lti_bound[1]}, {lti_flops / 1e9:.3f} GFLOP of MAC and FFTs; the design does "
          f"{design_flops / 1e9:.3f})", flush=True)

    # phase 7: TV kernel vs plain twin on the card
    tv_shapes = [headline + (np_ - 1,), (PTS, np_, 21, 100), (64, IR_LEN // 64, 40, 2047),
                 (128, 37, 70, 3), (2048, IR_LEN // 2048, 470, 63), (64, 5, 21, 2),
                 (128, 8, 3, 6), (256, 63, 65, 62), (8, 9, 200, 4), (2, 3, 5, 1), (16, 1, 1, 0)]
    tv_err = 0.0
    worst = 0.0
    for pts, nparts, nb_, wp2 in tv_shapes:
        bx, w0_, h0_, tail = scan_inputs(pts, nparts, nb_)
        bh = f(nb_, pts, s=0.1)
        for b0 in (1.0, 2.0):
            n0 = S.BATCHED_TV_LAUNCHES
            got = S.stream_steps_fused_tv(bx, bh, w0_, h0_, wp2, b0, tail, pts)
            again = S.stream_steps_fused_tv(bx, bh, w0_, h0_, wp2, b0, tail, pts)
            torch.cuda.synchronize()
            check(S.BATCHED_TV_LAUNCHES == n0 + 2, "BATCHED_TV_LAUNCHES counts the kernel launch")
            check(all(torch.equal(a_, b_) for a_, b_ in zip((got[0], *got[1], *got[2], got[3]),
                                                           (again[0], *again[1], *again[2],
                                                            again[3]))),
                  f"the TV scan repeats its bits at pts={pts} nparts={nparts} nb={nb_}")
            want = S.stream_steps_fused_tv_plain(bx, bh, w0_, h0_, wp2, b0, tail, pts)
            worst = compare((("out", got[0], want[0]), ("window re", got[1][0], want[1][0]),
                             ("window im", got[1][1], want[1][1]),
                             ("h ring re", got[2][0], want[2][0]),
                             ("h ring im", got[2][1], want[2][1]),
                             ("tail", got[3], want[3])),
                            f"pts={pts} nparts={nparts} nb={nb_} wp2={wp2} b0={b0}", worst)
            if (pts, nparts, nb_) == headline:
                tv_err = max(tv_err, float((got[0] - want[0]).abs().max()))
    print(f"phase 7 TV kernel vs twin: shapes (pts,nparts,nb,wp2) {tv_shapes} x b0 {{1,2}}, "
          f"bit-equal on a second launch; "
          f"worst rel err {worst:.3e} (tol {TOL}); headline out max_abs_err {tv_err:.3e}",
          flush=True)

    # phase 8: direct-FIR kernel vs plain twin (the Toeplitz product of the
    # slabs built from the same taps) on the card
    d_shapes = [(DIRECT_TAPS, PTS, SCAN_BLOCKS), (DIRECT_TAPS, PTS, 21), (7 * 128, 128, 200),
                (1000, 256, 40), (5, 3, 1), (3000, 64, 100)]
    d_err = 0.0
    worst = 0.0
    for irsize, vsize, nb_ in d_shapes:
        seq = f(K.context_blocks(irsize, vsize) + nb_, vsize)
        coefs = f(irsize, s=0.1)
        for off in (0, 1):          # delay_compat True / False
            n0 = K.LAUNCHES
            got = K.dstream_steps(seq, coefs, vsize, off)
            torch.cuda.synchronize()
            check(K.LAUNCHES == n0 + 1, "dstream LAUNCHES counts the kernel launch")
            want = K.dstream_steps_plain(seq, K.toeplitz_slabs(coefs, irsize, vsize, off), vsize)
            worst = compare((("out", got, want),),
                            f"irsize={irsize} vsize={vsize} nb={nb_} off={off}", worst)
            if (irsize, vsize, nb_) == d_shapes[0]:
                d_err = max(d_err, float((got - want).abs().max()))
    print(f"phase 8 dstream kernel vs twin: shapes (irsize,vsize,nb) {d_shapes} x "
          f"delay_compat {{0,1}}; worst rel err {worst:.3e} (tol {TOL}); 512@512 out "
          f"max_abs_err {d_err:.3e}", flush=True)

    # phase 9: TV main path. After push_ir, feeding the IR's partitions
    # cyclically through operand 2 rewrites each ring slot with the frame
    # it already holds, so pconv_stream_tv must equal the full convolution.
    nb_tv = -(-(x.size + IR_LEN) // PTS)
    x_p = torch.nn.functional.pad(x_d, (0, nb_tv * PTS - x.size)).reshape(nb_tv, PTS)
    h_cyc = ir_d.reshape(cfg.nparts, PTS)[torch.arange(nb_tv, device=dev) % cfg.nparts]
    state = P.push_ir(cfg, P.pconv_init(cfg, dev), ir_d)
    zero_counts()
    _, y_tv = P.pconv_stream_tv(cfg, state, x_p, h_cyc.contiguous())
    torch.cuda.synchronize()
    tv_launches = S.BATCHED_TV_LAUNCHES
    check(tv_launches > 0, "the TV main path launched the TV kernel")
    y_tv = y_tv.reshape(-1)[:ref.size].cpu().numpy()
    check(bool(np.isfinite(y_tv).all()), "pconv_stream_tv finite")
    err9 = rel_err(y_tv, ref)
    check(err9 <= ORACLE_TOL, f"pconv_stream_tv vs scipy {err9:.3e} > {ORACLE_TOL}")
    tvp = P.CltvconvProcessor(PTS, IR_LEN, device="cuda", on_message=lambda m, u: None)
    ir_cyc = np.resize(ir, xs.size)
    out = np.concatenate([tvp.process(xs[i:i + 64], ir_cyc[i:i + 64])
                          for i in range(0, xs.size, 64)])
    check(bool(np.isfinite(out).all()) and np.all(out[:PTS] == 0), "TV processor output")
    err9p = rel_err(out[PTS:], ref5[: xs.size - PTS])
    check(err9p <= ORACLE_TOL, f"CltvconvProcessor vs scipy {err9p:.3e} > {ORACLE_TOL}")
    print(f"phase 9 TV main path: push_ir + pconv_stream_tv({nb_tv}x{PTS} blocks, IR "
          f"partitions cyclic in operand 2) on {dev}: rel err vs float64 scipy {err9:.3e}; "
          f"CltvconvProcessor(parts={PTS}) fed {xs.size // 64} host blocks of 64: rel err "
          f"{err9p:.3e} (tol {ORACLE_TOL}); TV kernel launches {tv_launches}", flush=True)

    # phase 10: direct path, convolve_direct of 20 s against numpy in float64
    ir_d512 = (0.1 * rng.standard_normal(DIRECT_TAPS)).astype(np.float32)
    zero_counts()
    y_d = P.convolve_direct(x_d, torch.from_numpy(ir_d512).to(dev), vsize=PTS)
    torch.cuda.synchronize()
    d_launches = K.LAUNCHES
    check(d_launches > 0, "the direct path launched the dstream kernel")
    y_d = y_d.cpu().numpy()
    ref10 = np.convolve(x.astype(np.float64), ir_d512.astype(np.float64))
    check(y_d.shape == ref10.shape and bool(np.isfinite(y_d).all()),
          "convolve_direct shape/finite")
    err10 = rel_err(y_d, ref10)
    check(err10 <= ORACLE_TOL, f"convolve_direct vs numpy {err10:.3e} > {ORACLE_TOL}")
    bs, nblk = 64, 20
    xs10 = x[: bs * nblk]
    cp = P.ClconvProcessor(ir_d512, parts=1, block_size=bs, device="cuda",
                           on_message=lambda m, u: None)
    check(cp.latency == 0, "direct processor latency 0")
    out = np.concatenate([cp.process(xs10[i:i + bs]) for i in range(0, xs10.size, bs)])
    err10c = rel_err(out, ref10[: xs10.size])
    hs = (0.1 * rng.standard_normal(xs10.size)).astype(np.float32)
    tp = P.CltvconvProcessor(1, DIRECT_TAPS, block_size=bs, device="cuda",
                             on_message=lambda m, u: None)
    out = np.concatenate([tp.process(xs10[i:i + bs], hs[i:i + bs])
                          for i in range(0, xs10.size, bs)])
    model = direct_tv_model(DIRECT_TAPS, bs, xs10.reshape(nblk, bs).astype(np.float64),
                            hs.reshape(nblk, bs).astype(np.float64))
    err10t = rel_err(out, model)
    check(max(err10c, err10t) <= ORACLE_TOL,
          f"direct processors vs float64 models {err10c:.3e}, {err10t:.3e} > {ORACLE_TOL}")
    print(f"phase 10 direct path: convolve_direct({x.size} samples, {DIRECT_TAPS} taps, "
          f"vsize={PTS}) on {dev}: rel err vs float64 numpy {err10:.3e}; "
          f"ClconvProcessor(parts=1) {nblk} blocks of {bs}: {err10c:.3e}; "
          f"CltvconvProcessor(parts=1): {err10t:.3e} (tol {ORACLE_TOL}); dstream kernel "
          f"launches {d_launches}", flush=True)

    # phase 11: TV and direct timing at the bench shapes
    state = P.push_ir(cfg, P.pconv_init(cfg, dev), ir_d)
    bh = f(SCAN_BLOCKS, PTS, s=0.1)
    tv_stream_ms = cuda_ms(lambda: P.pconv_stream_tv(cfg, state, blocks, bh), reps=15)
    w0 = (state.spec_x_re[:cfg.nparts].contiguous(), state.spec_x_im[:cfg.nparts].contiguous())
    h0 = (state.spec_h_re, state.spec_h_im)
    tv_args = (blocks, bh, w0, h0, state.wp2, 2.0, state.tail, PTS)
    tv_kernel_ms = cuda_ms(lambda: S.stream_steps_fused_tv(*tv_args), reps=15)
    tv_plain_ms = cuda_ms(lambda: S.stream_steps_fused_tv_plain(*tv_args), warmup=1, reps=5)
    # least work: the MAC and two forward and one inverse transform a block;
    # bytes: both block sets, window, h ring and tail, in and out
    tv_flops = stream_flops(nb, np_, b, PTS, 3 * nb)
    tv_bound = bound(tv_flops, 2 * nbytes(blocks, *w0, *h0, state.tail) + nbytes(bh))
    tv_design_flops = scan_design_flops(nb, 1, np_, b, True)
    sets11 = scan_sets(SCAN_BLOCKS, 1, 1)
    k2_hbm = graph_us(lambda i: S.stream_steps_fused_tv(
        sets11[i][0][0][:, 0], sets11[i][0][1][:, 0], (sets11[i][1][0][0], sets11[i][1][1][0]),
        (sets11[i][2][0][0], sets11[i][2][1][0]), np_ - 1, 2.0, sets11[i][3][0], PTS),
        len(sets11))
    k2_parts = scan_parts(lambda: S.stream_steps_fused_tv(*tv_args), True)
    del sets11

    dcfg = D.DconvConfig(irsize=DIRECT_TAPS, vsize=PTS)
    dstate = D.push_ir(dcfg, D.dconv_init(dcfg, dev), torch.from_numpy(ir_d512).to(dev))
    d_stream_ms = cuda_ms(lambda: D.dconv_stream(dcfg, dstate, blocks), reps=15)
    p = K.context_blocks(DIRECT_TAPS, PTS)
    taps = dstate.coefs[:DIRECT_TAPS]
    seqs = [torch.cat([f(p, PTS), blocks])] + [f(p + SCAN_BLOCKS, PTS) for _ in range(3)]
    seq = seqs[0]
    slabs = K.toeplitz_slabs(taps, DIRECT_TAPS, PTS, dcfg.off)
    d_call_ms = cuda_ms(lambda: K.dstream_steps(seq, taps, PTS, dcfg.off), reps=15)
    d_plain_ms = cuda_ms(lambda: K.dstream_steps_plain(seq, slabs, PTS), reps=15)
    d_lib_call_ms = cuda_ms(lambda: torch.matmul(K.context_rows(seq, p, PTS), slabs), reps=15)
    # device time without the host's launch cost: CUDA graphs over 4 input
    # sets, the kernel and the library call alike
    d_kernel_ms = graph_us(lambda i: K.dstream_steps(seqs[i], taps, PTS, dcfg.off), 4) / 1e3
    d_lib_ms = graph_us(lambda i: torch.matmul(K.context_rows(seqs[i], p, PTS), slabs), 4) / 1e3
    # least work: an irsize-tap dot product per output sample; bytes: the
    # context and the blocks in, the outputs out, the taps in
    d_flops = 2.0 * SCAN_BLOCKS * PTS * DIRECT_TAPS
    d_bound = bound(d_flops, nbytes(seq, blocks) + 4 * DIRECT_TAPS)
    print(f"phase 11 timing [{card}]: pconv_stream_tv {SCAN_BLOCKS}x{PTS} blocks, {IR_LEN} "
          f"taps: {tv_stream_ms:.4f} ms/scan = {audio_s / (tv_stream_ms / 1e3):.1f}x real "
          f"time; stream_steps_fused_tv kernel {tv_kernel_ms:.4f} ms by events, {k2_hbm:.1f} us "
          f"from HBM by CUDA graph ({100 * tv_bound[0] * 1e3 / k2_hbm:.1f}% of the bound), "
          f"forward / MAC / inverse / rest {fmt_parts(k2_parts, mac1_flops)}; plain twin "
          f"{tv_plain_ms:.4f} ms; bound {tv_bound[0]:.4f} ms ({tv_bound[1]}, "
          f"{tv_flops / 1e9:.3f} GFLOP of MAC and FFTs; the design does "
          f"{tv_design_flops / 1e9:.3f}) | dconv_stream {SCAN_BLOCKS}x{PTS} blocks, "
          f"{DIRECT_TAPS} taps: {d_stream_ms:.4f} ms/scan = "
          f"{audio_s / (d_stream_ms / 1e3):.1f}x real time; dstream_steps kernel "
          f"{d_kernel_ms:.4f} ms by CUDA graph ({100 * d_bound[0] / d_kernel_ms:.1f}% of the "
          f"bound; one call by events {d_call_ms:.4f}); torch.matmul of the strided product "
          f"{d_lib_ms:.4f} ms by CUDA graph (one call {d_lib_call_ms:.4f}); plain twin "
          f"{d_plain_ms:.4f} ms; bound {d_bound[0]:.4f} ms ({d_bound[1]}, "
          f"{d_flops / 1e9:.3f} GFLOP of taps, all the kernel does)", flush=True)

    # phase 12: batched (serving) kernels vs plain twins on the card; TV
    # with one shared ring pointer and with one per channel
    def batched_inputs(pts, nparts, nb, nch):
        return (f(nb, nch, pts, s=0.1), f(nb, nch, pts, s=0.1),
                (f(nch, nparts, pts), f(nch, nparts, pts)),
                (f(nch, nparts, pts, s=0.05), f(nch, nparts, pts, s=0.05)), f(nch, pts))

    serving = (PTS, IR_LEN // PTS, SERVE_BLOCKS, SERVE_CH)
    b_shapes = [serving, (64, IR_LEN // 64, 40, 4), (128, 37, 70, 3),
                (2048, IR_LEN // 2048, 117, SERVE_CH), (64, 5, 21, 3), (128, 8, 3, 1),
                (256, 63, 65, 3), (2, 3, 5, 2), (16, 1, 1, 2)]
    b_err = bt_err = worst = 0.0
    for pts, nparts, nb_, nch in b_shapes:
        px, ph, w0_, h0_, tails = batched_inputs(pts, nparts, nb_, nch)
        where = f"pts={pts} nparts={nparts} nb={nb_} C={nch}"
        for b0 in (1.0, 2.0):
            n0 = S.BATCHED_LAUNCHES
            got = S.stream_steps_fused_batched(px, w0_, h0_, b0, tails, pts)
            again = S.stream_steps_fused_batched(px, w0_, h0_, b0, tails, pts)
            torch.cuda.synchronize()
            check(S.BATCHED_LAUNCHES == n0 + 2, "BATCHED_LAUNCHES counts the kernel launch")
            check(all(torch.equal(a_, b_) for a_, b_ in zip((got[0], *got[1], got[2]),
                                                           (again[0], *again[1], again[2]))),
                  f"the batched scan repeats its bits at {where}")
            want = S.stream_steps_fused_batched_plain(px, w0_, h0_, b0, tails, pts)
            worst = compare((("out", got[0], want[0]), ("window re", got[1][0], want[1][0]),
                             ("window im", got[1][1], want[1][1]),
                             ("tails", got[2], want[2])), f"{where} b0={b0}", worst)
            if (pts, nparts, nb_, nch) == serving:
                b_err = max(b_err, float((got[0] - want[0]).abs().max()))
            for wp2 in (nparts - 1, tuple((7 * c + 3) % nparts for c in range(nch))):
                n0 = S.BATCHED_TV_LAUNCHES
                got = S.stream_steps_fused_batched_tv(px, ph, w0_, h0_, wp2, b0, tails, pts)
                again = S.stream_steps_fused_batched_tv(px, ph, w0_, h0_, wp2, b0, tails, pts)
                torch.cuda.synchronize()
                check(S.BATCHED_TV_LAUNCHES == n0 + 2,
                      "BATCHED_TV_LAUNCHES counts the kernel launch")
                check(all(torch.equal(a_, b_) for a_, b_ in zip(
                    (got[0], *got[1], *got[2], got[3]), (again[0], *again[1], *again[2],
                                                         again[3]))),
                      f"the batched TV scan repeats its bits at {where}")
                want = S.stream_steps_fused_batched_tv_plain(px, ph, w0_, h0_, wp2, b0,
                                                             tails, pts)
                worst = compare((("out", got[0], want[0]),
                                 ("window re", got[1][0], want[1][0]),
                                 ("window im", got[1][1], want[1][1]),
                                 ("h ring re", got[2][0], want[2][0]),
                                 ("h ring im", got[2][1], want[2][1]),
                                 ("tails", got[3], want[3])),
                                f"{where} b0={b0} wp2 {'per channel' if isinstance(wp2, tuple) else 'shared'}",
                                worst)
                if (pts, nparts, nb_, nch) == serving:
                    bt_err = max(bt_err, float((got[0] - want[0]).abs().max()))
    del px, ph, w0_, h0_, tails, got, again, want
    print(f"phase 12 batched kernels vs twins: shapes (pts,nparts,nb,C) {b_shapes} x b0 "
          f"{{1,2}}, TV wp2 shared and per channel, bit-equal on a second launch; worst rel err {worst:.3e} (tol {TOL}); "
          f"serving out max_abs_err LTI {b_err:.3e} TV {bt_err:.3e}", flush=True)

    # phase 13: LTI serving main path: Convolver(cfg, 64).push_ir, then one
    # 470-block scan of all 64 channels, against the single-channel kernel
    # path on every channel and against float64 scipy on four
    n_serve = SERVE_BLOCKS * PTS
    irs = (rng.standard_normal((SERVE_CH, IR_LEN)) * decay).astype(np.float32)
    xs_serve = (0.1 * rng.standard_normal((SERVE_CH, n_serve))).astype(np.float32)
    irs_d = torch.from_numpy(irs).to(dev)
    serve_blocks = torch.from_numpy(
        np.ascontiguousarray(xs_serve.reshape(SERVE_CH, SERVE_BLOCKS, PTS).transpose(1, 0, 2))
    ).to(dev)
    conv = P.Convolver(cfg, SERVE_CH, device=dev)
    conv.push_ir(irs_d)
    zero_counts()
    y_serve = conv.stream(serve_blocks)
    torch.cuda.synchronize()
    serve_launches = S.BATCHED_LAUNCHES
    check(serve_launches > 0, "the serving path launched the batched kernel")
    check(tuple(y_serve.shape) == (SERVE_BLOCKS, SERVE_CH, PTS)
          and bool(torch.isfinite(y_serve).all()), "Convolver.stream shape/finite")
    singles = []
    for c in range(SERVE_CH):
        st = P.push_ir(cfg, P.pconv_init(cfg, dev), irs_d[c])
        singles.append(P.pconv_stream(cfg, st, serve_blocks[:, c])[1])
    singles = torch.stack(singles, 1)
    err13 = max(float((y_serve[:, c] - singles[:, c]).abs().max())
                / float(singles[:, c].abs().max()) for c in range(SERVE_CH))
    check(err13 <= TOL, f"Convolver.stream vs single-channel pconv_stream {err13:.3e} > {TOL}")
    y_np = y_serve.cpu().numpy()
    oracle_ch = (0, SERVE_CH // 3, 2 * SERVE_CH // 3, SERVE_CH - 1)
    refs = {c: sps.fftconvolve(xs_serve[c].astype(np.float64),
                               irs[c].astype(np.float64))[:n_serve] for c in oracle_ch}
    err13o = max(rel_err(y_np[:, c].reshape(-1), refs[c]) for c in oracle_ch)
    check(err13o <= ORACLE_TOL, f"Convolver.stream vs scipy {err13o:.3e} > {ORACLE_TOL}")
    # the per-block step's state chains into the scan: 3 steps (the block
    # step kernel), then a scan of 8 blocks, against the scan of all of them
    conv_st = P.Convolver(cfg, SERVE_CH, device=dev)
    conv_st.push_ir(irs_d)
    y_st = torch.stack([conv_st.step(serve_blocks[i]) for i in range(3)])
    y_st = torch.cat([y_st, conv_st.stream(serve_blocks[3:11])])
    err13s = worst_channel(y_st, y_serve[:11])
    check(err13s <= TOL, f"Convolver.step then stream vs stream {err13s:.3e} > {TOL}")
    print(f"phase 13 serving main path: Convolver(C={SERVE_CH}).push_ir({SERVE_CH}x{IR_LEN}) + "
          f"stream({SERVE_BLOCKS}x{SERVE_CH}x{PTS}) on {dev}: vs single-channel pconv_stream "
          f"on all {SERVE_CH} channels {err13:.3e} (tol {TOL}); vs float64 scipy on channels "
          f"{oracle_ch} {err13o:.3e} (tol {ORACLE_TOL}); 3 step() then stream(8) vs stream "
          f"{err13s:.3e} (tol {TOL}); batched kernel launches {serve_launches}", flush=True)

    # phase 14: TV serving main path: from a zero state, each channel's IR
    # partitions fed cyclically through operand 2 (partition j arrives
    # before any input block it multiplies), so TVConvolver.stream equals
    # the full convolution; then MatrixConvolver true stereo
    h_cyc = irs_d.reshape(SERVE_CH, cfg.nparts, PTS)[
        :, torch.arange(SERVE_BLOCKS, device=dev) % cfg.nparts].transpose(0, 1).contiguous()
    tvc = P.TVConvolver(cfg, SERVE_CH, device=dev)
    zero_counts()
    y_tvs = tvc.stream(serve_blocks, h_cyc)
    torch.cuda.synchronize()
    serve_tv_launches = S.BATCHED_TV_LAUNCHES
    check(serve_tv_launches > 0, "the TV serving path launched the batched TV kernel")
    check(bool(torch.isfinite(y_tvs).all()), "TVConvolver.stream finite")
    err14 = max(float((y_tvs[:, c] - singles[:, c]).abs().max())
                / float(singles[:, c].abs().max()) for c in range(SERVE_CH))
    check(err14 <= ORACLE_TOL, f"TVConvolver.stream vs pconv_stream {err14:.3e} > {ORACLE_TOL}")
    y_np = y_tvs.cpu().numpy()
    err14o = max(rel_err(y_np[:, c].reshape(-1), refs[c]) for c in oracle_ch)
    check(err14o <= ORACLE_TOL, f"TVConvolver.stream vs scipy {err14o:.3e} > {ORACLE_TOL}")
    tv_st = P.TVConvolver(cfg, SERVE_CH, device=dev)
    y_st = torch.stack([tv_st.step(serve_blocks[i], h_cyc[i]) for i in range(3)])
    y_st = torch.cat([y_st, tv_st.stream(serve_blocks[3:11], h_cyc[3:11])])
    err14s = worst_channel(y_st, y_tvs[:11])
    check(err14s <= TOL, f"TVConvolver.step then stream vs stream {err14s:.3e} > {TOL}")
    del conv_st, tv_st, y_st
    m_len, m_blocks = 1 << 14, 64
    mcfg = P.PconvConfig.for_ir_length(m_len, PTS)
    m_irs = (0.1 * rng.standard_normal((2, 2, m_len))).astype(np.float32)
    mx = (0.1 * rng.standard_normal((m_blocks, 2, PTS))).astype(np.float32)
    mconv = P.MatrixConvolver(mcfg, 2, 2, device=dev)
    mconv.push_ir(m_irs)
    n0 = (S.MATRIX_LAUNCHES, S.BATCHED_LAUNCHES)
    y_m = mconv.stream(torch.from_numpy(mx).to(dev)).cpu().numpy()
    check((S.MATRIX_LAUNCHES, S.BATCHED_LAUNCHES) == (n0[0] + 1, n0[1]),
          "MatrixConvolver.stream launched the matrix scan entry once, the batched one never")
    mxs = mx.transpose(1, 0, 2).reshape(2, -1).astype(np.float64)
    err14m = max(rel_err(y_m[:, o].reshape(-1),
                         sum(sps.fftconvolve(mxs[i], m_irs[o, i].astype(np.float64))
                             [:m_blocks * PTS] for i in range(2))) for o in range(2))
    check(err14m <= ORACLE_TOL, f"MatrixConvolver vs scipy {err14m:.3e} > {ORACLE_TOL}")
    print(f"phase 14 TV serving main path: TVConvolver(C={SERVE_CH}).stream("
          f"{SERVE_BLOCKS}x{SERVE_CH}x{PTS}, IR partitions cyclic in operand 2) on {dev}: vs "
          f"single-channel pconv_stream on all channels {err14:.3e}, vs float64 scipy "
          f"{err14o:.3e} (tol {ORACLE_TOL}); 3 step() then stream(8) vs stream {err14s:.3e} "
          f"(tol {TOL}); batched TV kernel launches {serve_tv_launches}; "
          f"MatrixConvolver(2, 2) true stereo, {m_len} taps x {m_blocks} blocks: vs scipy "
          f"{err14m:.3e}", flush=True)
    del singles, y_np, h_cyc

    # phase 15: serving timing, one 470-block scan of 64 channels
    serve_audio_s = SERVE_CH * SERVE_BLOCKS * PTS / SR
    sbx = f(SERVE_BLOCKS, SERVE_CH, PTS, s=0.1)
    sbh = f(SERVE_BLOCKS, SERVE_CH, PTS, s=0.1)
    serve_ms = cuda_ms(lambda: conv.stream(sbx), reps=9)
    serve_tv_ms = cuda_ms(lambda: tvc.stream(sbx, sbh), reps=9)
    cst = conv.state
    sw0 = (cst.spec_x_re[:, :cfg.nparts].contiguous(), cst.spec_x_im[:, :cfg.nparts].contiguous())
    sh = (cst.spec_h_re, cst.spec_h_im)
    b_args = (sbx, sw0, sh, 2.0, cst.tail, PTS)
    bt_args = (sbx, sbh, sw0, sh, cfg.nparts - 1, 2.0, cst.tail, PTS)
    b_kernel_ms = cuda_ms(lambda: S.stream_steps_fused_batched(*b_args), reps=9)
    bt_kernel_ms = cuda_ms(lambda: S.stream_steps_fused_batched_tv(*bt_args), reps=9)
    b_plain_ms = cuda_ms(lambda: S.stream_steps_fused_batched_plain(*b_args), warmup=1, reps=3)
    bt_plain_ms = cuda_ms(lambda: S.stream_steps_fused_batched_tv_plain(*bt_args),
                          warmup=1, reps=3)
    nbc = SERVE_BLOCKS * SERVE_CH
    # least work: the MAC and two (LTI) or three (TV) real transforms a
    # block of a channel; bytes: blocks, windows and tails in and out, the
    # IR spectra in (LTI) or in and out (TV), the coefficient blocks in
    b_flops = stream_flops(nbc, np_, b, PTS, 2 * nbc)
    bt_flops = stream_flops(nbc, np_, b, PTS, 3 * nbc)
    b_bound = bound(b_flops, 2 * nbytes(sbx, *sw0, cst.tail) + nbytes(*sh))
    bt_bound = bound(bt_flops, 2 * nbytes(sbx, *sw0, *sh, cst.tail) + nbytes(sbh))
    b_design = scan_design_flops(SERVE_BLOCKS, SERVE_CH, np_, b, False)
    bt_design = scan_design_flops(SERVE_BLOCKS, SERVE_CH, np_, b, True)
    mac64_flops = 8.0 * nbc * np_ * b
    sets15 = scan_sets(SERVE_BLOCKS, SERVE_CH, 1)
    k3_hbm = graph_us(lambda i: S.stream_steps_fused_batched(
        sets15[i][0][0], sets15[i][1], sets15[i][2], 2.0, sets15[i][3], PTS), len(sets15),
        calls=4, reps=5)
    k4_hbm = graph_us(lambda i: S.stream_steps_fused_batched_tv(
        sets15[i][0][0], sets15[i][0][1], sets15[i][1], sets15[i][2], np_ - 1, 2.0, sets15[i][3],
        PTS), len(sets15), calls=4, reps=5)
    del sets15
    k3_parts = scan_parts(lambda: S.stream_steps_fused_batched(*b_args), False)
    k4_parts = scan_parts(lambda: S.stream_steps_fused_batched_tv(*bt_args), True)
    print(f"phase 15 serving timing [{card}]: serving_64ch_audio_seconds_per_second LTI "
          f"{serve_audio_s / (serve_ms / 1e3):.1f} (Convolver.stream {SERVE_BLOCKS}x{SERVE_CH}x"
          f"{PTS}, {IR_LEN} taps: {serve_ms:.4f} ms/scan; stream_steps_fused_batched kernel "
          f"{b_kernel_ms:.4f} ms by events, {k3_hbm:.1f} us from HBM by CUDA graph "
          f"({100 * b_bound[0] * 1e3 / k3_hbm:.1f}% of the bound), forward / MAC / inverse / rest "
          f"{fmt_parts(k3_parts, mac64_flops)}; plain twin {b_plain_ms:.4f} ms; bound "
          f"{b_bound[0]:.4f} ms ({b_bound[1]}, {b_flops / 1e9:.3f} GFLOP; the design does "
          f"{b_design / 1e9:.3f})) | TV {serve_audio_s / (serve_tv_ms / 1e3):.1f} "
          f"(TVConvolver.stream: {serve_tv_ms:.4f} ms/scan; stream_steps_fused_batched_tv kernel "
          f"{bt_kernel_ms:.4f} ms by events, {k4_hbm:.1f} us from HBM by CUDA graph "
          f"({100 * bt_bound[0] * 1e3 / k4_hbm:.1f}% of the bound), forward / MAC / inverse / "
          f"rest {fmt_parts(k4_parts, mac64_flops)}; plain twin {bt_plain_ms:.4f} ms; bound "
          f"{bt_bound[0]:.4f} ms ({bt_bound[1]}, {bt_flops / 1e9:.3f} GFLOP; the design does "
          f"{bt_design / 1e9:.3f}))", flush=True)

    # phase 16: device memory of one serving scan
    for label, fn in (("Convolver.stream", lambda: conv.stream(sbx)),
                      ("TVConvolver.stream", lambda: tvc.stream(sbx, sbh))):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        print(f"phase 16 memory {label} {SERVE_BLOCKS}x{SERVE_CH}x{PTS}: peak "
              f"{(torch.cuda.max_memory_allocated() - base) / 1e9:.3f} GB above the "
              f"{base / 1e9:.3f} GB held before the call", flush=True)

    # phase 17: where each stream's time goes, device and host
    quiet = lambda m, u: None  # noqa: E731
    eng = P.Clpconv(0, IR_LEN, PTS, quiet, device="cuda")
    eng.push_ir(ir)
    deng = P.Cldconv(0, DIRECT_TAPS, 64, quiet, device="cuda")
    deng.push_ir(ir_d512)
    out, out64 = np.empty(PTS, np.float32), np.empty(64, np.float32)
    b1, b2 = x[:PTS], x[PTS:2 * PTS]
    small = blocks[:8]
    n18 = 1 << 18
    cf = P.Clcfft(0, n18, True, on_message=quiet)
    cbuf = (rng.standard_normal(n18) + 1j * rng.standard_normal(n18)).astype(np.complex64)
    bfft = P.BatchedFFT(n18, device=dev)
    xb = (f(16, n18), f(16, n18))
    profile_streams((
        ("pconv_stream", lambda: P.pconv_stream(cfg, state, blocks)),
        ("pconv_stream_tv", lambda: P.pconv_stream_tv(cfg, state, blocks, bh)),
        ("dconv_stream", lambda: D.dconv_stream(dcfg, dstate, blocks)),
        ("Convolver.stream 64ch", lambda: conv.stream(sbx)),
        ("pconv_offline", lambda: P.pconv_offline(cfg, state, blocks)),
        ("Convolver.render 64ch", lambda: conv.render(sbx)),
        ("pconv_stream_batched_chunked K=8 64ch x 464 blocks",
         lambda: P.pconv_stream_batched_chunked(cfg, conv.state, sbx[:464], K=8)),
        ("TVConvolver.stream 64ch", lambda: tvc.stream(sbx, sbh)),
        ("pconv_stream 8 blocks", lambda: P.pconv_stream(cfg, state, small)),
        ("pconv_stream_tv 8 blocks", lambda: P.pconv_stream_tv(cfg, state, small, small)),
        ("dconv_stream 8 blocks", lambda: D.dconv_stream(dcfg, dstate, small)),
        ("Clpconv.convolution LTI block", lambda: eng.convolution(out, b1)),
        ("Clpconv.convolution TV block", lambda: eng.convolution(out, b1, b2)),
        ("Cldconv.convolution 64-sample block", lambda: deng.convolution(out64, b1[:64])),
        ("Clcfft.transform 2^18", lambda: cf.transform(cbuf.copy())),
        ("BatchedFFT 2^18 x 16", lambda: bfft(xb))))

    # phase 18: FFT kernels vs plain twins on the card at the sweep's shapes:
    # fft_vmem by its route, fft_vmem_front2 at its default sizes and at an
    # explicit split
    def planes(rows, n):
        return f(rows, n), f(rows, n)

    def sweep_rows(n):
        return max(1, SWEEP_BYTES // (8 * n))

    def fft_check(call, twin, x_, what, count):
        """call() vs twin() at both signs, scale 0.5; one launch counted on
        ``count`` each; the worst relative error and max abs error."""
        err, abs_err = 0.0, 0.0
        for sign in (-1, 1):
            n0 = count()
            got = call(x_, sign)
            torch.cuda.synchronize()
            check(count() == n0 + 1, f"{what} counts its launch")
            want = twin(x_, sign)
            err = compare((("re", got[0], want[0]), ("im", got[1], want[1])),
                          f"{what} sign={sign}", err)
            abs_err = max(abs_err, *(float((g - w).abs().max()) for g, w in zip(got, want)))
        return err, abs_err

    def front2_count():
        return V.FRONT2_LAUNCHES

    def one_pass_check(e, what):
        """The pipelined single pass within NEW_TOL of its twin."""
        check(e <= NEW_TOL, f"single-pass fft_vmem vs twin at {what}: {e:.3e} > {NEW_TOL}")
        return e

    worst, fft_err, f2_err, one_worst = 0.0, 0.0, 0.0, 0.0
    for logn in SWEEP_LOG2:
        n = 1 << logn
        xs_ = planes(sweep_rows(n), n)
        e, a = fft_check(lambda x_, s_: V.fft_vmem(x_, s_, 0.5),
                         lambda x_, s_: V.fft_vmem_plain(x_, s_, 0.5), xs_,
                         f"fft_vmem n=2^{logn} x{sweep_rows(n)} ({V.route(n)})",
                         lambda: V.LAUNCHES + V.FRONT2_LAUNCHES)
        worst = max(worst, e)
        if V.route(n).kind == "rows":
            one_worst = max(one_worst, one_pass_check(e, f"2^{logn} x{sweep_rows(n)}"))
        if logn == 13:
            fft_err = a
        if n in V.FRONT2_SIZES:
            e, a = fft_check(lambda x_, s_: V.fft_vmem_front2(x_, s_, 0.5),
                             lambda x_, s_: V.fft_vmem_front2_plain(x_, s_, 0.5), xs_,
                             f"fft_vmem_front2 n=2^{logn}", front2_count)
            worst = max(worst, e)
            if logn == 18:
                f2_err = a
    xs_ = planes(3, 1 << 15)
    e, _ = fft_check(lambda x_, s_: V.fft_vmem_front2(x_, s_, 0.5, split=(128, 256)),
                     lambda x_, s_: V.fft_vmem_front2_plain(x_, s_, 0.5, split=(128, 256)),
                     xs_, "fft_vmem_front2 n=2^15 split=(128, 256)", front2_count)
    worst = max(worst, e)
    # the few-row calls of the main paths (the per-block step and the
    # zero-latency terminal segment at pts 4096 transform 4096 bins of 1 or
    # 16 channels; Clcfft and the processors one row) and short last tiles
    few = ((1, 1 << 10), (1, 1 << 12), (3, 1 << 12), (16, 1 << 12), (1, 1 << 13), (5, 1 << 13),
           (1, 1 << 14), (3, 1 << 14), (257, 1 << 11))
    for rows_, n in few:
        e, _ = fft_check(lambda x_, s_: V.fft_vmem(x_, s_, 0.5),
                         lambda x_, s_: V.fft_vmem_plain(x_, s_, 0.5), planes(rows_, n),
                         f"fft_vmem n={n} x{rows_}", lambda: V.LAUNCHES)
        one_worst = max(one_worst, one_pass_check(e, f"{n} x{rows_}"))
        worst = max(worst, e)
    del xs_
    print(f"phase 18 FFT kernels vs twins: fft_vmem n=2^{{{SWEEP_LOG2[0]}..{SWEEP_LOG2[-1]}}} "
          f"at {SWEEP_BYTES >> 20} MB of planes (rows = 32 MB / 8n), fft_vmem_front2 at "
          f"2^{{18,19,20}} and at split (128, 256), sign +-1, scale 0.5; the single pass "
          f"(n <= {V.SINGLE_PASS_MAX}) also at (rows, n) {few}: worst rel err {worst:.3e} (tol "
          f"{TOL}), single pass {one_worst:.3e} (tol {NEW_TOL}); 2^13 x512 max_abs_err fft_vmem "
          f"{fft_err:.3e}, 2^18 x16 fft_vmem_front2 {f2_err:.3e}", flush=True)

    # phase 19: FFT main paths on the card against float64 numpy
    def cplx(*shape):
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)

    def oracle(got, ref, what):
        """max |got - ref| / max |ref| of complex spectra, within ORACLE_TOL."""
        got = np.asarray(got, np.complex128)
        check(got.shape == np.shape(ref) and bool(np.isfinite(got).all()),
              f"{what} shape/finite")
        err = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
        check(err <= ORACLE_TOL, f"{what} vs float64 numpy {err:.3e} > {ORACLE_TOL}")
        return err

    z18 = cplx(n18)
    n19 = 1 << 19
    r19 = rng.standard_normal(n19).astype(np.float32)
    z1000, r1000 = cplx(1000), rng.standard_normal(1000).astype(np.float32)
    zb = cplx(16, n18)
    nblu = 3 << 16
    zblu = cplx(4, nblu)
    fwd, inv = P.Clcfft(0, n18, True, on_message=quiet), P.Clcfft(0, n18, False, on_message=quiet)
    rf = P.Clrfft(0, n19, True, on_message=quiet)
    cproc = P.ClfftProcessor(1000, on_message=quiet)
    rproc = P.ClrfftProcessor(1000, on_message=quiet)
    bf = P.BatchedFFT(n18, device=dev)
    zero_counts()
    spec = z18.copy()
    check(fwd.transform(spec) == 0, "Clcfft forward status")
    back = spec.copy()
    check(inv.transform(back) == 0, "Clcfft inverse status")
    packed = np.zeros(n19 // 2, np.complex64)
    check(rf.transform(packed, r19) == 0, "Clrfft status")
    c_out, r_out = cproc.process(z1000), rproc.process(r1000)
    yb = bf((torch.from_numpy(zb.real.copy()).to(dev), torch.from_numpy(zb.imag.copy()).to(dev)))
    yblu = P.fft_split((torch.from_numpy(zblu.real.copy()).to(dev),
                        torch.from_numpy(zblu.imag.copy()).to(dev)), -1)
    torch.cuda.synchronize()
    fft_launches, f2_launches = V.LAUNCHES, V.FRONT2_LAUNCHES
    check(fft_launches > 0 and f2_launches > 0,
          f"the FFT main paths launched both FFT kernels ({fft_launches}, {f2_launches})")
    z64 = z18.astype(np.complex128)
    e_fwd = oracle(spec, np.fft.fft(z64) / n18, "Clcfft(2^18) forward")
    e_inv = oracle(back, np.fft.ifft(spec.astype(np.complex128)) * n18, "Clcfft(2^18) inverse")
    e_rt = oracle(back, z64, "Clcfft(2^18) forward then inverse")
    std = np.fft.rfft(r19.astype(np.float64)) * 2 / n19
    ref_packed = P.standard_to_packed(torch.from_numpy(std)).numpy()
    e_rf = oracle(packed, ref_packed, "Clrfft(2^19) vs standard_to_packed(np.fft.rfft)")
    pad = np.zeros(1024, np.complex128)
    pad[:1000] = z1000
    e_cp = oracle(c_out, (np.fft.fft(pad) / 1024)[:1000], "ClfftProcessor(1000)")
    rpad = np.zeros(1024)
    rpad[:1000] = r1000
    ref_rp = P.standard_to_packed(torch.from_numpy(np.fft.rfft(rpad) * 2 / 1024)).numpy()[:500]
    e_rp = oracle(r_out, ref_rp, "ClrfftProcessor(1000)")
    e_bf = oracle((yb[0] + 1j * yb[1]).cpu().numpy(), np.fft.fft(zb.astype(np.complex128)),
                  "BatchedFFT(2^18) x16")
    e_blu = oracle((yblu[0] + 1j * yblu[1]).cpu().numpy(),
                   np.fft.fft(zblu.astype(np.complex128)), "Bluestein n=3*2^16")
    print(f"phase 19 FFT main paths on {dev} vs float64 numpy (tol {ORACLE_TOL}): Clcfft(2^18) "
          f"forward {e_fwd:.3e}, inverse {e_inv:.3e}, round trip {e_rt:.3e}; Clrfft(2^19) "
          f"{e_rf:.3e}; ClfftProcessor(1000) {e_cp:.3e}; ClrfftProcessor(1000) {e_rp:.3e}; "
          f"BatchedFFT(2^18) x16 {e_bf:.3e}; Bluestein 4 x {nblu} (core 2^19) {e_blu:.3e}; "
          f"launches fft_vmem {fft_launches} fft_vmem_front2 {f2_launches}", flush=True)
    del zb, yb, zblu, yblu

    # phase 20: the FFT sweep's times, CUDA events over 10 calls back to back;
    # GFLOP/s in bench.py's 5 n log2 n convention; device microseconds of
    # each __global__ under torch.profiler; bound: the planes read once and
    # written once
    def kernel_us(fn, calls=10):
        """Device microseconds per call of each kernel fn() launches (a
        profiler session that records no kernel is taken again, twice at
        most)."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            us = {re.sub(r"^void |\(anonymous namespace\)::", "", e.key).split("(")[0][:40]:
                  e.self_device_time_total / calls for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0}
            if us:
                return us
        return us

    def us_text(d):
        return " + ".join(f"{k} {v:.1f}" for k, v in d.items()) + " us"

    def unpipelined(x_, sign):
        """The earlier single pass (fft_rows_f32 at n1 = 1: each CTA loads its
        rows through registers, with no overlap inside it), n <= 2^13: the
        yardstick the pipelined kernel is timed against."""
        re_, im_ = x_
        rows_, n_ = re_.shape
        y = torch.empty((2, rows_, n_), device=dev)
        tw = V._plan(V.Route("rows", 1, n_), sign, dev).pointers[0]
        V._call("fft_rows_f32", re_.data_ptr(), im_.data_ptr(), y[0].data_ptr(), y[1].data_ptr(),
                tw, None, None, None, 0, rows_, n_.bit_length() - 1, 0, sign, 1.0, dev.index,
                torch.cuda.current_stream(dev).cuda_stream)
        return y[0], y[1]

    def host_us(fn, calls=200):
        """Host microseconds a call of fn() takes to enqueue its work."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        return us

    sweep = []
    device_us(torch.cuda.synchronize, calls=1)    # one session first: the first read 0 us
    # device time from HBM: 4 input sets of 32 MB, over twice the L2
    nsets20 = 1 + -(-2 * L2_BYTES // SWEEP_BYTES)
    for logn in SWEEP_LOG2:
        n, rows = 1 << logn, sweep_rows(1 << logn)
        sets20 = [planes(rows, n) for _ in range(nsets20)]
        zs20 = [torch.complex(*p_) for p_ in sets20]
        xs_, z = sets20[0], zs20[0]
        row = {"lg": logn, "rows": rows, "route": V.route(n)}
        row["k"] = cuda_ms(lambda: V.fft_vmem(xs_, -1), reps=9, calls=10)
        row["k_us"] = kernel_us(lambda: V.fft_vmem(xs_, -1))
        row["k_dev"] = graph_us(lambda i: V.fft_vmem(sets20[i], -1), nsets20)
        row["lib"] = cuda_ms(lambda: torch.fft.fft(z), reps=9, calls=10)
        row["lib_us"] = sum(kernel_us(lambda: torch.fft.fft(z)).values())
        row["lib_dev"] = graph_us(lambda i: torch.fft.fft(zs20[i]), nsets20)
        if row["route"].kind == "rows":
            row["host"] = host_us(lambda: V.fft_vmem(xs_, -1))
            if n <= V.LEAF_PASS_MAX:
                row["old"] = cuda_ms(lambda: unpipelined(xs_, -1), reps=9, calls=10)
                row["old_dev"] = graph_us(lambda i: unpipelined(sets20[i], -1), nsets20)
        row["tw"] = cuda_ms(lambda: V.fft_vmem_plain(xs_, -1), warmup=1, reps=5)
        if n in V.FRONT2_SIZES:
            row["f2"] = cuda_ms(lambda: V.fft_vmem_front2(xs_, -1), reps=9, calls=10)
            row["f2_us"] = kernel_us(lambda: V.fft_vmem_front2(xs_, -1))
        row["alts"] = {sp: (cuda_ms(lambda: V.fft_vmem_front2(xs_, -1, split=sp), reps=9,
                                    calls=10),
                            sum(kernel_us(lambda: V.fft_vmem_front2(xs_, -1, split=sp)).values()))
                       for sp in FFT_ALT_SPLITS.get(logn, ())}
        row["flops"] = 5.0 * n * logn * rows
        row["bnd"] = bound(row["flops"], 2 * nbytes(*xs_))
        sweep.append(row)
        if logn == 13:
            fft_row = (row["k"], row["tw"], row["bnd"], row["lib"])
        if logn == 18:
            f2_row = (row["f2"],
                      cuda_ms(lambda: V.fft_vmem_front2_plain(xs_, -1), warmup=1, reps=5),
                      row["bnd"], row["lib"])
    del xs_, z, sets20, zs20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        cf.transform(cbuf.copy())
    clc_ms = (time.perf_counter() - t0) / 20 * 1e3

    def sweep_text(r):
        fl, b = r["flops"], r["bnd"]
        out = (f"2^{r['lg']} x{r['rows']}: fft_vmem {r['k']:.4f} ({fl / r['k'] / 1e6:.1f} "
               f"GFLOP/s; {r['route'].kind} {r['route'].n1}x{r['route'].n2}; device "
               f"{us_text(r['k_us'])}; from HBM {r['k_dev']:.1f} us, "
               f"{100 * b[0] * 1e3 / r['k_dev']:.1f}% of the bound)")
        if "host" in r:
            out += (f" [host {r['host']:.1f} us a call to enqueue; events - device "
                    f"{r['k'] * 1e3 - r['k_dev']:.1f} us]")
        if "old" in r:
            out += (f", the earlier single pass {r['old']:.4f} (from HBM {r['old_dev']:.1f} us; "
                    f"pipelined/earlier {r['k_dev'] / r['old_dev']:.3f})")
        if "f2" in r:
            out += f", fft_vmem_front2 {r['f2']:.4f} (device {us_text(r['f2_us'])})"
        for sp, (ms_, us_) in r["alts"].items():
            out += f", split {sp[0]}x{sp[1]} {ms_:.4f} (device {us_:.1f} us)"
        return out + (f", cuFFT {r['lib']:.4f} ({fl / r['lib'] / 1e6:.1f}; device "
                      f"{r['lib_us']:.1f} us; from HBM {r['lib_dev']:.1f} us; fft_vmem/cuFFT "
                      f"from HBM {r['k_dev'] / r['lib_dev']:.3f}), twin {r['tw']:.4f}, bound "
                      f"{b[0]:.4f} ({b[1]}; fft_vmem at {100 * b[0] / r['k']:.1f}%)")

    print(f"phase 20 FFT sweep [{card}] (ms per call, median CUDA events over 10 calls back "
          f"to back, the twin over 1; GFLOP/s = 5 n log2 n rows / time; device us per "
          f"__global__ under torch.profiler; from HBM: a CUDA graph of 20 calls over "
          f"{nsets20} rotating input sets): " + "; ".join(sweep_text(r) for r in sweep)
          + f" | Clcfft.transform 2^18 host wall {clc_ms:.4f} ms per call (numpy in and out)",
          flush=True)

    # phase 21: the sliding-MAC kernel (one CUDA entry under three wrappers:
    # chunk_mac, macflow_lti_batched, macflow_lti on channel 0) vs its plain
    # twin on the card, at the JAX bench's offline shapes and at odd shapes,
    # on the route slide_route picks (tiled or q-split) and on the other one,
    # bit-equal on a second launch
    from opencl_fft_tpu_torch.ops.decomposed import stream_decomposed

    @contextlib.contextmanager
    def slide_route_forced(route):
        own = SM.slide_route
        SM.slide_route = lambda *a, **k: own(*a, **k, force=route)
        try:
            yield
        finally:
            SM.slide_route = own

    sms = _build.sm_count(dev.index)

    def mac_inputs(nch, nparts, bins, nout):
        """timeline (C, nparts + nout, bins), h (C, nparts, bins): chunk_mac
        gives nout outputs, the macflow wrappers are asked for nout."""
        return ((f(nch, nparts + nout, bins), f(nch, nparts + nout, bins)),
                (f(nch, nparts, bins, s=0.05), f(nch, nparts, bins, s=0.05)))

    def wrapper_counts():
        return SM.CHUNKMAC_LAUNCHES, SM.MACFLOW_LAUNCHES, SM.MACFLOW_BATCHED_LAUNCHES

    CHUNK_K, CHUNK_BLOCKS = 8, 472      # bench.py:374-417
    # every main-path shape (the K = 8 chunk takes 59 of the 60 launches of
    # macflow_lti_batched), then odd ones
    mac_shapes = [(1, np_, b, SCAN_BLOCKS), (16, np_, b, SERVE_BLOCKS),
                  (SERVE_CH, np_, b, SERVE_BLOCKS), (SERVE_CH, np_, b, CHUNK_K),
                  (2, 3, 64, 13), (3, 37, 64, 21), (1, 1, 16, 1), (2, 70, 100, 300),
                  (1, 5, 33, 70)]
    mac_err = {}
    worst = 0.0
    routes_taken, other_worst = [], 0.0
    for nch, nparts, bins, nout in mac_shapes:
        xm, hm = mac_inputs(nch, nparts, bins, nout)
        for b0 in (1.0, 2.0):
            n0 = wrapper_counts()
            got = {"chunk_mac": SM.chunk_mac(xm, hm, b0),
                   "macflow_lti_batched": SM.macflow_lti_batched(xm, hm, nout, b0),
                   "macflow_lti": SM.macflow_lti((xm[0][0], xm[1][0]), (hm[0][0], hm[1][0]),
                                                 nout, b0)}
            torch.cuda.synchronize()
            check(wrapper_counts() == tuple(n + 1 for n in n0),
                  "each sliding-MAC wrapper counts its launch")
            again = SM.macflow_lti_batched(xm, hm, nout, b0)
            torch.cuda.synchronize()
            check(all(torch.equal(g, a_) for g, a_ in zip(got["macflow_lti_batched"], again)),
                  f"sliding MAC bit-equal on a second launch at C={nch} nout={nout}")
            want = SM.slide_mac_plain(xm, hm, nout, b0)
            for wname, g in got.items():
                w = (want[0][0], want[1][0]) if wname == "macflow_lti" else want
                worst = compare(((f"{wname} re", g[0], w[0]), (f"{wname} im", g[1], w[1])),
                                f"C={nch} nparts={nparts} bins={bins} nout={nout} b0={b0}",
                                worst)
                key = (wname, nch, nout)
                mac_err[key] = max(mac_err.get(key, 0.0),
                                   *(float((gg - ww).abs().max()) for gg, ww in zip(g, w)))
            route = SM.slide_route(nch, nout, bins, nparts, sms)[0]
            other = "split" if route == "tiled" else "tiled"
            with slide_route_forced(other):
                g = SM.macflow_lti_batched(xm, hm, nout, b0)
                again = SM.macflow_lti_batched(xm, hm, nout, b0)
            torch.cuda.synchronize()
            check(all(torch.equal(u, v) for u, v in zip(g, again)),
                  f"sliding MAC ({other}) bit-equal on a second launch at C={nch} nout={nout}")
            other_worst = compare(((f"{other} re", g[0], want[0]), (f"{other} im", g[1], want[1])),
                                  f"forced {other} C={nch} nparts={nparts} bins={bins} "
                                  f"nout={nout} b0={b0}", other_worst)
        routes_taken.append(route)
    del xm, hm, got, want, g, again
    print(f"phase 21 sliding-MAC kernel vs twin: chunk_mac, macflow_lti_batched and "
          f"macflow_lti (channel 0) at (C,nparts,bins,nout) {mac_shapes} x b0 {{1,2}} on the "
          f"routes {routes_taken}; worst rel err {worst:.3e} (tol {TOL}), the other route "
          f"forced {other_worst:.3e}; bit-equal on a second launch; max_abs_err chunk_mac "
          f"1x{SCAN_BLOCKS} "
          f"{mac_err[('chunk_mac', 1, SCAN_BLOCKS)]:.3e}, 16x{SERVE_BLOCKS} "
          f"{mac_err[('chunk_mac', 16, SERVE_BLOCKS)]:.3e}; macflow_lti_batched "
          f"{SERVE_CH}x{SERVE_BLOCKS} "
          f"{mac_err[('macflow_lti_batched', SERVE_CH, SERVE_BLOCKS)]:.3e}, "
          f"{SERVE_CH}x{CHUNK_K} {mac_err[('macflow_lti_batched', SERVE_CH, CHUNK_K)]:.3e}; "
          f"macflow_lti "
          f"{SCAN_BLOCKS} {mac_err[('macflow_lti', 1, SCAN_BLOCKS)]:.3e}", flush=True)

    # phase 22: the offline and chunked main paths on the card, against
    # float64 scipy (phase 4's 20 s signal and 2^17-tap IR; phase 13's 64
    # IRs) and against the streaming paths
    def conv_ready(nch):
        c = P.Convolver(cfg, nch, device=dev)
        c.push_ir(irs_d[:nch])
        return c

    def in_chunks(fn, state0, *ops):
        """fn(cfg, state, *chunk) over CHUNK_K-block chunks of ops, the state
        chained from state0; the outputs concatenated."""
        st_, outs = state0, []
        for i in range(0, ops[0].shape[0], CHUNK_K):
            st_, o = fn(cfg, st_, *(a[i:i + CHUNK_K] for a in ops))
            outs.append(o)
        return torch.cat(outs)

    n_chk = CHUNK_BLOCKS * PTS
    xs_chk = (0.1 * rng.standard_normal((SERVE_CH, n_chk))).astype(np.float32)
    chk_blocks = torch.from_numpy(np.ascontiguousarray(
        xs_chk.reshape(SERVE_CH, CHUNK_BLOCKS, PTS).transpose(1, 0, 2))).to(dev)
    st_ir = P.push_ir(cfg, P.pconv_init(cfg, dev), ir_d)
    conv16, conv64, conv_s1, conv_s8 = (conv_ready(n) for n in (16, SERVE_CH, SERVE_CH,
                                                                  SERVE_CH))
    st64 = conv_s1.state
    bx32 = x_p[:32]
    bh32 = f(32, PTS, s=0.1)
    zero_counts()
    y_off = P.pconv_offline(cfg, st_ir, x_p)[1]
    y_r16 = conv16.render(serve_blocks[:, :16].contiguous())
    y_r64 = conv64.render(serve_blocks)
    y_chk = P.pconv_stream_batched_chunked(cfg, st64, chk_blocks, K=CHUNK_K)[1]
    y_s8 = conv_s8.stream(chk_blocks, chunk=CHUNK_K)
    y_chunk = in_chunks(P.pconv_chunk, st_ir, bx32)
    y_chunk_tv = in_chunks(P.pconv_chunk_tv, st_ir, bx32, bh32)
    y_dec = stream_decomposed(cfg, st_ir, x_p)[1]
    y_one = P.convolve_oneshot(x_d, ir_d)
    torch.cuda.synchronize()
    off_launches = wrapper_counts()
    check(min(off_launches) > 0,
          f"the offline main paths launched every sliding-MAC wrapper {off_launches}")
    # the checks, after the counts are read
    n_ref = ref.size
    err_off = rel_err(y_off.reshape(-1)[:n_ref].cpu().numpy(), ref)
    err_dec = rel_err(y_dec.reshape(-1)[:n_ref].cpu().numpy(), ref)
    err_one = rel_err(y_one.cpu().numpy(), ref)
    check(tuple(y_one.shape) == ref.shape, "convolve_oneshot shape")
    y_str = P.pconv_stream(cfg, st_ir, x_p)[1]
    err_dec_s = float((y_dec - y_str).abs().max()) / float(y_str.abs().max())
    singles = torch.stack([P.pconv_stream(cfg, P.push_ir(cfg, P.pconv_init(cfg, dev), irs_d[c]),
                                          serve_blocks[:, c])[1] for c in range(SERVE_CH)], 1)
    err_r64, err_r16 = worst_channel(y_r64, singles), worst_channel(y_r16, singles[:, :16])
    # the render's state chains into the batched scan kernel
    conv_ref = conv_ready(16)
    conv_ref.stream(serve_blocks[:, :16].contiguous())
    nxt = chk_blocks[:CHUNK_K, :16].contiguous()
    err_r16c = worst_channel(conv16.stream(nxt), conv_ref.stream(nxt))
    y_np = y_r64.cpu().numpy()
    err_r64o = max(rel_err(y_np[:, c].reshape(-1), refs[c]) for c in oracle_ch)
    ref15 = sps.fftconvolve(xs_serve[15].astype(np.float64), irs[15].astype(np.float64))[:n_serve]
    y_np = y_r16.cpu().numpy()
    err_r16o = max(rel_err(y_np[:, 0].reshape(-1), refs[0]),
                   rel_err(y_np[:, 15].reshape(-1), ref15))
    y_s1 = conv_s1.stream(chk_blocks)
    err_chk = worst_channel(y_chk, y_s1)
    err_chko = max(rel_err(y_chk[:, c].reshape(-1).cpu().numpy(),
                           sps.fftconvolve(xs_chk[c].astype(np.float64),
                                           irs[c].astype(np.float64))[:n_chk])
                   for c in (0, SERVE_CH - 1))
    err_s8 = worst_channel(y_s8, y_s1)
    s8_bit_s1 = bool(torch.equal(y_s8, y_s1))
    conv_st = conv_ready(SERVE_CH)
    y_steps = torch.stack([conv_st.step(chk_blocks[i]) for i in range(16)])
    s8_bit_steps = bool(torch.equal(y_s8[:16], y_steps))
    st_, seq = st_ir, []
    for blk in bx32:
        st_, o = P.pconv_step(cfg, st_, blk)
        seq.append(o)
    seq = torch.stack(seq)
    st_, seq_tv = st_ir, []
    for blk, bh_ in zip(bx32, bh32):
        st_, o = P.pconv_step_tv(cfg, st_, blk, bh_)
        seq_tv.append(o)
    seq_tv = torch.stack(seq_tv)
    err_chunk = float((y_chunk - seq).abs().max()) / float(seq.abs().max())
    err_chunk_tv = float((y_chunk_tv - seq_tv).abs().max()) / float(seq_tv.abs().max())
    err_chunko = rel_err(y_chunk.reshape(-1).cpu().numpy(), ref[:32 * PTS])
    for what, e, tol in (("pconv_offline vs scipy", err_off, ORACLE_TOL),
                         ("stream_decomposed vs scipy", err_dec, ORACLE_TOL),
                         ("stream_decomposed vs pconv_stream", err_dec_s, TOL),
                         ("convolve_oneshot vs scipy", err_one, ORACLE_TOL),
                         ("Convolver.render(64) vs pconv_stream", err_r64, TOL),
                         ("Convolver.render(16) vs pconv_stream", err_r16, TOL),
                         ("Convolver.render(16) then stream vs stream", err_r16c, TOL),
                         ("Convolver.render(64) vs scipy", err_r64o, ORACLE_TOL),
                         ("Convolver.render(16) vs scipy", err_r16o, ORACLE_TOL),
                         ("pconv_stream_batched_chunked vs Convolver.stream", err_chk, TOL),
                         ("pconv_stream_batched_chunked vs scipy", err_chko, ORACLE_TOL),
                         ("Convolver.stream(chunk=8) vs chunk=1", err_s8, TOL),
                         ("pconv_chunk vs steps", err_chunk, TOL),
                         ("pconv_chunk_tv vs steps", err_chunk_tv, TOL),
                         ("pconv_chunk vs scipy", err_chunko, ORACLE_TOL)):
        check(np.isfinite(e) and e <= tol, f"{what}: {e:.3e} > {tol}")
    print(f"phase 22 offline and chunked main paths on {dev}: pconv_offline({x_p.shape[0]}x{PTS}, "
          f"{IR_LEN} taps) vs float64 scipy {err_off:.3e}; stream_decomposed vs scipy "
          f"{err_dec:.3e}, vs pconv_stream {err_dec_s:.3e}; convolve_oneshot({x.size} samples) vs "
          f"scipy {err_one:.3e}; Convolver.render({SERVE_BLOCKS}x64) vs single-channel "
          f"pconv_stream {err_r64:.3e}, vs scipy {err_r64o:.3e}; render 16 ch {err_r16:.3e}, "
          f"{err_r16o:.3e}, then stream() vs stream() {err_r16c:.3e}; "
          f"pconv_stream_batched_chunked(K={CHUNK_K}, {CHUNK_BLOCKS}x64) vs "
          f"Convolver.stream {err_chk:.3e}, vs scipy {err_chko:.3e}; Convolver.stream(chunk=8) "
          f"vs chunk=1 {err_s8:.3e} (bit-equal {s8_bit_s1}), first 16 blocks bit-equal to "
          f"step() {s8_bit_steps}; pconv_chunk (K=8, 32 blocks) vs steps {err_chunk:.3e} "
          f"(bit-equal {bool(torch.equal(y_chunk, seq))}), vs scipy {err_chunko:.3e}; "
          f"pconv_chunk_tv vs steps {err_chunk_tv:.3e} (bit-equal "
          f"{bool(torch.equal(y_chunk_tv, seq_tv))}) (tol {TOL} between paths, {ORACLE_TOL} "
          f"vs scipy); launches chunk_mac {off_launches[0]} macflow_lti {off_launches[1]} "
          f"macflow_lti_batched {off_launches[2]}", flush=True)
    del singles, y_np, y_s1, y_s8, y_chk, y_r64, y_r16, y_steps, y_str

    # phase 23: offline and chunked timing (CUDA events) under the JAX
    # bench's metric names, and each sliding-MAC wrapper at its main-path
    # shape against its twin, its bound and one cuDNN conv1d of the same
    # correlation (groups = C*bins: [re, im] of one bin of one channel in,
    # the same out; weight [[hr, -hi], [hi, hr]], bin 0 [[b0 hr, 0], [0, b0 hi]])
    def conv1d_yardstick(xm, hm, nout, b0):
        (xr, xi), (hr, hi) = xm, hm
        nch, rows, bins = xr.shape
        inp = torch.stack([xr, xi], -1).permute(0, 2, 3, 1).reshape(1, 2 * nch * bins, rows)
        hr_t, hi_t = hr.permute(0, 2, 1), hi.permute(0, 2, 1)           # (C, bins, nparts)
        w = torch.stack([torch.stack([hr_t, -hi_t], 2), torch.stack([hi_t, hr_t], 2)], 2)
        z = torch.zeros_like(hr_t[:, 0])
        w[:, 0] = torch.stack([torch.stack([b0 * hr_t[:, 0], z], 1),
                               torch.stack([z, b0 * hi_t[:, 0]], 1)], 1)
        w = w.reshape(2 * nch * bins, 2, -1).contiguous()

        def call():
            return torch.nn.functional.conv1d(inp, w, groups=nch * bins)

        y = call().reshape(nch, bins, 2, -1)[..., :nout]
        return call, (y[:, :, 0].transpose(1, 2), y[:, :, 1].transpose(1, 2))

    def mac_bound(xm, hm, nout):
        nch, _, bins = xm[0].shape
        return bound(8.0 * nch * nout * hm[0].shape[1] * bins,
                     nbytes(*xm, *hm) + 2 * 4 * nch * nout * bins)

    sbx16 = sbx[:, :16].contiguous()
    audio_chk = SERVE_CH * n_chk / SR
    audio_16 = 16 * SERVE_BLOCKS * PTS / SR
    off_ms = cuda_ms(lambda: P.pconv_offline(cfg, state, blocks), reps=15)
    r16_ms = cuda_ms(lambda: conv16.render(sbx16), reps=9)
    r64_ms = cuda_ms(lambda: conv64.render(sbx), reps=9)
    chk_ms = cuda_ms(lambda: P.pconv_stream_batched_chunked(cfg, st64, chk_blocks, K=CHUNK_K),
                     warmup=1, reps=5)
    s1_ms = cuda_ms(lambda: conv_s1.stream(chk_blocks), reps=5)
    s8_ms = cuda_ms(lambda: conv_s8.stream(chk_blocks, chunk=CHUNK_K), warmup=1, reps=3)
    chunk8_ms = cuda_ms(lambda: in_chunks(P.pconv_chunk, state, blocks), warmup=1, reps=3)
    dec_ms = cuda_ms(lambda: stream_decomposed(cfg, state, blocks), reps=15)
    one_ms = cuda_ms(lambda: P.convolve_oneshot(x_d, ir_d), reps=9)
    def mac_call(wname, xx, hh, nout):
        if wname == "chunk_mac":
            return SM.chunk_mac(xx, hh, 2.0)
        if wname == "macflow_lti":
            return SM.macflow_lti((xx[0][0], xx[1][0]), (hh[0][0], hh[1][0]), nout, 2.0)
        return SM.macflow_lti_batched(xx, hh, nout, 2.0)

    mac_rows = []
    for wname, nch, nout in (("chunk_mac", 1, SCAN_BLOCKS), ("chunk_mac", 16, SERVE_BLOCKS),
                             ("macflow_lti_batched", SERVE_CH, SERVE_BLOCKS),
                             ("macflow_lti_batched", SERVE_CH, CHUNK_K),
                             ("macflow_lti", 1, SCAN_BLOCKS)):
        xm, hm = mac_inputs(nch, np_, b, nout)
        run = lambda: mac_call(wname, xm, hm, nout)  # noqa: E731
        k_ms = cuda_ms(run, reps=9, calls=10 if nout == CHUNK_K else 1)
        # from HBM: a CUDA graph over input sets that together outgrow the L2
        sets_ = [(xm, hm)] + [mac_inputs(nch, np_, b, nout)
                              for _ in range(-(-2 * L2_BYTES // nbytes(*xm, *hm)))]
        k_hbm = graph_us(lambda i: mac_call(wname, *sets_[i], nout), len(sets_),
                         calls=20 if nch * nout < 4096 else 5)
        del sets_
        tw_ms = cuda_ms(lambda: SM.slide_mac_plain(xm, hm, nout, 2.0), warmup=1, reps=3)
        lib_call, lib_out = conv1d_yardstick(xm, hm, nout, 2.0)
        want = SM.slide_mac_plain(xm, hm, nout, 2.0)
        lib_err = max(float((g - w_).abs().max()) / float(w_.abs().max())
                      for g, w_ in zip(lib_out, want))
        check(lib_err <= TOL, f"conv1d yardstick vs twin at {wname} C={nch}: {lib_err:.3e}")
        lib_ms = cuda_ms(lib_call, warmup=1, reps=3)
        mac_rows.append((wname, nch, nout, k_ms, tw_ms, mac_bound(xm, hm, nout), lib_ms, k_hbm,
                         SM.slide_route(nch, nout, b, np_, sms)[0]))
    del xm, hm, want, lib_out
    mac_by = {(r[0], r[1], r[2]): r for r in mac_rows}
    print(f"phase 23 offline timing [{card}]: pconv_offline_rt_factor "
          f"{audio_s / (off_ms / 1e3):.1f} (pconv_offline {SCAN_BLOCKS}x{PTS}, {IR_LEN} taps: "
          f"{off_ms:.4f} ms/scan); serving_offline_16ch_audio_seconds_per_second "
          f"{audio_16 / (r16_ms / 1e3):.1f} (Convolver.render {SERVE_BLOCKS}x16: {r16_ms:.4f} ms); "
          f"render 64 ch {serve_audio_s / (r64_ms / 1e3):.1f} audio-s/s ({r64_ms:.4f} ms); "
          f"serving_64ch_chunk8_audio_seconds_per_second {audio_chk / (chk_ms / 1e3):.1f} "
          f"(pconv_stream_batched_chunked K={CHUNK_K} {CHUNK_BLOCKS}x64: {chk_ms:.4f} ms; "
          f"Convolver.stream at the same shape {s1_ms:.4f} ms = "
          f"{audio_chk / (s1_ms / 1e3):.1f}; Convolver.stream(chunk=8) {s8_ms:.4f} ms = "
          f"{audio_chk / (s8_ms / 1e3):.1f}); pconv_chunk8_rt_factor "
          f"{audio_s / (chunk8_ms / 1e3):.1f} ({SCAN_BLOCKS // CHUNK_K} pconv_chunk calls: "
          f"{chunk8_ms:.4f} ms); stream_decomposed {SCAN_BLOCKS} blocks {dec_ms:.4f} ms; "
          f"convolve_oneshot({x.size} samples, {IR_LEN} taps) {one_ms:.4f} ms | kernels (ms by "
          f"events; device us from HBM by CUDA graph; twin; bound; cuDNN conv1d): " + "; ".join(
              f"{w_} C={c_}x{n_} ({rt}): {k:.4f}, from HBM {hb:.1f} us ({100 * bd[0] * 1e3 / hb:.1f}% "
              f"of the bound); twin {tw:.4f}; bound {bd[0]:.4f} ({bd[1]}, {100 * bd[0] / k:.1f}% "
              f"reached by events); conv1d {lib:.4f}"
              for w_, c_, n_, k, tw, bd, lib, hb, rt in mac_rows), flush=True)

    # phase 24: the block-step kernels (spectral_mac, block_step_fused,
    # block_step_fwd_fused, block_step_fwd_fused_tv, block_mac_unpack) vs
    # their twins on the card at one and 64 channels of the headline ring
    # (nparts 256, bins 512), at the ring boundaries (rp 0, 1, 255; wp2 0,
    # 255), both b0s, at one partition (the zero-latency doubling segments:
    # nparts 1, bins 64 and 2048), at pts 4096 and at odd shapes; each
    # bit-equal on a second launch, and the fused step's output bit-equal to
    # block_step_fused's on the ring it wrote (the crossfade's contract)
    def ring_inputs(nch, nparts, bins):
        """A doubled ring (both halves equal), h planes, a tail and the two
        operands' blocks; ``nch`` None for no channel axis."""
        lead = () if nch is None else (nch,)
        a, b_ = f(*lead, nparts, bins), f(*lead, nparts, bins)
        return ((torch.cat([a, a], -2).contiguous(), torch.cat([b_, b_], -2).contiguous()),
                (f(*lead, nparts, bins, s=0.05), f(*lead, nparts, bins, s=0.05)),
                f(*lead, bins), f(2, *lead, bins, s=0.1))

    def block_kernels(ring, h, tail, blocks, rp, wp2, b0, twin):
        """Each block-step kernel (or its twin) once: name -> its outputs."""
        m = (MC.spectral_mac_plain, BS.block_step_fused_plain, BS.block_step_fwd_fused_plain,
             BS.block_step_fwd_fused_tv_plain, BS.block_mac_unpack_plain) if twin else \
            (MC.spectral_mac, BS.block_step_fused, BS.block_step_fwd_fused,
             BS.block_step_fwd_fused_tv, BS.block_mac_unpack)
        bins = tail.shape[-1]
        fwd = m[2](blocks[0], ring, h, rp, b0, tail, bins)
        tv = m[3](blocks, ring, h, rp, wp2, b0, tail, bins)
        return {"spectral_mac": m[0](ring, h, rp, b0),
                "block_step_fused": m[1](ring, h, rp, b0, tail, bins),
                "block_step_fwd_fused": (fwd[0], fwd[1], *fwd[2]),
                "block_step_fwd_fused_tv": (tv[0], tv[1], *tv[2], *tv[3]),
                "block_mac_unpack": m[4](ring, h, rp, b0)}

    bs_names = ("spectral_mac", "block_step_fused", "block_step_fwd_fused",
                "block_step_fwd_fused_tv")
    bs_shapes = [(None, np_, b), (SERVE_CH, np_, b), (None, 1, 64), (None, 1, 2048),
                 (None, 8, LONG_PTS), (None, 3, 16), (3, 3, 16)]
    def mac_close(kname, got_, want_, where):
        """The one-launch MAC's planes within MAC_TOL of the twin's max."""
        rel_ = 0.0
        for g, w_ in zip(got_, want_):
            rel_ = max(rel_, float((g - w_).abs().max()) / max(float(w_.abs().max()), 1e-30))
        check(rel_ <= MAC_TOL, f"{kname} vs twin at {where}: {rel_:.3e} > {MAC_TOL}")
        return rel_

    bs_err = {}
    worst = mac_worst = 0.0
    for nch, nparts, bins in bs_shapes:
        ring, h, tail, bl2 = ring_inputs(nch, nparts, bins)
        for rp in sorted({0, 1 % nparts, nparts - 1}):
            for wp2 in sorted({0, nparts - 1}):
                for b0 in (1.0, 2.0):
                    n0, u0 = step_counts(), BS.MAC_UNPACK_LAUNCHES
                    got = block_kernels(ring, h, tail, bl2, rp, wp2, b0, False)
                    torch.cuda.synchronize()
                    check(step_counts() == tuple(n + 1 for n in n0)
                          and BS.MAC_UNPACK_LAUNCHES == u0 + 1,
                          "each block-step wrapper counts its launch")
                    again = block_kernels(ring, h, tail, bl2, rp, wp2, b0, False)
                    ring_n = got["block_step_fwd_fused"][2:]
                    fused = BS.block_step_fused(ring_n, h, rp, b0, tail, bins)
                    torch.cuda.synchronize()
                    check(all(torch.equal(g, a_) for k_ in got for g, a_ in
                              zip(got[k_], again[k_])),
                          f"block-step kernels bit-equal on a second launch at C={nch} "
                          f"nparts={nparts} bins={bins} rp={rp}")
                    check(all(torch.equal(g, a_) for g, a_ in
                              zip(got["block_step_fwd_fused"][:2], fused)),
                          f"block_step_fwd_fused bit-equal to block_step_fused on its ring at "
                          f"C={nch} nparts={nparts} bins={bins} rp={rp}")
                    want = block_kernels(ring, h, tail, bl2, rp, wp2, b0, True)
                    for kname in (*bs_names, "block_mac_unpack"):
                        for g in got[kname]:
                            check(g.is_contiguous(), f"{kname} returns contiguous planes")
                        if kname in ("spectral_mac", "block_mac_unpack"):
                            mac_worst = max(mac_worst, mac_close(
                                kname, got[kname], want[kname],
                                f"C={nch} nparts={nparts} bins={bins} rp={rp} b0={b0}"))
                        worst = compare(tuple((f"{kname} {i}", g, w_) for i, (g, w_) in
                                              enumerate(zip(got[kname], want[kname]))),
                                        f"C={nch} nparts={nparts} bins={bins} rp={rp} "
                                        f"wp2={wp2} b0={b0}", worst)
                        key = (kname, nch or 1, nparts)
                        bs_err[key] = max(bs_err.get(key, 0.0), *(
                            float((g - w_).abs().max()) for g, w_ in zip(got[kname],
                                                                         want[kname])))
    # the one-launch MAC alone at shapes the steps do not take (bins not a
    # power of two, nparts below and just above the cluster's CTAs), bit-equal
    # on a second launch; and each channel of the headline ring at C = 64
    # bit-equal to the same channel alone (its plan takes no channel count)
    mac_shapes = [(None, 7, 100), (2, 300, 33), (None, 65, 512), (None, 3, 2), (3, 9, 96)]
    for nch, nparts, bins in mac_shapes:
        ring, h, _, _ = ring_inputs(nch, nparts, bins)
        for rp in sorted({0, 1 % nparts, nparts - 1}):
            for b0 in (1.0, 2.0):
                n0 = MC.LAUNCHES
                got, again = MC.spectral_mac(ring, h, rp, b0), MC.spectral_mac(ring, h, rp, b0)
                torch.cuda.synchronize()
                check(MC.LAUNCHES == n0 + 2, "spectral_mac counts its launches")
                where = f"C={nch} nparts={nparts} bins={bins} rp={rp} b0={b0}"
                check(all(torch.equal(g, a_) for g, a_ in zip(got, again)),
                      f"spectral_mac bit-equal on a second launch at {where}")
                mac_worst = max(mac_worst, mac_close(
                    "spectral_mac", got, MC.spectral_mac_plain(ring, h, rp, b0), where))
    ring, h, _, _ = ring_inputs(SERVE_CH, np_, b)
    many = MC.spectral_mac(ring, h, 1, 2.0)
    for c in (0, 17, SERVE_CH - 1):
        alone = MC.spectral_mac(tuple(p[c].contiguous() for p in ring),
                                tuple(p[c].contiguous() for p in h), 1, 2.0)
        torch.cuda.synchronize()
        check(all(torch.equal(m_[c], a_) for m_, a_ in zip(many, alone)),
              f"spectral_mac channel {c} of {SERVE_CH} bit-equal to the channel alone")
    del ring, h, tail, bl2, got, want, again, ring_n, fused, many, alone
    print(f"phase 24 block-step kernels vs twins: {', '.join(bs_names)}, block_mac_unpack at "
          f"(C,nparts,bins) {bs_shapes}, rp {{0, 1, nparts-1}}, wp2 {{0, nparts-1}}, b0 {{1,2}}; "
          f"worst rel err {worst:.3e} (tol {TOL}); bit-equal on a second launch, and the fused "
          f"step to block_step_fused on its ring; spectral_mac also at {mac_shapes}, bit-equal "
          f"on a second launch, and channels 0/17/{SERVE_CH - 1} of the C={SERVE_CH} ring "
          f"bit-equal alone; the one-launch MACs' worst rel err {mac_worst:.3e} (tol {MAC_TOL}); "
          f"max_abs_err at C=1 / C={SERVE_CH} / nparts 1: "
          + "; ".join(f"{k} {bs_err[(k, 1, np_)]:.3e} / {bs_err[(k, SERVE_CH, np_)]:.3e} / "
                      f"{bs_err[(k, 1, 1)]:.3e}" for k in (*bs_names, "block_mac_unpack")),
          flush=True)

    # phase 25: the per-block main paths and the IR hot-swap on the card,
    # against float64 scipy blends (1-r) conv(x, h_old) + r conv(x, h_new)
    def blend(xx, h_old, h_new, f0, f1, n):
        """float64: r rises per sample over [f0, f1) to 1."""
        y_old = sps.fftconvolve(xx.astype(np.float64), h_old.astype(np.float64))[:n]
        y_new = sps.fftconvolve(xx.astype(np.float64), h_new.astype(np.float64))[:n]
        r = np.zeros(n)
        r[f0:f1] = (np.arange(f1 - f0) + 1) / (f1 - f0)
        r[f1:] = 1.0
        return (1 - r) * y_old + r * y_new

    def fresh_ir(n):
        return (rng.standard_normal(n) * np.exp(-np.arange(n) / (0.5 * SR))).astype(np.float32)

    FADE = 8
    h1, h2 = fresh_ir(IR_LEN), fresh_ir(IR_LEN)
    n25 = xs.size // PTS
    x25 = xs[:n25 * PTS]
    sw1, sw2 = 60, 64                      # fade to h1, retarget to h2 mid-fade
    eng25 = P.Clpconv(0, IR_LEN, PTS, quiet, device="cuda")
    eng25.push_ir(ir)
    proc_table = (0.3 * rng.standard_normal(IR_LEN + 900)).astype(np.float32)
    p_skip, p_size, p_scale, p_at, p_fade, p_blocks = 700, 100700, 0.5, 40, 4, 94
    proc25 = P.ClconvProcessor(ir, parts=PTS, device="cuda", on_message=quiet)
    tvp25 = P.CltvconvProcessor(PTS, IR_LEN, device="cuda", on_message=quiet)
    ir_cyc25 = np.resize(ir, p_blocks * PTS)
    swap_ch = list(range(0, SERVE_CH, 4))
    new_irs = (rng.standard_normal((len(swap_ch), IR_LEN)) * decay).astype(np.float32)
    conv25, ref25 = (P.Convolver(cfg, SERVE_CH, device=dev) for _ in range(2))
    conv25.push_ir(irs_d)
    ref25.push_ir(irs_d)
    m_new = (0.1 * rng.standard_normal((1, m_len))).astype(np.float32)
    mx25 = (0.1 * rng.standard_normal((16, 2, PTS))).astype(np.float32)
    m25 = P.MatrixConvolver(mcfg, 2, 2, device=dev)
    m25.push_ir(m_irs)
    out = np.empty(PTS, np.float32)
    zero_counts()
    y_eng = []
    for i in range(n25):
        if i == sw1:
            eng25.push_ir_xfade(h1, FADE)
        if i == sw2:
            eng25.push_ir_xfade(h2, FADE)
        eng25.convolution(out, x25[i * PTS:(i + 1) * PTS])
        y_eng.append(out.copy())
    y_proc, y_tvp = [], []
    for i in range(p_blocks):
        if i == p_at:
            proc25.set_ir(proc_table, skip=p_skip, size=p_size, scale=p_scale,
                          fade_blocks=p_fade)
        y_proc.append(proc25.process(xs[i * PTS:(i + 1) * PTS]))
        y_tvp.append(tvp25.process(xs[i * PTS:(i + 1) * PTS], ir_cyc25[i * PTS:(i + 1) * PTS]))
    y_conv, y_ref = [], []
    for i in range(24):
        if i == 8:
            conv25.set_ir(torch.from_numpy(new_irs).to(dev), channels=swap_ch, fade_blocks=FADE)
        y_conv.append(conv25.step(serve_blocks[i]))
        y_ref.append(ref25.step(serve_blocks[i]))
    y_conv = torch.cat([torch.stack(y_conv), conv25.stream(serve_blocks[24:32])])
    y_ref = torch.cat([torch.stack(y_ref), ref25.stream(serve_blocks[24:32])])
    y_m = []
    for i in range(16):
        if i == 5:
            m25.set_ir(m_new, entries=[(1, 0)], fade_blocks=4)
        y_m.append(m25.step(torch.from_numpy(mx25[i]).to(dev)))
    y_m = torch.stack(y_m).cpu().numpy()
    torch.cuda.synchronize()
    bs_launches = step_counts()
    check(min(bs_launches) > 0, f"the per-block main paths launched every block-step "
                                f"kernel {dict(zip(bs_names, bs_launches))}")
    # the checks, after the counts are read
    n_eng = n25 * PTS
    y_eng = np.concatenate(y_eng)
    want = blend(x25, ir, h1, sw1 * PTS, (sw1 + FADE) * PTS, n_eng)
    want[sw2 * PTS:] = blend(x25, h1, h2, sw2 * PTS, (sw2 + FADE) * PTS, n_eng)[sw2 * PTS:]
    err25a = rel_err(y_eng, want)
    h_proc = np.zeros(IR_LEN, np.float32)
    h_proc[:p_size - p_skip] = proc_table[p_skip:p_size] * np.float32(p_scale)
    n_p = p_blocks * PTS
    y_proc = np.concatenate(y_proc)
    check(np.all(y_proc[:PTS] == 0), "ClconvProcessor latency block")
    want = blend(xs[:n_p], ir, h_proc, p_at * PTS, (p_at + p_fade) * PTS, n_p)
    err25b = rel_err(y_proc[PTS:], want[:n_p - PTS])
    y_tvp = np.concatenate(y_tvp)
    err25c = rel_err(y_tvp[PTS:], ref5[:n_p - PTS])
    untouched = [c for c in range(SERVE_CH) if c not in swap_ch]
    bit25 = all(bool(torch.equal(y_conv[:24, c], y_ref[:24, c])) for c in untouched)
    check(bit25, "Convolver.set_ir: untouched channels bit-equal to a never-swapped engine")
    err25s = worst_channel(y_conv[24:, untouched], y_ref[24:, untouched])
    check(err25s <= TOL, f"Convolver stream after the fade, untouched channels {err25s:.3e}")
    y_np = y_conv.cpu().numpy()
    xs_np = serve_blocks[:32].cpu().numpy()
    err25d = max(rel_err(y_np[:, c].reshape(-1),
                         blend(xs_np[:, c].reshape(-1), irs[c], new_irs[j], 8 * PTS,
                               (8 + FADE) * PTS, 32 * PTS)) for j, c in enumerate(swap_ch))
    mxs = mx25.transpose(1, 0, 2).reshape(2, -1)
    T = 16 * PTS
    ref0 = sum(sps.fftconvolve(mxs[i].astype(np.float64), m_irs[0, i].astype(np.float64))[:T]
               for i in range(2))
    ref1 = blend(mxs[0], m_irs[1, 0], m_new[0], 5 * PTS, 9 * PTS, T) + sps.fftconvolve(
        mxs[1].astype(np.float64), m_irs[1, 1].astype(np.float64))[:T]
    err25m = max(rel_err(y_m[:, 0].reshape(-1), ref0), rel_err(y_m[:, 1].reshape(-1), ref1))
    for what, e in (("Clpconv push_ir_xfade with a retarget", err25a),
                    ("ClconvProcessor.set_ir", err25b), ("CltvconvProcessor", err25c),
                    ("Convolver.set_ir swapped channels", err25d),
                    ("MatrixConvolver.set_ir", err25m)):
        check(bool(np.isfinite(e)) and e <= ORACLE_TOL, f"{what} vs scipy: {e:.3e}")
    print(f"phase 25 per-block main paths and IR hot-swap on {dev} vs float64 scipy blends "
          f"(tol {ORACLE_TOL}): Clpconv.convolution {n25} blocks of {PTS}, push_ir_xfade "
          f"({FADE} blocks) at block {sw1} retargeted at {sw2}: {err25a:.3e}; "
          f"ClconvProcessor.set_ir(skip={p_skip}, size={p_size}, scale={p_scale}, "
          f"fade_blocks={p_fade}) {p_blocks} blocks: {err25b:.3e}; CltvconvProcessor, IR fed "
          f"cyclically: {err25c:.3e}; Convolver(C={SERVE_CH}) 24 step() with set_ir on "
          f"{len(swap_ch)} channels at step 8, then stream(8): swapped {err25d:.3e}, untouched "
          f"bit-equal to a never-swapped engine {bit25}, their stream after the fade "
          f"{err25s:.3e} (tol {TOL}); MatrixConvolver(2, 2) entry (1, 0) swap: {err25m:.3e}; "
          f"launches " + ", ".join(f"{k} {n}" for k, n in zip(bs_names, bs_launches)),
          flush=True)
    del y_conv, y_ref, y_np, xs_np

    # phase 26: per-block times. CUDA events over 10 calls back to back,
    # device time under torch.profiler, and host wall of one synchronised
    # call; each block-step kernel alone (and its twin) at one and 64
    # channels of the headline ring
    def host_wall_us(fn, calls=20):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e6

    st1 = P.push_ir(cfg, P.pconv_init(cfg, dev), ir_d)
    st1 = P.pconv_stream(cfg, st1, blocks[:5])[0]
    st64_ = conv25.state
    b1d, b1h, b64 = f(PTS, s=0.1), f(PTS, s=0.1), f(SERVE_CH, PTS, s=0.1)
    xf1 = P.pconv_begin_xfade(cfg, st1, torch.from_numpy(h1).to(dev))
    xf64 = P.pconv_begin_xfade(cfg, st64_, irs_d.flip(0).contiguous())
    # the blend weights of fade block 3 of FADE
    ramp = torch.from_numpy((np.arange(PTS, dtype=np.float32) + 1 + 3 * PTS)
                            / np.float32(FADE * PTS)).to(dev)
    conv26 = P.Convolver(cfg, SERVE_CH, device=dev)
    conv26.push_ir(irs_d)
    out_b = np.empty(PTS, np.float32)
    path_rows = []
    for label, fn in (("Clpconv.convolution LTI", lambda: eng25.convolution(out_b, b1)),
                      ("Clpconv.convolution TV", lambda: eng25.convolution(out_b, b1, b2)),
                      ("pconv_step C=1", lambda: P.pconv_step(cfg, st1, b1d)),
                      ("pconv_step_tv C=1", lambda: P.pconv_step_tv(cfg, st1, b1d, b1h)),
                      (f"Convolver.step C={SERVE_CH}", lambda: conv26.step(b64)),
                      ("pconv_step_xfade C=1", lambda: P.pconv_step_xfade(cfg, xf1, b1d, ramp)),
                      (f"pconv_step_xfade C={SERVE_CH}",
                       lambda: P.pconv_step_xfade(cfg, xf64, b64, ramp))):
        path_rows.append((label, cuda_ms(fn, reps=7, calls=10), device_us(fn),
                          host_wall_us(fn)))
    print(f"phase 26 per-block timing [{card}] (event ms per call over 10 back to back; "
          f"device us per call under torch.profiler; host wall us of one synchronised call): "
          + "; ".join(f"{lab}: {ms:.4f} ms, device {dus:.1f} us, wall {wus:.1f} us"
                      for lab, ms, dus, wus in path_rows), flush=True)

    def bs_bound(kname, nch, nparts=np_, bins=b):
        """Least time of one call: the step's least work, whatever computes
        it. Each input read once, each output written once (the window and
        h, re and im; the tail in, out and the tail out; the blocks, the new
        doubled input ring and the new h ring), and the operations of the
        MAC and of one real transform of 2 pts points (rfft_flops) a frame
        in and an output block out."""
        plane, row = nch * nparts * bins * 4, nch * bins * 4   # a (nparts, bins) plane; a row
        nbytes_, flops = 4 * plane, 8.0 * nch * nparts * bins  # the window and h; the MAC
        if kname == "spectral_mac":
            return bound(flops, nbytes_ + 2 * row)             # the accumulators out
        nbytes_ += 3 * row
        flops += nch * rfft_flops(2 * bins)
        if kname != "block_step_fused":
            nfr = 2 if kname.endswith("_tv") else 1
            nbytes_ += nfr * row + 4 * plane + (nfr - 1) * 2 * plane
            flops += nfr * nch * rfft_flops(2 * bins)
        return bound(flops, nbytes_)

    def bs_bound_tables(kname, nch):
        """The bound of the dense-table design, printed beside the least-work
        one: the JAX kernels' table products (wfwd, wpost read once, their
        GEMV operations) in place of the transforms."""
        plane, row = nch * np_ * b * 4, nch * b * 4
        nbytes_, flops = 4 * plane + (2 * b) ** 2 * 4 + 3 * row, 8.0 * nch * np_ * b
        flops += 2.0 * nch * (2 * b) ** 2
        if kname != "block_step_fused":
            nfr = 2 if kname.endswith("_tv") else 1
            nbytes_ += PTS * 2 * b * 4 + nfr * row + 4 * plane + (nfr - 1) * 2 * plane
            flops += 2.0 * nfr * nch * PTS * 2 * b
        return bound(flops, nbytes_)

    kern_rows = {}
    for nch in (None, SERVE_CH):
        ring, h, tail, bl2 = ring_inputs(nch, np_, b)
        for kname in bs_names:
            single = {"spectral_mac": lambda: MC.spectral_mac(ring, h, 1, 2.0),
                      "block_step_fused": lambda: BS.block_step_fused(ring, h, 1, 2.0, tail, b),
                      "block_step_fwd_fused": lambda: BS.block_step_fwd_fused(
                          bl2[0], ring, h, 1, 2.0, tail, b),
                      "block_step_fwd_fused_tv": lambda: BS.block_step_fwd_fused_tv(
                          bl2, ring, h, 1, 3, 2.0, tail, b)}[kname]
            plain = {"spectral_mac": lambda: MC.spectral_mac_plain(ring, h, 1, 2.0),
                     "block_step_fused": lambda: BS.block_step_fused_plain(ring, h, 1, 2.0, tail,
                                                                           b),
                     "block_step_fwd_fused": lambda: BS.block_step_fwd_fused_plain(
                         bl2[0], ring, h, 1, 2.0, tail, b),
                     "block_step_fwd_fused_tv": lambda: BS.block_step_fwd_fused_tv_plain(
                         bl2, ring, h, 1, 3, 2.0, tail, b)}[kname]
            kern_rows[(kname, nch or 1)] = (cuda_ms(single, reps=9, calls=10),
                                            device_us(single),
                                            cuda_ms(plain, warmup=1, reps=5, calls=3),
                                            bs_bound(kname, nch or 1))
    del ring, h, tail, bl2
    # the one-launch MAC (spectral_mac) from HBM: a CUDA graph over scaled
    # copies of the ring whose windows and h planes together read over twice
    # the L2; and the __global__ kernels of a call under the profiler (one
    # launch of one)
    mac_hbm = {}
    for nch in (None, SERVE_CH):
        c_ = nch or 1
        ring, h, _, _ = ring_inputs(nch, np_, b)
        nsets = 1 + -(-2 * L2_BYTES // (4 * 4 * c_ * np_ * b))
        sets = [tuple(tuple(p * (1.0 + 1e-3 * i) for p in planes) for planes in (ring, h))
                for i in range(nsets)]
        hbm_us = graph_us(lambda i: MC.spectral_mac(*sets[i], 1, 2.0), nsets)
        kernels_ = check_one_launch(lambda: MC.spectral_mac(ring, h, 1, 2.0),
                                    lambda: MC.LAUNCHES, "mac_cluster_kernel",
                                    f"spectral_mac C={c_}")
        mac_hbm[c_] = (hbm_us, bs_bound("spectral_mac", c_), kernels_)
        del ring, h, sets
    print(f"phase 26 block-step kernels [{card}] (ms per call, CUDA events over 10 calls back "
          f"to back; device us under torch.profiler; twin ms; least-work bound ms): " + "; ".join(
              f"{k} C={c}: {ms:.4f} (device {dus:.1f} us); twin {tw:.4f}; bound {bd[0]:.4f} "
              f"({bd[1]}, {100 * bd[0] / ms:.1f}% reached)"
              for (k, c), (ms, dus, tw, bd) in kern_rows.items())
          + "; the dense-table bound before the redesign, for comparison: " + "; ".join(
              f"{k} C={c} {bs_bound_tables(k, c)[0]:.4f}" for k in bs_names[1:]
              for c in (1, SERVE_CH))
          + f"; spectral_mac nparts {np_} bins {b} from HBM by CUDA graph: " + "; ".join(
              f"C={c_} {us:.1f} us ({100 * bd[0] * 1e3 / us:.1f}% of the bound {1e3 * bd[0]:.2f} "
              f"us, {bd[1]}), launches a call by kernel {kn}"
              for c_, (us, bd, kn) in mac_hbm.items()), flush=True)

    # each step's stages by shape (C = 1 without a channel axis): forward /
    # MAC / inverse device us a call under the profiler (each kernel's mean
    # a launch), the call from HBM by CUDA graph over rotating inputs, and
    # the least-work bound
    def stage_of(kname_):
        return ("inverse" if "inv" in kname_ or "reduce" in kname_ or "ola" in kname_
                else "forward" if "fwd" in kname_ else "MAC" if "mac" in kname_ else "rest")

    stage_rows = []
    for nch in (1, SERVE_CH):
        lead = () if nch == 1 else (nch,)
        for pts_ in (64, PTS, 2048):
            for nparts in (1, np_):
                def make():
                    a_, b_ = f(*lead, nparts, pts_), f(*lead, nparts, pts_)
                    return (torch.cat([a_, a_], -2), torch.cat([b_, b_], -2),
                            f(*lead, nparts, pts_, s=0.05), f(*lead, nparts, pts_, s=0.05),
                            f(*lead, pts_), f(2, *lead, pts_, s=0.1))

                first = make()
                sets_ = [first] + [make() for _ in range(min(
                    47, -(-2 * L2_BYTES // nbytes(*first))))]
                rp_, wp2_ = 1 % nparts, nparts - 1
                steps = {
                    "block_step_fused": lambda i: BS.block_step_fused(
                        sets_[i][:2], sets_[i][2:4], rp_, 2.0, sets_[i][4], pts_),
                    "block_step_fwd_fused": lambda i: BS.block_step_fwd_fused(
                        sets_[i][5][0], sets_[i][:2], sets_[i][2:4], rp_, 2.0, sets_[i][4], pts_),
                    "block_step_fwd_fused_tv": lambda i: BS.block_step_fwd_fused_tv(
                        sets_[i][5], sets_[i][:2], sets_[i][2:4], rp_, wp2_, 2.0, sets_[i][4],
                        pts_)}
                for kname, fn in steps.items():
                    parts = {"forward": 0.0, "MAC": 0.0, "inverse": 0.0, "rest": 0.0}
                    launched = launch_us(lambda: fn(0))
                    for kn, us in launched.items():
                        parts[stage_of(kn)] += us
                    hbm = graph_us(fn, len(sets_), calls=20 if nch == 1 else 5)
                    stage_rows.append((kname, nch, pts_, nparts, parts, len(launched), hbm,
                                       bs_bound(kname, nch, nparts, pts_)))
                del first, sets_
    torch.cuda.empty_cache()
    print(f"phase 26 block-step stages [{card}] (device us a call: forward / MAC / inverse "
          f"under the profiler, kernels a call; from HBM by CUDA graph; least-work bound): "
          + "; ".join(f"{k} C={c} pts={pt} nparts={n}: {pa['forward']:.1f} / {pa['MAC']:.1f} / "
                      f"{pa['inverse']:.1f} ({nk} kernels), from HBM {hb:.1f} us, bound "
                      f"{1e3 * bd[0]:.2f} us ({bd[1]})"
                      for k, c, pt, n, pa, nk, hb, bd in stage_rows), flush=True)

    # phase 27: the TV sliding-MAC kernel (macflow_tv, macflow_tv_batched:
    # one CUDA entry) vs its twin at every main-path shape (1 x 1880 of the
    # headline, the K = 8 chunk's 64 x 8 and 64 x 470, nparts 256, bins
    # 512) at phases on and off the JAX kernel's 8-row alignment, and at odd
    # shapes
    def tv_counts():
        return SM.MACFLOW_TV_LAUNCHES, SM.MACFLOW_TV_BATCHED_LAUNCHES

    @contextlib.contextmanager
    def forced_slices(sl):
        """The TV sliding MAC at ``sl`` q-slices a CTA (1: the unsplit
        kernel) in place of its plan, ``tv_q_slices``."""
        plan_fn = SM.tv_q_slices
        SM.tv_q_slices = lambda *a, **k: sl
        try:
            yield
        finally:
            SM.tv_q_slices = plan_fn

    def tv_mac_inputs(nch, nparts, bins, nout):
        rows = nparts - 1 + nout
        return ((f(nch, rows, bins), f(nch, rows, bins)),
                (f(nch, rows, bins, s=0.05), f(nch, rows, bins, s=0.05)))

    # the K = 8 chunk also at 255 partitions (nparts % S != 0) and the odd
    # shapes; q-slices: the plan's (tv_q_slices), and forced (None: the plan)
    tv_mac_shapes = [(1, np_, b, SCAN_BLOCKS, (0, 5, np_ - 1)),
                     (SERVE_CH, np_, b, CHUNK_K, (0, 3)), (SERVE_CH, np_, b, SERVE_BLOCKS, (0, 3)),
                     (SERVE_CH, np_ - 1, b, CHUNK_K, (0, 5)),
                     (2, 1, 16, 5, (0,)), (3, 3, 48, 13, (0, 2)), (2, 9, 16, 21, (4,))]
    forced = {(SERVE_CH, np_, CHUNK_K): (1, 2, 8), (3, 3, 13): (2, 4, 8), (2, 9, 21): (2, 4)}
    tvm_err, plans = {}, {}
    worst = 0.0
    for nch, nparts, bins, nout, phases in tv_mac_shapes:
        xm, hm = tv_mac_inputs(nch, nparts, bins, nout)
        plans[(nch, nparts, nout)] = SM.tv_q_slices(nch, nout, bins, nparts)
        for c in phases:
            for b0 in (1.0, 2.0):
                n0 = tv_counts()
                got = {"macflow_tv_batched": SM.macflow_tv_batched(xm, hm, nout, nparts, b0, c),
                       "macflow_tv": SM.macflow_tv((xm[0][0], xm[1][0]), (hm[0][0], hm[1][0]),
                                                   nout, nparts, b0, c)}
                for sl in forced.get((nch, nparts, nout), ()) if b0 == 2.0 else ():
                    with forced_slices(sl):
                        got[f"macflow_tv_batched slices={sl}"] = SM.macflow_tv_batched(
                            xm, hm, nout, nparts, b0, c)
                again = SM.macflow_tv_batched(xm, hm, nout, nparts, b0, c)
                torch.cuda.synchronize()
                check(tv_counts() == (n0[0] + 1, n0[1] + len(got)),
                      "each TV sliding-MAC wrapper counts its launch")
                check(all(torch.equal(g_, a_) for g_, a_ in zip(got["macflow_tv_batched"], again)),
                      f"the TV sliding MAC repeats its bits at C={nch} nparts={nparts}")
                want = SM.slide_mac_tv_plain(xm, hm, nout, nparts, b0, c)
                for wname, g in got.items():
                    w = (want[0][0], want[1][0]) if wname == "macflow_tv" else want
                    where = f"C={nch} nparts={nparts} bins={bins} nout={nout} c={c} b0={b0}"
                    e = compare(((f"{wname} re", g[0], w[0]), (f"{wname} im", g[1], w[1])),
                                where, 0.0)
                    check(e <= NEW_TOL, f"{wname} vs twin at {where}: {e:.3e} > {NEW_TOL}")
                    worst = max(worst, e)
                    key = (wname.split()[0], nch, nout)
                    tvm_err[key] = max(tvm_err.get(key, 0.0),
                                       *(float((gg - ww).abs().max()) for gg, ww in zip(g, w)))
    del xm, hm, got, want, again
    print(f"phase 27 TV sliding-MAC kernel vs twin: macflow_tv_batched and macflow_tv (channel "
          f"0) at (C,nparts,bins,nout,phases) {tv_mac_shapes} x b0 {{1,2}}, q-slices by the plan "
          f"{plans} and forced {forced}; bit-equal on a second launch; worst rel err "
          f"{worst:.3e} (tol {NEW_TOL}); max_abs_err macflow_tv 1x{SCAN_BLOCKS} "
          f"{tvm_err[('macflow_tv', 1, SCAN_BLOCKS)]:.3e}; macflow_tv_batched "
          f"{SERVE_CH}x{CHUNK_K} {tvm_err[('macflow_tv_batched', SERVE_CH, CHUNK_K)]:.3e}, "
          f"{SERVE_CH}x{SERVE_BLOCKS} "
          f"{tvm_err[('macflow_tv_batched', SERVE_CH, SERVE_BLOCKS)]:.3e}", flush=True)

    # phase 28: the scan entries above pts 2048, where they stand for the JAX
    # split scans (stream_steps_fused_split{,_tv}), vs their twins at the long-IR
    # shape (pts 4096, 2^20 taps: nparts 256, 470 blocks) at one and 16
    # channels (TV pointers shared and per channel), at pts 512, at odd
    # shapes, and at pts 8192 and 2^14 (the largest transforms inside a CTA)
    # and 2^15 (the four-step on scratch planes)
    long_np = LONG_IR // LONG_PTS
    split_shapes = [(LONG_PTS, long_np, LONG_BLOCKS, 1), (LONG_PTS, long_np, LONG_BLOCKS, LONG_CH),
                    (PTS, 16, 21, 2), (64, 3, 5, 3), (16, 1, 1, 2), (32, 3, 1, 1), (16, 1, 5, 1),
                    (1 << 13, 4, 5, 2), (1 << 14, 2, 3, 1), (1 << 15, 2, 3, 2)]
    split_err = {}
    worst = 0.0
    for pts, nparts, nb_, nch in split_shapes:
        px, ph, w0_, h0_, tails = batched_inputs(pts, nparts, nb_, nch)
        where = f"pts={pts} nparts={nparts} nb={nb_} C={nch}"
        for b0 in ((2.0,) if pts == LONG_PTS else (1.0, 2.0)):
            n0 = S.BATCHED_LAUNCHES
            got = S.stream_steps_fused_batched(px, w0_, h0_, b0, tails, pts)
            torch.cuda.synchronize()
            check(S.BATCHED_LAUNCHES == n0 + 1, "BATCHED_LAUNCHES counts the kernel launch")
            again = S.stream_steps_fused_batched(px, w0_, h0_, b0, tails, pts)
            check(torch.equal(got[0], again[0]) and torch.equal(got[2], again[2]),
                  f"the split scan repeats its bits at {where}")
            want = S.stream_steps_fused_batched_plain(px, w0_, h0_, b0, tails, pts)
            worst = compare((("out", got[0], want[0]), ("window re", got[1][0], want[1][0]),
                             ("window im", got[1][1], want[1][1]), ("tails", got[2], want[2])),
                            f"{where} b0={b0}", worst)
            key = ("split", nch, pts)
            split_err[key] = max(split_err.get(key, 0.0), float((got[0] - want[0]).abs().max()))
            ptrs = [nparts - 1]
            if nch > 1:
                ptrs.append(tuple((7 * c + 3) % nparts for c in range(nch)))
            for wp2 in ptrs:
                n0 = S.BATCHED_TV_LAUNCHES
                got = S.stream_steps_fused_batched_tv(px, ph, w0_, h0_, wp2, b0, tails, pts)
                torch.cuda.synchronize()
                check(S.BATCHED_TV_LAUNCHES == n0 + 1,
                      "BATCHED_TV_LAUNCHES counts the kernel launch")
                again = S.stream_steps_fused_batched_tv(px, ph, w0_, h0_, wp2, b0, tails, pts)
                check(torch.equal(got[0], again[0]) and torch.equal(got[3], again[3]),
                      f"the split TV scan repeats its bits at {where}")
                want = S.stream_steps_fused_batched_tv_plain(px, ph, w0_, h0_, wp2, b0, tails,
                                                             pts)
                worst = compare((("out", got[0], want[0]), ("window re", got[1][0], want[1][0]),
                                 ("h ring re", got[2][0], want[2][0]),
                                 ("h ring im", got[2][1], want[2][1]),
                                 ("tails", got[3], want[3])),
                                f"{where} b0={b0} wp2 "
                                f"{'per channel' if isinstance(wp2, tuple) else 'shared'}", worst)
                key = ("split_tv", nch, pts)
                split_err[key] = max(split_err.get(key, 0.0),
                                     float((got[0] - want[0]).abs().max()))
    del px, ph, w0_, h0_, tails, got, again, want
    print(f"phase 28 split-scan kernels vs twins: shapes (pts,nparts,nb,C) {split_shapes} "
          f"(b0 2 at pts {LONG_PTS}, {{1,2}} elsewhere), TV wp2 shared and per channel, "
          f"bit-equal on a second launch; worst rel "
          f"err {worst:.3e} (tol {TOL}); "
          f"out max_abs_err at pts {LONG_PTS}: LTI C=1 {split_err[('split', 1, LONG_PTS)]:.3e} "
          f"C={LONG_CH} {split_err[('split', LONG_CH, LONG_PTS)]:.3e}, TV C=1 "
          f"{split_err[('split_tv', 1, LONG_PTS)]:.3e} C={LONG_CH} "
          f"{split_err[('split_tv', LONG_CH, LONG_PTS)]:.3e}", flush=True)

    # phase 29: the new main paths against float64 oracles. The TV
    # decomposed engine at the headline (phase 9's scan, the IR fed
    # cyclically through operand 2); K = 8 chunked TV serving of 64
    # channels x 472 blocks (each channel's IR fed cyclically from a zero
    # state, so the output is its convolution), from the start and after 3
    # step() calls, chained into stream(); and the long-IR paths at pts 4096
    # (a 2^20-tap IR): convolve of phase 4's 20 s, pconv_stream_tv with the
    # IR fed cyclically, stream_decomposed LTI and TV against the split
    # scans, and Convolver / TVConvolver of 16 channels against 16
    # single-channel scans
    from opencl_fft_tpu_torch.ops.decomposed import stream_decomposed as SD

    cfg4 = P.PconvConfig.for_ir_length(LONG_IR, LONG_PTS)
    decay4 = np.exp(-np.arange(LONG_IR) / (2.0 * SR))
    ir4 = (rng.standard_normal(LONG_IR) * decay4).astype(np.float32)
    ir4_d = torch.from_numpy(ir4).to(dev)
    st4 = P.push_ir(cfg4, P.pconv_init(cfg4, dev), ir4_d)
    nb4 = -(-(x.size + LONG_IR) // LONG_PTS)
    x_p4 = torch.nn.functional.pad(x_d, (0, nb4 * LONG_PTS - x.size)).reshape(nb4, LONG_PTS)
    h_cyc4 = ir4_d.reshape(long_np, LONG_PTS)[torch.arange(nb4, device=dev) % long_np]
    h_cyc = ir_d.reshape(np_, PTS)[torch.arange(nb_tv, device=dev) % np_].contiguous()
    h_chk = irs_d.reshape(SERVE_CH, np_, PTS)[
        :, torch.arange(CHUNK_BLOCKS, device=dev) % np_].transpose(0, 1).contiguous()
    irs4 = (rng.standard_normal((LONG_CH, LONG_IR)) * decay4).astype(np.float32)
    irs4_d = torch.from_numpy(irs4).to(dev)
    xs4 = (0.1 * rng.standard_normal((LONG_CH, LONG_BLOCKS * LONG_PTS))).astype(np.float32)
    b4 = torch.from_numpy(np.ascontiguousarray(
        xs4.reshape(LONG_CH, LONG_BLOCKS, LONG_PTS).transpose(1, 0, 2))).to(dev)
    h4 = irs4_d.reshape(LONG_CH, long_np, LONG_PTS)[
        :, torch.arange(LONG_BLOCKS, device=dev) % long_np].transpose(0, 1).contiguous()
    conv4 = P.Convolver(cfg4, LONG_CH, device=dev)
    conv4.push_ir(irs4_d)
    tvc4 = P.TVConvolver(cfg4, LONG_CH, device=dev)
    tvk, tvk3 = (P.TVConvolver(cfg, SERVE_CH, device=dev) for _ in range(2))
    zero_counts()
    y_dtv = SD(cfg, st_ir, x_p, h_cyc)[1]
    y_k = tvk.stream_chunked(chk_blocks, h_chk, K=CHUNK_K)
    y_k3 = torch.cat([torch.stack([tvk3.step(chk_blocks[i], h_chk[i]) for i in range(3)]),
                      tvk3.stream_chunked(chk_blocks[3:CHUNK_BLOCKS - 5],
                                          h_chk[3:CHUNK_BLOCKS - 5], K=CHUNK_K),
                      tvk3.stream(chk_blocks[CHUNK_BLOCKS - 5:], h_chk[CHUNK_BLOCKS - 5:])])
    # the scan launches of the pts-4096 calls alone (tvk3.stream above ran the
    # TV scan at pts 512); stream_decomposed launches no scan
    S.BATCHED_LAUNCHES = S.BATCHED_TV_LAUNCHES = 0
    y_c4 = P.convolve(x_d, ir4_d, LONG_PTS)
    y_tv4 = P.pconv_stream_tv(cfg4, st4, x_p4, h_cyc4)[1]
    y_d4 = SD(cfg4, st4, x_p4)[1]
    y_dtv4 = SD(cfg4, st4, x_p4, h_cyc4)[1]
    y_s4 = conv4.stream(b4)
    y_t4 = tvc4.stream(b4, h4)
    torch.cuda.synchronize()
    new_launches = (SM.MACFLOW_TV_LAUNCHES, SM.MACFLOW_TV_BATCHED_LAUNCHES, S.BATCHED_LAUNCHES,
                    S.BATCHED_TV_LAUNCHES)
    check(min(new_launches) > 0, f"the new main paths launched every new kernel {new_launches}")
    # the checks, after the counts are read
    y_tvs = P.pconv_stream_tv(cfg, st_ir, x_p, h_cyc)[1]
    err_dtv = rel_err(y_dtv.reshape(-1)[:ref.size].cpu().numpy(), ref)
    err_dtv_s = float((y_dtv - y_tvs).abs().max()) / float(y_tvs.abs().max())
    tv_ref = P.TVConvolver(cfg, SERVE_CH, device=dev)
    y_ks = tv_ref.stream(chk_blocks, h_chk)
    err_k, err_k3 = worst_channel(y_k, y_ks), worst_channel(y_k3, y_ks)
    err_ko = max(rel_err(y_k[:, c].reshape(-1).cpu().numpy(),
                         sps.fftconvolve(xs_chk[c].astype(np.float64),
                                         irs[c].astype(np.float64))[:n_chk])
                 for c in (0, SERVE_CH - 1))
    n4 = x.size + LONG_IR - 1
    ref4 = sps.fftconvolve(x.astype(np.float64), ir4.astype(np.float64))
    check(tuple(y_c4.shape) == ref4.shape, "convolve at pts 4096 shape")
    err_c4 = rel_err(y_c4.cpu().numpy(), ref4)
    err_tv4 = rel_err(y_tv4.reshape(-1)[:n4].cpu().numpy(), ref4)
    err_d4 = float((y_d4.reshape(-1)[:n4] - y_c4).abs().max()) / float(y_c4.abs().max())
    err_dtv4 = float((y_dtv4 - y_tv4).abs().max()) / float(y_tv4.abs().max())
    singles4 = torch.stack([P.pconv_stream(cfg4, P.push_ir(cfg4, P.pconv_init(cfg4, dev),
                                                           irs4_d[c]), b4[:, c])[1]
                            for c in range(LONG_CH)], 1)
    err_s4, err_t4 = worst_channel(y_s4, singles4), worst_channel(y_t4, singles4)
    n_4 = LONG_BLOCKS * LONG_PTS
    err_s4o = max(rel_err(y_s4[:, c].reshape(-1).cpu().numpy(),
                          sps.fftconvolve(xs4[c].astype(np.float64),
                                          irs4[c].astype(np.float64))[:n_4])
                  for c in (0, LONG_CH - 1))
    for what, e, tol in (("TV stream_decomposed vs scipy", err_dtv, ORACLE_TOL),
                         ("TV stream_decomposed vs pconv_stream_tv", err_dtv_s, TOL),
                         ("TVConvolver.stream_chunked vs stream", err_k, TOL),
                         ("3 step() + stream_chunked + stream vs stream", err_k3, TOL),
                         ("TVConvolver.stream_chunked vs scipy", err_ko, ORACLE_TOL),
                         ("convolve at pts 4096 vs scipy", err_c4, ORACLE_TOL),
                         ("pconv_stream_tv at pts 4096 vs scipy", err_tv4, ORACLE_TOL),
                         ("stream_decomposed at pts 4096 vs the split scan", err_d4, TOL),
                         ("TV stream_decomposed at pts 4096 vs the split scan", err_dtv4, TOL),
                         ("Convolver(16).stream at pts 4096 vs single scans", err_s4, TOL),
                         ("TVConvolver(16).stream at pts 4096 vs single scans", err_t4,
                          ORACLE_TOL),
                         ("Convolver(16).stream at pts 4096 vs scipy", err_s4o, ORACLE_TOL)):
        check(np.isfinite(e) and e <= tol, f"{what}: {e:.3e} > {tol}")
    print(f"phase 29 TV decomposed and long-IR main paths on {dev}: TV stream_decomposed("
          f"{nb_tv}x{PTS}, {IR_LEN} taps cyclic in operand 2) vs float64 scipy {err_dtv:.3e}, vs "
          f"pconv_stream_tv {err_dtv_s:.3e}; TVConvolver({SERVE_CH}).stream_chunked(K={CHUNK_K}, "
          f"{CHUNK_BLOCKS} blocks, IRs cyclic) vs stream {err_k:.3e}, vs scipy {err_ko:.3e}; 3 "
          f"step() + stream_chunked + stream vs stream {err_k3:.3e}; convolve({x.size} samples, "
          f"{LONG_IR} taps, pts={LONG_PTS}) vs scipy {err_c4:.3e}; pconv_stream_tv({nb4}x"
          f"{LONG_PTS}, IR cyclic) vs scipy {err_tv4:.3e}; stream_decomposed LTI / TV at pts "
          f"{LONG_PTS} vs the split scans {err_d4:.3e} / {err_dtv4:.3e}; Convolver({LONG_CH}) / "
          f"TVConvolver({LONG_CH}).stream({LONG_BLOCKS}x{LONG_CH}x{LONG_PTS}) vs {LONG_CH} "
          f"single-channel scans {err_s4:.3e} / {err_t4:.3e}, vs scipy {err_s4o:.3e} (tol "
          f"{TOL} between paths, {ORACLE_TOL} vs scipy); launches macflow_tv "
          f"{new_launches[0]} macflow_tv_batched {new_launches[1]} stream_steps_fused_split "
          f"{new_launches[2]} stream_steps_fused_split_tv {new_launches[3]}", flush=True)
    del y_dtv, y_k, y_k3, y_ks, y_tvs, y_c4, y_tv4, y_d4, y_dtv4, y_s4, y_t4, singles4, tv_ref

    # phase 30: timing of the new paths (CUDA events) under the JAX bench's
    # metric names, each beside the path it is an alternative to, the new
    # kernels against their twins and bounds, and the new paths' device
    # busy share under torch.profiler
    st_tv = P.push_ir(cfg, P.batched_state(cfg, SERVE_CH, dev), irs_d)
    b4_1, bh4_1 = b4[:, 0].contiguous(), h4[:, 0].contiguous()
    long_audio = LONG_BLOCKS * LONG_PTS / SR
    tv_s_ms = cuda_ms(lambda: P.pconv_stream_tv(cfg, state, blocks, bh), reps=9)
    dtv_ms = cuda_ms(lambda: SD(cfg, state, blocks, bh), reps=9)
    chk_tv_ms = cuda_ms(lambda: P.pconv_stream_batched_tv_chunked(cfg, st_tv, chk_blocks, h_chk,
                                                                   K=CHUNK_K), warmup=1, reps=3)
    # the same path with the TV sliding MAC unsplit (one q-slice a CTA),
    # then the default again: the q-split's effect end to end on this card
    with forced_slices(1):
        chk_tv_unsplit_ms = cuda_ms(lambda: P.pconv_stream_batched_tv_chunked(
            cfg, st_tv, chk_blocks, h_chk, K=CHUNK_K), warmup=1, reps=3)
        chk_tv_unsplit_dev = device_us(lambda: P.pconv_stream_batched_tv_chunked(
            cfg, st_tv, chk_blocks, h_chk, K=CHUNK_K), calls=2)
    chk_tv_dev = device_us(lambda: P.pconv_stream_batched_tv_chunked(
        cfg, st_tv, chk_blocks, h_chk, K=CHUNK_K), calls=2)
    chk_tv_ms2 = cuda_ms(lambda: P.pconv_stream_batched_tv_chunked(cfg, st_tv, chk_blocks, h_chk,
                                                                    K=CHUNK_K), warmup=1, reps=3)
    s_tv_ms = cuda_ms(lambda: P.pconv_stream_batched_tv(cfg, st_tv, chk_blocks, h_chk), reps=5)
    l_ms = cuda_ms(lambda: P.pconv_stream(cfg4, st4, b4_1), reps=7)
    l_tv_ms = cuda_ms(lambda: P.pconv_stream_tv(cfg4, st4, b4_1, bh4_1), reps=7)
    l_d_ms = cuda_ms(lambda: SD(cfg4, st4, b4_1), reps=7)
    l_dtv_ms = cuda_ms(lambda: SD(cfg4, st4, b4_1, bh4_1), reps=7)
    s4_ms = cuda_ms(lambda: conv4.stream(b4), warmup=1, reps=3)
    t4_ms = cuda_ms(lambda: tvc4.stream(b4, h4), warmup=1, reps=3)
    audio_chk_tv = SERVE_CH * n_chk / SR
    new_rows, tv_dev = {}, {}
    for wname, nch, nout in (("macflow_tv", 1, SCAN_BLOCKS),
                             ("macflow_tv_batched", SERVE_CH, CHUNK_K),
                             ("macflow_tv_batched", SERVE_CH, SERVE_BLOCKS)):
        # two input sets (2 x 138 MB at the K = 8 chunk) for device time from HBM
        tv_sets = [tv_mac_inputs(nch, np_, b, nout) for _ in range(2)]
        xm, hm = tv_sets[0]
        if wname == "macflow_tv":
            x1, h1_ = (xm[0][0], xm[1][0]), (hm[0][0], hm[1][0])
            run = lambda: SM.macflow_tv(x1, h1_, nout, np_, 2.0, 5)  # noqa: E731
        else:
            run = lambda: SM.macflow_tv_batched(xm, hm, nout, np_, 2.0, 3)  # noqa: E731
        k_ms = cuda_ms(run, reps=9, calls=10 if nout == CHUNK_K else 1)
        tw_ms = cuda_ms(lambda: SM.slide_mac_tv_plain(xm, hm, nout, np_, 2.0, 3), warmup=1,
                        reps=3)
        # least work: the MAC; bytes: both timelines in, the accumulators out
        bnd = bound(8.0 * nch * nout * np_ * b, nbytes(*xm, *hm) + 2 * 4 * nch * nout * b)
        new_rows[(wname, nch, nout)] = (k_ms, tw_ms, bnd)
        # device us from HBM at the plan's q-slices and at the others (1: the
        # unsplit kernel)
        plan = SM.tv_q_slices(nch, nout, b, np_)
        calls = 10 if nout == CHUNK_K else 2
        by_slices = {}
        for sl in ((1, 2, 4, 8) if nout == CHUNK_K else (1, 2)):
            with forced_slices(sl):
                by_slices[sl] = graph_us(
                    lambda i: SM.macflow_tv_batched(*tv_sets[i], nout, np_, 2.0, 3), 2,
                    calls=calls)
        tv_dev[(wname, nch, nout)] = (plan, by_slices)
    del xm, hm, tv_sets

    # the split scans at cell 12: CUDA events, device us from HBM (a CUDA
    # graph over input sets that together outgrow the L2), and by
    # torch.profiler the forward transforms / MAC / inverse transforms / the
    # rest; at C = 1 also the scan's transient device memory
    split_dev, split_parts = {}, {}
    for nch in (1, LONG_CH):
        px, ph, w0_, h0_, tails = batched_inputs(LONG_PTS, long_np, LONG_BLOCKS, nch)
        la = (px, w0_, h0_, 2.0, tails, LONG_PTS)
        ta = (px, ph, w0_, h0_, long_np - 1, 2.0, tails, LONG_PTS)
        nbc4 = LONG_BLOCKS * nch
        nsets = 1 + -(-2 * L2_BYTES // nbytes(px, ph, *w0_, *h0_, tails))
        sets = [batched_inputs(LONG_PTS, long_np, LONG_BLOCKS, nch) for _ in range(nsets)]
        for kname, fn, plain, args, ntr, hio in (
                ("stream_steps_fused_split", S.stream_steps_fused_batched,
                 S.stream_steps_fused_batched_plain, la, 2, 1),
                ("stream_steps_fused_split_tv", S.stream_steps_fused_batched_tv,
                 S.stream_steps_fused_batched_tv_plain, ta, 3, 2)):
            k_ms = cuda_ms(lambda: fn(*args), reps=5 if nch == 1 else 3)
            tw_ms = cuda_ms(lambda: plain(*args), warmup=1, reps=3)
            # least work: the MAC and 2 (LTI) or 3 (TV) real transforms a
            # block; bytes: blocks, windows and tails in and out, the h
            # planes in (LTI) or in and out (TV), the coefficient blocks in
            nbytes_ = 2 * nbytes(px, *w0_, tails) + hio * nbytes(*h0_) \
                + (nbytes(ph) if ntr == 3 else 0)
            bnd = bound(stream_flops(nbc4, long_np, LONG_PTS, LONG_PTS, ntr * nbc4), nbytes_)
            new_rows[(kname, nch, LONG_BLOCKS)] = (k_ms, tw_ms, bnd)
            if ntr == 2:
                run_set = lambda i: fn(sets[i][0], *sets[i][2:4], 2.0, sets[i][4],  # noqa: E731
                                       LONG_PTS)
            else:
                run_set = lambda i: fn(sets[i][0], *sets[i][1:4], long_np - 1,  # noqa: E731
                                       2.0, sets[i][4], LONG_PTS)
            split_dev[(kname, nch)] = graph_us(run_set, nsets, calls=10 if nch == 1 else 4,
                                               reps=5)
            split_parts[(kname, nch)] = scan_parts(lambda: fn(*args), ntr == 3)
        if nch == 1:
            torch.cuda.synchronize()
            base_mem = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            S.stream_steps_fused_batched(*la)
            torch.cuda.synchronize()
            split_peak = torch.cuda.max_memory_allocated(dev) - base_mem
    split_tables_bytes = sum(nbytes(t) for t in S._plan(LONG_PTS, dev).tables if t is not None) \
        + nbytes(*S.coef_tables(LONG_PTS, dev))
    del px, ph, w0_, h0_, tails, sets, la, ta

    design_lti = scan_design_flops(LONG_BLOCKS, 1, long_np, LONG_PTS, False)
    print(f"phase 30 timing [{card}]: tvconv_decomposed_rt_factor_2^17_512 "
          f"{audio_s / (dtv_ms / 1e3):.1f} (TV stream_decomposed {SCAN_BLOCKS}x{PTS}: "
          f"{dtv_ms:.4f} ms; pconv_stream_tv {tv_s_ms:.4f} ms = {audio_s / (tv_s_ms / 1e3):.1f}x); "
          f"serving_64ch_tv_chunk8_audio_seconds_per_second {audio_chk_tv / (chk_tv_ms / 1e3):.1f} "
          f"(pconv_stream_batched_tv_chunked K={CHUNK_K} {CHUNK_BLOCKS}x{SERVE_CH}: "
          f"{chk_tv_ms:.4f} ms; TVConvolver.stream at that shape {s_tv_ms:.4f} ms = "
          f"{audio_chk_tv / (s_tv_ms / 1e3):.1f}; chunked/stream {chk_tv_ms / s_tv_ms:.2f}x; "
          f"with the unsplit TV MAC {chk_tv_unsplit_ms:.4f} ms (device {chk_tv_unsplit_dev:.1f} "
          f"us), then split again {chk_tv_ms2:.4f} ms (device {chk_tv_dev:.1f} us)); "
          f"pconv_realtime_factor_2^20tap_4096pts {long_audio / (l_ms / 1e3):.1f} (pconv_stream "
          f"{LONG_BLOCKS}x{LONG_PTS}: {l_ms:.4f} ms; stream_decomposed {l_d_ms:.4f} ms = "
          f"{long_audio / (l_d_ms / 1e3):.1f}x); tvconv_rt_factor_2^20_4096 "
          f"{long_audio / (l_tv_ms / 1e3):.1f} (pconv_stream_tv {l_tv_ms:.4f} ms; TV "
          f"stream_decomposed {l_dtv_ms:.4f} ms = {long_audio / (l_dtv_ms / 1e3):.1f}x); "
          f"Convolver({LONG_CH}).stream {s4_ms:.4f} ms = "
          f"{LONG_CH * long_audio / (s4_ms / 1e3):.1f} audio-s/s, TVConvolver({LONG_CH}).stream "
          f"{t4_ms:.4f} ms = {LONG_CH * long_audio / (t4_ms / 1e3):.1f} | kernels (ms; twin; "
          f"bound): " + "; ".join(
              f"{k} C={c}x{n}: {ms:.4f}; twin {tw:.4f}; bound {bd[0]:.4f} ({bd[1]}, "
              f"{100 * bd[0] / ms:.2f}% reached)" for (k, c, n), (ms, tw, bd) in new_rows.items())
          + " | TV sliding MAC, device us from HBM (a CUDA graph over 2 input sets) by q-slices "
          "a CTA: " + "; ".join(
              f"C={c}x{n} (plan {pl}): " + ", ".join(
                  f"S={sl} {us:.1f} ({100 * new_rows[(k, c, n)][2][0] * 1e3 / us:.1f}% of the "
                  f"bound)" for sl, us in d.items())
              for (k, c, n), (pl, d) in tv_dev.items())
          + f" | split scans at pts {LONG_PTS} x {LONG_BLOCKS} blocks, device us from HBM (a "
          "CUDA graph over rotating input sets) and by torch.profiler (mean a launch times "
          "launches a scan) forward / MAC / inverse / rest: " + "; ".join(
              f"{k} C={c}: {us:.1f} us "
              f"({100 * new_rows[(k, c, LONG_BLOCKS)][2][0] * 1e3 / us:.2f}% of the bound); "
              + fmt_parts(parts, 8.0 * c * LONG_BLOCKS * long_np * LONG_PTS)
              + f" ({100 * parts['MAC'] / sum(parts.values()):.1f}% MAC)"
              for (k, c), us in split_dev.items() for parts in (split_parts[(k, c)],))
          + f" | the split LTI scan's design does {design_lti / 1e9:.3f} GFLOP at C=1 "
          f"({design_lti / (split_dev[('stream_steps_fused_split', 1)] / 1e6) / 1e12:.2f} "
          f"TFLOP/s from HBM); its tables {split_tables_bytes / 2**20:.3f} MiB, transient device "
          f"memory of one C=1 scan {split_peak / 2**20:.1f} MiB", flush=True)
    profile_streams((
        ("TV stream_decomposed 1880 blocks", lambda: SD(cfg, state, blocks, bh)),
        ("pconv_stream_batched_tv_chunked K=8 64ch x 472 blocks",
         lambda: P.pconv_stream_batched_tv_chunked(cfg, st_tv, chk_blocks, h_chk, K=CHUNK_K)),
        ("pconv_stream pts 4096 470 blocks", lambda: P.pconv_stream(cfg4, st4, b4_1)),
        ("pconv_stream_tv pts 4096 470 blocks",
         lambda: P.pconv_stream_tv(cfg4, st4, b4_1, bh4_1)),
        ("stream_decomposed pts 4096 470 blocks", lambda: SD(cfg4, st4, b4_1)),
        ("Convolver(16).stream pts 4096", lambda: conv4.stream(b4))), calls=3, phase=30)

    # phase 31: the MAC-and-unpack kernel (block_mac_unpack) vs its twin on
    # the card at its main-path shapes (the zero-latency terminal segment,
    # nparts 255; the per-block step at pts 4096, nparts 256, one channel and
    # Convolver(16)), at one partition, at the JAX test's (8, 128) and at an
    # odd shape, within 3e-6 of max|twin|; and bit for bit against
    # unpack_inverse of the spectral_mac kernel, whose MAC and slice-order
    # reduce it shares
    from opencl_fft_tpu_torch.ops.rfft import unpack_inverse
    from opencl_fft_tpu_torch.ops.stft import hann_np

    # the main-path shapes, one partition, the JAX test's (8, 128), and odd
    # shapes: bins not a power of two (odd bins too), nparts below the
    # cluster's CTAs
    mu_shapes = [(None, long_np - 1, LONG_PTS), (None, long_np, LONG_PTS),
                 (LONG_CH, long_np, LONG_PTS), (None, 1, LONG_PTS), (None, 8, 128), (3, 5, 96),
                 (None, 7, 100), (2, 300, 65), (None, 3, 2)]
    mu_err, worst, mu_bit = {}, 0.0, True
    for nch, nparts, bins in mu_shapes:
        ring, h, _, _ = ring_inputs(nch, nparts, bins)
        for rp in sorted({0, 1 % nparts, nparts - 1}):
            for b0 in (1.0, 2.0):
                u0 = BS.MAC_UNPACK_LAUNCHES
                got = BS.block_mac_unpack(ring, h, rp, b0)
                torch.cuda.synchronize()
                check(BS.MAC_UNPACK_LAUNCHES == u0 + 1, "block_mac_unpack counts its launch")
                again = BS.block_mac_unpack(ring, h, rp, b0)
                want = BS.block_mac_unpack_plain(ring, h, rp, b0)
                same = unpack_inverse(MC.spectral_mac(ring, h, rp, b0))
                where = f"C={nch} nparts={nparts} bins={bins} rp={rp} b0={b0}"
                for g, a_, w_, s_ in zip(got, again, want, same):
                    check(g.is_contiguous() and bool(torch.isfinite(g).all()),
                          f"block_mac_unpack contiguous and finite at {where}")
                    check(torch.equal(g, a_),
                          f"block_mac_unpack bit-equal on a second launch at {where}")
                    rel = float((g - w_).abs().max()) / max(float(w_.abs().max()), 1e-30)
                    check(rel <= MAC_TOL, f"block_mac_unpack vs twin at {where}: {rel:.3e}")
                    worst = max(worst, rel)
                    mu_bit = mu_bit and bool(torch.equal(g, s_))
                    key = (nch or 1, nparts, bins)
                    mu_err[key] = max(mu_err.get(key, 0.0), float((g - w_).abs().max()))
    check(mu_bit, "block_mac_unpack equals unpack_inverse(spectral_mac) bit for bit")
    # each channel of the Convolver(16) ring bit-equal to the same ring alone
    ring, h, _, _ = ring_inputs(LONG_CH, long_np, LONG_PTS)
    many = BS.block_mac_unpack(ring, h, 1, 2.0)
    for c in range(LONG_CH):
        alone = BS.block_mac_unpack(tuple(p[c:c + 1].contiguous() for p in ring),
                                    tuple(p[c:c + 1].contiguous() for p in h), 1, 2.0)
        torch.cuda.synchronize()
        check(all(torch.equal(m_[c], a_[0]) for m_, a_ in zip(many, alone)),
              f"block_mac_unpack channel {c} of {LONG_CH} bit-equal to the channel alone")
    # rp read from device memory (rp_at: the step graphs' route) at the
    # zero-latency terminal's shape and the opcode engine's (nparts 512,
    # bins 8192), given another int rp: bit-equal to the int launch at the
    # row held, within MAC_TOL of the twin there
    at_shapes = [(long_np - 1, LONG_PTS), (OPCODE_TAPS // OPCODE_PTS, OPCODE_PTS)]
    worst_at = 0.0
    for nparts, bins in at_shapes:
        ring, h, _, _ = ring_inputs(None, nparts, bins)
        for held in sorted({0, 1, nparts // 3, nparts - 1}):
            at = torch.tensor([held], dtype=torch.int32, device=dev)
            u0 = BS.MAC_UNPACK_LAUNCHES
            got = BS.block_mac_unpack(ring, h, (held + 1) % nparts, 2.0, at)
            want_k = BS.block_mac_unpack(ring, h, held, 2.0)
            want = BS.block_mac_unpack_plain(ring, h, held, 2.0)
            torch.cuda.synchronize()
            check(BS.MAC_UNPACK_LAUNCHES == u0 + 2, "block_mac_unpack counts its launch with rp_at")
            where = f"nparts={nparts} bins={bins} rp_at={held} rp={(held + 1) % nparts}"
            for g, k_, w_ in zip(got, want_k, want):
                check(torch.equal(g, k_),
                      f"block_mac_unpack reading rp from device memory vs the int launch at {where}")
                rel = float((g - w_).abs().max()) / max(float(w_.abs().max()), 1e-30)
                check(rel <= MAC_TOL, f"block_mac_unpack with rp_at vs twin at {where}: {rel:.3e}")
                worst_at = max(worst_at, rel)
    del ring, h, got, again, want, same, many, alone, want_k
    print(f"phase 31 MAC-and-unpack kernel vs twin: block_mac_unpack at (C,nparts,bins) "
          f"{mu_shapes}, rp {{0, 1, nparts-1}}, b0 {{1,2}}: worst rel err {worst:.3e} (tol "
          f"{MAC_TOL}); bit-equal on a second launch; bit-equal to unpack_inverse(spectral_mac "
          f"kernel) {mu_bit}; each channel of C={LONG_CH} bit-equal alone; max_abs_err "
          + ", ".join(f"{k} {e:.3e}" for k, e in mu_err.items())
          + f"; rp read from device memory at (nparts,bins) {at_shapes}, rp {{0, 1, nparts/3, "
          f"nparts-1}}, another int given: bit-equal to the int launch, worst rel err vs twin "
          f"{worst_at:.3e}", flush=True)

    # phase 32: this slice's main paths on the card against float64 scipy.
    # A, zero-latency reverb of the 2^20-tap hall IR: ClconvProcessor(parts=0,
    # block_size=64, pmax=4096) (a 64-tap direct head, doubling segments at
    # pts 64..2048 of one partition on block_step_fwd_fused, a terminal
    # engine of 255 partitions of 4096 on block_mac_unpack and fft_vmem) fed
    # 2 s in 64-sample blocks, ZeroLatencyConvolver.render of the same with
    # its whole tail, and a unit impulse (ir[:64] in block 0). B, the
    # per-block step at pts 4096 on the same IR: ClconvProcessor(parts=4096)
    # for 2 s, pconv_step_tv with the IR fed cyclically, Clpconv.push_ir_xfade
    # against the float64 blend, Convolver(16).step x 3 then stream(8)
    # against the split scan. C, the opcode cell's engine: a TV Clpconv at
    # pts 8192 fed the 2^22-tap operand cyclically (the LTI convolution by
    # it) for 2 nparts + 3 blocks, so both ring pointers wrap, by its step
    # graph, against the functional pconv_step_tv bit for bit and scipy. And
    # the STFT layer on phase 4's 20 s at nfft 1024 / hop 256 and 4096 /
    # 1024: stft against float64 numpy, istft back to the input, twice
    # (deterministic)
    from opencl_fft_tpu_torch.utils import profiling as PF

    ZL_B = 64
    n32 = xs.size
    proc_a = P.ClconvProcessor(ir4, parts=0, block_size=ZL_B, pmax=LONG_PTS, device="cuda",
                               on_message=quiet)
    zl_a = P.ZeroLatencyConvolver(ir4, block=ZL_B, pmax=LONG_PTS, device=dev)
    zl_imp = P.ZeroLatencyConvolver(ir4, block=ZL_B, pmax=LONG_PTS, device=dev)
    zl_plan = [(sg.pts, sg.nparts) for sg in zl_a.segments]
    check(zl_plan == [(64 << i, 1) for i in range(6)] + [(LONG_PTS, long_np - 1)],
          f"the zero-latency plan of the hall IR {zl_plan}")
    proc_b = P.ClconvProcessor(ir4, parts=LONG_PTS, device="cuda", on_message=quiet)
    eng_b = P.Clpconv(0, LONG_IR, LONG_PTS, quiet, device="cuda")
    eng_b.push_ir(ir4)
    h_new4 = fresh_ir(LONG_IR)
    conv_b, conv_ref = (P.Convolver(cfg4, LONG_CH, device=dev) for _ in range(2))
    conv_b.push_ir(irs4_d)
    conv_ref.push_ir(irs4_d)
    nb32 = -(-n32 // LONG_PTS)
    SW4, N_XF = 6, 20
    imp = np.zeros(3 * ZL_B, np.float32)
    imp[0] = 1.0
    out4 = np.empty(LONG_PTS, np.float32)
    STFT_SIZES = ((1024, 256), (4096, 1024))
    op_np = OPCODE_TAPS // OPCODE_PTS
    n_op = 2 * op_np + 3
    ir_op = (rng.standard_normal(OPCODE_TAPS)
             * np.exp(-np.arange(OPCODE_TAPS) / (2.0 * SR))).astype(np.float32)
    h_op = ir_op.reshape(op_np, OPCODE_PTS)
    x_op = (0.1 * rng.standard_normal((n_op, OPCODE_PTS))).astype(np.float32)
    eng_op = P.Clpconv(0, OPCODE_TAPS, OPCODE_PTS, quiet, device="cuda")
    y_op = np.empty_like(x_op)

    def path_counts(fn):
        """fn() with every count set to 0 just before it and read just after,
        inside one request, so the firings count: (its result, launches of
        block_mac_unpack, block_step_fwd_fused, fft_vmem and the LTI scan
        entry stream_steps_fused_batched, and the firings that step graphs
        replayed, whose #11 launches the wrapper does not count)."""
        zero_counts()
        PF.reset()
        with PF.request("phase32", True):
            out = fn()
        torch.cuda.synchronize()
        return out, (BS.MAC_UNPACK_LAUNCHES, BS.FWD_LAUNCHES, V.LAUNCHES, S.BATCHED_LAUNCHES,
                     PF.counters().get("step.replays", 0))

    def zl_counts(nblocks):
        """(block_mac_unpack, block_step_fwd_fused) launches of nblocks
        zero-latency blocks from t = 0: a segment of r = pts / ZL_B base
        blocks fires at t % r == r - 1, the terminal one on block_mac_unpack,
        each doubling one on block_step_fwd_fused."""
        fired = [nblocks // (sg.pts // ZL_B) for sg in zl_a.segments]
        return fired[-1], sum(fired[:-1])

    def zl_replayed_counts(nblocks):
        """zl_counts of ``process`` on the card's graph path."""
        fired = zl_replayed_fires(zl_a.segments, ZL_B, nblocks)
        return fired[-1], sum(fired[:-1])

    def tv_run():
        st_, y_ = st4, []
        for t in range(nb32):
            st_, o = P.pconv_step_tv(cfg4, st_, x_p4[t], h_cyc4[t])
            y_.append(o)
        return torch.stack(y_)

    def xfade_run():
        y_ = []
        for i in range(N_XF):
            if i == SW4:
                eng_b.push_ir_xfade(h_new4, FADE)
            eng_b.convolution(out4, x[i * LONG_PTS:(i + 1) * LONG_PTS])
            y_.append(out4.copy())
        return y_

    def opcode_run():
        for t in range(n_op):
            eng_op.convolution(y_op[t], x_op[t], h_op[t % op_np])

    def opcode_eager():
        st_, y_ = P.pconv_init(eng_op.cfg, dev), []
        xo, ho = (torch.from_numpy(a_).to(dev) for a_ in (x_op, h_op))
        for t in range(n_op):
            st_, o = P.pconv_step_tv(eng_op.cfg, st_, xo[t], ho[t % op_np])
            y_.append(o)
        return torch.stack(y_).cpu().numpy()

    # every path counted on its own
    t_a = time.perf_counter()
    y_a, cnt_a = path_counts(lambda: np.concatenate(
        [proc_a.process(xs[i:i + ZL_B]) for i in range(0, n32, ZL_B)]))
    t_a = time.perf_counter() - t_a
    t_r = time.perf_counter()
    y_ar, cnt_r = path_counts(lambda: zl_a.render(xs))
    t_r = time.perf_counter() - t_r
    y_imp, cnt_imp = path_counts(lambda: np.concatenate(
        [zl_imp.process(imp[i:i + ZL_B]) for i in range(0, imp.size, ZL_B)]))
    y_b, cnt_b = path_counts(lambda: np.concatenate(
        [proc_b.process(xs[i:i + 64]) for i in range(0, n32, 64)]))
    y_tv32, cnt_tv = path_counts(tv_run)
    y_xf, cnt_xf = path_counts(xfade_run)
    y_cs1, cnt_cs1 = path_counts(lambda: torch.stack([conv_b.step(b4[i]) for i in range(3)]))
    y_cs2, cnt_cs2 = path_counts(lambda: conv_b.stream(b4[3:11]))
    t_op = time.perf_counter()
    _, cnt_op = path_counts(opcode_run)
    t_op = time.perf_counter() - t_op
    y_op_eager, cnt_ope = path_counts(opcode_eager)
    y_cs = torch.cat([y_cs1, y_cs2])
    stft_out, cnt_st = {}, {}
    for nfft, hop in STFT_SIZES:
        spec, cnt_st[f"stft nfft {nfft}"] = path_counts(lambda: P.stft(x_d, nfft, hop))
        (y1, y2), cnt_st[f"istft x 2 nfft {nfft}"] = path_counts(
            lambda: (P.istft(spec, nfft, hop, length=x.size),
                     P.istft(spec, nfft, hop, length=x.size)))
        stft_out[nfft] = (spec, y1, y2)
    # what each path must launch and replay, in the order of path_counts:
    # an int is the exact count, POS any positive one, None any. A step
    # graph launches #11 through the wrapper at its eager first firing and
    # at its capture; the capture's firing and every later one are replays
    POS = "> 0"
    nb_r = -(-(n32 + LONG_IR - 1) // ZL_B)
    zl_term = n32 // ZL_B // (zl_a.segments[-1].pts // ZL_B)
    n_b = n32 // LONG_PTS
    want_counts = (
        # the terminal: the eager cycle's firing by _step, then its graph's
        ("ClconvProcessor(parts=0)", cnt_a,
         (*zl_replayed_counts(n32 // ZL_B), POS, 0, max(zl_term - 2, 0))),
        ("ZeroLatencyConvolver.render", cnt_r, (*zl_counts(nb_r), POS, 0, 0)),
        ("unit impulse", cnt_imp, (*zl_counts(imp.size // ZL_B), None, 0, 0)),
        (f"ClconvProcessor(parts={LONG_PTS})", cnt_b, (min(n_b, 2), 0, POS, 0, n_b - 1)),
        (f"pconv_step_tv pts {LONG_PTS}", cnt_tv, (nb32, 0, POS, 0, 0)),
        # the step graph's two before the fade, one to rebuild the incoming
        # tail, two a fade block (both paths, eager), none after it (replays)
        (f"push_ir_xfade pts {LONG_PTS}", cnt_xf,
         (min(SW4, 2) + 1 + 2 * FADE, 0, POS, 0, N_XF - FADE - 1)),
        (f"Convolver({LONG_CH}).step x 3", cnt_cs1, (3, 0, POS, 0, 0)),
        (f"Convolver({LONG_CH}).stream(8)", cnt_cs2, (0, 0, None, POS, 0)),
        (f"TV Clpconv pts {OPCODE_PTS} on its step graph", cnt_op, (2, 0, POS, 0, n_op - 1)),
        (f"pconv_step_tv pts {OPCODE_PTS}", cnt_ope, (n_op, 0, POS, 0, 0)),
        *((what, c_, (0, 0, POS, 0, 0)) for what, c_ in cnt_st.items()))
    for what, got_c, want_c in want_counts:
        check(all(w is None or (g > 0 if w == POS else g == w) for g, w in zip(got_c, want_c)),
              f"{what}: launches (block_mac_unpack, block_step_fwd_fused, fft_vmem, "
              f"stream_steps_fused_batched) and step-graph replays {got_c}, want {want_c}")
    # the checks, after the counts are read
    ref_a = sps.fftconvolve(xs.astype(np.float64), ir4.astype(np.float64))
    check(y_a.shape == (n32,) and y_ar.shape == ref_a.shape, "zero-latency output shapes")
    err_a = rel_err(y_a, ref_a[:n32])
    err_ar = rel_err(y_ar, ref_a)
    err_aa = float(np.max(np.abs(y_a - y_ar[:n32]))) / float(np.max(np.abs(y_ar[:n32])))
    err_imp = float(np.max(np.abs(y_imp - ir4[:imp.size]))) / float(np.max(np.abs(ir4)))
    lat_b = proc_b.latency
    check(lat_b == LONG_PTS and np.all(y_b[:lat_b] == 0), "ClconvProcessor(parts=4096) latency")
    err_b = rel_err(y_b[lat_b:], ref_a[:n32 - lat_b])
    err_tv32 = rel_err(y_tv32.reshape(-1).cpu().numpy(), ref4[:nb32 * LONG_PTS])
    n_xf = N_XF * LONG_PTS
    err_xf = rel_err(np.concatenate(y_xf), blend(x[:n_xf], ir4, h_new4, SW4 * LONG_PTS,
                                                 (SW4 + FADE) * LONG_PTS, n_xf))
    err_cs = worst_channel(y_cs, conv_ref.stream(b4[:11]))
    check(np.array_equal(y_op, y_op_eager),
          f"TV Clpconv pts {OPCODE_PTS} on its step graph bit-equal to pconv_step_tv over "
          f"{n_op} blocks")
    err_op = rel_err(y_op.reshape(-1), sps.fftconvolve(
        x_op.reshape(-1).astype(np.float64), ir_op.astype(np.float64))[:n_op * OPCODE_PTS])
    stft_err = {}
    for nfft, hop in STFT_SIZES:
        (sr_, si_), y1, y2 = stft_out[nfft]
        nfr = sr_.shape[0]
        xp = np.zeros((nfr - 1) * hop + nfft)
        xp[:x.size] = x
        fr64 = np.lib.stride_tricks.sliding_window_view(xp, nfft)[::hop][:nfr]
        want = np.fft.rfft(fr64 * hann_np(nfft).astype(np.float64), axis=-1)
        e_spec = max(rel_err(sr_.cpu().numpy(), want.real), rel_err(si_.cpu().numpy(), want.imag))
        y1n = y1.cpu().numpy()
        e_rt = rel_err(y1n[nfft:-nfft], x[nfft:-nfft])
        stft_err[nfft] = (e_spec, e_rt, bool(torch.equal(y1, y2)))
        check(stft_err[nfft][2], f"istft at nfft {nfft} is deterministic")
    for what, e, tol in (("ClconvProcessor(parts=0) vs scipy", err_a, ORACLE_TOL),
                         ("ZeroLatencyConvolver.render vs scipy", err_ar, ORACLE_TOL),
                         ("ClconvProcessor(parts=0) vs render", err_aa, TOL),
                         ("unit impulse: ir in block 0 and on", err_imp, TOL),
                         ("ClconvProcessor(parts=4096) vs scipy", err_b, ORACLE_TOL),
                         ("pconv_step_tv at pts 4096 vs scipy", err_tv32, ORACLE_TOL),
                         ("push_ir_xfade at pts 4096 vs the float64 blend", err_xf, ORACLE_TOL),
                         ("Convolver(16) 3 step() + stream(8) vs stream", err_cs, TOL),
                         (f"TV Clpconv pts {OPCODE_PTS} on its step graph vs scipy", err_op,
                          ORACLE_TOL),
                         *((f"stft nfft {n_} vs float64 numpy", e_[0], ORACLE_TOL)
                           for n_, e_ in stft_err.items()),
                         *((f"stft -> istft nfft {n_} vs the input", e_[1], ORACLE_TOL)
                           for n_, e_ in stft_err.items())):
        check(bool(np.isfinite(e)) and e <= tol, f"{what}: {e:.3e} > {tol}")
    print(f"phase 32 zero-latency and long-partition per-block main paths on {dev}: "
          f"ClconvProcessor(parts=0, block_size={ZL_B}, pmax={LONG_PTS}) on the {LONG_IR}-tap IR "
          f"(plan {zl_plan}) fed {n32 // ZL_B} blocks of {ZL_B} ({t_a:.3f} s): latency "
          f"{proc_a.latency}, vs float64 scipy {err_a:.3e}; ZeroLatencyConvolver.render "
          f"({y_ar.size} samples, {-(-y_ar.size // ZL_B)} blocks, {t_r:.3f} s) vs scipy "
          f"{err_ar:.3e}, vs the processor {err_aa:.3e}; unit impulse -> ir[:{imp.size}] "
          f"{err_imp:.3e}; ClconvProcessor(parts={LONG_PTS}) {n32 // 64} blocks of 64: latency "
          f"{lat_b}, vs scipy {err_b:.3e}; pconv_step_tv {nb32}x{LONG_PTS} (IR cyclic) vs scipy "
          f"{err_tv32:.3e}; Clpconv.push_ir_xfade ({FADE} blocks at block {SW4} of {N_XF}) vs "
          f"the float64 blend {err_xf:.3e}; Convolver({LONG_CH}) 3 step() + stream(8) vs the "
          f"split scan {err_cs:.3e}; TV Clpconv({OPCODE_TAPS}, {OPCODE_PTS}) {n_op} blocks "
          f"(operand cyclic) on its step graph ({t_op:.3f} s): bit-equal to pconv_step_tv, vs "
          f"scipy {err_op:.3e}; stft/istft of {x.size} samples: " + "; ".join(
              f"nfft {n_} spectrum {e_[0]:.3e}, round trip {e_[1]:.3e}, deterministic {e_[2]}"
              for n_, e_ in stft_err.items())
          + f" (tol {TOL} between paths, {ORACLE_TOL} vs float64); each path's own launches "
          f"(block_mac_unpack, block_step_fwd_fused, fft_vmem, stream_steps_fused_batched) "
          f"and step-graph replays: "
          + "; ".join(f"{what} {got_c}" for what, got_c, _ in want_counts), flush=True)
    del y_cs, y_cs1, y_cs2, stft_out, spec, y1, y2, y_tv32, conv_b, conv_ref
    del eng_op, y_op, y_op_eager, x_op, ir_op, h_op

    # phase 33: timing. The zero-latency processor's host wall per 64-sample
    # block (process() ends in the copy to the host) over 512 blocks, 8 of
    # them firing the terminal engine, against the 1.333 ms a block of
    # 48 kHz audio lasts, and the device's busy share of 64 blocks under
    # torch.profiler (and of 8 blocks of Clpconv.convolution at pts 4096);
    # Clpconv.convolution at pts 4096 (host wall and device time a block);
    # block_mac_unpack at its main-path shapes (event ms, and device us a
    # call read from HBM through a CUDA graph) against its twin and bound;
    # stft at 20 s beside torch.stft (cuFFT, the yardstick)
    budget_us = ZL_B / SR * 1e6
    xs33 = x[n32:n32 + 512 * ZL_B]
    t_first = proc_a._engine.state.t
    walls = []
    for i in range(512):
        t0 = time.perf_counter()
        proc_a.process(xs33[i * ZL_B:(i + 1) * ZL_B])
        walls.append((time.perf_counter() - t0) * 1e6)
    walls = np.asarray(walls)
    fires = np.asarray([(t_first + i) % (LONG_PTS // ZL_B) == LONG_PTS // ZL_B - 1
                        for i in range(512)])
    zl_blk = xs33[:64 * ZL_B].reshape(64, ZL_B)
    b4_blk = x[:LONG_PTS]
    profile_streams((("ClconvProcessor(parts=0) 64 blocks of 64",
                      lambda: [proc_a.process(bb) for bb in zl_blk]),
                     (f"Clpconv.convolution pts {LONG_PTS} x 8",
                      lambda: [eng_b.convolution(out4, b4_blk) for _ in range(8)])),
                    calls=2, phase=33)
    cl_ms = cuda_ms(lambda: eng_b.convolution(out4, b4_blk), reps=7, calls=10)
    cl_dev = device_us(lambda: eng_b.convolution(out4, b4_blk))
    cl_wall = host_wall_us(lambda: eng_b.convolution(out4, b4_blk))
    mu_rows, mu_kernels = {}, {}
    for nch, nparts in ((None, long_np - 1), (None, long_np), (LONG_CH, long_np)):
        ring, h, _, _ = ring_inputs(nch, nparts, LONG_PTS)
        c_ = nch or 1
        k_ms = cuda_ms(lambda: BS.block_mac_unpack(ring, h, 1, 2.0), reps=9, calls=10)
        # device time from HBM: scaled copies of (ring, h) whose windows and
        # h planes together read over twice the L2
        nsets = 1 + -(-2 * L2_BYTES // (4 * 4 * c_ * nparts * LONG_PTS))
        sets = [tuple(tuple(p * (1.0 + 1e-3 * i) for p in planes) for planes in (ring, h))
                for i in range(nsets)]
        k_dev = graph_us(lambda i: BS.block_mac_unpack(*sets[i], 1, 2.0), nsets)
        del sets
        # the __global__ kernels of a call under the profiler: one launch of one
        mu_kernels[(c_, nparts)] = check_one_launch(
            lambda: BS.block_mac_unpack(ring, h, 1, 2.0), lambda: BS.MAC_UNPACK_LAUNCHES,
            "mac_cluster_kernel", f"block_mac_unpack C={c_} nparts={nparts}")
        tw_ms = cuda_ms(lambda: BS.block_mac_unpack_plain(ring, h, 1, 2.0), warmup=1, reps=5,
                        calls=3)
        # least work: the MAC (8 operations a bin and partition) and the
        # unpack (~10 a bin); bytes: the window rows and h planes in, z out
        mu_bnd = bound(8.0 * c_ * nparts * LONG_PTS + 10.0 * c_ * LONG_PTS,
                       4 * 4 * c_ * nparts * LONG_PTS + 2 * 4 * c_ * LONG_PTS)
        mu_rows[(c_, nparts)] = (k_ms, tw_ms, mu_bnd, k_dev)
    del ring, h
    # the few-row fft_vmem calls of these paths (4096 bins of 1 and 16
    # channels: the inverse of the step at pts 4096 and of the terminal
    # segment), the pipelined single pass against the earlier one: events
    # over 10 calls back to back (host-bound) and device us by CUDA graph
    few_rows = {}
    for rows_ in (1, LONG_CH):
        xf = (f(rows_, LONG_PTS), f(rows_, LONG_PTS))
        few_rows[rows_] = tuple(
            (cuda_ms(lambda: fn_(xf, 1), reps=7, calls=10), graph_us(lambda i: fn_(xf, 1), 1))
            for fn_ in (V.fft_vmem, unpipelined))
    del xf
    hann1024 = torch.hann_window(1024, periodic=True, device=dev)
    st_ms = cuda_ms(lambda: P.stft(x_d, 1024, 256), reps=7)
    ist_spec = P.stft(x_d, 1024, 256)
    ist_ms = cuda_ms(lambda: P.istft(ist_spec, 1024, 256, length=x.size), reps=7)
    tst_ms = cuda_ms(lambda: torch.stft(x_d, 1024, 256, window=hann1024, center=False,
                                        return_complex=True), reps=7)
    print(f"phase 33 timing [{card}]: ClconvProcessor(parts=0, pmax={LONG_PTS}) host wall per "
          f"{ZL_B}-sample block over 512 blocks: mean {walls.mean():.1f} us, worst "
          f"{walls.max():.1f} us, median {np.median(walls):.1f} us; the {int(fires.sum())} "
          f"blocks firing the terminal engine mean {walls[fires].mean():.1f} / worst "
          f"{walls[fires].max():.1f} us, the others worst {walls[~fires].max():.1f} us; budget "
          f"{budget_us:.1f} us (mean {100 * walls.mean() / budget_us:.1f}%, worst "
          f"{100 * walls.max() / budget_us:.1f}%); Clpconv.convolution pts {LONG_PTS}: {cl_ms:.4f} "
          f"ms a block (events, 10 back to back), device {cl_dev:.1f} us, host wall "
          f"{cl_wall:.1f} us; block_mac_unpack (ms, CUDA events over 10 calls back to back; "
          f"device us a call from HBM, a CUDA graph of 20 calls over rotating inputs; twin; "
          f"bound): " + "; ".join(
              f"C={c_} nparts={np__} bins={LONG_PTS}: {k_ms:.4f} (device {kd:.1f} us, "
              f"{100 * bd[0] * 1e3 / kd:.1f}% of the bound); twin {tw:.4f}; bound {bd[0]:.4f} "
              f"({bd[1]}, {100 * bd[0] / k_ms:.1f}% reached by the event ms); launches a call "
              f"by kernel {mu_kernels[(c_, np__)]}"
              for (c_, np__), (k_ms, tw, bd, kd) in mu_rows.items())
          + f"; stft {x.size} samples nfft 1024 hop 256: {st_ms:.4f} ms, istft {ist_ms:.4f} ms, "
          f"torch.stft {tst_ms:.4f} ms; fft_vmem {LONG_PTS} points, pipelined / earlier single "
          f"pass (ms by events over 10 calls; device us by CUDA graph): " + "; ".join(
              f"{r_} rows {a[0]:.4f} ({a[1]:.2f} us) / {o[0]:.4f} ({o[1]:.2f} us)"
              for r_, (a, o) in few_rows.items()), flush=True)

    # phase 34: bf16 rings on the card at the JAX bench's shapes (2^17-tap
    # IRs at pts 512). The config takes no kernel (PconvConfig.
    # _kernel_eligible, the JAX rule): Convolver(64).stream of 470 blocks,
    # pconv_chunk K = 8 and pconv_stream over 1880 blocks of one channel,
    # each against float64 scipy (5e-3 of max|ref|, the JAX bound,
    # tests/test_pconv.py:221) and the same call on f32 rings; the state's
    # dtypes; no scan, step or sliding-MAC kernel launched on the bf16
    # routes, while the f32 routes launch theirs; times by CUDA events under
    # the JAX bench's names beside the f32 route's in the same call
    from opencl_fft_tpu_torch.ops import pconv as PC

    BF16_TOL = 5e-3

    def path_kernels():
        """Launches of every scan, step, MAC and FIR kernel (not the FFT's)."""
        return (S.BATCHED_LAUNCHES, S.BATCHED_TV_LAUNCHES, MC.LAUNCHES, BS.STEP_LAUNCHES,
                BS.FWD_LAUNCHES, BS.FWD_TV_LAUNCHES, BS.MAC_UNPACK_LAUNCHES, SM.CHUNKMAC_LAUNCHES,
                SM.MACFLOW_LAUNCHES, SM.MACFLOW_BATCHED_LAUNCHES, SM.MACFLOW_TV_LAUNCHES,
                SM.MACFLOW_TV_BATCHED_LAUNCHES, K.LAUNCHES)

    def stream_vs_steps(cfg_, st_, xb, stream=P.pconv_stream):
        """A plain route's stream (``pconv_chunk`` over chunks of up to
        nparts blocks) against sequential ``pconv_step`` calls on the card:
        (bit-equal, max|diff| / max|steps|)."""
        got_ = stream(cfg_, st_, xb)[1]
        seq_ = []
        for b_ in xb:
            st_, o_ = P.pconv_step(cfg_, st_, b_)
            seq_.append(o_)
        want_ = torch.stack(seq_)
        return bool(torch.equal(got_, want_)), rel_err(got_.cpu().numpy(), want_.cpu().numpy())

    def chunked(cfg_, st_, xb, k=CHUNK_K):
        outs_ = []
        for c0 in range(0, xb.shape[0], k):
            st_, o_ = PC.pconv_chunk(cfg_, st_, xb[c0:c0 + k])
            outs_.append(o_)
        return torch.cat(outs_)

    decay34 = np.exp(-np.arange(IR_LEN) / (0.5 * SR))
    irs34 = (0.05 * rng.standard_normal((SERVE_CH, IR_LEN)) * decay34).astype(np.float32)
    sb34 = (0.1 * rng.standard_normal((SERVE_BLOCKS, SERVE_CH, PTS))).astype(np.float32)
    x34 = (0.1 * rng.standard_normal((SCAN_BLOCKS, PTS))).astype(np.float32)
    irs34_d, sb34_d, x34_d = (torch.from_numpy(a).to(dev) for a in (irs34, sb34, x34))
    routes34 = {}
    for ring in ("bf16", "f32"):
        cfg34 = P.PconvConfig.for_ir_length(IR_LEN, PTS, ring_dtype=ring)
        zero_counts()
        conv34 = P.Convolver(cfg34, SERVE_CH, device=dev)
        conv34.push_ir(irs34_d)
        one34 = P.push_ir(cfg34, P.pconv_init(cfg34, dev), irs34_d[0])
        y_serve = conv34.stream(sb34_d)
        torch.cuda.synchronize()
        serve_scans = S.BATCHED_LAUNCHES
        y_chunk = chunked(cfg34, one34, x34_d)
        torch.cuda.synchronize()
        n0 = S.BATCHED_LAUNCHES
        y_stream = P.pconv_stream(cfg34, one34, x34_d)[1]
        torch.cuda.synchronize()
        # LTI scan launches of the serving call (#3) and of pconv_stream (#1)
        scans34 = (serve_scans, S.BATCHED_LAUNCHES - n0)
        counts34 = path_kernels()
        if ring == "bf16":
            # two chunks of nparts blocks of one channel; four chunks of
            # 4 blocks at 64 channels (the window budget's K there)
            steps34 = (stream_vs_steps(cfg34, one34, x34_d[:2 * cfg34.nparts]),
                       stream_vs_steps(cfg34, conv34.state, sb34_d[:16],
                                       P.pconv_stream_batched))
        dtypes34 = (conv34.state.spec_x_re.dtype, conv34.state.spec_h_im.dtype,
                    conv34.state.tail.dtype, one34.spec_h_re.dtype)
        serve_ms34 = cuda_ms(lambda: conv34.stream(sb34_d), warmup=1, reps=3)
        chunk_ms34 = cuda_ms(lambda: chunked(cfg34, one34, x34_d), warmup=1, reps=3)
        stream_ms34 = cuda_ms(lambda: P.pconv_stream(cfg34, one34, x34_d), warmup=1, reps=3)
        if ring == "bf16":
            profile_streams(((f"Convolver({SERVE_CH}).stream bf16, 16 blocks",
                              lambda: conv34.stream(sb34_d[:16])),
                             ("pconv_stream bf16, 64 blocks",
                              lambda: P.pconv_stream(cfg34, one34, x34_d[:64]))),
                            calls=2, phase=34)
        routes34[ring] = ((y_serve.cpu().numpy(), y_chunk.cpu().numpy(),
                           y_stream.cpu().numpy()), counts34, scans34, dtypes34,
                          (serve_ms34, chunk_ms34, stream_ms34))
        del conv34, one34, y_serve, y_chunk, y_stream
    (bf_serve, bf_chunk, bf_stream), bf_counts, _, bf_dtypes, bf_ms = routes34["bf16"]
    (f_serve, f_chunk, f_stream), f_counts, f_scans, f_dtypes, f_ms = routes34["f32"]
    check(bf_dtypes == (torch.bfloat16, torch.bfloat16, torch.float32, torch.bfloat16),
          f"bf16 state dtypes (rings, tail): {bf_dtypes}")
    check(f_dtypes == (torch.float32,) * 4, f"f32 state dtypes {f_dtypes}")
    check(not any(bf_counts), f"the bf16 routes launched no scan/step/MAC kernel: {bf_counts}")
    check(f_scans == (1, 1), f"the f32 routes launched #3 and #1 once each: {f_scans}")
    ref1 = sps.fftconvolve(x34.reshape(-1).astype(np.float64),
                           irs34[0].astype(np.float64))[:SCAN_BLOCKS * PTS]
    errs34 = {"serve": max(rel_err(bf_serve[:, c].reshape(-1), sps.fftconvolve(
        sb34[:, c].reshape(-1).astype(np.float64), irs34[c].astype(np.float64))[
            :SERVE_BLOCKS * PTS]) for c in range(SERVE_CH)),
              "chunk": rel_err(bf_chunk.reshape(-1), ref1),
              "stream": rel_err(bf_stream.reshape(-1), ref1)}
    errs34_f32 = {"serve": rel_err(bf_serve, f_serve), "chunk": rel_err(bf_chunk, f_chunk),
                  "stream": rel_err(bf_stream, f_stream)}
    for what, e in (*errs34.items(), *((f"{k} vs f32", v) for k, v in errs34_f32.items()),
                    *((f"stream vs steps {i}", v) for i, (_, v) in enumerate(steps34))):
        check(bool(np.isfinite(e)) and e <= BF16_TOL, f"bf16 {what}: {e:.3e} > {BF16_TOL}")
    chunk_audio_s = SCAN_BLOCKS * PTS / SR
    print(f"phase 34 bf16 rings [{card}]: Convolver({SERVE_CH}).stream {SERVE_BLOCKS}x{PTS}, "
          f"{IR_LEN} taps: serving_64ch_bf16_audio_seconds_per_second "
          f"{serve_audio_s / (bf_ms[0] / 1e3):.1f} ({bf_ms[0]:.4f} ms/scan; f32 rings "
          f"{serve_audio_s / (f_ms[0] / 1e3):.1f}, {f_ms[0]:.4f} ms: {bf_ms[0] / f_ms[0]:.1f}x "
          f"faster than bf16); pconv_chunk K={CHUNK_K} over {SCAN_BLOCKS} blocks: "
          f"pconv_chunk8_bf16_rt_factor {chunk_audio_s / (bf_ms[1] / 1e3):.1f} ({bf_ms[1]:.4f} "
          f"ms; f32 {chunk_audio_s / (f_ms[1] / 1e3):.1f}, {f_ms[1]:.4f} ms); pconv_stream "
          f"{SCAN_BLOCKS} blocks {chunk_audio_s / (bf_ms[2] / 1e3):.1f}x real time "
          f"({bf_ms[2]:.4f} ms; f32 {chunk_audio_s / (f_ms[2] / 1e3):.1f}x, {f_ms[2]:.4f} ms); "
          f"vs float64 scipy (worst channel) serve {errs34['serve']:.3e}, chunk "
          f"{errs34['chunk']:.3e}, stream {errs34['stream']:.3e}; vs the f32 rings "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs34_f32.items())
          + f" (tol {BF16_TOL}); pconv_stream vs sequential pconv_step on the card, "
          f"{2 * (IR_LEN // PTS)} blocks of 1 channel: bit-equal {steps34[0][0]}, "
          f"{steps34[0][1]:.3e}; pconv_stream_batched 16 blocks x {SERVE_CH}: bit-equal "
          f"{steps34[1][0]}, {steps34[1][1]:.3e}; state (rings, tail) {bf_dtypes[0]}, "
          f"{bf_dtypes[2]}; "
          f"scan/step/MAC kernel launches on the bf16 routes {sum(bf_counts)}, on the f32 "
          f"routes {sum(f_counts)} (#3 {f_scans[0]}, #1 {f_scans[1]}); CUDA events, median "
          f"of 3", flush=True)
    del routes34, bf_serve, f_serve

    # phase 35: float64 on the card: pconv_stream at 2^17 taps over 1880
    # blocks and dconv_stream at 512 taps, against float64 scipy/numpy at
    # 1e-12 of max|ref| (the JAX bound, tests/test_f64.py:79-110); they take
    # no kernel; times beside the f32 routes'. The float64 rounding scale
    # printed beside the errors is eps * log2(2 pts) * sqrt(nparts)
    F64_TOL = 1e-12
    cfg35 = P.PconvConfig.for_ir_length(IR_LEN, PTS, dtype="f64")
    dcfg35 = P.DconvConfig(irsize=DIRECT_TAPS, vsize=PTS, dtype="f64")
    x35_d = torch.from_numpy(x34.astype(np.float64)).to(dev)
    ir35 = irs34[0].astype(np.float64)
    h35 = ir_d512.astype(np.float64)
    zero_counts()
    st35 = P.push_ir(cfg35, P.pconv_init(cfg35, dev), torch.from_numpy(ir35).to(dev))
    dst35 = D.push_ir(dcfg35, D.dconv_init(dcfg35, dev), torch.from_numpy(h35).to(dev))
    y35 = P.pconv_stream(cfg35, st35, x35_d)[1]
    yd35 = D.dconv_stream(dcfg35, dst35, x35_d)[1]
    steps35 = stream_vs_steps(cfg35, st35, x35_d[:2 * cfg35.nparts])
    torch.cuda.synchronize()
    counts35 = path_kernels()
    check(not any(counts35), f"the float64 routes launched no scan/step/MAC/FIR kernel: "
          f"{counts35}")
    check(y35.dtype == torch.float64 and yd35.dtype == torch.float64, "float64 outputs")
    x35 = x34.reshape(-1).astype(np.float64)
    err35 = rel_err(y35.cpu().numpy().reshape(-1), ref1)
    errd35 = rel_err(yd35.cpu().numpy().reshape(-1), np.convolve(x35, h35)[:x35.size])
    scale35 = np.finfo(np.float64).eps * math.log2(2 * PTS) * math.sqrt(IR_LEN // PTS)
    for what, e in (("pconv_stream", err35), ("dconv_stream", errd35),
                    ("pconv_stream vs sequential pconv_step", steps35[1])):
        check(bool(np.isfinite(e)) and e <= F64_TOL,
              f"float64 {what} vs float64 numpy/scipy: {e:.3e} > {F64_TOL} (the float64 "
              f"rounding scale eps log2(2 pts) sqrt(nparts) is {scale35:.3e})")
    profile_streams((("pconv_stream float64, 64 blocks",
                      lambda: P.pconv_stream(cfg35, st35, x35_d[:64])),
                     ("dconv_stream float64, 64 blocks",
                      lambda: D.dconv_stream(dcfg35, dst35, x35_d[:64]))), calls=2, phase=35)
    p35_ms = cuda_ms(lambda: P.pconv_stream(cfg35, st35, x35_d), warmup=1, reps=3)
    d35_ms = cuda_ms(lambda: D.dconv_stream(dcfg35, dst35, x35_d), warmup=1, reps=3)
    st32 = P.push_ir(cfg, P.pconv_init(cfg, dev), irs34_d[0])
    p32_ms = cuda_ms(lambda: P.pconv_stream(cfg, st32, x34_d), reps=7)
    d32_ms = cuda_ms(lambda: D.dconv_stream(dcfg, dstate, x34_d), reps=7)
    print(f"phase 35 float64 [{card}]: pconv_stream {SCAN_BLOCKS}x{PTS}, {IR_LEN} taps: vs "
          f"float64 scipy {err35:.3e}; dconv_stream {DIRECT_TAPS} taps: vs float64 np.convolve "
          f"{errd35:.3e} (tol {F64_TOL}; float64 rounding scale {scale35:.3e}); pconv_stream "
          f"vs sequential pconv_step, {2 * cfg35.nparts} blocks: bit-equal {steps35[0]}, "
          f"{steps35[1]:.3e}; "
          f"{chunk_audio_s / (p35_ms / 1e3):.1f}x real time ({p35_ms:.4f} ms/scan; f32 "
          f"{chunk_audio_s / (p32_ms / 1e3):.1f}x, {p32_ms:.4f} ms) and "
          f"{chunk_audio_s / (d35_ms / 1e3):.1f}x ({d35_ms:.4f} ms; f32 "
          f"{chunk_audio_s / (d32_ms / 1e3):.1f}x, {d32_ms:.4f} ms); scan/step/MAC/FIR kernel "
          f"launches on the float64 routes {sum(counts35)}; CUDA events, median of 3", flush=True)
    del st35, dst35, y35, yd35, x35_d, st32

    # phase 36: scale-out on the card. One NCCL rank on cuda:0 (make_mesh()'s
    # default), the file store in a temporary directory: the sharded LTI
    # step with a crossfade of 16 of 64 channels at block 260 (8 fade
    # blocks) and the sharded TV step, 64 channels, 2^17 taps, pts 512, for
    # 2 nparts + 3 blocks, against the unsharded Convolver.step (and its
    # set_ir fade) and TVConvolver.step at 1e-4 of the output scale, one
    # all_reduce a block; sharded_fft at 2^13 x 512 rows (#18) and 2^18 x 16
    # (#19) and dist_fft_split at 2^20 (two 1024-point passes of #18)
    # against float64 numpy; the per-block times of the sharded step beside
    # the unsharded step's. Then dryrun_multichip(4) with its defaults: with
    # fewer cards than ranks, four gloo ranks share the card (gloo takes CUDA
    # tensors for all_reduce, all_to_all_single and all_gather) at (dp 2, tp 2).
    import importlib
    import tempfile

    import torch.distributed as dist

    import opencl_fft_tpu_torch.parallel as PL
    SHm = importlib.import_module("opencl_fft_tpu_torch.parallel.sharded")
    DFm = importlib.import_module("opencl_fft_tpu_torch.parallel.dist_fft")
    n36, sw36, fade36 = 2 * cfg.nparts + 3, 260, 8
    bx36 = f(n36, SERVE_CH, PTS, s=0.1)
    bh36 = f(n36, SERVE_CH, PTS, s=0.1)
    swap36 = list(range(0, SERVE_CH, 4))
    irs36_new = irs34_d.flip(0).contiguous()
    mask36 = torch.zeros(SERVE_CH, dtype=torch.bool, device=dev)
    mask36[swap36] = True
    with tempfile.TemporaryDirectory() as store:
        dist.init_process_group("nccl", init_method="file://" + store + "/store", rank=0,
                                world_size=1)
        try:
            mesh = PL.make_mesh()
            check((mesh.backend, mesh.device, mesh.shape) == ("nccl", dev, {"dp": 1, "tp": 1}),
                  f"make_mesh() default: {mesh}")
            zero_counts()
            ar0, are0, a2a0 = SHm.ALL_REDUCES, SHm.ALL_REDUCE_ELEMENTS, DFm.ALL_TO_ALLS
            step36 = PL.make_sharded_pconv_step(cfg, mesh, tv=False)
            step36_tv = PL.make_sharded_pconv_step(cfg, mesh, tv=True)
            begin36, step36_xf = PL.make_sharded_pconv_xfade(cfg, mesh)
            st36 = PL.sharded_push_ir(cfg, mesh, PL.shard_state(
                PL.sharded_pconv_init(cfg, SERVE_CH), mesh), irs34_d)
            conv36 = P.Convolver(cfg, SERVE_CH, device=dev)
            conv36.push_ir(irs34_d)
            xf36, got36, want36 = None, [], []
            for i in range(n36):
                if i == sw36:
                    xf36 = begin36(st36, irs36_new, mask36)
                    conv36.set_ir(irs36_new[swap36], channels=swap36, fade_blocks=fade36)
                if xf36 is not None:
                    xf36, o_ = step36_xf(xf36, bx36[i], PC._xfade_ramp(cfg, i - sw36, fade36,
                                                                        dev))
                    if i - sw36 == fade36 - 1:
                        st36, xf36 = {k_: xf36[k_] for k_ in st36}, None
                else:
                    st36, o_ = step36(st36, bx36[i])
                got36.append(o_)
                want36.append(conv36.step(bx36[i]))
            sttv = PL.shard_state(PL.sharded_pconv_init(cfg, SERVE_CH), mesh)
            tvc36 = P.TVConvolver(cfg, SERVE_CH, device=dev)
            got36_tv, want36_tv = [], []
            for i in range(n36):
                sttv, o_ = step36_tv(sttv, bx36[i], bh36[i])
                got36_tv.append(o_)
                want36_tv.append(tvc36.step(bx36[i], bh36[i]))
            xa = (f(512, 1 << 13), f(512, 1 << 13))
            xb = (f(16, 1 << 18), f(16, 1 << 18))
            xc = (f(1 << 20), f(1 << 20))
            v_counts = [(V.LAUNCHES, V.FRONT2_LAUNCHES)]
            ya = PL.sharded_fft(xa, mesh)
            v_counts.append((V.LAUNCHES, V.FRONT2_LAUNCHES))
            yb = PL.sharded_fft(xb, mesh)
            v_counts.append((V.LAUNCHES, V.FRONT2_LAUNCHES))
            yc = PL.dist_fft_split(xc, mesh)
            torch.cuda.synchronize()
            v_counts.append((V.LAUNCHES, V.FRONT2_LAUNCHES))
            all_reduces36 = (SHm.ALL_REDUCES - ar0, SHm.ALL_REDUCE_ELEMENTS - are0)
            a2a36 = DFm.ALL_TO_ALLS - a2a0
            path36 = {"fft_vmem": V.LAUNCHES, "fft_vmem_front2": V.FRONT2_LAUNCHES,
                      "block_step_fwd_fused (the unsharded reference)": BS.FWD_LAUNCHES,
                      "block_step_fwd_fused_tv (the unsharded reference)": BS.FWD_TV_LAUNCHES}
            # the checks, after the counts are read
            err36 = rel_err(torch.stack(got36).cpu().numpy(), torch.stack(want36).cpu().numpy())
            err36_tv = rel_err(torch.stack(got36_tv).cpu().numpy(),
                               torch.stack(want36_tv).cpu().numpy())
            fft_err36 = []
            for (re_, im_), (gr, gi) in ((xa, ya), (xb, yb), (xc, yc)):
                ref_ = np.fft.fft(re_.cpu().double().numpy() + 1j * im_.cpu().double().numpy())
                fft_err36.append(rel_err(np.stack([gr.cpu().numpy(), gi.cpu().numpy()]),
                                         np.stack([ref_.real, ref_.imag])))
            for what, e, tol in (("sharded LTI step + crossfade vs Convolver.step", err36, 1e-4),
                                 ("sharded TV step vs TVConvolver.step", err36_tv, 1e-4),
                                 ("sharded_fft 2^13 x 512 vs float64 numpy", fft_err36[0],
                                  ORACLE_TOL),
                                 ("sharded_fft 2^18 x 16 vs float64 numpy", fft_err36[1],
                                  ORACLE_TOL),
                                 ("dist_fft_split 2^20 vs float64 numpy", fft_err36[2], 3e-5)):
                check(bool(np.isfinite(e)) and e <= tol, f"{what}: {e:.3e} > {tol}")
            check(all_reduces36[0] == 2 * n36 + 1,
                  f"one all_reduce a sharded block (+1 for the fade's begin): {all_reduces36}")
            check(v_counts[1][0] > v_counts[0][0] and v_counts[2][1] > v_counts[1][1]
                  and v_counts[3][0] >= v_counts[2][0] + 2,
                  f"#18 / #19 launched on the scale-out paths: {v_counts}")
            check(a2a36 == 3, f"dist_fft_split: three all_to_all transposes, got {a2a36}")
            b36, t36 = bx36[0], bh36[0]
            un_st = conv36.state
            times36 = {
                "sharded LTI": (cuda_ms(lambda: step36(st36, b36), reps=7, calls=10),
                                device_us(lambda: step36(st36, b36)),
                                host_wall_us(lambda: step36(st36, b36))),
                "unsharded pconv_step": (
                    cuda_ms(lambda: P.pconv_step(cfg, un_st, b36), reps=7, calls=10),
                    device_us(lambda: P.pconv_step(cfg, un_st, b36)),
                    host_wall_us(lambda: P.pconv_step(cfg, un_st, b36))),
                "sharded TV": (cuda_ms(lambda: step36_tv(sttv, b36, t36), reps=7, calls=10),
                               device_us(lambda: step36_tv(sttv, b36, t36)),
                               host_wall_us(lambda: step36_tv(sttv, b36, t36))),
                "unsharded pconv_step_tv": (
                    cuda_ms(lambda: P.pconv_step_tv(cfg, tvc36.state, b36, t36), reps=7,
                            calls=10),
                    device_us(lambda: P.pconv_step_tv(cfg, tvc36.state, b36, t36)),
                    host_wall_us(lambda: P.pconv_step_tv(cfg, tvc36.state, b36, t36)))}
            fft_ms36 = (cuda_ms(lambda: PL.sharded_fft(xa, mesh), reps=7),
                        cuda_ms(lambda: PL.sharded_fft(xb, mesh), reps=7),
                        cuda_ms(lambda: PL.dist_fft_split(xc, mesh), reps=7))
        finally:
            dist.destroy_process_group()
    del got36, want36, got36_tv, want36_tv, conv36, tvc36, st36, sttv, xa, xb, xc, ya, yb, yc
    t0 = time.perf_counter()
    dry36 = PL.dryrun_multichip(4, timeout=600)       # its defaults (F2)
    dry36_s = time.perf_counter() - t0
    print(f"phase 36 scale-out on {dev} [{card}]: one NCCL rank (make_mesh() default, mesh "
          f"{mesh.shape}): the sharded LTI step with a crossfade of {len(swap36)} of {SERVE_CH} "
          f"channels (fade {fade36} blocks at block {sw36}) vs Convolver.step / set_ir "
          f"{err36:.3e}, the sharded TV step vs TVConvolver.step {err36_tv:.3e} ({n36} blocks, "
          f"{SERVE_CH} channels, {IR_LEN} taps, pts {PTS}; tol 1e-4 of the output scale); "
          f"all_reduces {all_reduces36[0]} of {all_reduces36[1]} elements; sharded_fft 2^13 x 512 "
          f"{fft_err36[0]:.3e} ({fft_ms36[0]:.4f} ms), 2^18 x 16 {fft_err36[1]:.3e} "
          f"({fft_ms36[1]:.4f} ms), dist_fft_split 2^20 {fft_err36[2]:.3e} ({fft_ms36[2]:.4f} "
          f"ms; {a2a36} all_to_alls) vs float64 numpy; launches (fft_vmem, fft_vmem_front2) "
          f"before / after each: {v_counts}; the phase's own launches {path36}; per block "
          f"(events over 10 back to back ms; device us by the profiler; host wall us): "
          + "; ".join(f"{k} {v[0]:.4f} ms, {v[1]:.1f} us, {v[2]:.1f} us"
                      for k, v in times36.items())
          + f" | dryrun_multichip(4) with its defaults on {torch.cuda.device_count()} card(s): "
          f"four gloo ranks share the card (gloo takes CUDA tensors for all_reduce, "
          f"all_to_all_single and all_gather; NCCL takes one rank a card): mesh "
          f"{dry36['shape']}: "
          f"sharded TV step vs the unsharded engine {dry36['err']:.3e} of scale "
          f"{dry36['scale']:.3e} (tol 1e-4 of it), dist_fft over tp {dry36['dist_fft_err']:.3e} "
          f"(tol 3e-5); {dry36_s:.1f} s with the spawn", flush=True)

    # phase 37: precision (ROADMAP F1, item 18). With TF32 switched on the
    # way many applications do (allow_tf32 and "high"), convolve on phase 4's
    # 20 s and 2^17 taps at pts 512 and convolve_direct of 512 taps against
    # float64 scipy: every float32 product of the port goes through
    # exact_matmul (a float64 product, outside every float32 setting). The
    # same convolve with the products sent straight to cuBLAS (the parent's
    # route: the module global swapped for a float32 torch.matmul for one
    # call) shows the fault. Then TF32 off again, and set_fast_math through every mode
    # (the port's FFT is true float32 in all of them: the same bits).
    import opencl_fft_tpu_torch.ops.dconv as Dm
    import opencl_fft_tpu_torch.ops.pconv as PCm
    import opencl_fft_tpu_torch.utils.numerics as NUM
    ref37 = sps.fftconvolve(x.astype(np.float64), ir.astype(np.float64))
    ref37d = sps.fftconvolve(x.astype(np.float64), ir_d512.astype(np.float64))
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        tf32_state = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
        err37 = rel_err(P.convolve(x_d, ir_d, PTS).cpu().numpy(), ref37)
        err37d = rel_err(P.convolve_direct(x_d, torch.from_numpy(ir_d512).to(dev),
                                           vsize=PTS).cpu().numpy(), ref37d)
        after37 = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
        def as_given(a_, b_):       # the float32 operands straight to cuBLAS
            return torch.matmul(a_, b_.to(a_.dtype))

        PCm.exact_matmul = Dm.exact_matmul = as_given
        try:
            err37_raw = rel_err(P.convolve(x_d, ir_d, PTS).cpu().numpy(), ref37)
        finally:
            PCm.exact_matmul = Dm.exact_matmul = NUM.exact_matmul
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    check(after37 == tf32_state == (True, "high"),
          f"the caller's TF32 settings unchanged by the port: {tf32_state} -> {after37}")
    for what, e in (("convolve", err37), ("convolve_direct", err37d)):
        check(bool(np.isfinite(e)) and e <= ORACLE_TOL,
              f"{what} with TF32 on vs float64 scipy {e:.3e} > {ORACLE_TOL}")
    z37 = (f(4, 1 << 14), f(4, 1 << 14))
    base37 = P.fft_split(z37, -1)
    modes37 = ("turbo", "on", "off", "auto", True, False, None)
    for m_ in modes37:
        P.set_fast_math(m_)
        with P.exact_precision():
            y37 = P.fft_split(z37, -1)
        y37b = P.fft_split(z37, -1)
        check(all(torch.equal(a_, b_) for a_, b_ in zip(base37 + base37, y37 + y37b)),
              f"set_fast_math({m_!r}) changes no bit of fft_split 2^14")
    P.set_fast_math(None)
    del base37, y37, y37b, z37
    print(f"phase 37 precision [{card}]: with allow_tf32=True and "
          f"set_float32_matmul_precision('high'): convolve({x.size} samples, {IR_LEN} taps, "
          f"pts {PTS}) vs float64 scipy {err37:.3e}, convolve_direct({DIRECT_TAPS} taps) "
          f"{err37d:.3e} (tol {ORACLE_TOL}); the same convolve with its products on cuBLAS as "
          f"given (the parent's route) {err37_raw:.3e}; the caller's settings after the calls "
          f"{after37}; TF32 off again; set_fast_math through {modes37}: fft_split 2^14 x 4 "
          f"bit-equal in every mode", flush=True)

    # phase 38: the host layer at full width. The native runtime (g++), the
    # real-time pipeline at the bench headline (2^17 taps, pts 512) paced by
    # the virtual sound card at 48 kHz through the PortAudio-convention
    # callback for 5 s (output = the port's pconv_step chain sample for
    # sample after the priming, and scipy; no underrun, overrun or late
    # callback; #8 launched once a block), a TV pipeline (#9), the
    # zero-latency processor behind ProcessorPipeline at 64-sample blocks on
    # cell 12's 2^20-tap IR at prime 1 and 4 (underruns and the worker's time
    # a block measured, not gated; its output = the processor's own run), the
    # Csound host on a stub engine with a cltvconv insert, and a checkpoint
    # taken mid-stream on the card.
    import tempfile as tempfile38

    from opencl_fft_tpu_torch import runtime as RT
    from opencl_fft_tpu_torch.runtime import csound_host as CH
    from opencl_fft_tpu_torch.runtime.hosts import PipelineCallback, VirtualHost
    from opencl_fft_tpu_torch.runtime.pipeline import ProcessorPipeline, RealtimePipeline
    from opencl_fft_tpu_torch.stream import make_accumulator
    from opencl_fft_tpu_torch.utils import checkpoint as CK
    t0 = time.perf_counter()
    check(RT.native_available(), "the native runtime builds with g++")
    rt_s = time.perf_counter() - t0
    acc38 = make_accumulator(PTS, 2)
    check(isinstance(acc38, RT.NativeBlockAccumulator),
          f"make_accumulator returns the native class, got {type(acc38).__name__}")
    host_s = 5.0
    n38 = int(np.ceil(host_s * SR / PTS))
    x38 = x[: n38 * PTS]
    pos38 = [0]

    def source38(n):
        s_ = np.zeros(n, np.float32)
        take = min(n, x38.size - pos38[0])
        if take > 0:
            s_[:take] = x38[pos38[0]:pos38[0] + take]
            pos38[0] += take
        return s_

    def time_blocks(pipe):
        """The worker's microseconds a processed block, recorded around the
        pipeline's unit of work (ring read, copy to the card, engine, copy
        back, ring write)."""
        us, work = [], pipe._work_once

        def timed():
            t0_ = time.perf_counter()
            done = work()
            if done:
                us.append((time.perf_counter() - t0_) * 1e6)
            return done
        pipe._work_once = timed
        return us

    prime38 = 2
    zero_counts()
    pipe38 = RealtimePipeline(cfg, ir=ir, prime_blocks=prime38)
    us38 = time_blocks(pipe38)
    # the host process as a real-time one is set up: no cyclic garbage
    # collection during the paced run (collected just before) and a 0.5 ms
    # thread switch interval, so the pacing thread waits at most that long
    # for the interpreter lock (the default 5 ms, twice over with the worker
    # and the main thread, comes close to the 10.67 ms period)
    gc.collect()
    gc.disable()
    switch38 = sys.getswitchinterval()
    sys.setswitchinterval(5e-4)
    with pipe38:
        pipe38.push(np.zeros(PTS, np.float32))
        pipe38.wait_for_blocks(1, timeout=120)            # off the clock
        cb38 = PipelineCallback(pipe38)
        host38 = VirtualHost(cb38, sr=int(SR), frames=PTS, source=source38)
        t0 = time.perf_counter()
        with host38:
            while len(host38.captured) < prime38 + 1 + n38:
                time.sleep(0.005)
        host_wall38 = time.perf_counter() - t0
    sys.setswitchinterval(switch38)
    gc.enable()
    torch.cuda.synchronize()
    fwd38, blocks38 = BS.FWD_LAUNCHES, pipe38.blocks_processed
    under38, over38, late38 = (pipe38.underrun_samples, pipe38.overrun_samples,
                               host38.late_callbacks)
    out38 = host38.output()
    st38 = P.push_ir(cfg, P.pconv_init(cfg, dev), ir_d)
    chain38 = []
    for blk in np.concatenate([np.zeros(PTS, np.float32), x38]).reshape(-1, PTS):
        st38, o_ = P.pconv_step(cfg, st38, torch.from_numpy(blk).to(dev))
        chain38.append(o_)
    chain38 = torch.cat(chain38).cpu().numpy()
    n_cmp = min(out38.size - prime38 * PTS, chain38.size)
    check(n_cmp >= (n38 + 1) * PTS, f"the host captured the whole 5 s: {n_cmp}")
    check(np.array_equal(out38[:prime38 * PTS], np.zeros(prime38 * PTS, np.float32))
          and np.array_equal(out38[prime38 * PTS:prime38 * PTS + n_cmp], chain38[:n_cmp]),
          "the paced pipeline's output is the pconv_step chain, sample for sample")
    err38 = rel_err(chain38[PTS:], sps.fftconvolve(x38.astype(np.float64),
                                                   ir.astype(np.float64))[:x38.size])
    check(err38 <= ORACLE_TOL, f"the pipeline's stream vs float64 scipy {err38:.3e}")
    check((under38, over38, late38) == (0, 0, 0),
          f"no underrun, overrun or late callback in 5 s: {(under38, over38, late38)}")
    check(fwd38 == blocks38, f"block_step_fwd_fused once a block: {fwd38} vs {blocks38}")
    w38 = np.asarray(us38[1:])                            # the paced blocks
    # TV: pushed, waited for, pulled (no pacing), 64 blocks
    n38t = 64
    bx38, bh38 = x[:n38t * PTS].reshape(n38t, PTS), x[-n38t * PTS:].reshape(n38t, PTS)
    zero_counts()
    with RealtimePipeline(cfg, tv=True, prime_blocks=1) as pt38:
        pt38.push(bx38.reshape(-1), bh38.reshape(-1))
        pt38.wait_for_blocks(n38t, timeout=120)
        got38t = pt38.pull((1 + n38t) * PTS)
    torch.cuda.synchronize()
    fwdtv38 = BS.FWD_TV_LAUNCHES
    st38t, want38t = P.pconv_init(cfg, dev), []
    for a_, b_ in zip(bx38, bh38):
        st38t, o_ = P.pconv_step_tv(cfg, st38t, torch.from_numpy(a_).to(dev),
                                    torch.from_numpy(b_).to(dev))
        want38t.append(o_)
    want38t = torch.cat(want38t).cpu().numpy()
    check(fwdtv38 == n38t and np.array_equal(got38t[PTS:], want38t),
          f"the TV pipeline: block_step_fwd_fused_tv {fwdtv38} of {n38t} blocks, output = "
          f"the pconv_step_tv chain")

    zl_s = 2.0
    nzl = int(zl_s * SR) // ZL_B
    xzl = x[: nzl * ZL_B]
    own38 = P.ClconvProcessor(ir4, parts=0, block_size=ZL_B, pmax=LONG_PTS, device="cuda",
                              on_message=quiet)
    want38z = np.concatenate([own38.process(b_) for b_ in
                              np.concatenate([np.zeros(ZL_B, np.float32), xzl]).reshape(-1, ZL_B)])
    zl_rows = []
    ZL_RING = 64        # ProcessorPipeline's default ring capacity, in blocks
    for prime_ in (1, 4):
        proc38 = P.ClconvProcessor(ir4, parts=0, block_size=ZL_B, pmax=LONG_PTS, device="cuda",
                                   on_message=quiet)
        pos38[0] = 0
        x38 = xzl
        gc.collect()
        gc.disable()
        sys.setswitchinterval(5e-4)
        pz = ProcessorPipeline(proc38, ZL_B, prime_blocks=prime_, capacity_blocks=ZL_RING)
        zl_us = time_blocks(pz)
        with pz:
            pz.push(np.zeros(ZL_B, np.float32))
            pz.wait_for_blocks(1, timeout=120)
            hz = VirtualHost(PipelineCallback(pz), sr=int(SR), frames=ZL_B, source=source38)
            with hz:
                while len(hz.captured) < prime_ + 1 + nzl:
                    time.sleep(0.005)
        sys.setswitchinterval(switch38)
        gc.enable()
        us_ = np.asarray(zl_us[1:])
        outz = hz.output()
        same_ = (pz.underrun_samples == 0 and np.array_equal(
            outz[prime_ * ZL_B:prime_ * ZL_B + want38z.size], want38z[:outz.size - prime_ * ZL_B]))
        zl_rows.append((prime_, pz.underrun_samples, pz.overrun_samples, hz.late_callbacks,
                        float(us_.mean()), float(np.median(us_)), float(us_.max()),
                        float((us_ > ZL_B / SR * 1e6).mean()), same_))
    # the output check without pacing: each block pushed while fewer than
    # 32 are in flight (the rings hold 64), the output pulled as it comes
    def drive(pipe, blocks_, timeout=300.0):
        out_, i_, deadline = [], 0, time.monotonic() + timeout
        while pipe.blocks_processed < len(blocks_) or pipe.pull_available():
            while i_ < len(blocks_) and i_ - pipe.blocks_processed < 32:
                pipe.push(blocks_[i_])
                i_ += 1
            k_ = pipe.pull_available()
            if k_:
                out_.append(pipe.pull(k_))
            else:
                time.sleep(1e-4)
            check(time.monotonic() < deadline, f"the pipeline drained in {timeout} s")
        check(pipe.underrun_samples == 0 and pipe.overrun_samples == 0,
              "an unpaced pipeline neither underruns nor overruns")
        return np.concatenate(out_)

    proc38u = P.ClconvProcessor(ir4, parts=0, block_size=ZL_B, pmax=LONG_PTS, device="cuda",
                                on_message=quiet)
    with ProcessorPipeline(proc38u, ZL_B, prime_blocks=1) as pu:
        gotz = drive(pu, np.concatenate([np.zeros(ZL_B, np.float32), xzl]).reshape(-1, ZL_B))
    check(np.array_equal(gotz[ZL_B:], want38z),
          "ProcessorPipeline(ClconvProcessor(parts=0)) = the processor's own run")
    # the Csound host on a stub engine: a cltvconv insert (parts 2048, the
    # reference demo's) at ksmps 64, the second operand looping
    cparts, cks = 2048, 64
    icsize, ccycles = cparts * 8, cparts * 10 // cks
    beats38 = x[:icsize] * np.float32(2.0)
    fox38 = x[icsize:icsize + ccycles * cks]
    looped38 = beats38[np.arange(ccycles * cks) % icsize]

    class StubCsound:
        def __init__(self):
            self.cycle, self.bus, self.heard = -1, {}, []

        def setOption(self, opt):
            pass

        def compileCsdText(self, text):
            return 0

        def start(self):
            return 0

        def ksmps(self):
            return cks

        def performKsmps(self):
            self.cycle += 1
            if self.cycle >= ccycles:
                return 1
            self.heard.append(np.array(self.bus.get("cltvconv_out", np.zeros(cks)), np.float32))
            sl = slice(self.cycle * cks, (self.cycle + 1) * cks)
            self.bus["cltvconv_in1"], self.bus["cltvconv_in2"] = fox38[sl], looped38[sl]
            return 0

        def audioChannel(self, name):
            return self.bus[name]

        def setAudioChannel(self, name, data):
            self.bus[name] = np.array(data, np.float32)

        def cleanup(self):
            pass

    class StubModule:
        made = []

        @staticmethod
        def Csound():
            StubModule.made.append(StubCsound())
            return StubModule.made[-1]

    saved_cs, CH.ctcsound = CH.ctcsound, StubModule
    try:
        zero_counts()
        cycles38 = CH.CsoundHost("<CsoundSynthesizer/>", [CH.cltvconv_insert(
            parts=cparts, size=icsize, block_size=cks, device="cuda")]).run()
        fwdcs38 = BS.FWD_TV_LAUNCHES
    finally:
        CH.ctcsound = saved_cs
    heard = np.concatenate(StubModule.made[0].heard)
    full38 = sps.fftconvolve(fox38.astype(np.float64), beats38.astype(np.float64))
    want38c = np.concatenate([np.zeros(cks + cparts), full38])[:heard.size]
    errcs38 = float(np.max(np.abs(heard - want38c)) / np.max(np.abs(full38)))
    check(cycles38 == ccycles and fwdcs38 == ccycles * cks // cparts and errcs38 <= ORACLE_TOL,
          f"CsoundHost.run: {cycles38} cycles, #9 launches {fwdcs38}, vs scipy {errcs38:.3e}")
    # a checkpoint taken mid-stream on the card continues bit for bit
    st_ck = P.push_ir(cfg, P.pconv_init(cfg, dev), ir_d)
    blk38 = torch.from_numpy(x[:10 * PTS].reshape(10, PTS)).to(dev)
    for i in range(5):
        st_ck, _ = P.pconv_step(cfg, st_ck, blk38[i])
    with tempfile38.TemporaryDirectory() as td:
        CK.save_state(td + "/ck.npz", st_ck, meta={"blocks": 5})
        back = CK.load_state(td + "/ck.npz", P.pconv_init(cfg, dev))
    same_ck = True
    for i in range(5, 10):
        st_ck, o1 = P.pconv_step(cfg, st_ck, blk38[i])
        back, o2 = P.pconv_step(cfg, back, blk38[i])
        same_ck = same_ck and torch.equal(o1, o2)
    check(same_ck and back.tail.device == dev, "a checkpoint on the card continues bit-equal")
    del chain38, out38, want38z, gotz, heard, full38, want38c, blk38, st_ck, back
    print(f"phase 38 host layer [{card}]: native runtime {RT.library_path().name} ready in "
          f"{rt_s:.3f} s, make_accumulator -> {type(acc38).__name__}; RealtimePipeline("
          f"{IR_LEN} taps, pts {PTS}, prime {prime38}) paced by VirtualHost at {int(SR)} Hz "
          f"through PipelineCallback for {host_s} s ({n38} blocks + 1 warm-up, host wall "
          f"{host_wall38:.3f} s; paced runs with gc off and a 0.5 ms switch interval): "
          f"output = the pconv_step chain sample for sample, vs float64 "
          f"scipy {err38:.3e}; underruns {under38}, overruns {over38}, late callbacks {late38}; "
          f"the worker's time a block mean {w38.mean():.1f} us, median {np.median(w38):.1f}, "
          f"worst {w38.max():.1f} against the {PTS / SR * 1e6:.1f} us period (busy "
          f"{w38.sum() / 1e6 / host_wall38:.2%} of the paced run's wall); "
          f"block_step_fwd_fused launches {fwd38} for {blocks38} blocks; TV pipeline {n38t} "
          f"blocks = the pconv_step_tv chain, block_step_fwd_fused_tv {fwdtv38}; "
          f"ProcessorPipeline(ClconvProcessor(parts=0, pmax={LONG_PTS}), {ZL_B}) on the "
          f"{LONG_IR}-tap IR for {zl_s} s ({nzl} blocks, period {ZL_B / SR * 1e6:.1f} us): "
          f"input ring {ZL_RING} blocks = {ZL_RING * ZL_B} samples ({ZL_RING * ZL_B / SR * 1e3:.1f}"
          f" ms; past it input is dropped and counted as overruns), output ring {ZL_RING} "
          f"blocks + the priming: "
          + "; ".join(f"prime {p_}: underruns {u_} ({u_ / (nzl * ZL_B):.2%} of the "
                      f"{nzl * ZL_B} samples), overruns {o_} ({o_ / (nzl * ZL_B):.2%}), late "
                      f"callbacks {l_}, the "
                      f"worker's time a block mean {m_:.1f} us, median {md_:.1f}, worst "
                      f"{w_:.1f}, over the period {fr_:.3%}, pulled stream = own run {s_}"
                      for p_, u_, o_, l_, m_, md_, w_, fr_, s_ in zl_rows)
          + f"; unpaced: output = the processor's own run (bit-equal); CsoundHost.run on a "
          f"stub engine, cltvconv_insert(parts {cparts}, size {icsize}) at ksmps {cks}: "
          f"{cycles38} cycles, vs float64 scipy {errcs38:.3e}, block_step_fwd_fused_tv "
          f"{fwdcs38}; checkpoint mid-stream on the card: continues bit-equal", flush=True)

    # phase 39: the sweep harness on the card: the quick grid (M 2^9, 2^11 x
    # L 2^16, 2^18, TV, one repeat) in a temporary directory, every point
    # measured and above 100x real time; device_timer of pconv_step at one
    # channel beside phase 26's event time
    from opencl_fft_tpu_torch.bench import sweep as SW
    from opencl_fft_tpu_torch.utils.profiling import device_timer
    grid39 = ([1 << 9, 1 << 11], [1 << 16, 1 << 18])
    t0 = time.perf_counter()
    with tempfile38.TemporaryDirectory() as td:
        res39 = SW.run_sweep(*grid39, tv=True, out_prefix=td + "/sweep", row_repeats=1)
        table39 = open(td + "/sweep_table.tex").read()
    sweep_s = time.perf_counter() - t0
    keys39 = [f"M={m_},L=2^{int(np.log2(l_))}" for m_ in grid39[0] for l_ in grid39[1]]
    check(sorted(res39) == sorted(keys39) and all(res39[k_] > 100 for k_ in keys39),
          f"the quick sweep measured every point above 100x: {res39}")
    check("\\begin{tabular}" in table39 and "--" not in table39, "the sweep's table is whole")
    st39 = P.push_ir(cfg, P.pconv_init(cfg, dev), ir_d)
    b39 = f(PTS, s=0.1)
    dt39 = device_timer(lambda s_: P.pconv_step(cfg, s_, b39)[0], st39, iters=50)
    ev26 = dict((lab, ms) for lab, ms, _, _ in path_rows)["pconv_step C=1"]
    print(f"phase 39 sweep [{card}]: run_sweep quick grid (TV, one repeat, {sweep_s:.1f} s): "
          + ", ".join(f"{k_} {res39[k_]:.1f}x" for k_ in keys39)
          + f" real time (44.1 kHz); device_timer(pconv_step, C=1, 50 chained) "
          f"{dt39 * 1e3:.4f} ms a step beside phase 26's events {ev26:.4f} ms", flush=True)

    # phase 40: the demo command lines (opencl_fft_tpu_torch/examples) on the
    # card. Each runs at its full default size as `python -m
    # opencl_fft_tpu_torch.examples.<name>` into a temporary directory (the
    # seven unpaced ones side by side, then the two paced ones alone): exit
    # codes, wavs (nonzero share > 0.4, peak within +-32767), the printed
    # checks (zero added latency, the faded jump below the instant one, the
    # farm's PASS, 0 underruns and overruns at pts 4096). In process, with
    # the launch counts set to 0 just before each demo's path and read just
    # after (the profiler's __global__ list beside them): demo, stereo_demo
    # and zl_demo against float64 scipy aligned by their latency to 5e-5 of
    # max|ref|, tvconv_demo and hotswap_demo against the same render on the
    # CPU (the plain twins) to 1e-5, the csound inserts block by block
    # against the CPU where ctcsound is absent, one rank of the farm in this
    # process, realtime_pipeline's unpaced phases 1 and 3 and audio_host_demo
    # for 1 s. Phase 3's pacing is recorded, not required.
    import glob
    import importlib.util
    import os
    import tempfile
    import wave

    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from opencl_fft_tpu_torch.examples import audio_host_demo as XA
    from opencl_fft_tpu_torch.examples import csound_demo as XC
    from opencl_fft_tpu_torch.examples import demo as XD
    from opencl_fft_tpu_torch.examples import dist_serving_demo as XS
    from opencl_fft_tpu_torch.examples import hotswap_demo as XH
    from opencl_fft_tpu_torch.examples import realtime_pipeline as XR
    from opencl_fft_tpu_torch.examples import stereo_demo as XST
    from opencl_fft_tpu_torch.examples import tvconv_demo as XT
    from opencl_fft_tpu_torch.examples import zl_demo as XZ
    t40 = time.perf_counter()
    root40 = os.path.dirname(os.path.abspath(__file__))
    has_cs = importlib.util.find_spec("ctcsound") is not None
    wavs40 = ("demo", "tvconv_demo", "hotswap_demo", "stereo_demo", "zl_demo")

    def run_demo(name, *args):
        t0_ = time.perf_counter()
        p_ = subprocess.run([sys.executable, "-m", f"opencl_fft_tpu_torch.examples.{name}",
                             *args], cwd=root40, capture_output=True, text=True, timeout=600)
        return name, p_.returncode, p_.stdout, p_.stderr, time.perf_counter() - t0_

    with tempfile.TemporaryDirectory() as td40:
        unpaced40 = [(n_, f"{td40}/{n_}.wav") for n_ in wavs40] + [
            ("csound_demo",), ("dist_serving_demo",)]
        with ThreadPoolExecutor(len(unpaced40)) as ex:
            cli40 = {r_[0]: r_[1:] for r_ in ex.map(lambda a_: run_demo(*a_), unpaced40)}
        for n_ in ("realtime_pipeline", "audio_host_demo"):
            cli40[n_] = run_demo(n_)[1:]
        for n_, (rc_, out_, err_, _) in cli40.items():
            want_rc = 1 if n_ == "csound_demo" and not has_cs else 0
            check(rc_ == want_rc, f"{n_} exits {rc_} (want {want_rc}):\n{out_[-2000:]}\n"
                                  f"{err_[-4000:]}")
        wav_rows = {}
        for n_ in wavs40:
            with wave.open(f"{td40}/{n_}.wav") as w_:
                pcm = np.frombuffer(w_.readframes(w_.getnframes()), np.int16)
                wav_rows[n_] = (w_.getnchannels(), w_.getnframes() / w_.getframerate(),
                                float(np.mean(pcm != 0)), int(np.abs(pcm.astype(np.int32)).max()))
            check(wav_rows[n_][2] > 0.4 and 0 < wav_rows[n_][3] <= 32767,
                  f"{n_}'s wav: nonzero share {wav_rows[n_][2]:.3f}, peak {wav_rows[n_][3]}")
    out40 = {n_: v_[1] for n_, v_ in cli40.items()}
    check("zero-latency engine = 0 samples" in out40["zl_demo"], out40["zl_demo"])
    jm = re.search(r"instant ([\d.]+), faded ([\d.]+)", out40["hotswap_demo"])
    check(jm is not None and float(jm.group(2)) < float(jm.group(1)),
          f"hotswap_demo's faded jump below the instant one: {out40['hotswap_demo']}")
    check(out40["dist_serving_demo"].rstrip().endswith("PASS"), out40["dist_serving_demo"])
    check("underruns=0 overruns=0" in out40["realtime_pipeline"]
          and "REALTIME OK" in out40["realtime_pipeline"].split("phase 3")[0],
          f"realtime_pipeline phase 2 keeps up: {out40['realtime_pipeline']}")
    check("underrun samples: 0; overrun samples: 0;" in out40["audio_host_demo"],
          f"audio_host_demo: {out40['audio_host_demo']}")
    check(has_cs or "ctcsound is not importable" in out40["csound_demo"], out40["csound_demo"])
    cli_s40 = time.perf_counter() - t40

    names40 = {"spectral_mac": lambda: MC.LAUNCHES, "block_step_fused": lambda: BS.STEP_LAUNCHES,
               "block_step_fwd_fused": lambda: BS.FWD_LAUNCHES,
               "block_step_fwd_fused_tv": lambda: BS.FWD_TV_LAUNCHES,
               "block_mac_unpack": lambda: BS.MAC_UNPACK_LAUNCHES,
               "stream_steps_fused_batched": lambda: S.BATCHED_LAUNCHES,
               "stream_steps_fused_batched_tv": lambda: S.BATCHED_TV_LAUNCHES,
               "stream_steps_fused_matrix": lambda: S.MATRIX_LAUNCHES,
               "fft_vmem": lambda: V.LAUNCHES, "fft_vmem_front2": lambda: V.FRONT2_LAUNCHES,
               "dstream_steps": lambda: K.LAUNCHES}

    # the __global__ kernels of the port's sources, by name
    csrc40 = "".join(open(p_).read() for p_ in sorted(
        glob.glob(os.path.join(root40, "opencl_fft_tpu_torch", "csrc", "*.cu*"))))
    ours40 = re.compile(r"\b(?:" + "|".join(sorted(set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?(\w+_kernel)\s*\(",
        csrc40)))) + r")\b(?:<[^>]*>)?")

    def traced(fn):
        """fn() with every launch count set to 0 just before and read just
        after, under the profiler: (result, wall s, {wrapper: launches},
        {our __global__: launches}, other kernel launches). The profiler's
        counts are a lower bound (a session can drop launches)."""
        zero_counts()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof_:
            t0_ = time.perf_counter()
            res_ = fn()
            torch.cuda.synchronize()
            wall_ = time.perf_counter() - t0_
        counts_ = {k_: c_() for k_, c_ in names40.items() if c_()}
        ours_, other_ = {}, 0
        for e_ in prof_.key_averages():
            if e_.self_device_time_total <= 0:
                continue
            k_ = None if "at::" in e_.key else ours40.search(e_.key)
            if k_ is None:
                other_ += e_.count
            else:
                ours_[k_.group(0)] = ours_.get(k_.group(0), 0) + e_.count
        return res_, wall_, counts_, ours_, other_

    rows40 = []

    def row(name, audio_s, wall, counts, ours, other, note, need):
        """Record a demo's run; its wrapper counts must hold ``need``
        (other wrappers may appear, and are printed)."""
        check(all(counts.get(k_) == v_ for k_, v_ in need.items()),
              f"{name}: launches {counts}, need {need}")
        rows40.append((name, audio_s, wall, counts, ours, other, note))

    # demo: 64-sample host blocks into parts 1024, one partition of latency
    dry40, irh40 = XD.inputs()
    wet40, w_, c_, o_, n_ = traced(lambda: XD.render(dry40, irh40, dev))
    full40 = sps.fftconvolve(dry40.astype(np.float64), irh40.astype(np.float64))
    ref40 = np.zeros(wet40.size - XD.PARTS)
    m_ = min(ref40.size, full40.size)
    ref40[:m_] = full40[:m_]
    e_demo = rel_err(wet40[XD.PARTS:], ref40)
    steps40 = wet40.size // XD.PARTS
    check(e_demo <= ORACLE_TOL and not wet40[:XD.PARTS].any(),
          f"demo vs float64 scipy {e_demo:.3e}")
    row("demo", wet40.size / 44100, w_, c_, o_, n_, f"vs scipy {e_demo:.3e}",
        {"block_step_fwd_fused": steps40})

    # tvconv_demo: against the same render on the CPU
    a40, b40 = XT.inputs()
    tvw40, w_, c_, o_, n_ = traced(lambda: XT.render(a40, b40, dev))
    e_tv = rel_err(tvw40, XT.render(a40, b40, "cpu"))
    tvsteps = tvw40.size // XT.PARTS
    check(e_tv <= 1e-5, f"tvconv_demo card vs CPU {e_tv:.3e}")
    row("tvconv_demo", tvw40.size / 44100, w_, c_, o_, n_, f"vs CPU {e_tv:.3e}",
        {"block_step_fwd_fused_tv": tvsteps})

    # hotswap_demo: the instant and the faded swap, against the CPU
    dryh, small40, big40 = XH.inputs()
    swap40 = int(1.2 * 44100) // XH.PARTS
    hs40 = {}
    for fade_ in (0, XH.FADE):
        got_, w_, c_, o_, n_ = traced(lambda: XH.render(dryh, small40, big40, XH.PARTS, swap40,
                                                        fade_, dev))
        e_ = rel_err(got_, XH.render(dryh, small40, big40, XH.PARTS, swap40, fade_, "cpu"))
        check(e_ <= 1e-5, f"hotswap_demo fade {fade_} card vs CPU {e_:.3e}")
        hsteps = got_.size // XH.PARTS
        hs40[fade_] = got_
        # the fade: one #7 to rebuild the incoming tail, then #8 and #10 a
        # faded block
        row(f"hotswap_demo fade {fade_}", got_.size / 44100, w_, c_, o_, n_, f"vs CPU {e_:.3e}",
            {"block_step_fwd_fused": hsteps} if not fade_ else
            {"spectral_mac": 1, "block_step_fused": fade_, "block_step_fwd_fused": hsteps})
    j40 = XH.jumps(hs40[0], hs40[XH.FADE], XH.PARTS, swap40)
    check(j40[1] < j40[0], f"hotswap_demo on the card: faded jump {j40[1]} < instant {j40[0]}")

    # stereo_demo: one matrix scan of (nblk, 2, 1024) blocks, no latency
    drys, cfgs, irss = XST.inputs()
    (strm40, wets40), w_, c_, o_, n_ = traced(lambda: XST.render(drys, cfgs, irss, dev))
    refs40 = np.stack([sum(sps.fftconvolve(strm40[i].astype(np.float64),
                                           irss[o, i].astype(np.float64))[:strm40.shape[1]]
                           for i in range(2)) for o in range(2)])
    e_st = rel_err(wets40, refs40)
    check(e_st <= ORACLE_TOL, f"stereo_demo vs float64 scipy {e_st:.3e}")
    row("stereo_demo", wets40.shape[1] / 44100, w_, c_, o_, n_, f"vs scipy {e_st:.3e}",
        {"stream_steps_fused_matrix": 1})

    # zl_demo: zero added latency, the reverb workload in 64-sample blocks
    lat40 = XZ.latencies(irh40, dev)
    check(lat40 == (0, XZ.PARTS), f"zl_demo latencies {lat40}")
    (zw40, segs40), w_, c_, o_, n_ = traced(lambda: XZ.render(dry40, irh40, dev))
    refz = np.zeros(zw40.size)
    m_ = min(refz.size, full40.size)
    refz[:m_] = full40[:m_]
    e_zl = rel_err(zw40, refz)
    nblk_z = zw40.size // XZ.BLOCK
    # every segment of this plan (pmax 1024) fires block_step_fwd_fused,
    # the terminal too; process replays graphs on the card
    fires = sum(zl_replayed_fires(segs40, XZ.BLOCK, nblk_z))
    check(e_zl <= ORACLE_TOL, f"zl_demo vs float64 scipy {e_zl:.3e}")
    row("zl_demo", zw40.size / 44100, w_, c_, o_, n_,
        f"vs scipy {e_zl:.3e}, latency {lat40[0]} (uniform {lat40[1]})",
        {"block_step_fwd_fused": fires})

    # csound_demo's inserts, block by block, card against CPU
    ins_d, ins_c = XC.inserts(dev), XC.inserts("cpu")
    ncyc = 2 * 44100 // XC.KSMPS
    sig40 = (0.3 * rng.standard_normal((ncyc, 2, XC.KSMPS))).astype(np.float32)

    def inserts_run(ins):
        return np.stack([np.stack([ins[0].process(s_[0]), ins[1].process(s_[0], s_[1])])
                         for s_ in sig40])
    csd_out, w_, c_, o_, n_ = traced(lambda: inserts_run(ins_d))
    csc_out = inserts_run(ins_c)
    e_cs = max(rel_err(csd_out[:, k_], csc_out[:, k_]) for k_ in range(2))
    csteps = ncyc * XC.KSMPS // XC.PARTS
    check(e_cs <= 1e-5, f"csound inserts card vs CPU {e_cs:.3e}")
    row("csound_demo inserts", ncyc * XC.KSMPS / 44100, w_, c_, o_, n_,
        f"vs CPU {e_cs:.3e}; ctcsound {'present: the demo ran' if has_cs else 'absent'}",
        {"block_step_fwd_fused": csteps, "block_step_fwd_fused_tv": csteps})

    # dist_serving_demo: one NCCL rank of the farm in this process
    with tempfile.TemporaryDirectory() as store40:
        dist.init_process_group("nccl", init_method="file://" + store40 + "/store", rank=0,
                                world_size=1)
        try:
            rk40, w_, c_, o_, n_ = traced(lambda: XS.serve_rank((1, 1), 8, 32, 128, 16, "cuda"))
        finally:
            dist.destroy_process_group()
    cfgd, irsd, blkd = XS.inputs(8, 32, 128, 16)
    convd = P.Convolver(cfgd, 8, device=dev)
    convd.push_ir(irsd)
    refd = convd.stream(blkd).cpu().numpy()
    e_ds = float(np.max(np.abs(rk40["out"] - refd))) / max(1.0, float(np.max(np.abs(refd))))
    check(e_ds <= XS.TOL, f"the farm's rank vs Convolver.stream {e_ds:.3e}")
    row("dist_serving_demo rank", 32 * 128 * 8 / 48000, w_, c_, o_, n_,
        f"vs Convolver.stream {e_ds:.3e} of max(1, scale)", {})

    # realtime_pipeline's unpaced phases 1 and 3, audio_host_demo for 1 s
    cfgr, irr, blkr, blkr3 = XR.inputs(4096, 3.0)
    r1_40, w_, c_, o_, n_ = traced(lambda: XR.phase1(cfgr, irr, blkr, dev))
    check(c_.get("fft_vmem", 0) >= len(blkr), f"realtime_pipeline phase 1: #18 {c_}")
    row("realtime_pipeline phase 1", (len(blkr) - 1) * 4096 / 48000, w_, c_, o_, n_,
        f"unpaced {r1_40['rt']:.1f}x real time", {"block_mac_unpack": len(blkr)})
    r3_40, w_, c_, o_, n_ = traced(lambda: XR.phase3(irr, blkr3, dev))
    row("realtime_pipeline phase 3", None, w_, c_, o_, n_,
        f"unpaced {r3_40['rt']:.2f}x real time, then paced if >= {XR.BUDGET3}x: "
        f"(underruns, overruns) {r3_40['paced']}", {})
    ra40, w_, c_, o_, n_ = traced(lambda: XA.run(1.0, 4096, dev, report=lambda m_: None))
    row("audio_host_demo 1 s", 1.0, w_, c_, o_, n_,
        f"{ra40['host']}: callbacks {ra40['callbacks']}, underruns {ra40['underruns']}, "
        f"overruns {ra40['overruns']}, late {ra40['late']}", {})
    print(f"phase 40 demos [{card}] in {time.perf_counter() - t40:.1f} s: python -m "
          f"opencl_fft_tpu_torch.examples.<name> ({cli_s40:.1f} s; the seven unpaced side by "
          f"side, then the paced two alone): "
          + "; ".join(f"{n_} rc {v_[0]} in {v_[3]:.1f} s: "
                      + " | ".join(ln_ for ln_ in v_[1].splitlines()
                                   if not ln_.startswith("using device"))
                      for n_, v_ in cli40.items())
          + "; wavs (channels, s, nonzero share, peak): "
          + ", ".join(f"{n_} {v_[0]}, {v_[1]:.2f}, {v_[2]:.3f}, {v_[3]}"
                      for n_, v_ in wav_rows.items())
          + ". In process (wall s, audio s / wall s, launches by wrapper | the profiler's "
          "__global__ kernels | other kernels): "
          + "; ".join(f"{n_}: {w_:.3f} s, " + (f"{a_ / w_:.1f}x" if a_ else "-")
                      + f", {c_} | {o_} | {k_} ({note_})"
                      for n_, a_, w_, c_, o_, k_, note_ in rows40), flush=True)

    # phase 41: a third-order Ambisonic reverb matrix at its full size, the
    # shape of the benchmark cell mimo16x16_stream470: MatrixConvolver(16, 16)
    # of 2^17-tap IRs in 512-sample partitions through the matrix scan entry
    # (16 inputs' transforms and rings, 256 pairs' MAC, 16 outputs'
    # transforms), two chained 470-block stream calls, each one launch of it
    # and none of the batched scan. Against each pair's single-channel
    # pconv_stream (the batched entry at C = 1), chained the same way and
    # summed over the inputs, on every output; against float64 scipy on four
    # outputs. Then the entry against its plain twin on the same card
    # tensors, at the MAC width the cell runs (TILE_TT_MAX): the first call's
    # blocks, the windows and tails the two calls left, the pairs' IR planes
    amb, rng41 = 16, np.random.default_rng(41)
    acfg = P.PconvConfig.for_ir_length(IR_LEN, PTS)
    a_irs = (rng41.standard_normal((amb, amb, IR_LEN))
             * np.exp(-np.arange(IR_LEN) / (0.5 * SR))).astype(np.float32)
    a_x = (0.1 * rng41.standard_normal((2 * SERVE_BLOCKS, amb, PTS))).astype(np.float32)
    a_irs_d, a_x_d = torch.from_numpy(a_irs).to(dev), torch.from_numpy(a_x).to(dev)
    amat = P.MatrixConvolver(acfg, amb, amb, device=dev)
    amat.push_ir(a_irs_d)
    y41, launches41 = [], []
    calls41 = [slice(k_ * SERVE_BLOCKS, (k_ + 1) * SERVE_BLOCKS) for k_ in range(2)]
    for seg_ in calls41:
        S.MATRIX_LAUNCHES = S.BATCHED_LAUNCHES = 0
        y41.append(amat.stream(a_x_d[seg_]))
        torch.cuda.synchronize()
        launches41.append((S.MATRIX_LAUNCHES, S.BATCHED_LAUNCHES))
    check(launches41 == [(1, 0), (1, 0)],
          f"MatrixConvolver(16, 16).stream launches of the matrix and batched scan entries a "
          f"call {launches41} (want [(1, 0), (1, 0)])")
    y41 = torch.cat(y41)
    check(tuple(y41.shape) == (2 * SERVE_BLOCKS, amb, PTS) and bool(torch.isfinite(y41).all()),
          "MatrixConvolver(16, 16).stream shape/finite")
    st41 = amat._compact
    tt41 = S.matrix_plan(amb, amb, SERVE_BLOCKS, PTS, acfg.nparts, _build.sm_count(0))[3]
    check(tt41 == S.TILE_TT_MAX,
          f"matrix_plan at the cell's shape: {tt41} outputs a thread (want {S.TILE_TT_MAX})")
    args41 = (a_x_d[calls41[0]], PC._window(acfg, st41), (st41.spec_h_re, st41.spec_h_im),
              acfg.b0_scale, st41.tail, PTS)
    got41 = S.stream_steps_fused_matrix(*args41)
    want41 = S.stream_steps_fused_matrix_plain(*args41)
    torch.cuda.synchronize()
    err41t = max(worst_channel(got41[0], want41[0]),
                 *(rel_err(g_.cpu(), w_.cpu()) for g_, w_ in
                   ((got41[1][0], want41[1][0]), (got41[1][1], want41[1][1]),
                    (got41[2], want41[2]))))
    check(err41t <= TOL, f"stream_steps_fused_matrix vs its twin at the cell's shape "
          f"{err41t:.3e} > {TOL}")
    del amat, st41, args41, got41, want41
    pairs41 = torch.zeros_like(y41)
    for o_ in range(amb):
        for i_ in range(amb):
            st_ = P.push_ir(acfg, P.pconv_init(acfg, dev), a_irs_d[o_, i_])
            for seg_ in calls41:
                st_, yk_ = P.pconv_stream(acfg, st_, a_x_d[seg_, i_])
                pairs41[seg_, o_] += yk_
    err41 = worst_channel(y41, pairs41)
    check(err41 <= TOL, f"MatrixConvolver(16, 16) vs the pairs' pconv_stream {err41:.3e} > {TOL}")
    n41, oracle41 = 2 * SERVE_BLOCKS * PTS, (0, 5, 10, amb - 1)
    ax64 = a_x.transpose(1, 0, 2).reshape(amb, -1).astype(np.float64)
    y41_np = y41.cpu().numpy()
    err41o = max(rel_err(y41_np[:, o_].reshape(-1),
                         sum(sps.fftconvolve(ax64[i_], a_irs[o_, i_].astype(np.float64))[:n41]
                             for i_ in range(amb))) for o_ in oracle41)
    check(err41o <= ORACLE_TOL, f"MatrixConvolver(16, 16) vs scipy {err41o:.3e} > {ORACLE_TOL}")
    print(f"phase 41 Ambisonic matrix: MatrixConvolver({amb}, {amb}).push_ir({amb}x{amb}x"
          f"{IR_LEN}) + 2 chained stream({SERVE_BLOCKS}x{amb}x{PTS}) on {dev}: (matrix, batched) "
          f"scan launches a call {launches41}; vs the {amb * amb} pairs' pconv_stream summed over "
          f"inputs on all outputs {err41:.3e} (tol {TOL}); vs float64 scipy on outputs "
          f"{oracle41} {err41o:.3e} (tol {ORACLE_TOL}); the entry (tt {tt41}) vs its twin on "
          f"the card, outputs, windows and tails {err41t:.3e} (tol {TOL})", flush=True)
    del y41, pairs41, y41_np, a_irs_d, a_x_d

    # phase 42: head-tracked binaural room synthesis at the shape of the
    # benchmark cell brs24x2_headturn: MatrixConvolver(24, 2) of 2^16-tap
    # BRIRs in 512-sample partitions (48 pairs, nparts 128, bins 512) with a
    # bank of 4 orientations (fill_bank), a switch before every block (each
    # input's orientation changes, every fourth block only the even inputs':
    # the switch's row route) and one step. Each block counts one
    # spectral_mac (the incoming tail's rebuild), one block_step_fwd_fused
    # (the incoming path) and one block_step_fused (the outgoing path)
    # launch, the first block (an instant swap) one block_step_fwd_fused.
    # Against the float64 blends of tests/brs_reference.py. Then the three
    # wrappers against their twins on the same card tensors at C = 48,
    # nparts 128, bins 512, the plan of mac_plan(128, 512)
    import importlib.util
    import os
    spec42 = importlib.util.spec_from_file_location(
        "brs_reference", os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                                      "brs_reference.py"))
    brs_ref = importlib.util.module_from_spec(spec42)
    spec42.loader.exec_module(brs_ref)
    n_src, n_ear, n_or, brs_taps, brs_blocks = 24, 2, 4, 1 << 16, 16
    bcfg = P.PconvConfig.for_ir_length(brs_taps, PTS)
    rng42 = np.random.default_rng(42)
    b_irs = (rng42.standard_normal((n_src, n_or, n_ear, brs_taps))
             * np.exp(-np.arange(brs_taps) / (0.3 * SR))).astype(np.float32)
    b_x = (0.1 * rng42.standard_normal((brs_blocks, n_src, PTS))).astype(np.float32)
    b_irs_d, b_x_d = torch.from_numpy(b_irs).to(dev), torch.from_numpy(b_x).to(dev)
    brs = P.MatrixConvolver(bcfg, n_src, n_ear, device=dev)
    for s_ in range(0, n_src, 8):
        brs.fill_bank(b_irs_d[s_:s_ + 8], first=s_)
    src42 = np.arange(n_src)
    index42, switches42, y42, launches42 = src42 % n_or, {}, [], []
    for t_ in range(brs_blocks):
        nxt = (src42 + t_) % n_or
        if t_ % 4 == 3:
            nxt = np.where(src42 % 2 == 0, nxt, index42)
        index42 = nxt
        fade_ = 0 if t_ == 0 else 1
        switches42[t_] = (index42.copy(), fade_)
        zero_counts()
        brs.switch(index42, fade_)
        y42.append(brs.step(b_x_d[t_]))
        torch.cuda.synchronize()
        launches42.append(step_counts()[:3] + (BS.MAC_UNPACK_LAUNCHES, BS.FWD_TV_LAUNCHES,
                                               S.BATCHED_LAUNCHES, S.MATRIX_LAUNCHES))
    want42 = [(0, 0, 1, 0, 0, 0, 0)] + [(1, 1, 1, 0, 0, 0, 0)] * (brs_blocks - 1)
    check(launches42 == want42,
          f"MatrixConvolver(24, 2) switch + step launches of (spectral_mac, "
          f"block_step_fused, block_step_fwd_fused, block_mac_unpack, block_step_fwd_fused_tv, "
          f"batched scan, matrix scan) a block {launches42} (want {want42})")
    y42 = torch.stack(y42)
    check(tuple(y42.shape) == (brs_blocks, n_ear, PTS) and bool(torch.isfinite(y42).all()),
          "MatrixConvolver(24, 2) switch + step shape/finite")
    ref42 = brs_ref.render(torch.from_numpy(b_x).permute(1, 0, 2).reshape(n_src, -1),
                           torch.from_numpy(b_irs), switches42, brs_blocks, PTS)
    err42 = rel_err(y42.cpu().numpy(), ref42.numpy())
    check(err42 <= ORACLE_TOL, f"MatrixConvolver(24, 2) bank switches vs the float64 "
          f"blends {err42:.3e} > {ORACLE_TOL}")
    del brs, b_irs_d, b_x_d, y42, ref42
    plan42 = MC.mac_plan(bcfg.nparts, bcfg.bins)
    pair42 = n_src * n_ear
    ring, h, tail, bl2 = ring_inputs(pair42, bcfg.nparts, bcfg.bins)
    worst42 = mac42 = 0.0
    for rp in (0, 1, bcfg.nparts - 1):
        for b0 in (1.0, 2.0):
            where = f"C={pair42} nparts={bcfg.nparts} bins={bcfg.bins} rp={rp} b0={b0}"
            planes42 = []
            for twin in (False, True):
                mac_, fused_, fwd_ = ((MC.spectral_mac_plain, BS.block_step_fused_plain,
                                       BS.block_step_fwd_fused_plain) if twin else
                                      (MC.spectral_mac, BS.block_step_fused,
                                       BS.block_step_fwd_fused))
                fwd = fwd_(bl2[0], ring, h, rp, b0, tail, bcfg.pts)
                planes42.append({"spectral_mac": mac_(ring, h, rp, b0),
                                 "block_step_fused": fused_(ring, h, rp, b0, tail, bcfg.pts),
                                 "block_step_fwd_fused": (fwd[0], fwd[1], *fwd[2])})
            got, want = planes42
            torch.cuda.synchronize()
            mac42 = max(mac42, mac_close("spectral_mac", got["spectral_mac"],
                                         want["spectral_mac"], where))
            worst42 = compare(tuple((f"{k_} {i}", g, w_) for k_ in got for i, (g, w_) in
                                    enumerate(zip(got[k_], want[k_]))), where, worst42)
    del ring, h, tail, bl2, got, want, planes42
    print(f"phase 42 binaural room synthesis: MatrixConvolver({n_src}, {n_ear}) of {brs_taps}"
          f"-tap BRIRs, a bank of {n_or} orientations, switch + step on each of {brs_blocks} "
          f"blocks on {dev}: (spectral_mac, block_step_fused, block_step_fwd_fused) launches "
          f"{launches42[0][:3]} on the first block (an instant swap), {launches42[1][:3]} on "
          f"each other, no other counted launch; vs the float64 "
          f"blends {err42:.3e} (tol {ORACLE_TOL}); spectral_mac, block_step_fused and "
          f"block_step_fwd_fused vs their twins at C={pair42} nparts={bcfg.nparts} "
          f"bins={bcfg.bins} (mac_plan {tuple(plan42)}) rp {{0, 1, {bcfg.nparts - 1}}} b0 "
          f"{{1, 2}}: worst rel err {worst42:.3e} (tol {TOL}), the MAC {mac42:.3e} "
          f"(tol {MAC_TOL})", flush=True)

    def kernel(name, source, replaces, launches, err, ms, plain, bnd, lib):
        return {"name": name, "route": "cuda", "source": f"opencl_fft_tpu_torch/csrc/{source}",
                "replaces": f"opencl_fft_tpu/ops/pallas/{replaces}", "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": lib}

    print(json.dumps({"kernels": [
        kernel("stream_steps_fused", "streamstep.cu", "streamstep.py:209", main_launches,
               headline_err, kernel_ms, plain_ms, lti_bound, None),
        kernel("stream_steps_fused_tv", "streamstep.cu", "streamstep.py:345", tv_launches,
               tv_err, tv_kernel_ms, tv_plain_ms, tv_bound, None),
        kernel("stream_steps_fused_batched", "streamstep.cu", "streamstep.py:506",
               serve_launches, b_err, b_kernel_ms, b_plain_ms, b_bound, None),
        kernel("stream_steps_fused_batched_tv", "streamstep.cu", "streamstep.py:682",
               serve_tv_launches, bt_err, bt_kernel_ms, bt_plain_ms, bt_bound, None),
        kernel("dstream_steps", "dstream.cu", "dstream.py:85", d_launches, d_err,
               d_kernel_ms, d_plain_ms, d_bound, d_lib_ms),
        kernel("fft_vmem", "fft.cu", "vmemfft.py:1100", fft_launches, fft_err, *fft_row),
        kernel("fft_vmem_front2", "fft.cu", "vmemfft.py:808", f2_launches, f2_err,
               *f2_row),
        # times at the shape that takes most of the wrapper's main-path
        # launches; the error over every main-path shape of the wrapper
        *(kernel(w_, "slidemac.cu", src, launches,
                 max(mac_err[(w_, c_, n_)] for c_, n_ in shapes),
                 *(mac_by[(w_, *shapes[0])][i] for i in (3, 4, 5, 6)))
          for w_, shapes, src, launches in (
              ("chunk_mac", ((1, SCAN_BLOCKS), (16, SERVE_BLOCKS)), "chunkmac.py:158",
               off_launches[0]),
              ("macflow_lti", ((1, SCAN_BLOCKS),), "macflow.py:252", off_launches[1]),
              ("macflow_lti_batched", ((SERVE_CH, CHUNK_K), (SERVE_CH, SERVE_BLOCKS)),
               "macflow.py:367", off_launches[2]))),
        # times at one channel, the shape of most of each kernel's main-path
        # launches (Clpconv, the processors); the error over both widths
        *(kernel(k, "blockstep.cu", src, n,
                 max(bs_err[(k, 1, np_)], bs_err[(k, SERVE_CH, np_)]),
                 kern_rows[(k, 1)][0], kern_rows[(k, 1)][2], kern_rows[(k, 1)][3], None)
          for k, src, n in zip(bs_names, ("mac.py:87", "blockstep.py:438", "blockstep.py:343",
                                          "blockstep.py:382"), bs_launches)),
        # times at the shape of most of each kernel's main-path launches;
        # the error over the kernel's main-path shapes
        *(kernel(k, "streamstep.cu", src, n,
                 max(split_err[(ek, c_, LONG_PTS)] for c_ in (1, LONG_CH)),
                 *new_rows[(k, 1, LONG_BLOCKS)], None)
          for k, ek, src, n in (("stream_steps_fused_split", "split",
                                 "splitstep.py:367", new_launches[2]),
                                ("stream_steps_fused_split_tv", "split_tv",
                                 "splitstep.py:493", new_launches[3]))),
        kernel("macflow_tv", "slidemac.cu", "macflow.py:498", new_launches[0],
               tvm_err[("macflow_tv", 1, SCAN_BLOCKS)],
               *new_rows[("macflow_tv", 1, SCAN_BLOCKS)], None),
        kernel("macflow_tv_batched", "slidemac.cu", "macflow.py:646", new_launches[1],
               max(tvm_err[("macflow_tv_batched", SERVE_CH, n_)]
                   for n_ in (CHUNK_K, SERVE_BLOCKS)),
               *new_rows[("macflow_tv_batched", SERVE_CH, CHUNK_K)], None),
        # times at one channel, 255 partitions (the zero-latency terminal
        # segment); launches of ClconvProcessor(parts=0)'s own run through
        # the wrapper, and beside them the terminal firings that replayed
        # the captured launch (graph_replays); the error over the main-path
        # shapes
        {**kernel("block_mac_unpack", "blockstep.cu", "blockstep.py:484", cnt_a[0],
                  max(mu_err[(1, long_np - 1, LONG_PTS)], mu_err[(1, long_np, LONG_PTS)],
                      mu_err[(LONG_CH, long_np, LONG_PTS)]),
                  *mu_rows[(1, long_np - 1)][:3], None),
         "graph_replays": cnt_a[4]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
