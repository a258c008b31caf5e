"""Smoke run of the PyTorch/CUDA port (opencl_fft_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout, holds it
against its plain PyTorch twin at the headline shape (2^17-tap IR in
512-sample partitions: nparts=256, bins=512, 1880-block scans), drives the
main path (``convolve`` and the ``ClconvProcessor`` opcode layer) on the card
against a float64 scipy oracle, times the stream, and prints one JSON line
per kernel and, last, ``{"ok": true, "device": {...}}``. Every phase prints
one line; any failure exits non-zero before the last line. Without a CUDA
card, or without the port beside this script, it fails.
"""

import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SR = 48000.0
PTS = 512
IR_LEN = 1 << 17
SCAN_BLOCKS = 1880
TOL = 2e-5          # kernel vs twin, relative to max|twin| (JAX stream-vs-scan bound)
ORACLE_TOL = 5e-5   # relative max error vs the float64 scipy oracle


def check(ok, what):
    if not ok:
        raise RuntimeError(f"FAILED: {what}")


def rel_err(got, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - ref)) / np.max(np.abs(ref)))


def cuda_ms(fn, warmup=2, reps=7):
    """Median milliseconds of fn() over reps runs, by CUDA events."""
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
    from opencl_fft_tpu_torch.ops.cuda import _build
    from opencl_fft_tpu_torch.ops.cuda import streamstep as S

    # phase 2: build from the checkout's sources
    t0 = time.perf_counter()
    _build.load("streamstep")
    build_s = time.perf_counter() - t0
    # ptxas -v: per kernel, its spill line and then its register/smem line
    kernels, resources = [], []
    for ln in _build.build_log("streamstep").splitlines():
        found = re.search(r"Compiling entry function '.*?\d+([a-z_]+_kernel)E", ln)
        if found:
            kernels.append(found.group(1))
        elif "Used" in ln:
            resources.append(ln.split(":", 1)[1].strip())
    print(f"phase 2 build: streamstep.cu for sm_90a in {build_s:.3f} s; ptxas: "
          + "; ".join(f"{k}: {r}" for k, r in zip(kernels, resources)), flush=True)

    # phase 3: kernel vs plain twin on the card
    rng = np.random.default_rng(0)

    def scan_inputs(pts, nparts, nb):
        def f(*shape, s=1.0):
            return torch.from_numpy((s * rng.standard_normal(shape)).astype(np.float32)).to(dev)
        return (f(nb, pts, s=0.1), (f(nparts, pts), f(nparts, pts)),
                (f(nparts, pts, s=0.05), f(nparts, pts, s=0.05)), f(pts))

    headline = (PTS, IR_LEN // PTS, SCAN_BLOCKS)
    shapes = [headline, (PTS, IR_LEN // PTS, 21), (64, 5, 21), (16, 1, 1)]
    headline_err = 0.0
    worst = 0.0
    for pts, nparts, nb in shapes:
        blocks, w0, h, tail = scan_inputs(pts, nparts, nb)
        for b0 in (1.0, 2.0):
            n0 = S.LAUNCHES
            got = S.stream_steps_fused(blocks, w0, h, b0, tail, pts)
            torch.cuda.synchronize()
            check(S.LAUNCHES == n0 + 1, "LAUNCHES counts the kernel launch")
            want = S.stream_steps_fused_plain(blocks, w0, h, b0, tail, pts)
            for label, g, w in (("out", got[0], want[0]), ("window re", got[1][0], want[1][0]),
                                ("window im", got[1][1], want[1][1]), ("tail", got[2], want[2])):
                check(bool(torch.isfinite(g).all()), f"{label} finite at {pts},{nparts},{nb}")
                err = float((g - w).abs().max())
                rel = err / float(w.abs().max())
                worst = max(worst, rel)
                check(rel <= TOL, f"kernel vs twin {label} at pts={pts} nparts={nparts} "
                                  f"nb={nb} b0={b0}: {rel:.3e} > {TOL}")
                if (pts, nparts, nb) == headline and label == "out":
                    headline_err = max(headline_err, err)
    print(f"phase 3 kernel vs twin: shapes (pts,nparts,nb) {shapes} x b0 {{1,2}}; "
          f"worst rel err {worst:.3e} (tol {TOL}); headline out max_abs_err "
          f"{headline_err:.3e}", flush=True)

    # phase 4: main path, convolve() on the card, against scipy in float64
    x = (0.1 * rng.standard_normal(int(20 * SR))).astype(np.float32)
    decay = np.exp(-np.arange(IR_LEN) / (0.5 * SR))
    ir = (rng.standard_normal(IR_LEN) * decay).astype(np.float32)
    x_d, ir_d = torch.from_numpy(x).to(dev), torch.from_numpy(ir).to(dev)
    S.LAUNCHES = 0
    y = P.convolve(x_d, ir_d, PTS)
    torch.cuda.synchronize()
    main_launches = S.LAUNCHES
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
    blocks = torch.from_numpy(
        (0.1 * rng.standard_normal((SCAN_BLOCKS, PTS))).astype(np.float32)).to(dev)
    stream_ms = cuda_ms(lambda: P.pconv_stream(cfg, state, blocks), reps=15)
    w0 = (state.spec_x_re[:cfg.nparts].contiguous(), state.spec_x_im[:cfg.nparts].contiguous())
    h = (state.spec_h_re, state.spec_h_im)
    kernel_ms = cuda_ms(lambda: S.stream_steps_fused(blocks, w0, h, 2.0, state.tail, PTS),
                        reps=15)
    plain_ms = cuda_ms(lambda: S.stream_steps_fused_plain(blocks, w0, h, 2.0, state.tail, PTS),
                       warmup=1, reps=5)
    audio_s = SCAN_BLOCKS * PTS / SR
    rtf = audio_s / (stream_ms / 1e3)
    print(f"phase 6 timing [{card}]: pconv_stream {SCAN_BLOCKS}x{PTS} blocks, {IR_LEN} taps: "
          f"{stream_ms:.4f} ms/scan = {rtf:.1f}x real time ({1e3 * stream_ms / SCAN_BLOCKS:.4f} "
          f"us/block); stream_steps_fused kernel {kernel_ms:.4f} ms/scan; plain twin "
          f"{plain_ms:.4f} ms/scan (median CUDA-event times)", flush=True)

    print(json.dumps({"kernels": [{
        "name": "stream_steps_fused", "route": "cuda",
        "source": "opencl_fft_tpu_torch/csrc/streamstep.cu",
        "replaces": "opencl_fft_tpu/ops/pallas/streamstep.py:149",
        "launches": main_launches, "max_abs_err": headline_err,
        "ms": kernel_ms, "plain_ms": plain_ms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
