"""Benchmark sweep harness — the analog of the reference's csound/tests.py,
ported from the JAX package's ``bench/sweep.py``.

The reference times `cltvconv` against the CPU `tvconv` for 100 s of audio
across devices x partition sizes M in {2^9, 2^11, 2^13, 2^15} x IR lengths
L in {2^16..2^22}, then writes a real-time-ratio plot and a LaTeX table
(csound/tests.py:10-76). This module runs that sweep for the port:

  * the workload is the time-varying partitioned convolver (the engine
    `cltvconv` drives): ``pconv_stream_tv`` (``pconv_stream`` with
    ``--lti``), whose scans run on the whole-scan kernels (#2/#1 up to
    pts 2048, the split scans' entries #6/#5 above);
  * the metric is the real-time ratio dur/elapsed (tests.py:33), each
    point timed by CUDA events over k chained scans from a state copied on
    the card, through ``utils.profiling.median_chain_delta``;
  * outputs: ``<out>.json`` (all points), ``<out>_table.tex`` (the
    table.tex analog, tests.py:70-76) and ``<out>_plot.csv`` (RT ratio vs
    log2(L) per partition size; a PNG too when matplotlib is installed).

Run:  python3 -m opencl_fft_tpu_torch.bench.sweep [--quick] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from functools import partial
from typing import Optional

import numpy as np
import torch

SR = 44100.0          # the reference benches at sr=44100 (tests.csd:3)
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
FLOOR_MARGIN = 5.0            # the floor is this many times generous


class Unmeasurable(RuntimeError):
    """The timing delta at this point never cleared the physical floor
    after retries; the point is OMITTED rather than shipped (never a
    clamped delta)."""


def floor_per_block(cfg, scan_blocks: int, tv: bool) -> float:
    """The least seconds a block can take on the H100, FLOOR_MARGIN times
    generous: the bytes a scan of the port's route must move (the state's
    rings read and written once, the doubled input ring 2 nparts rows and
    the IR ring nparts rows of re and im at bins each, and each block read
    and its output written; TV reads a second block) over HBM's rate, per
    block."""
    ring_bytes = 2 * 4 * cfg.bins * (2 * cfg.nparts + cfg.nparts) * 2
    block_bytes = 4 * cfg.pts * (3 if tv else 2)
    return (ring_bytes / scan_blocks + block_bytes) / (FLOOR_MARGIN * HBM_BYTES_PER_S)


def _scan(cfg, tv: bool):
    from ..ops import pconv as P
    return partial(P.pconv_stream_tv if tv else P.pconv_stream, cfg)


def rt_ratio(pts: int, ir_len: int, scan_blocks: int = 512, reps: int = 4,
             tv: bool = True, device=None) -> float:
    """Real-time ratio of the (TV) partitioned convolver at one sweep point,
    on the card (``device=None``) or the CPU (``device="cpu"``)."""
    from ..ops import pconv as P
    from ..utils.devices import get_device
    from ..utils.profiling import chain_seconds, median_chain_delta

    dev = get_device(0, device, on_message=lambda m, u: None)
    cfg = P.PconvConfig.for_ir_length(ir_len, pts)
    rng = np.random.default_rng(0)
    base = P.pconv_init(cfg, dev)
    blocks = torch.from_numpy((rng.standard_normal((scan_blocks, pts)) * 0.1)
                              .astype(np.float32)).to(dev)
    args = (blocks, blocks) if tv else (blocks,)
    step = _scan(cfg, tv)

    def fresh():                              # a copy of the state on the device
        return base._replace(**{k: v.clone() for k, v in base._asdict().items()
                                if isinstance(v, torch.Tensor)})

    def timed(k):
        return chain_seconds(lambda st: step(st, *args)[0], fresh(), k)

    timed(1)                                  # load the kernels, warm the caches
    floor = floor_per_block(cfg, scan_blocks, tv)
    delta, n = median_chain_delta(timed, reps, floor * scan_blocks,
                                  tries=4, min_chain_s=0.05)
    if delta is None:
        raise Unmeasurable(f"M={pts} L={ir_len}: only {n} delta(s) above the floor "
                           f"after retries")
    per_block = delta / scan_blocks
    return (pts / SR) / per_block


def cpu_rt_ratio_inprocess(pts: int, ir_len: int, scan_blocks: int = 32,
                           repeats: int = 3, tv: bool = True) -> float:
    """Real-time ratio of the SAME workload on the CPU (the port's own
    engine with ``device="cpu"``): the comparison-oracle arm of the
    reference's benchmark (its published table is GPU vs the CPU `tvconv`
    opcode on the identical signal path, csound/tests.py:19-34,
    tests.csd:14-18). Wall-clock timing, min over repeats."""
    from ..ops import pconv as P

    cfg = P.PconvConfig.for_ir_length(ir_len, pts)
    rng = np.random.default_rng(0)
    blocks = torch.from_numpy((rng.standard_normal((scan_blocks, pts)) * 0.1)
                              .astype(np.float32))
    args = (blocks, blocks) if tv else (blocks,)
    step = _scan(cfg, tv)
    step(P.pconv_init(cfg, "cpu"), *args)    # warm
    best = float("inf")
    for _ in range(repeats):
        st = P.pconv_init(cfg, "cpu")
        t0 = time.perf_counter()
        step(st, *args)
        best = min(best, time.perf_counter() - t0)
    return (pts / SR) / (best / scan_blocks)


def measure_cpu_oracle(parts_list, ir_list, out_path, tv=True):
    """CPU timings for every grid point, in this process (the port's CPU
    engine needs no platform of its own). Results merge into ``out_path``;
    points already present are kept (CPU numbers do not drift)."""
    try:
        with open(out_path) as f:
            cpu = json.load(f)
    except (OSError, json.JSONDecodeError):
        cpu = {}
    for pts in parts_list:
        for L in ir_list:
            if L < pts:
                continue
            key = f"M={pts},L=2^{int(np.log2(L))}"
            if key in cpu:
                continue
            cpu[key] = round(cpu_rt_ratio_inprocess(pts, L, tv=tv), 1)
            print(f"  cpu-oracle {key}: {cpu[key]:.1f}x realtime", file=sys.stderr,
                  flush=True)
            with open(out_path, "w") as f:
                json.dump(cpu, f, indent=2)
    return cpu


_HISTORY_KEEP = 9      # pooled drift windows per published point


def _code_fingerprint() -> str:
    """Hash of the code a point's time depends on: the port's ``ops/``
    (``*.py``) and ``csrc/`` (the CUDA sources). History windows are
    stamped with it; a window measured under other code is discarded
    instead of pooled into the published medians."""
    import hashlib
    import os

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    h = hashlib.sha256()
    for sub, exts in (("ops", (".py",)), ("csrc", (".cu", ".cuh"))):
        root = os.path.join(pkg, sub)
        for dirpath, _dirs, files in sorted(os.walk(root)):
            if "__pycache__" in dirpath:
                continue
            for fn in sorted(files):
                if fn.endswith(exts):
                    with open(os.path.join(dirpath, fn), "rb") as f:
                        h.update(fn.encode())
                        h.update(f.read())
    return h.hexdigest()[:16]


def _load_history(hist_path: str, fp: str) -> dict:
    """history file -> {key: [windows]}, dropping stale-fingerprint
    entries AND legacy un-stamped lists. (r5 initially grandfathered the
    legacy format; a --repeats 0 artifact regen then re-stamped those
    stale-methodology windows with the current fingerprint, silently
    pooling them into fresh measurements — exactly the laundering the
    stamp exists to prevent. Unstamped windows are now discarded.)"""
    try:
        with open(hist_path) as f:
            raw = json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}
    out = {}
    stale = []
    for k, v in raw.items():
        if isinstance(v, dict) and v.get("fp") == fp:
            out[k] = v.get("windows", [])
        else:
            stale.append(k)
    if stale:
        print(f"  history: discarded {len(stale)} stale-fingerprint "
              f"point(s) (code changed since they were measured): "
              f"{', '.join(sorted(stale)[:6])}"
              f"{'...' if len(stale) > 6 else ''}",
              file=sys.stderr, flush=True)
    return out


def run_sweep(parts_list, ir_list, tv=True, out_prefix="sweep",
              row_repeats=2, merge_json=None, reset_history=False, device=None):
    """Measure the grid on ``device`` (None: the card). Each M-row is swept
    row_repeats times end-to-end; each point's published value is the
    MEDIAN of its pooled window estimates, then the row is checked for
    monotonicity: RT
    ratio must be non-increasing in L (longer IR, strictly more work per
    block). Inversions get extra estimates on both endpoints and a
    re-median; survivors are reported to stderr rather than silently
    shipped.

    Cross-RUN window pooling: per-window estimates persist in
    `<out_prefix>_history.json` and each re-run APPENDS its estimates,
    publishing the median of the last _HISTORY_KEEP windows, so one slow
    window (another process on the card, a clock change) cannot publish a
    point alone. reset_history=True (--reset-history) clears the measured rows'
    history first — REQUIRED after a code change that alters those
    rows' kernels (stale windows describe the old program).

    merge_json: path to a prior sweep.json — its points seed the result
    table so a single re-measured row (--row) refreshes the full-grid
    artifacts without re-running every point. Re-measured points REPLACE
    the stale entries; a point that comes back Unmeasurable in every
    pass falls back to its prior value (kept, with a stderr note) rather
    than leaving a hole where data existed."""
    results = {}
    prior_row = {}
    if merge_json:
        with open(merge_json) as f:
            results.update(json.load(f))
        for pts in parts_list:                 # stale row: fully replace
            for L in ir_list:
                if L < pts:
                    continue      # mirror the Ls filter below: a prior
                    # point outside the measured set must not be popped
                    # (it would never be re-added -> silent data loss)
                old = results.pop(f"M={pts},L=2^{int(np.log2(L))}", None)
                if old is not None:
                    prior_row[(pts, L)] = old
    hist_path = f"{out_prefix}_history.json"
    fp = _code_fingerprint()
    history = _load_history(hist_path, fp)
    for pts in parts_list:
        Ls = [L for L in ir_list if L >= pts]
        if reset_history:
            for L in Ls:
                history.pop(f"M={pts},L=2^{int(np.log2(L))}", None)
        est = {L: [] for L in Ls}              # this run's estimates
        broken = set()                         # points that fail to run
        for _ in range(row_repeats):           # one slow window cannot
            for L in Ls:                       # poison a point
                if L in broken:
                    continue
                try:
                    est[L].append(rt_ratio(pts, L, tv=tv, device=device))
                except Unmeasurable:
                    continue                 # other repeats cover the point
                except Exception as e:       # e.g. out of device memory: one
                    broken.add(L)            # bad point must not kill the
                    print(f"  M={pts} L=2^{int(np.log2(L))}: FAILED "
                          f"({str(e)[:160]})", file=sys.stderr, flush=True)
                    continue                 # row's artifacts
        def pooled(L):
            key = f"M={pts},L=2^{int(np.log2(L))}"
            return (history.get(key, []) + est[L])[-_HISTORY_KEEP:]

        row = {L: float(np.median(pooled(L))) for L, v in est.items() if v}
        for L in Ls:
            if est[L]:
                print(f"  M={pts} L=2^{int(np.log2(L))}: run estimates "
                      f"{[round(v, 1) for v in est[L]]}, pooled "
                      f"{[round(v, 1) for v in pooled(L)]}",
                      file=sys.stderr, flush=True)
        # monotonicity repair: an out-of-order point means one window's
        # drift still dominates its median — add estimates, re-median
        for _ in range(2):
            bad = set()                        # either side may be off
            for i in range(len(Ls) - 1):
                if (Ls[i] in row and Ls[i + 1] in row
                        and row[Ls[i + 1]] > row[Ls[i]] * 1.15):
                    bad.update((Ls[i], Ls[i + 1]))
            if not bad:
                break
            for L in sorted(bad):
                if L in broken:
                    continue
                try:
                    est[L].append(rt_ratio(pts, L, tv=tv, device=device))
                except Unmeasurable:
                    continue
                except Exception:
                    broken.add(L)
                    continue
                row[L] = float(np.median(pooled(L)))
        for i in range(len(Ls) - 1):
            if (Ls[i] in row and Ls[i + 1] in row
                    and row[Ls[i + 1]] > row[Ls[i]] * 1.15):
                print(f"  WARNING: M={pts} row non-monotone at "
                      f"L=2^{int(np.log2(Ls[i]))} after re-measures",
                      file=sys.stderr, flush=True)
        for L in Ls:
            if L not in row:
                if L in broken:
                    # deterministic failure (a build or launch error), not
                    # a timing glitch: re-shipping the prior value would advertise
                    # throughput for a config that cannot currently run
                    print(f"  M={pts} L=2^{int(np.log2(L))}: DROPPED "
                          f"(point fails to compile/run; prior value NOT "
                          f"carried over)", file=sys.stderr, flush=True)
                    continue
                if (pts, L) in prior_row:      # keep prior data over a hole
                    row[L] = prior_row[(pts, L)]
                    print(f"  M={pts} L=2^{int(np.log2(L))}: unmeasurable "
                          f"this run — KEPT prior value "
                          f"{row[L]:.1f}x", file=sys.stderr, flush=True)
                else:
                    print(f"  M={pts} L=2^{int(np.log2(L))}: unmeasurable "
                          f"(timing never cleared the floor)", file=sys.stderr, flush=True)
                    continue
            results[f"M={pts},L=2^{int(np.log2(L))}"] = round(row[L], 1)
            print(f"  M={pts:6d} L=2^{int(np.log2(L)):2d}: "
                  f"{row[L]:10.1f}x realtime", file=sys.stderr, flush=True)
        for L in Ls:                           # persist this run's windows
            if est[L]:
                key = f"M={pts},L=2^{int(np.log2(L))}"
                history[key] = [round(v, 1) for v in pooled(L)]

    with open(hist_path, "w") as f:
        json.dump({k: {"fp": fp, "windows": v} for k, v in history.items()},
                  f, indent=2)
    with open(f"{out_prefix}.json", "w") as f:
        json.dump(results, f, indent=2)

    # artifacts cover every point in the (possibly merged) result table
    all_parts = sorted({int(k.split(",")[0][2:]) for k in results})
    all_irs = sorted({1 << int(k.split("=2^")[1]) for k in results})
    parts_list = sorted(set(parts_list) | set(all_parts))
    ir_list = sorted(set(ir_list) | set(all_irs))

    # table.tex analog (tests.py:70-76): rows = partition sizes, cols = L.
    # When the CPU-oracle arm has been measured (--cpu-oracle ->
    # <prefix>_cpu.json), each M additionally gets a CPU row and a
    # card/CPU speedup row — the reference's published table is exactly
    # this device-vs-`tvconv` comparison (tests.csd:14-18).
    try:
        with open(f"{out_prefix}_cpu.json") as f:
            cpu = json.load(f)
    except (OSError, json.JSONDecodeError):
        cpu = {}
    with open(f"{out_prefix}_table.tex", "w") as f:
        cols = " & ".join(f"$2^{{{int(np.log2(L))}}}$" for L in ir_list)
        f.write("\\begin{tabular}{l" + "r" * len(ir_list) + "}\n")
        f.write(f"M / L & {cols} \\\\\n\\hline\n")
        for pts in parts_list:
            vals, cvals, rvals = [], [], []
            for L in ir_list:
                key = f"M={pts},L=2^{int(np.log2(L))}"
                vals.append(f"{results[key]:.0f}" if key in results else "--")
                cvals.append(f"{cpu[key]:.0f}" if key in cpu else "--")
                rvals.append(f"{results[key] / cpu[key]:.1f}"
                             if key in results and cpu.get(key) else "--")
            f.write(f"{pts} & " + " & ".join(vals) + " \\\\\n")
            if any(v != "--" for v in cvals):
                f.write(f"{pts} (cpu) & " + " & ".join(cvals) + " \\\\\n")
                f.write(f"{pts} (speedup) & " + " & ".join(rvals)
                        + " \\\\\n")
        f.write("\\end{tabular}\n")

    # plot.csv: RT ratio vs log2(L), one column per M (plot.eps analog)
    with open(f"{out_prefix}_plot.csv", "w") as f:
        f.write("log2L," + ",".join(f"M{p}" for p in parts_list) + "\n")
        for L in ir_list:
            row = [str(int(np.log2(L)))]
            for pts in parts_list:
                key = f"M={pts},L=2^{int(np.log2(L))}"
                row.append(str(results.get(key, "")))
            f.write(",".join(row) + "\n")

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots()
        for pts in parts_list:
            xs, ys = [], []
            for L in ir_list:
                key = f"M={pts},L=2^{int(np.log2(L))}"
                if key in results:
                    xs.append(int(np.log2(L)))
                    ys.append(results[key])
            ax.plot(xs, ys, marker="o", label=f"M={pts}")
        ax.set_xlabel("log2(IR length)")
        ax.set_ylabel("x real time")
        ax.set_yscale("log")
        ax.legend()
        fig.savefig(f"{out_prefix}_plot.png", dpi=120)
        plt.close(fig)
    except Exception:
        pass                                        # CSV is the durable output

    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="small sweep (CI-sized)")
    ap.add_argument("--lti", action="store_true",
                    help="bench the LTI engine instead of time-varying")
    ap.add_argument("--row", type=int, default=0,
                    help="re-measure ONE partition-size row only")
    ap.add_argument("--merge", default="",
                    help="prior sweep.json to seed un-re-measured points")
    ap.add_argument("--out", default="sweep", help="artifact path prefix")
    ap.add_argument("--repeats", type=int, default=3,
                    help="end-to-end row sweeps (median kept per point)")
    ap.add_argument("--reset-history", action="store_true",
                    help="clear the measured rows' pooled window history "
                         "first (REQUIRED after a code change that alters "
                         "those rows' kernels)")
    ap.add_argument("--cpu-oracle", action="store_true",
                    help="also measure the CPU comparison arm (the port's "
                         "engine on the CPU, each missing grid point; merged "
                         "into <out>_cpu.json and the table.tex "
                         "speedup rows)")
    ap.add_argument("--device", default=None,
                    help="where to sweep: the card (default) or cpu")
    args = ap.parse_args()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    if args.row:
        parts = [args.row]
        irs = [1 << k for k in range(16, 23)]
    elif args.quick:
        parts = [1 << 9, 1 << 11]
        irs = [1 << 16, 1 << 18]
    else:
        # the reference grid: tests.py:10,12
        parts = [1 << 9, 1 << 11, 1 << 13, 1 << 15]
        irs = [1 << k for k in range(16, 23)]
    if args.device != "cpu":
        import subprocess

        from ..utils.devices import get_device
        dev = get_device(0, args.device, on_message=lambda m, u: None)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip()
        print(f"sweep on {torch.cuda.get_device_name(dev)}; nvidia-smi: {smi}",
              file=sys.stderr, flush=True)
    if args.cpu_oracle:
        measure_cpu_oracle(parts, irs, f"{args.out}_cpu.json",
                           tv=not args.lti)
    run_sweep(parts, irs, tv=not args.lti, out_prefix=args.out,
              row_repeats=args.repeats, merge_json=args.merge or None,
              reset_history=args.reset_history, device=args.device)


if __name__ == "__main__":
    main()
