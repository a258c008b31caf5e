"""Time the entry points whose forward transform is the float32 table
product of ``ops/pconv._forward_partition`` at the JAX bench's shapes
(PERF.md §4 cells 6, 7, 8, 11, 15 and 17, and ``Convolver.push_ir``), by
CUDA events on the card, and compare checkouts of the repository in one
run::

    python3 -m opencl_fft_tpu_torch.bench.paths [--tree DIR ...] [--reps N] [--out FILE]

Each ``--tree`` (a checkout's root; default: the one holding this file)
runs in a process of its own with that checkout's package first on
``sys.path``, in the order given, so ``--tree A --tree B --tree B --tree A``
shows the drift between runs beside the difference. Every tree is timed by
this file's code. Each run prints one JSON line (and appends it to
``--out``): the card's name and power limit, the package it imported, and
the median milliseconds of each path. ``pconv_step`` runs no table product
and is the control. Where the package has ``utils.numerics.exact_matmul``,
the forward product alone is also timed by three routes at the cells' row
counts: float32 as given with TF32 off, ``exact_matmul`` against the
table's float64 copy, ``exact_matmul`` against the float32 table (widened
a call), and the transform chain that larger pts take.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
from pathlib import Path

SR = 48000.0
PTS = 512
IR_LEN = 1 << 17
SCAN_BLOCKS = 1880
SERVE_CH, SERVE_BLOCKS = 64, 470
CHUNK_K, CHUNK_BLOCKS = 8, 472
ROOT = Path(__file__).resolve().parents[2]


def cuda_ms(fn, warmup=2, reps=7, calls=1):
    """Median milliseconds of one fn() over reps runs of ``calls`` calls
    back to back, by CUDA events."""
    import torch

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


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def worker(tree: str, reps: int) -> dict:
    """Time every path with the package of the checkout at ``tree``."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    import torch.distributed as dist

    import opencl_fft_tpu_torch as P
    import opencl_fft_tpu_torch.parallel as PL
    from opencl_fft_tpu_torch.ops import pconv as PC
    from opencl_fft_tpu_torch.ops.cuda import _build
    from opencl_fft_tpu_torch.ops.decomposed import stream_decomposed

    if not Path(P.__file__).resolve().is_relative_to(Path(tree).resolve()):
        raise RuntimeError(f"imported {P.__file__}, not the package of {tree}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from concurrent.futures import ThreadPoolExecutor
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    with ThreadPoolExecutor(len(names)) as ex:
        list(ex.map(_build.load, names))

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    def f(*shape, s=1.0):
        return torch.from_numpy((s * rng.standard_normal(shape)).astype(np.float32)).to(dev)

    decay = torch.from_numpy(np.exp(-np.arange(IR_LEN) / (0.5 * SR)).astype(np.float32)).to(dev)
    ir = f(IR_LEN, s=0.05) * decay
    irs = f(SERVE_CH, IR_LEN, s=0.05) * decay
    cfg = P.PconvConfig.for_ir_length(IR_LEN, PTS)
    state = P.push_ir(cfg, P.pconv_init(cfg, dev), ir)
    blocks, bh = f(SCAN_BLOCKS, PTS, s=0.1), f(SCAN_BLOCKS, PTS, s=0.1)
    sbx = f(SERVE_BLOCKS, SERVE_CH, PTS, s=0.1)
    chk = f(CHUNK_BLOCKS, SERVE_CH, PTS, s=0.1)
    h_chk = irs.reshape(SERVE_CH, cfg.nparts, PTS)[
        :, torch.arange(CHUNK_BLOCKS, device=dev) % cfg.nparts].transpose(0, 1).contiguous()

    def conv(nch, c=cfg):
        cv = P.Convolver(c, nch, device=dev)
        cv.push_ir(irs[:nch])
        return cv

    conv16, conv64 = conv(16), conv(SERVE_CH)
    sbx16 = sbx[:, :16].contiguous()
    st_tv = P.push_ir(cfg, P.batched_state(cfg, SERVE_CH, dev), irs)
    cfg_bf = P.PconvConfig.for_ir_length(IR_LEN, PTS, ring_dtype="bf16")
    conv_bf = conv(SERVE_CH, cfg_bf)
    one_bf = P.push_ir(cfg_bf, P.pconv_init(cfg_bf, dev), ir)

    def chunked(c, st, xb):
        for c0 in range(0, xb.shape[0], CHUNK_K):
            st, _ = PC.pconv_chunk(c, st, xb[c0:c0 + CHUNK_K])
        return st

    ms = {
        "pconv_step C=1 (control: no table product)":
            cuda_ms(lambda: P.pconv_step(cfg, state, blocks[0]), reps=reps, calls=10),
        "cell 6 pconv_offline 1x1880": cuda_ms(lambda: P.pconv_offline(cfg, state, blocks),
                                               reps=reps),
        "cell 7 Convolver(16).render 470": cuda_ms(lambda: conv16.render(sbx16), reps=reps),
        "cell 7 Convolver(64).render 470": cuda_ms(lambda: conv64.render(sbx), reps=reps),
        "cell 8 pconv_stream_batched_chunked K=8 64x472": cuda_ms(
            lambda: P.pconv_stream_batched_chunked(cfg, conv64.state, chk, K=CHUNK_K),
            warmup=1, reps=max(3, reps // 2)),
        "cell 11 stream_decomposed TV 1x1880": cuda_ms(
            lambda: stream_decomposed(cfg, state, blocks, bh), reps=reps),
        "cell 11 pconv_stream_batched_tv_chunked K=8 64x472": cuda_ms(
            lambda: P.pconv_stream_batched_tv_chunked(cfg, st_tv, chk, h_chk, K=CHUNK_K),
            warmup=1, reps=max(3, reps // 2)),
        "cell 15 bf16 Convolver(64).stream 470": cuda_ms(lambda: conv_bf.stream(sbx), warmup=1,
                                                         reps=max(3, reps // 2)),
        "cell 15 bf16 pconv_chunk K=8 1x1880": cuda_ms(lambda: chunked(cfg_bf, one_bf, blocks),
                                                       warmup=1, reps=max(3, reps // 2)),
        "Convolver(64).push_ir 2^17 taps": cuda_ms(lambda: conv64.push_ir(irs), reps=reps),
    }

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = PL.make_mesh()
        st_sh = PL.sharded_push_ir(cfg, mesh, PL.shard_state(
            PL.sharded_pconv_init(cfg, SERVE_CH), mesh), irs)
        st_sh_tv = PL.shard_state(PL.sharded_pconv_init(cfg, SERVE_CH), mesh)
        step = PL.make_sharded_pconv_step(cfg, mesh, tv=False)
        step_tv = PL.make_sharded_pconv_step(cfg, mesh, tv=True)
        ms["cell 17 sharded LTI step 64 ch, world 1"] = cuda_ms(
            lambda: step(st_sh, sbx[0]), reps=reps, calls=10)
        ms["cell 17 sharded TV step 64 ch, world 1"] = cuda_ms(
            lambda: step_tv(st_sh_tv, sbx[0], sbx[1]), reps=reps, calls=10)
    finally:
        dist.destroy_process_group()

    products = None
    try:
        from opencl_fft_tpu_torch.utils.numerics import exact_matmul
    except ImportError:
        exact_matmul = None
    if exact_matmul is not None:
        from opencl_fft_tpu_torch.ops.cuda.tables import fwd_table
        t32 = fwd_table(PTS, dev)
        t64 = t32.double()
        from opencl_fft_tpu_torch.ops.rfft import rfft_split
        products = {}
        for label, rows in (("1880 rows (cell 6)", SCAN_BLOCKS),
                            ("7520 rows (cell 7, 16 ch)", 16 * SERVE_BLOCKS),
                            ("16384 rows (push_ir, 64 ch)", SERVE_CH * cfg.nparts),
                            ("30080 rows (cell 7, 64 ch)", SERVE_CH * SERVE_BLOCKS)):
            a = f(rows, PTS, s=0.1)
            products[label] = {
                "float32 as given, TF32 off": cuda_ms(lambda: a @ t32, reps=reps),
                "exact_matmul, float64 table": cuda_ms(lambda: exact_matmul(a, t64), reps=reps),
                "exact_matmul, float32 table widened a call": cuda_ms(
                    lambda: exact_matmul(a, t32), reps=reps),
                "the transform chain (rfft_split of the zero-padded frame)": cuda_ms(
                    lambda: rfft_split(torch.cat([a, torch.zeros_like(a)], -1), "auto",
                                       unnormalized=True), reps=reps),
            }
    return {"tree": tree, "package": P.__file__, "card": _card(),
            "device": torch.cuda.get_device_name(0), "ms": ms, "products_ms": products}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="a checkout's root, timed in the order given (repeatable)")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--out", default="", help="append each run's JSON line here")
    ap.add_argument("--worker", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.reps)), flush=True)
        return
    runs = []
    for tree in args.tree or [str(ROOT)]:
        tree = str(Path(tree).resolve())
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--worker", tree, "--reps", str(args.reps)],
                              cwd=tree, capture_output=True, text=True, timeout=1800,
                              env={**os.environ, "PYTHONPATH": tree})
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            raise SystemExit(f"the run of {tree} failed (exit {proc.returncode})")
        line = proc.stdout.strip().splitlines()[-1]
        runs.append(json.loads(line))
        print(line, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
    print(f"card: {runs[0]['card']}; ms by run ({', '.join(Path(r['tree']).name for r in runs)})")
    for key in runs[0]["ms"]:
        print(f"  {key}: " + " / ".join(f"{r['ms'][key]:.4f}" for r in runs))


if __name__ == "__main__":
    main()
