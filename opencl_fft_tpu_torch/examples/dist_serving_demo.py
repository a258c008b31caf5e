"""Distributed serving demo on the port: a multi-channel convolution farm
sharded over a (dp, tp) mesh of ranks with the ``parallel.sharded``
engines.

The reference scales by running one OpenCL context per device and placing
opcode instances by hand (csound/opcode.cpp builds a context per instance;
csound/tests.py sweeps --device to bench each one). Here it is a sharding:
one program per rank (``torch.distributed``), channels split across the
data-parallel axis and each channel's partition ring across the
tensor-parallel axis, with one all_reduce of O(pts) floats a block over tp.

The ranks are started with ``parallel.dryrun.run_ranks``, one a card
(NCCL); ``render(ranks=n)`` with more ranks than cards shares them over
gloo, and on the CPU the ranks run gloo (one rank unless asked for more).
Channel 0 is held against the single-device ``pconv_stream`` to 3e-5 of
max(1, its scale).

Run:  python -m opencl_fft_tpu_torch.examples.dist_serving_demo [channels] [blocks] [--device cuda|cuda:i|cpu]
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops import pconv as P
from ..parallel.dryrun import pick_backend, run_ranks
from ..parallel.mesh import balanced_shape, make_mesh
from ..parallel.sharded import (make_sharded_pconv_step, shard_state, sharded_pconv_init,
                                sharded_push_ir)
from ..utils.devices import get_device
from ._common import command_line, quiet

SR = 48000.0
TOL = 3e-5


def inputs(channels: int, nblocks: int, pts: int, nparts: int
           ) -> Tuple[P.PconvConfig, np.ndarray, np.ndarray]:
    """(config, IRs (channels, cvs), blocks (nblocks, channels, pts)), made
    from seed 0."""
    cfg = P.PconvConfig.for_ir_length(pts * nparts, pts)
    rng = np.random.default_rng(0)
    irs = (rng.standard_normal((channels, cfg.cvs)) * 0.2).astype(np.float32)
    blocks = (rng.standard_normal((nblocks, channels, pts)) * 0.1).astype(np.float32)
    return cfg, irs, blocks


def mesh_shape(ranks: int, channels: int, nparts: int) -> Tuple[int, int]:
    """``balanced_shape(ranks)``, dp halved until it divides the channels
    and tp until it divides the partitions (the ranks left over idle)."""
    dp, tp = balanced_shape(ranks)
    while dp > 1 and channels % dp:
        dp //= 2
    while tp > 1 and nparts % tp:
        tp //= 2
    return dp, tp


def serve_rank(shape: Tuple[int, int], channels: int, nblocks: int, pts: int, nparts: int,
               device: str) -> Dict[str, object]:
    """One rank of the farm (the process group is up): its dp block of
    channels streamed block by block through the sharded LTI step, each
    block's output copied to the host. Returns its rows, outputs
    (nblocks, rows, pts) and the seconds of the stream."""
    mesh = make_mesh(shape, dist.get_backend(), device)
    cfg, irs, blocks = inputs(channels, nblocks, pts, nparts)
    rows = mesh.rows(channels)
    dev = mesh.device
    state = shard_state(sharded_pconv_init(cfg, channels), mesh)
    state = sharded_push_ir(cfg, mesh, state, torch.from_numpy(irs[rows]).to(dev))
    step = make_sharded_pconv_step(cfg, mesh, tv=False)
    xs = torch.from_numpy(np.ascontiguousarray(blocks[:, rows])).to(dev)
    outs = []
    t0 = time.perf_counter()
    for b in range(nblocks):
        state, out = step(state, xs[b])
        outs.append(out.cpu().numpy())
    return {"rows": (rows.start, rows.stop), "out": np.stack(outs),
            "seconds": time.perf_counter() - t0}


def render(channels: int = 8, nblocks: int = 32, pts: int = 128, nparts: int = 16,
           ranks: Optional[int] = None, device=None) -> Dict[str, object]:
    """Stream the farm on ``ranks`` ranks (default: one a card, or one on
    the CPU) on ``device`` (None: the card). Returns the mesh shape, the
    backend, the outputs (nblocks, channels, pts) and the slowest rank's
    seconds."""
    dev = get_device(device=device, on_message=quiet)
    if ranks is None:
        ranks = torch.cuda.device_count() if dev.type == "cuda" else 1
    dp, tp = mesh_shape(ranks, channels, nparts)
    backend = pick_backend(dp * tp, None, dev.type)
    results = run_ranks(dp * tp, serve_rank, (dp, tp), channels, nblocks, pts, nparts,
                        dev.type, backend=backend)
    outs = np.zeros((nblocks, channels, pts), np.float32)
    for r in results:
        outs[:, slice(*r["rows"])] = r["out"]
    return {"shape": (dp, tp), "backend": backend, "device": dev, "out": outs,
            "seconds": max(r["seconds"] for r in results)}


def run(channels: int = 8, nblocks: int = 32, pts: int = 128, nparts: int = 16,
        ranks: Optional[int] = None, device=None, verbose: bool = True) -> Dict[str, object]:
    """Stream ``nblocks`` blocks through the sharded farm and cross-check
    channel 0 against the single-device engine: ``render``'s result with
    channel 0's max abs error (``err``), its reference's scale and
    ``rel`` = err / max(1, scale)."""
    res = render(channels, nblocks, pts, nparts, ranks, device)
    dev = res["device"]
    dp, tp = res["shape"]
    cfg, irs, blocks = inputs(channels, nblocks, pts, nparts)
    st0 = P.push_ir(cfg, P.pconv_init(cfg, dev), torch.from_numpy(irs[0]).to(dev))
    _, ref = P.pconv_stream(cfg, st0, torch.from_numpy(blocks[:, 0]).to(dev))
    ref = ref.cpu().numpy()
    err = float(np.max(np.abs(res["out"][:, 0] - ref)))
    scale = float(np.max(np.abs(ref))) or 1.0
    if verbose:
        elapsed = res["seconds"]
        audio_s = nblocks * pts / SR * channels
        ndev = torch.cuda.device_count() if dev.type == "cuda" else 1
        print(f"devices: {ndev} ({dev.type}), mesh dp={dp} x tp={tp} "
              f"({dp * tp} {res['backend']} ranks), channels={channels}, "
              f"ring {nparts} x {pts}")
        print(f"streamed {nblocks} blocks x {channels} ch in "
              f"{elapsed:.2f}s ({audio_s / elapsed:.1f} audio-s/s "
              f"aggregate; per-block dispatch with a host copy a block)")
        print(f"channel-0 vs single-device engine: max err {err:.2e} "
              f"(scale {scale:.2e}) -> "
              f"{'PASS' if err <= TOL * max(1.0, scale) else 'FAIL'}")
    res.update(err=err, scale=scale, rel=err / max(1.0, scale))
    return res


def main(argv: Optional[Sequence[str]] = None) -> int:
    args, dev = command_line(__doc__, [("channels", int, 8), ("blocks", int, 32)], argv)
    return 1 if run(args.channels, args.blocks, device=dev)["rel"] > TOL else 0


if __name__ == "__main__":
    raise SystemExit(main())
