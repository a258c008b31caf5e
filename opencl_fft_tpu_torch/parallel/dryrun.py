"""Start ranks of one process group, and the multi-rank dry run.

``run_ranks`` spawns n processes, one rank each, that meet through a file
store in a fresh temporary directory (no fixed port, so several runs can
share a machine) and run one function. ``dryrun_multichip`` is the
counterpart of ``__graft_entry__.dryrun_multichip``: one sharded TV step of
the sharded convolver at the deployment shape (pts 512, nparts 256: a
2^17-tap IR; 8 channels) on the ``balanced_shape(n)`` mesh, held against the
unsharded ``pconv_step_tv`` channel by channel to 1e-4 of the output scale
(the tp all_reduce reorders the float32 partition sum), one
``sharded_fft``, and one ``dist_fft`` of 2^14 points over tp against numpy
to 3e-5 of max|ref|.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..ops import pconv as _p
from ..utils.errors import DeviceError, Status
from .dist_fft import dist_fft
from .mesh import balanced_shape, make_mesh
from .sharded import (make_sharded_pconv_step, shard_state, sharded_fft, sharded_pconv_init,
                      sharded_push_ir)

DRYRUN_PTS = 512
DRYRUN_NPARTS = 256
DRYRUN_BATCH = 8
DRYRUN_TOL = 1e-4
DRYRUN_FFT = 1 << 14
DRYRUN_FFT_TOL = 3e-5


def _rank_main(rank: int, n: int, backend: str, workdir: str):
    # the ranks meet on the loopback interface only
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)
    with open(os.path.join(workdir, "job.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    dist.init_process_group(backend, init_method="file://" + os.path.join(workdir, "store"),
                            rank=rank, world_size=n)
    try:
        result = fn(*args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_ranks(n: int, fn: Callable, *args, backend: str = "gloo",
              timeout: float = 600.0) -> List[Any]:
    """Run ``fn(*args)`` on n spawned ranks of one process group with
    ``backend``; returns each rank's result, in rank order.

    ``fn`` and ``args`` go to the ranks through a pickle file (not the
    spawn pipe, whose writes block on large arguments until each rank has
    started), so ``fn`` is a module-level function of a module the ranks can
    import (the spawn start method: a rank imports what it needs afresh). A
    rank's exception is raised here; every process is stopped before this
    returns, and TimeoutError after ``timeout`` seconds."""
    with tempfile.TemporaryDirectory() as workdir:
        with open(os.path.join(workdir, "job.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        ctx = mp.start_processes(_rank_main, args=(n, backend, workdir), nprocs=n,
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n} ranks of {getattr(fn, '__name__', fn)} did not "
                                       f"finish in {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(10)
        results = []
        for rank in range(n):
            with open(os.path.join(workdir, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def pick_backend(n: int, backend: Optional[str] = None, device: str = "cuda") -> str:
    """The backend for n ranks on ``device``: on the card NCCL, one card a
    rank, when there are at least n cards, else n gloo ranks sharing the
    cards with CUDA tensors (gloo takes them); on the CPU gloo. A backend
    named is taken as given. DeviceError when a card is asked for and there
    is none, ValueError when NCCL is named for more ranks than cards."""
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceError("failed to find a CUDA device!", Status.DEVICE_NOT_FOUND)
        cards = torch.cuda.device_count()
        if backend is None:
            return "nccl" if n <= cards else "gloo"
        if backend == "nccl" and n > cards:
            raise ValueError(f"NCCL takes one rank a card: {n} ranks, {cards} cards")
        return backend
    return backend or "gloo"


def _dryrun_rank(n: int, backend: str, device: str) -> Dict[str, Any]:
    """One rank of the dry run: its channels' sharded TV step and the
    unsharded steps of the same channels, as numpy."""
    mesh = make_mesh(balanced_shape(n), backend, device)
    dev = mesh.device
    cfg = _p.PconvConfig.for_ir_length(DRYRUN_PTS * DRYRUN_NPARTS, DRYRUN_PTS)
    rng = np.random.default_rng(0)
    ir = rng.standard_normal((DRYRUN_BATCH, cfg.cvs)).astype(np.float32)
    bx, bh = (rng.standard_normal((DRYRUN_BATCH, cfg.pts)).astype(np.float32) for _ in range(2))
    rows = mesh.rows(DRYRUN_BATCH)

    def mine(a):
        return torch.from_numpy(a[rows]).to(dev)

    state = sharded_push_ir(cfg, mesh, shard_state(sharded_pconv_init(cfg, DRYRUN_BATCH), mesh),
                            mine(ir))
    _, out = make_sharded_pconv_step(cfg, mesh, tv=True)(state, mine(bx), mine(bh))
    expect = []
    for c in range(rows.start, rows.stop):
        one = _p.push_ir(cfg, _p.pconv_init(cfg, dev), torch.from_numpy(ir[c]).to(dev))
        _, o = _p.pconv_step_tv(cfg, one, *(torch.from_numpy(b[c]).to(dev) for b in (bx, bh)))
        expect.append(o)
    x = torch.from_numpy(rng.standard_normal((2 * n, 256)).astype(np.float32)).to(dev)
    fr, fi = sharded_fft((x[mesh.rows(2 * n)], torch.zeros_like(x[mesh.rows(2 * n)])), mesh)
    z = (rng.standard_normal(DRYRUN_FFT)
         + 1j * rng.standard_normal(DRYRUN_FFT)).astype(np.complex64)
    ref = np.fft.fft(z.astype(np.complex128))
    y = dist_fft(z, mesh, axis="tp").cpu().numpy()
    return {"coords": dict(mesh.coords), "rows": (rows.start, rows.stop),
            "out": out.cpu().numpy(), "expect": torch.stack(expect).cpu().numpy(),
            "fft_ok": bool(fr.shape == (2 * n // mesh.shape["dp"], 256)
                           and torch.isfinite(fr).all() and torch.isfinite(fi).all()),
            "dist_fft_err": float(np.max(np.abs(y - ref)) / np.max(np.abs(ref)))}


def dryrun_multichip(n: int, backend: Optional[str] = None, device: str = "cuda",
                     timeout: float = 900.0) -> Dict[str, Any]:
    """Start n ranks, build the ``balanced_shape(n)`` mesh, run one sharded
    TV step at the deployment shape and hold it against the unsharded engine
    channel by channel, and a ``dist_fft`` over tp against numpy. Raises on
    disagreement beyond 1e-4 of the output scale (3e-5 of max|ref| for the
    transform); returns the mesh shape, the step's error and scale and the
    transform's relative error.

    By default the ranks run on the card, on ``pick_backend``'s choice:
    NCCL, one card a rank, when there are at least n cards, else n gloo
    ranks sharing the cards, as the JAX entry point provisions virtual
    devices when it has too few real ones. ``device="cpu"`` defaults to
    gloo. DeviceError when a card is asked for and there is none,
    ValueError when NCCL is asked for by name for more ranks than there are
    cards (it takes one rank a card)."""
    backend = pick_backend(n, backend, device)
    results = run_ranks(n, _dryrun_rank, n, backend, device, backend=backend, timeout=timeout)
    out = np.zeros((DRYRUN_BATCH, DRYRUN_PTS), np.float32)
    expect = np.zeros_like(out)
    for r in results:
        out[slice(*r["rows"])] = r["out"]
        expect[slice(*r["rows"])] = r["expect"]
    scale = float(np.max(np.abs(expect))) + 1e-9
    err = float(np.max(np.abs(out - expect)))
    fft_err = max(r["dist_fft_err"] for r in results)
    if (err > DRYRUN_TOL * scale or not all(r["fft_ok"] for r in results)
            or fft_err > DRYRUN_FFT_TOL):
        raise RuntimeError(f"the dry run disagrees: sharded TV step max|diff| {err:.3e} vs "
                           f"tol {DRYRUN_TOL * scale:.3e} (the unsharded engine), sharded_fft "
                           f"ok {[r['fft_ok'] for r in results]}, dist_fft rel err "
                           f"{fft_err:.3e} vs {DRYRUN_FFT_TOL}")
    return {"shape": balanced_shape(n), "err": err, "scale": scale, "dist_fft_err": fft_err}
