"""Sliding-window spectral MACs over frame timelines, LTI and time-varying:
the CUDA kernels of ``csrc/slidemac.cu`` and their plain PyTorch twins,
under the names the JAX package gives them.

Counterparts of ``opencl_fft_tpu/ops/pallas/chunkmac.py`` ``chunk_mac`` and
``opencl_fft_tpu/ops/pallas/macflow.py`` ``macflow_lti`` and
``macflow_lti_batched``, which compute one function:

    acc[c, t, k] = sum_{q < nparts} X[c, t+q, k] (*) H[c, q, k]

a complex product per bin, except at bin 0 (the packed (DC/2, Nyq/2) pair),
which multiplies componentwise and is scaled by ``b0``. All three wrappers
run the one CUDA entry (the channel is a grid dimension; a single timeline
is its C = 1 case), on one of two routes that ``slide_route`` picks from
the shape: the scans' tiled MAC for long timelines, the partitions split
between the threads of a CTA (``tv_q_slices``' rule) for short ones. The
TPU kernels' shapes rules (``nparts`` and the output count multiples of 8,
``bins`` of 128) are VMEM and DMA-alignment rules and do not apply: every
``nparts >= 1``, ``bins`` and output count is taken, and the wrappers
return exactly the rows asked for.

The time-varying form (``macflow_tv``, ``macflow_tv_batched``: the JAX
``macflow.py`` kernels of the same names) pairs each input frame with a
frame of a second, coefficient timeline:

    acc[c, t, k] = sum_{p < nparts} X[c, t+p, k] (*) H[c, t + nparts-1 -
                   ((t - nparts+1 + p + phase) mod nparts), k]

both timelines laid out as row f + nparts-1 = the frame of time f, and
``phase`` = (nparts-1 - wp2) mod nparts the coefficient ring's, shared by
the channels. The JAX kernel takes only phases = 0 (mod 8) (a DMA row
alignment rule); here every phase runs the kernel. Where the grid of
MAC_TT outputs x 128 bins x C is too short to fill the card (a K = 8
chunk), the kernel splits the partitions of a CTA between ``S``
q-slices (``tv_q_slices`` picks S from the shape, ``q_ranges`` is the
split) and sums the slices in a fixed order.

Each wrapper runs the CUDA kernel for CUDA tensors and the twin for CPU
tensors; anything else raises, and a build or launch failure raises.
``CHUNKMAC_LAUNCHES``, ``MACFLOW_LAUNCHES``, ``MACFLOW_BATCHED_LAUNCHES``,
``MACFLOW_TV_LAUNCHES`` and ``MACFLOW_TV_BATCHED_LAUNCHES`` count the kernel
launches of ``chunk_mac``, ``macflow_lti``, ``macflow_lti_batched``,
``macflow_tv`` and ``macflow_tv_batched``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import torch

from ..cplx import Cplx
from . import _build
from .streamstep import TILE_BINS, TILE_MAX_GROUPS, MacPlan, mac_plan

CHUNKMAC_LAUNCHES = 0
MACFLOW_LAUNCHES = 0
MACFLOW_BATCHED_LAUNCHES = 0
MACFLOW_TV_LAUNCHES = 0
MACFLOW_TV_BATCHED_LAUNCHES = 0

# Offline render routing (``ops/pconv._offline_batched``): chunk_mac up to
# this many channels, macflow_lti_batched above, as in the JAX package
# (``chunkmac.CHUNKMAC_MAX_BATCH``). Both run the one CUDA entry here on the
# same timeline, so the crossover only decides which wrapper (and launch
# count) a render goes through.
CHUNKMAC_MAX_BATCH = 16

# Elements of one gathered (C, k, nparts, bins) window plane in the twin:
# bounds its memory at any shape (64 MB a plane).
_PLAIN_CHUNK_ELEMS = 1 << 24

# The q-split kernels' grid: MAC_TT outputs x MAC_THREADS bins a CTA of
# MAC_THREADS threads per q-slice (csrc/scan_mac.cuh, csrc/slidemac.cu).
MAC_TT = 8
MAC_THREADS = 128
TV_MAX_SLICES = 8
# Groups of MAC_THREADS threads an SM holds at the kernels' 64 registers a
# thread (65,536 registers): the grid fills the card at 8 a SM.
_GROUPS_PER_SM = 8


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("slidemac").slide_mac_batched_f32
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 6 + [i] * 5 + [ctypes.c_float, i, p, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _tv_kernel():
    fn = _build.load("slidemac").slide_mac_tv_batched_f32
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 6 + [i] * 7 + [ctypes.c_float, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, x: Cplx, h: Cplx, nout: int):
    """x planes (C, rows, bins), h planes (C, nparts, bins), one shape each;
    rows must hold every window: rows >= nout + nparts - 1 (later rows are
    not read)."""
    (xr, xi), (hr, hi) = x, h
    if xr.dim() != 3 or tuple(xi.shape) != tuple(xr.shape):
        raise ValueError(f"{name}: timeline planes must be one (C, rows, bins) shape, got "
                         f"{tuple(xr.shape)} and {tuple(xi.shape)}")
    nch, rows, bins = xr.shape
    if hr.dim() != 3 or tuple(hi.shape) != tuple(hr.shape) or hr.shape[0] != nch \
            or hr.shape[2] != bins or hr.shape[1] < 1:
        raise ValueError(f"{name}: h planes must be ({nch}, nparts >= 1, {bins}), got "
                         f"{tuple(hr.shape)} and {tuple(hi.shape)}")
    if nout < 1 or rows < nout + hr.shape[1] - 1:
        raise ValueError(f"{name}: {nout} outputs of {hr.shape[1]} partitions need a "
                         f"timeline of >= {nout + hr.shape[1] - 1} rows, got {rows}")


def slide_route(C: int, nout: int, bins: int, nparts: int, sms: int = 132,
                force: Optional[str] = None) -> Tuple[str, Union[MacPlan, int]]:
    """The LTI kernel's route at this shape: ("tiled", plan) or ("split",
    slices).

    "tiled", the scans' tiled MAC at ``streamstep.mac_plan``'s plan, where
    the timeline fills the smallest full tile (nout >= TILE_MAX_GROUPS *
    MAC_TT = 64 outputs, so that every staged h row feeds at least 64
    outputs) and the tiled grid gives each of the card's ``sms`` SMs a CTA
    (1 x 1880, 16 x 470, 64 x 470 at nparts 256, bins 512). Else "split":
    the q-split kernel at ``tv_q_slices`` slices, the TV kernel's rule (the
    K = 8 chunk of 64 channels: 256 CTAs of 4 slices). ``force`` names the
    route to take regardless (the tests and the timing tools)."""
    plan = mac_plan(C, nout, bins, nparts, False, sms)
    grid = -(-nout // plan.outs) * -(-bins // TILE_BINS) * C
    route = force or ("tiled" if nout >= TILE_MAX_GROUPS * MAC_TT and grid >= sms
                      else "split")
    if route == "tiled":
        return route, plan
    if route != "split":
        raise ValueError(f"no sliding-MAC route {route!r}")
    return route, tv_q_slices(C, nout, bins, nparts, sms)


def _launch(x: Cplx, h: Cplx, nout: int, b0: float, dev: torch.device) -> Cplx:
    (xr, xi), (hr, hi) = x, h
    nch, rows, bins = xr.shape
    route, how = slide_route(nch, nout, bins, hr.shape[1], _build.sm_count(dev.index))
    slices, plan = (0, (ctypes.c_int * 4)(*how)) if route == "tiled" else (how, None)
    outr = torch.empty((nch, nout, bins), dtype=torch.float32, device=dev)
    outi = torch.empty_like(outr)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel()(xr.data_ptr(), xi.data_ptr(), hr.data_ptr(), hi.data_ptr(),
                    outr.data_ptr(), outi.data_ptr(), nch, rows, hr.shape[1], bins, nout,
                    float(b0), slices, None if plan is None else ctypes.addressof(plan),
                    dev.index, stream)
    if err != 0:
        raise RuntimeError(f"slide_mac_batched_f32: CUDA error {err} at launch")
    return outr, outi


def _run(name: str, x: Cplx, h: Cplx, nout: int, b0: float):
    """(acc planes, launched): the kernel on a card (on ``slide_route``'s
    route), the twin on the CPU."""
    _check(name, x, h, nout)
    dev = _build.launch_device(name, (*x, *h))
    if dev.type == "cpu":
        return slide_mac_plain(x, h, nout, b0), False
    return _launch(x, h, nout, b0, dev), True


def slide_mac_plain(x: Cplx, h: Cplx, nout: int, b0: float) -> Cplx:
    """Plain PyTorch twin of the sliding MAC (the JAX package's
    ``_lti_mac_xla`` over channels): x (C, rows, bins), h (C, nparts,
    bins) -> (C, nout, bins). Outputs are taken in chunks of k rows whose
    (C, k, nparts, bins) windows are gathered and summed over the
    partitions."""
    (xr, xi), (hr, hi) = x, h
    nch, _, bins = xr.shape
    nparts = hr.shape[1]
    dev = xr.device
    acc_r = torch.empty((nch, nout, bins), dtype=torch.float32, device=dev)
    acc_i = torch.empty_like(acc_r)
    hr4, hi4 = hr[:, None], hi[:, None]                       # (C, 1, nparts, bins)
    step = max(1, _PLAIN_CHUNK_ELEMS // (nch * nparts * bins))
    for t0 in range(0, nout, step):
        k = min(step, nout - t0)
        idx = t0 + torch.arange(k, device=dev)[:, None] + torch.arange(nparts, device=dev)
        wr, wi = xr[:, idx], xi[:, idx]                       # (C, k, nparts, bins)
        ar = torch.sum(wr * hr4 - wi * hi4, dim=2)
        ai = torch.sum(wr * hi4 + wi * hr4, dim=2)
        ar[..., 0] = b0 * torch.sum(wr[..., 0] * hr4[..., 0], dim=2)
        ai[..., 0] = b0 * torch.sum(wi[..., 0] * hi4[..., 0], dim=2)
        acc_r[:, t0:t0 + k] = ar
        acc_i[:, t0:t0 + k] = ai
    return acc_r, acc_i


def chunk_mac(timeline: Cplx, h: Cplx, b0_scale: float) -> Cplx:
    """acc[b, k] = sum_q timeline[b, k+q] (*) h[b, q] for k < G.

    timeline: split (batch, nparts + G, bins), prior frames then fresh ones
    (its last row feeds no output); h: split (batch, nparts, bins)
    coefficient frames in ring order. Returns split (batch, G, bins); any
    G >= 1 (the JAX kernel needs a multiple of its group size).
    """
    global CHUNKMAC_LAUNCHES
    ranks = (timeline[0].dim(), h[0].dim())
    nout = timeline[0].shape[1] - h[0].shape[1] if ranks == (3, 3) else 0
    acc, launched = _run("chunk_mac", timeline, h, nout, b0_scale)
    CHUNKMAC_LAUNCHES += launched
    return acc


def macflow_lti_batched(xtl: Cplx, h: Cplx, nb: int, b0: float) -> Cplx:
    """Per-channel LTI sliding MAC: acc[c, t] = sum_q xtl[c, t+q] (*)
    h[c, q] for t < nb. xtl: split (B, >= nparts-1+nb, bins), rows past
    the last window unread; h: split (B, nparts, bins). Returns split (B,
    nb, bins) (the JAX kernel returns a padded row count for the caller to
    slice)."""
    global MACFLOW_BATCHED_LAUNCHES
    acc, launched = _run("macflow_lti_batched", xtl, h, nb, b0)
    MACFLOW_BATCHED_LAUNCHES += launched
    return acc


def macflow_lti(xtl: Cplx, h: Cplx, nb: int, b0: float) -> Cplx:
    """acc[t] = sum_q xtl[t+q] (*) h[q] for t < nb: the C = 1 case of
    ``macflow_lti_batched``. xtl: split (>= nparts-1+nb, bins); h: split
    (nparts, bins). Returns split (nb, bins)."""
    global MACFLOW_LAUNCHES
    for name, planes in (("xtl", xtl), ("h", h)):
        if planes[0].dim() != 2:
            raise ValueError(f"macflow_lti: {name} planes must be (rows, bins), got "
                             f"{tuple(planes[0].shape)}")
    (acc_r, acc_i), launched = _run("macflow_lti", (xtl[0][None], xtl[1][None]),
                                    (h[0][None], h[1][None]), nb, b0)
    MACFLOW_LAUNCHES += launched
    return acc_r[0], acc_i[0]


def _check_tv(name: str, x: Cplx, h: Cplx, nout: int, nparts: int):
    """x and h planes (C, rows, bins), each pair one shape and the two
    alike but for rows; both must hold nparts-1+nout rows."""
    for what, (re, im) in (("x", x), ("h", h)):
        if re.dim() != 3 or tuple(im.shape) != tuple(re.shape):
            raise ValueError(f"{name}: {what} timeline planes must be one (C, rows, bins) "
                             f"shape, got {tuple(re.shape)} and {tuple(im.shape)}")
    if x[0].shape[0] != h[0].shape[0] or x[0].shape[2] != h[0].shape[2]:
        raise ValueError(f"{name}: x and h timelines differ in channels or bins: "
                         f"{tuple(x[0].shape)}, {tuple(h[0].shape)}")
    if nparts < 1 or nout < 1:
        raise ValueError(f"{name}: need nparts >= 1 and nb >= 1, got {nparts}, {nout}")
    need = nparts - 1 + nout
    if min(x[0].shape[1], h[0].shape[1]) < need:
        raise ValueError(f"{name}: {nout} outputs of {nparts} partitions need timelines of "
                         f">= {need} rows, got {x[0].shape[1]} and {h[0].shape[1]}")


def tv_q_slices(C: int, nout: int, bins: int, nparts: int, sms: int = 132) -> int:
    """q-slices a CTA of the q-split kernels (TV, and LTI on ``slide_route``'s
    "split" route) at this shape. The unsplit grid has
    cdiv(nout, MAC_TT) x cdiv(bins, MAC_THREADS) x C CTAs of MAC_TT outputs
    x MAC_THREADS bins; where more of them than the card's ``sms`` SMs hold
    at once, 1 (64 x 470: 15,104 CTAs). Else the largest power of two up to
    ``TV_MAX_SLICES`` and nparts whose split grid (MAC_THREADS threads a
    slice) still fits at once, and at least 2: the split kernel also loads
    a partition ahead (1 x 1880: 940 CTAs, 2 slices; a K = 8 chunk of 64
    channels: 256 CTAs, 4)."""
    groups = -(-nout // MAC_TT) * -(-bins // MAC_THREADS) * C
    slots = _GROUPS_PER_SM * sms
    cap = min(TV_MAX_SLICES, nparts)
    if groups > slots or cap < 2:
        return 1
    s = 2
    while 2 * s <= cap and 2 * s * groups <= slots:
        s *= 2
    return s


def q_ranges(nparts: int, slices: int) -> list:
    """The partitions [q0, q1) of each q-slice, as the kernel splits them:
    q0 = slice * nparts // slices (a slice may be empty where nparts <
    slices)."""
    return [(u * nparts // slices, (u + 1) * nparts // slices) for u in range(slices)]


def _run_tv(name: str, x: Cplx, h: Cplx, nout: int, nparts: int, b0: float, phase: int):
    """(acc planes (C, nout, bins), launched): the TV kernel on a card (at
    ``tv_q_slices`` of the shape), the twin on the CPU."""
    _check_tv(name, x, h, nout, nparts)
    phase = int(phase) % nparts
    dev = _build.launch_device(name, (*x, *h))
    if dev.type == "cpu":
        return slide_mac_tv_plain(x, h, nout, nparts, b0, phase), False
    slices = tv_q_slices(x[0].shape[0], nout, x[0].shape[2], nparts,
                         _build.sm_count(dev.index))
    return _launch_tv(x, h, nout, nparts, b0, phase, slices, dev), True


def _launch_tv(x: Cplx, h: Cplx, nout: int, nparts: int, b0: float, phase: int, slices: int,
               dev: torch.device) -> Cplx:
    (xr, xi), (hr, hi) = x, h
    nch, rows, bins = xr.shape
    out = torch.empty((2, nch, nout, bins), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _tv_kernel()(xr.data_ptr(), xi.data_ptr(), hr.data_ptr(), hi.data_ptr(),
                       out[0].data_ptr(), out[1].data_ptr(), nch, rows, hr.shape[1], nparts,
                       bins, nout, phase, float(b0), slices, dev.index, stream)
    if err != 0:
        raise RuntimeError(f"slide_mac_tv_batched_f32: CUDA error {err} at launch")
    return out[0], out[1]


def slide_mac_tv_plain(x: Cplx, h: Cplx, nout: int, nparts: int, b0: float,
                       phase: int) -> Cplx:
    """Plain PyTorch twin of the TV sliding MAC (the JAX package's
    ``_tv_mac_xla`` over channels): x, h (C, rows, bins) timelines -> (C,
    nout, bins). Outputs are taken in chunks of k rows whose (C, k, nparts,
    bins) windows of both timelines are gathered and summed over the
    partitions."""
    (xr, xi), (hr, hi) = x, h
    nch, _, bins = xr.shape
    dev = xr.device
    acc_r = torch.empty((nch, nout, bins), dtype=torch.float32, device=dev)
    acc_i = torch.empty_like(acc_r)
    p = torch.arange(nparts, device=dev)
    step = max(1, _PLAIN_CHUNK_ELEMS // (nch * nparts * bins))
    for t0 in range(0, nout, step):
        k = min(step, nout - t0)
        t = t0 + torch.arange(k, device=dev)[:, None]                 # (k, 1)
        xrow = t + p                                                  # (k, nparts)
        hrow = t + nparts - 1 - (t - nparts + 1 + p + phase) % nparts
        wr, wi, gr, gi = xr[:, xrow], xi[:, xrow], hr[:, hrow], hi[:, hrow]
        ar = torch.sum(wr * gr - wi * gi, dim=2)
        ai = torch.sum(wr * gi + wi * gr, dim=2)
        ar[..., 0] = b0 * torch.sum(wr[..., 0] * gr[..., 0], dim=2)
        ai[..., 0] = b0 * torch.sum(wi[..., 0] * gi[..., 0], dim=2)
        acc_r[:, t0:t0 + k] = ar
        acc_i[:, t0:t0 + k] = ai
    return acc_r, acc_i


def macflow_tv_batched(xtl: Cplx, htl: Cplx, nb: int, np_: int, b0: float, c=0) -> Cplx:
    """Per-channel TV sliding MAC with a shared phase ``c`` = (np_-1 -
    wp2) mod np_: xtl, htl split (B, >= np_-1+nb, bins) timelines (row f +
    np_-1 = the frame of time f, rows [0, np_-1) the pre-call ring contents
    in time order). Returns split (B, nb, bins) (the JAX kernel returns a
    padded row count for the caller to slice). Any phase."""
    global MACFLOW_TV_BATCHED_LAUNCHES
    acc, launched = _run_tv("macflow_tv_batched", xtl, htl, nb, np_, b0, c)
    MACFLOW_TV_BATCHED_LAUNCHES += launched
    return acc


def macflow_tv(xtl: Cplx, htl: Cplx, nb: int, np_: int, b0: float, c=0) -> Cplx:
    """The TV sliding MAC of one timeline pair, the C = 1 case of
    ``macflow_tv_batched``: xtl, htl split (>= np_-1+nb, bins). Returns split
    (nb, bins). Any phase ``c``."""
    global MACFLOW_TV_LAUNCHES
    for name, planes in (("xtl", xtl), ("htl", htl)):
        if planes[0].dim() != 2:
            raise ValueError(f"macflow_tv: {name} planes must be (rows, bins), got "
                             f"{tuple(planes[0].shape)}")
    (acc_r, acc_i), launched = _run_tv("macflow_tv", (xtl[0][None], xtl[1][None]),
                                       (htl[0][None], htl[1][None]), nb, np_, b0, c)
    MACFLOW_TV_LAUNCHES += launched
    return acc_r[0], acc_i[0]
