"""Whole-scan streaming convolution, LTI and time-varying, for one channel
or many: the CUDA kernels of ``csrc/streamstep.cu`` and their plain
PyTorch twins.

Counterparts of ``opencl_fft_tpu/ops/pallas/streamstep.py``
``stream_steps_fused``, ``stream_steps_fused_tv``,
``stream_steps_fused_batched`` and ``stream_steps_fused_batched_tv``, with
the same results within float32 rounding: every block of the scan goes
through the forward rFFT of its zero-padded frame, a one-frame window
slide, the frequency-delay-line complex MAC (bin 0 componentwise, times
``b0_scale``), the inverse transform and the overlap-add / pts. In the TV
scan block t's coefficient frame is first written into the IR ring at slot
(wp2 - t) mod nparts. The JAX kernels take both transform chains as
products against dense tables (``wfwd``, ``wpost``); here each block's
forward chain is an m-point complex FFT (m = pts) of the half-size sequence
z_j = x_2j + i x_2j+1, then the pack with the forward coefficient stack,
and each output row's inverse chain is the unpack (inverse stack) of
acc[t] + (-1)^k acc[t-1], an unnormalized m-point inverse FFT and a
deinterleave of its first m/2 values, which is the overlap-added block
(``tables._coef_stacks_np`` holds both stacks). The kernels take any
power-of-two pts >= 2 up to ``MAX_PTS``, transforming up to 2^14 points
inside a CTA and larger sizes by the four-step of ``csrc/fft_tile.cuh``, so
the same functions also stand for the JAX package's split scans
(``ops/pallas/splitstep.py`` ``stream_steps_fused_split{,_tv}``), which it
runs above pts 2048 where its dense tables grow large.

The batched scans take blocks (nblocks, C, pts): block t of channel c is
row t*C + c of the (nblocks*C, pts) matrix, the row order of the JAX
batched kernels. Every channel has its own window, IR ring and tail, and
in the TV scan its own coefficient-ring pointer (one int shared by every
channel, or a length-C sequence). A single-channel scan is the C = 1 case
of the same CUDA entry and of the same twin.

The scans are computed block-parallel: all input blocks are known up front,
so the forward frames of a channel's scan form one timeline behind its
initial window, and block t's window is timeline rows [t+1, t+1+nparts).
The TV scan's coefficient frames form a second timeline (see
``stream_steps_fused_batched_tv_plain``). How the kernels split the work
between CTAs is planned here by shape (``scan_plan``).

The matrix scan (``stream_steps_fused_matrix``, a design of the port's
own: the JAX package runs a convolution matrix as n_out n_in channels of
the batched scan) takes blocks (nblocks, n_in, pts), one window an input,
the IR planes of the n_out n_in (out, in) pairs and one tail an output,
and sums every pair's MAC over the inputs inside the kernel: one forward
transform an input and one inverse transform an output a block
(``matrix_plan``).

Each CUDA entry has one wrapper that checks its arguments, runs the
kernel for CUDA tensors and its twin for CPU tensors (anything else raises)
and counts: ``stream_steps_fused_batched`` (``BATCHED_LAUNCHES``),
``stream_steps_fused_batched_tv`` (``BATCHED_TV_LAUNCHES``) and
``stream_steps_fused_matrix`` (``MATRIX_LAUNCHES``), each counter every
launch of its entry at any shape. The single-channel scans are the
batched scans' C = 1 views. The twins are the kernels' chains in plain
PyTorch (``torch.fft``); ``_dense_frames`` and ``_post_ola_plain`` keep the JAX
kernels' dense-table chains as the tests' oracle.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Union

import numpy as np
import torch

from ...utils.numerics import exact_matmul, is_pow2
from ..cplx import Cplx
from . import _build
from .tables import coef_tables, fwd_table, post_table
from .vmemfft import (LEAF_PASS_MAX, SINGLE_PASS_MAX, four_step_log_a,
                      four_step_tables_np, pass_twiddle_np, two_pass_split)

BATCHED_LAUNCHES = 0
BATCHED_TV_LAUNCHES = 0
MATRIX_LAUNCHES = 0

MAX_PTS = LEAF_PASS_MAX ** 2   # the four-step's factors are at most 2^13 each

# the kernels' constants (csrc/fft_tile.cuh, csrc/scan_mac.cuh)
TILE_LOG2 = 13          # values a transform CTA holds, log2
MAC_TT = 8              # outputs a MAC thread
TILE_BINS = 32          # bins a MAC CTA: a warp's lanes
TILE_MAX_GROUPS = 8     # warps a MAC CTA
TILE_TT_MAX = 16        # outputs a MAC thread: MAC_TT or this
MAC_STAGE = 32          # partitions a MAC stage
MATRIX_GROUP = 2        # inputs the matrix MAC sums in registers before adding to its output

Pointers = Union[int, Sequence[int]]

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("streamstep").stream_steps_fused_batched_f32
    fn.argtypes = [_P] * 16 + [_I] * 6 + [_P, ctypes.c_float, _I, _P]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _tv_kernel():
    fn = _build.load("streamstep").stream_steps_fused_batched_tv_f32
    fn.argtypes = [_P] * 7 + [_I] + [_P] * 14 + [_I] * 6 + [_P, ctypes.c_float, _I, _P]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _matrix_kernel():
    fn = _build.load("streamstep").stream_steps_fused_matrix_f32
    fn.argtypes = [_P] * 16 + [_I] * 7 + [_P, ctypes.c_float, _I, _P]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _slot_table(nparts: int, device: torch.device) -> torch.Tensor:
    """int32 [0, nparts) on ``device``: a shared ring pointer p is passed to
    the TV kernel as the address of entry p with channel stride 0."""
    return torch.arange(nparts, dtype=torch.int32, device=device)


def _check_pts(pts: int):
    if not is_pow2(pts) or pts < 2:
        raise ValueError(f"the scans take a power-of-two pts >= 2, got {pts}")


def _check(blocks, w0r, w0i, hr, hi, tail, pts):
    _check_pts(pts)
    if blocks.dim() != 2 or blocks.shape[1] != pts or blocks.shape[0] < 1:
        raise ValueError(f"blocks must be (nblocks >= 1, {pts}), got {tuple(blocks.shape)}")
    if hr.dim() != 2 or hr.shape[1] != pts:
        raise ValueError(f"h planes must be (nparts, {pts}), got {tuple(hr.shape)}")
    for name, t, shape in (("w0 re", w0r, hr.shape), ("w0 im", w0i, hr.shape),
                           ("h im", hi, hr.shape), ("tail", tail, (pts,))):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")


def _check_batched(blocks, w0r, w0i, hr, hi, tails, pts):
    _check_pts(pts)
    if blocks.dim() != 3 or blocks.shape[0] < 1 or blocks.shape[1] < 1 \
            or blocks.shape[2] != pts:
        raise ValueError(f"blocks must be (nblocks >= 1, channels >= 1, {pts}), "
                         f"got {tuple(blocks.shape)}")
    nch = blocks.shape[1]
    if hr.dim() != 3 or hr.shape[0] != nch or hr.shape[2] != pts:
        raise ValueError(f"h planes must be ({nch}, nparts, {pts}), got {tuple(hr.shape)}")
    for name, t, shape in (("w0 re", w0r, hr.shape), ("w0 im", w0i, hr.shape),
                           ("h im", hi, hr.shape), ("tails", tails, (nch, pts))):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")


def _check_tv_blocks(blocks_x, blocks_h):
    if tuple(blocks_h.shape) != tuple(blocks_x.shape):
        raise ValueError(f"blocks_h must have the shape of blocks_x "
                         f"{tuple(blocks_x.shape)}, got {tuple(blocks_h.shape)}")


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def _channel_pointers(wp2: Pointers, nch: int, nparts: int):
    """``wp2`` mod nparts: an int when shared by every channel, else a
    tuple of one int per channel."""
    if isinstance(wp2, (tuple, list)):
        if len(wp2) != nch:
            raise ValueError(f"wp2 needs one pointer per channel ({nch}), got {len(wp2)}")
        return tuple(int(p) % nparts for p in wp2)
    return int(wp2) % nparts


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def fft_tile_log_b(pts: int, rows: int, seqs: int = 1, sms: int = 132) -> int:
    """log2 of the transforms a CTA of the in-CTA forward or inverse kernel
    takes, for ``seqs`` sequences of ``rows`` transforms of pts points (the
    forward: one of nb*C rows; the inverse: C of nb+1). 2^11 values a CTA,
    or two rows where a row holds more (the fastest at pts 64..4096 on the
    H100, PERF.md §6), at most 2^13 (one row at pts 2^14), no more rows
    than a sequence holds; fewer while the grid would leave some of the
    card's ``sms`` SMs without a CTA, down to a warp a CTA (512 values); at
    least one thread (16 values). 0 above 2^14 (the four-step)."""
    log_l = pts.bit_length() - 1
    if log_l >= TILE_LOG2 + 1:
        return 0
    log_b = min(max(11 - log_l, 1), TILE_LOG2 - log_l, (rows - 1).bit_length())
    while log_b > 0 and log_l + log_b > 9 and seqs * _cdiv(rows, 1 << log_b) < sms:
        log_b -= 1
    return max(log_b, 4 - log_l)


class MacPlan(NamedTuple):
    """The tiled MAC's CTA (``csrc/scan_mac.cuh`` MacPlan): ``groups``
    warps, each ``tt`` (MAC_TT or TILE_TT_MAX) consecutive outputs of the
    CTA's TILE_BINS bins; ``q`` partitions a stage; ``ring`` timeline rows
    in shared memory."""
    groups: int
    tt: int
    q: int
    ring: int

    @property
    def outs(self) -> int:
        return self.groups * self.tt


def mac_plan(nch: int, nb: int, bins: int, nparts: int, tv: bool, sms: int = 132) -> MacPlan:
    """The MAC's CTA at this shape, as measured on the H100 (PERF.md §6):
    TILE_TT_MAX outputs a thread in the LTI MAC where that grid still gives
    every one of the card's ``sms`` SMs a CTA and there are at least 2 *
    MAC_STAGE partitions (a CTA of that width runs two an SM, too few to
    hide a lone stage's copies), else MAC_TT (the TV MAC always: its
    TILE_TT_MAX form runs at half the rate); TILE_MAX_GROUPS warps, at most
    nparts // tt in a TV scan (a TV tile's outputs read at most two h rows a
    partition only while they span no more than nparts blocks), halved
    while the grid would leave SMs without a CTA; stages of 2 * MAC_STAGE
    partitions (LTI) or MAC_STAGE (TV; fewer where nparts is smaller,
    rounded up to tt); the smallest power-of-two ring that holds one
    stage's rows and the next stage's (2q + outs - 1). A TV scan below
    MAC_TT partitions runs the per-thread MAC and ignores the plan."""
    tiles = _cdiv(bins, TILE_BINS) * nch
    wide = not tv and nparts >= 2 * MAC_STAGE \
        and _cdiv(nb, TILE_MAX_GROUPS * TILE_TT_MAX) * tiles >= sms
    tt = TILE_TT_MAX if wide else MAC_TT
    groups = TILE_MAX_GROUPS
    if tv:
        groups = max(1, min(groups, nparts // tt))
    while groups > 1 and _cdiv(nb, groups * tt) * tiles < sms:
        groups //= 2
    q = min(MAC_STAGE if tv else 2 * MAC_STAGE, _cdiv(nparts, tt) * tt)
    ring = 1 << (2 * q + groups * tt - 2).bit_length()
    return MacPlan(groups, tt, q, ring)


def scan_plan(pts: int, nb: int, nch: int, nparts: int, tv: bool, sms: int = 132) -> tuple:
    """The 6 ints the CUDA entries take: the forward and inverse
    transforms' log2 rows a CTA (``fft_tile_log_b``) and the MAC's
    (groups, tt, q, ring) (``mac_plan``)."""
    return (fft_tile_log_b(pts, nb * nch, 1, sms), fft_tile_log_b(pts, nb + 1, nch, sms),
            *mac_plan(nch, nb, pts, nparts, tv, sms))


def matrix_plan(n_in: int, n_out: int, nb: int, bins: int, nparts: int, sms: int = 132
                ) -> tuple:
    """The 6 ints the matrix entry takes: the forward transform's log2
    rows a CTA over the n_in inputs' nb blocks, the inverse's over the
    n_out outputs' nb + 1 rows, and the matrix MAC's (groups, tt, q, ring),
    planned as the LTI MAC's at n_out channels (``mac_plan``: a CTA's
    outputs are one output's, as an LTI scan's are one channel's)."""
    return (fft_tile_log_b(bins, nb * n_in, 1, sms), fft_tile_log_b(bins, nb + 1, n_out, sms),
            *mac_plan(n_out, nb, bins, nparts, False, sms))


class _Plan(NamedTuple):
    tables: tuple           # the device tables (kept alive with the plan)
    tabs: ctypes.Array      # their data pointers, as the C entries take them
    log_n1: int
    log_a: int


@functools.lru_cache(maxsize=None)
def _plan(pts: int, device: torch.device) -> _Plan:
    """The transforms' device tables for both signs (-1, then +1): the pass
    tables of n1 and n2 and the four-step tables A, B, S above
    ``SINGLE_PASS_MAX``; up to it the pass table of pts in the second place."""
    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    tables, log_n1, log_a = [], 0, 0
    for sign in (-1, 1):
        if pts <= SINGLE_PASS_MAX:
            tables += [None, dev(pass_twiddle_np(pts, sign)), None, None, None]
        else:
            n1, n2 = two_pass_split(pts)
            log_n1, log_a = n1.bit_length() - 1, four_step_log_a(n2)
            tables += [dev(pass_twiddle_np(n1, sign)), dev(pass_twiddle_np(n2, sign)),
                       *map(dev, four_step_tables_np(n1, n2, sign))]
    tabs = (ctypes.c_void_p * 10)(*(t.data_ptr() if t is not None else None for t in tables))
    return _Plan(tuple(tables), tabs, log_n1, log_a)


def _kernel_args(pts, nb, nch, dev):
    """(plan, scratch) of one launch: the scratch planes of the four-step
    (4 C (nb+1) pts floats; none up to ``SINGLE_PASS_MAX``)."""
    if pts > MAX_PTS:
        raise ValueError(f"the scan kernels take pts <= {MAX_PTS}, got {pts}")
    plan = _plan(pts, dev)
    scratch = None if plan.log_n1 == 0 else torch.empty(
        4 * nch * (nb + 1) * pts, dtype=torch.float32, device=dev)
    return plan, scratch


def _aligned8(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its data is not 8-byte aligned (the kernels
    read blocks as float2 pairs)."""
    return t if t.data_ptr() % 8 == 0 else t.clone()


def _launch(name, blocks, w0, h, b0_scale, tails, pts, dev):
    """The LTI CUDA entry on (nb, C, pts) blocks."""
    (w0r, w0i), (hr, hi) = w0, h
    nb, nch, _ = blocks.shape
    nparts = hr.shape[1]
    plan, scratch = _kernel_args(pts, nb, nch, dev)
    sms = _build.sm_count(dev.index)
    cut = (ctypes.c_int * 6)(*scan_plan(pts, nb, nch, nparts, False, sms))
    f32 = dict(dtype=torch.float32, device=dev)
    outs = torch.empty((nb, nch, pts), **f32)
    wfr, wfi = (torch.empty((nch, nparts, pts), **f32) for _ in range(2))
    tailf = torch.empty((nch, pts), **f32)
    timeline = torch.empty((nch, nparts + nb, 2 * pts), **f32)
    aext = torch.empty((nch, nb + 2, 2 * pts), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel()(*_ptrs(_aligned8(blocks), w0r, w0i, hr, hi), ctypes.addressof(plan.tabs),
                    *_ptrs(*coef_tables(pts, dev), tails, outs, wfr, wfi, tailf, timeline, aext),
                    None if scratch is None else scratch.data_ptr(),
                    nb, nch, nparts, pts, plan.log_n1, plan.log_a, ctypes.addressof(cut),
                    float(b0_scale), dev.index, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    return outs, (wfr, wfi), tailf


def _launch_tv(name, blocks_x, blocks_h, w0, h0, wp2, b0_scale, tails, pts, dev):
    """The TV CUDA entry on (nb, C, pts) blocks; ``wp2`` as
    ``_channel_pointers`` returns it."""
    (w0r, w0i), (h0r, h0i) = w0, h0
    nb, nch, _ = blocks_x.shape
    nparts = h0r.shape[1]
    if isinstance(wp2, tuple):
        slots, offset, stride = torch.tensor(wp2, dtype=torch.int32, device=dev), 0, 1
    else:
        slots, offset, stride = _slot_table(nparts, dev), 4 * wp2, 0
    plan, scratch = _kernel_args(pts, nb, nch, dev)
    sms = _build.sm_count(dev.index)
    cut = (ctypes.c_int * 6)(*scan_plan(pts, nb, nch, nparts, True, sms))
    f32 = dict(dtype=torch.float32, device=dev)
    outs = torch.empty((nb, nch, pts), **f32)
    wfr, wfi, hfr, hfi = (torch.empty((nch, nparts, pts), **f32) for _ in range(4))
    tailf = torch.empty((nch, pts), **f32)
    timeline = torch.empty((nch, nparts + nb, 2 * pts), **f32)
    htimeline = torch.empty((nch, nparts - 1 + nb, 2 * pts), **f32)
    aext = torch.empty((nch, nb + 2, 2 * pts), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _tv_kernel()(
        *_ptrs(_aligned8(blocks_x), _aligned8(blocks_h), w0r, w0i, h0r, h0i),
        slots.data_ptr() + offset, stride, ctypes.addressof(plan.tabs),
        *_ptrs(*coef_tables(pts, dev), tails, outs, wfr, wfi, hfr, hfi, tailf, timeline,
               htimeline, aext),
        None if scratch is None else scratch.data_ptr(),
        nb, nch, nparts, pts, plan.log_n1, plan.log_a, ctypes.addressof(cut), float(b0_scale),
        dev.index, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    return outs, (wfr, wfi), (hfr, hfi), tailf


def _one(planes: Cplx) -> Cplx:
    return planes[0][None], planes[1][None]


def stream_steps_fused(blocks: torch.Tensor, w0: Cplx, h: Cplx,
                       b0_scale: float, tail: torch.Tensor, pts: int):
    """Run an entire LTI streaming scan in one call: the C = 1 view of
    ``stream_steps_fused_batched``.

    blocks: (nblocks, pts); w0: split (nparts, bins) initial window (row q
    = frame wp0+q, i.e. doubled-ring rows [wp0, wp0+nparts)); h: split
    (nparts, bins) IR spectra, stored reversed; tail: (bins,), bins == pts.
    Returns (outs (nblocks, pts), (wfr, wfi), tail_fin (bins,)); final
    window row q holds frame wp0 + nblocks + q.
    """
    _check(blocks, *w0, *h, tail, pts)
    outs, (wfr, wfi), tailf = stream_steps_fused_batched(
        blocks[:, None], _one(w0), _one(h), b0_scale, tail[None], pts)
    return outs[:, 0], (wfr[0], wfi[0]), tailf[0]


def stream_steps_fused_plain(blocks: torch.Tensor, w0: Cplx, h: Cplx,
                             b0_scale: float, tail: torch.Tensor, pts: int):
    """Plain PyTorch twin of the LTI scan: the batched twin at one channel."""
    outs, (wfr, wfi), tailf = stream_steps_fused_batched_plain(
        blocks[:, None], _one(w0), _one(h), b0_scale, tail[None], pts)
    return outs[:, 0], (wfr[0], wfi[0]), tailf[0]


def stream_steps_fused_batched(blocks: torch.Tensor, w0: Cplx, h: Cplx,
                               b0_scale: float, tails: torch.Tensor, pts: int):
    """Run an entire LTI streaming scan of C channels in one call.

    blocks: (nblocks, C, pts); w0, h: split (C, nparts, bins) windows and
    IR spectra, each channel in the single-channel layout; tails: (C, bins).
    Returns (outs (nblocks, C, pts), (wfr, wfi) (C, nparts, bins),
    tails_fin (C, bins)).
    """
    global BATCHED_LAUNCHES
    w0r, w0i = w0
    hr, hi = h
    _check_batched(blocks, w0r, w0i, hr, hi, tails, pts)
    dev = _build.launch_device("stream_steps_fused_batched",
                               (blocks, w0r, w0i, hr, hi, tails))
    if dev.type == "cpu":
        return stream_steps_fused_batched_plain(blocks, w0, h, b0_scale, tails, pts)
    got = _launch("stream_steps_fused_batched", blocks, w0, h, b0_scale, tails, pts, dev)
    BATCHED_LAUNCHES += 1
    return got


def _nflip(v: torch.Tensor) -> torch.Tensor:
    """Index negation along the last axis: v_k -> v_{(m-k) mod m}."""
    return torch.roll(torch.flip(v, (-1,)), 1, -1)


def _fft_frames(blocks: torch.Tensor, pts: int) -> Cplx:
    """Forward frames of blocks (nb, C, pts), the kernel's chain: the FFT of
    z_j = x_2j + i x_2j+1 zero-padded to pts points, then the pack with the
    forward coefficient stack. Split (C, nb, bins)."""
    fc, _ = coef_tables(pts, blocks.device)
    x = blocks.to(torch.float32)
    z = torch.fft.fft(torch.complex(x[..., 0::2], x[..., 1::2]), n=pts)
    zr, zi = z.real, z.imag
    fr, fi = _nflip(zr), _nflip(zi)
    re = zr * fc[0] + fr * fc[1] + zi * fc[2] + fi * fc[3]
    im = zr * fc[4] + fr * fc[5] + zi * fc[6] + fi * fc[7]
    return re.transpose(0, 1), im.transpose(0, 1)


def _unpack_ifft(wr: torch.Tensor, wi: torch.Tensor, pts: int) -> torch.Tensor:
    """y = IFFT_m(U(w)) unnormalized, m = pts: the unpack of the split
    spectrum (wr, wi) (..., m) with the inverse coefficient stack, then the
    m-point inverse transform; complex (..., m)."""
    _, ic = coef_tables(pts, wr.device)
    a, bv, d, e = (wr * ic[2 * j] + wi * ic[2 * j + 1] for j in range(4))
    return torch.fft.ifft(torch.complex(a + _nflip(bv), d + _nflip(e)), norm="forward")


def _fft_post_ola(acc_r: torch.Tensor, acc_i: torch.Tensor, tails: torch.Tensor, pts: int):
    """The (C, nb, bins) accumulators to output blocks, the kernel's chain:
    row t (t = 0..nb) folds acc[t] + (-1)^k acc[t-1] (zero rows before and
    after), unpacks it with the inverse coefficient stack (the sign commutes
    with the unpack), inverse-transforms it unnormalized and deinterleaves
    its first pts/2 values: out1[t] + out2[t-1]; the carried tails are added
    at t = 0 and the rows divided by pts, row nb is the final tails:
    (outs (nb, C, pts), final tails (C, pts))."""
    pm = torch.where(torch.arange(pts, device=acc_r.device) % 2 == 0, 1.0, -1.0)
    ar, ai = (torch.nn.functional.pad(a, (0, 0, 1, 1)) for a in (acc_r, acc_i))
    wr, wi = ar[:, 1:] + pm * ar[:, :-1], ai[:, 1:] + pm * ai[:, :-1]
    y = _unpack_ifft(wr, wi, pts)[..., :pts // 2]
    out = torch.stack([y.real, y.imag], -1).reshape(*y.shape[:-1], pts)   # (C, nb+1, pts)
    outs = out[:, :-1].clone()
    outs[:, 0] += tails
    return (outs / pts).transpose(0, 1).contiguous(), out[:, -1].contiguous()


def _dense_frames(blocks: torch.Tensor, pts: int) -> Cplx:
    """The JAX kernels' forward chain, the tests' oracle for ``_fft_frames``:
    frames of blocks (nb, C, pts) as one product against the ``wfwd``
    table, split (C, nb, bins)."""
    f = exact_matmul(blocks.to(torch.float32),
                     fwd_table(pts, blocks.device, torch.float64)).transpose(0, 1)
    return f[..., :pts], f[..., pts:]


def _post_ola_plain(acc_r, acc_i, tails, pts):
    """The JAX kernels' inverse chain, the tests' oracle for
    ``_fft_post_ola``: [acc_r | acc_i] @ wpost per channel, overlap-add
    with the carried tail, / pts: (C, nb, bins) accumulators -> (outs (nb,
    C, pts), final tails (C, pts))."""
    y = exact_matmul(torch.cat([acc_r, acc_i], -1),
                     post_table(pts, acc_r.device, torch.float64))            # (C, nb, 2b)
    prev = torch.cat([tails[:, None], y[:, :-1, pts:]], 1)
    return ((y[..., :pts] + prev) / pts).transpose(0, 1).contiguous(), y[:, -1, pts:]


def _timeline(frames: Cplx, w0: Cplx) -> Cplx:
    """Per channel: the initial window, then the frames (C, nb, bins) ->
    split (C, nparts + nb, bins)."""
    return torch.cat([w0[0], frames[0]], 1), torch.cat([w0[1], frames[1]], 1)


def stream_steps_fused_batched_plain(blocks: torch.Tensor, w0: Cplx, h: Cplx,
                                     b0_scale: float, tails: torch.Tensor, pts: int):
    """Plain PyTorch twin of the batched LTI scan: the kernel's three steps
    with a leading channel axis, the MAC summed over partitions in the
    kernel's order (q ascending)."""
    return _lti_scan_plain(blocks, w0, h, b0_scale, tails, pts, _fft_frames, _fft_post_ola)


def _lti_scan_plain(blocks, w0: Cplx, h: Cplx, b0_scale: float, tails, pts: int,
                   frames, post_ola):
    """The batched LTI scan, block-parallel, around two transform steps:
    ``frames(blocks, pts)`` -> split (C, nb, bins) forward frames and
    ``post_ola(acc_r, acc_i, tails, pts)`` -> (outs (nb, C, pts), final
    tails (C, pts)): the kernels' FFT chains, or the dense oracle's."""
    hr, hi = h
    nparts = hr.shape[1]
    nb = blocks.shape[0]
    tr, ti = _timeline(frames(blocks, pts), w0)                # (C, nparts+nb, b)
    acc_r = torch.zeros((hr.shape[0], nb, pts), dtype=torch.float32, device=blocks.device)
    acc_i = torch.zeros_like(acc_r)
    for q in range(nparts):
        xr, xi = tr[:, 1 + q:1 + q + nb], ti[:, 1 + q:1 + q + nb]
        acc_r += xr * hr[:, q, None] - xi * hi[:, q, None]
        acc_i += xr * hi[:, q, None] + xi * hr[:, q, None]
    acc_r[..., 0] = b0_scale * (tr[:, 1:, 0].unfold(1, nparts, 1) * hr[:, None, :, 0]).sum(-1)
    acc_i[..., 0] = b0_scale * (ti[:, 1:, 0].unfold(1, nparts, 1) * hi[:, None, :, 0]).sum(-1)
    outs, tailf = post_ola(acc_r, acc_i, tails, pts)
    return outs, (tr[:, nb:nb + nparts], ti[:, nb:nb + nparts]), tailf


def _check_matrix(blocks, w0r, w0i, hr, hi, tails, pts):
    """The matrix scan's shapes."""
    _check_pts(pts)
    if blocks.dim() != 3 or blocks.shape[0] < 1 or blocks.shape[1] < 1 \
            or blocks.shape[2] != pts:
        raise ValueError(f"blocks must be (nblocks >= 1, inputs >= 1, {pts}), "
                         f"got {tuple(blocks.shape)}")
    n_in = blocks.shape[1]
    if hr.dim() != 3 or hr.shape[0] < n_in or hr.shape[0] % n_in or hr.shape[2] != pts:
        raise ValueError(f"h planes must be (outputs * {n_in}, nparts, {pts}), "
                         f"got {tuple(hr.shape)}")
    n_out, nparts = hr.shape[0] // n_in, hr.shape[1]
    for name, t, shape in (("w0 re", w0r, (n_in, nparts, pts)),
                           ("w0 im", w0i, (n_in, nparts, pts)), ("h im", hi, hr.shape),
                           ("tails", tails, (n_out, pts))):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")


def _launch_matrix(name, blocks, w0, h, b0_scale, tails, pts, dev):
    """The matrix CUDA entry on (nb, n_in, pts) blocks."""
    (w0r, w0i), (hr, hi) = w0, h
    nb, n_in, _ = blocks.shape
    n_out, nparts = tails.shape[0], hr.shape[1]
    plan, scratch = _kernel_args(pts, nb, max(n_in, n_out), dev)
    sms = _build.sm_count(dev.index)
    cut = (ctypes.c_int * 6)(*matrix_plan(n_in, n_out, nb, pts, nparts, sms))
    f32 = dict(dtype=torch.float32, device=dev)
    outs = torch.empty((nb, n_out, pts), **f32)
    wfr, wfi = (torch.empty((n_in, nparts, pts), **f32) for _ in range(2))
    tailf = torch.empty((n_out, pts), **f32)
    timeline = torch.empty((n_in, nparts + nb, 2 * pts), **f32)
    aext = torch.empty((max(n_in, n_out), nb + 2, 2 * pts), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _matrix_kernel()(
        *_ptrs(_aligned8(blocks), w0r, w0i, hr, hi), ctypes.addressof(plan.tabs),
        *_ptrs(*coef_tables(pts, dev), tails, outs, wfr, wfi, tailf, timeline, aext),
        None if scratch is None else scratch.data_ptr(),
        nb, n_in, n_out, nparts, pts, plan.log_n1, plan.log_a, ctypes.addressof(cut),
        float(b0_scale), dev.index, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    return outs, (wfr, wfi), tailf


def stream_steps_fused_matrix(blocks: torch.Tensor, w0: Cplx, h: Cplx, b0_scale: float,
                              tails: torch.Tensor, pts: int):
    """Run an entire LTI streaming scan of a convolution matrix in one call,
    out[o] = sum_i in[i] * ir[o, i].

    blocks: (nblocks, n_in, pts); w0: split (n_in, nparts, bins) windows,
    one an input; h: split (n_out * n_in, nparts, bins) IR spectra, pair
    (o, i) at o * n_in + i, each in the single-channel layout; tails:
    (n_out, bins), one an output. Returns (outs (nblocks, n_out, pts), (wfr,
    wfi) (n_in, nparts, bins), tails_fin (n_out, bins)): the scan of the
    n_out n_in pairs summed over the inputs, with one forward transform and
    window an input and one inverse transform and tail an output.
    """
    global MATRIX_LAUNCHES
    w0r, w0i = w0
    hr, hi = h
    _check_matrix(blocks, w0r, w0i, hr, hi, tails, pts)
    dev = _build.launch_device("stream_steps_fused_matrix", (blocks, w0r, w0i, hr, hi, tails))
    if dev.type == "cpu":
        return stream_steps_fused_matrix_plain(blocks, w0, h, b0_scale, tails, pts)
    got = _launch_matrix("stream_steps_fused_matrix", blocks, w0, h, b0_scale, tails, pts, dev)
    MATRIX_LAUNCHES += 1
    return got


def stream_steps_fused_matrix_plain(blocks: torch.Tensor, w0: Cplx, h: Cplx,
                                    b0_scale: float, tails: torch.Tensor, pts: int):
    """Plain PyTorch twin of the matrix scan, in the kernel's blocking and
    order: the forward frames and timelines of the n_in inputs; every
    output's MAC over the inputs (ascending), each over the partitions
    (ascending), summed from zero in groups of ``MATRIX_GROUP`` inputs (bin
    0 componentwise, then times b0_scale), the groups' sums added in order
    into the outputs' accumulators; the inverse transforms and tails of the
    n_out outputs."""
    hr, hi = h
    nb, n_in, _ = blocks.shape
    n_out, nparts = hr.shape[0] // n_in, hr.shape[1]
    tr, ti = _timeline(_fft_frames(blocks, pts), w0)           # (n_in, nparts+nb, b)
    hr4, hi4 = (p.reshape(n_out, n_in, nparts, 1, pts) for p in h)
    acc_r = torch.zeros((n_out, nb, pts), dtype=torch.float32, device=blocks.device)
    acc_i = torch.zeros_like(acc_r)
    for i0 in range(0, n_in, MATRIX_GROUP):
        sr, si = torch.zeros_like(acc_r), torch.zeros_like(acc_r)
        dc_r = torch.zeros((n_out, nb), dtype=torch.float32, device=blocks.device)
        dc_i = torch.zeros_like(dc_r)
        for i in range(i0, min(i0 + MATRIX_GROUP, n_in)):
            for q in range(nparts):
                xr, xi = tr[i, 1 + q:1 + q + nb], ti[i, 1 + q:1 + q + nb]   # (nb, b)
                yr, yi = hr4[:, i, q], hi4[:, i, q]                        # (n_out, 1, b)
                sr += xr * yr - xi * yi
                si += xr * yi + xi * yr
                dc_r += xr[:, 0] * yr[..., 0]
                dc_i += xi[:, 0] * yi[..., 0]
        sr[..., 0] = b0_scale * dc_r
        si[..., 0] = b0_scale * dc_i
        acc_r += sr
        acc_i += si
    outs, tailf = _fft_post_ola(acc_r, acc_i, tails, pts)
    return outs, (tr[:, nb:nb + nparts], ti[:, nb:nb + nparts]), tailf


def stream_steps_fused_tv(blocks_x: torch.Tensor, blocks_h: torch.Tensor,
                          w0: Cplx, h0: Cplx, wp2: int, b0_scale: float,
                          tail: torch.Tensor, pts: int):
    """Run an entire time-varying streaming scan in one call: the C = 1
    view of ``stream_steps_fused_batched_tv``.

    blocks_x, blocks_h: (nblocks, pts) input and coefficient operands;
    w0 as in ``stream_steps_fused``; h0: split (nparts, bins) coefficient
    ring (MAC layout), written at the decrementing slot wp2; tail: (bins,).
    Returns (outs (nblocks, pts), (wfr, wfi), (hfr, hfi), tail_fin): the
    final window, the final coefficient ring (its pointer is
    (wp2 - nblocks) mod nparts) and the final tail.
    """
    _check(blocks_x, *w0, *h0, tail, pts)
    _check_tv_blocks(blocks_x, blocks_h)
    outs, (wfr, wfi), (hfr, hfi), tailf = stream_steps_fused_batched_tv(
        blocks_x[:, None], blocks_h[:, None], _one(w0), _one(h0), int(wp2), b0_scale,
        tail[None], pts)
    return outs[:, 0], (wfr[0], wfi[0]), (hfr[0], hfi[0]), tailf[0]


def stream_steps_fused_tv_plain(blocks_x: torch.Tensor, blocks_h: torch.Tensor,
                                w0: Cplx, h0: Cplx, wp2: int, b0_scale: float,
                                tail: torch.Tensor, pts: int):
    """Plain PyTorch twin of the TV scan: the batched twin at one channel."""
    outs, (wfr, wfi), (hfr, hfi), tailf = stream_steps_fused_batched_tv_plain(
        blocks_x[:, None], blocks_h[:, None], _one(w0), _one(h0), wp2, b0_scale,
        tail[None], pts)
    return outs[:, 0], (wfr[0], wfi[0]), (hfr[0], hfi[0]), tailf[0]


def stream_steps_fused_batched_tv(blocks_x: torch.Tensor, blocks_h: torch.Tensor,
                                  w0: Cplx, h0: Cplx, wp2: Pointers, b0_scale: float,
                                  tails: torch.Tensor, pts: int):
    """Run an entire time-varying streaming scan of C channels in one call.

    blocks_x, blocks_h: (nblocks, C, pts); w0, h0: split (C, nparts, bins)
    windows and coefficient rings; wp2: the rings' pointer, one int shared
    by every channel or a length-C sequence; tails: (C, bins). Returns
    (outs (nblocks, C, pts), (wfr, wfi), (hfr, hfi), tails_fin): each
    channel's final ring has pointer (wp2_c - nblocks) mod nparts.
    """
    global BATCHED_TV_LAUNCHES
    w0r, w0i = w0
    h0r, h0i = h0
    _check_batched(blocks_x, w0r, w0i, h0r, h0i, tails, pts)
    _check_tv_blocks(blocks_x, blocks_h)
    wp2 = _channel_pointers(wp2, blocks_x.shape[1], h0r.shape[1])
    dev = _build.launch_device("stream_steps_fused_batched_tv",
                               (blocks_x, blocks_h, w0r, w0i, h0r, h0i, tails))
    if dev.type == "cpu":
        return stream_steps_fused_batched_tv_plain(blocks_x, blocks_h, w0, h0, wp2,
                                                   b0_scale, tails, pts)
    got = _launch_tv("stream_steps_fused_batched_tv", blocks_x, blocks_h, w0, h0, wp2,
                     b0_scale, tails, pts, dev)
    BATCHED_TV_LAUNCHES += 1
    return got


def _tv_rows(t, q, wp2, nparts: int) -> torch.Tensor:
    """Row of the coefficient timeline that ring slot q holds at block t:
    that of the last block s <= t with s = wp2 - q (mod nparts), at row
    s + nparts - 1 (rows [0, nparts-1) are pseudo-times -(nparts-1)..-1)."""
    return t - (t - wp2 + q) % nparts + nparts - 1


def stream_steps_fused_batched_tv_plain(blocks_x: torch.Tensor, blocks_h: torch.Tensor,
                                        w0: Cplx, h0: Cplx, wp2: Pointers,
                                        b0_scale: float, tails: torch.Tensor, pts: int):
    """Plain PyTorch twin of the batched TV scan, from the same timelines.

    Per channel c: x timeline rows [0, nparts) = w0_c, then block t's input
    frame at row nparts + t. h timeline: the initial ring in time order
    (row j = the frame of pseudo-time s = j - (nparts-1), ring slot
    (wp2_c - s) mod nparts), then block t's coefficient frame at row
    nparts - 1 + t. The MAC pairs window row q of block t with h timeline
    row ``_tv_rows(t, q, wp2_c)``, summed over q ascending as the kernel
    does; the final ring is the same gather at t = nblocks - 1.
    """
    return _tv_scan_plain(blocks_x, blocks_h, w0, h0, wp2, b0_scale, tails, pts,
                         _fft_frames, _fft_post_ola)


def _tv_scan_plain(blocks_x, blocks_h, w0: Cplx, h0: Cplx, wp2: Pointers, b0_scale: float,
                  tails, pts: int, frames, post_ola):
    """The batched TV scan around the two transform steps of
    ``_lti_scan_plain``."""
    h0r, h0i = h0
    nch, nparts = h0r.shape[:2]
    nb = blocks_x.shape[0]
    dev = blocks_x.device
    wp2 = _channel_pointers(wp2, nch, nparts)
    wp2 = torch.tensor(wp2 if isinstance(wp2, tuple) else (wp2,) * nch, device=dev)[:, None]
    ch = torch.arange(nch, device=dev)[:, None]
    tr, ti = _timeline(frames(blocks_x, pts), w0)              # (C, nparts+nb, b)
    slots = (wp2 - torch.arange(-(nparts - 1), 0, device=dev)) % nparts
    htr, hti = _timeline(frames(blocks_h, pts), (h0r[ch, slots], h0i[ch, slots]))
    t = torch.arange(nb, device=dev)
    acc_r = torch.zeros((nch, nb, pts), dtype=torch.float32, device=dev)
    acc_i = torch.zeros_like(acc_r)
    dc_r = torch.zeros((nch, nb), dtype=torch.float32, device=dev)
    dc_i = torch.zeros_like(dc_r)
    for q in range(nparts):
        xr, xi = tr[:, 1 + q:1 + q + nb], ti[:, 1 + q:1 + q + nb]
        rows = _tv_rows(t, q, wp2, nparts)                     # (C, nb)
        hr, hi = htr[ch, rows], hti[ch, rows]
        acc_r += xr * hr - xi * hi
        acc_i += xr * hi + xi * hr
        dc_r += xr[..., 0] * hr[..., 0]
        dc_i += xi[..., 0] * hi[..., 0]
    acc_r[..., 0] = b0_scale * dc_r
    acc_i[..., 0] = b0_scale * dc_i
    outs, tailf = post_ola(acc_r, acc_i, tails, pts)
    rows = _tv_rows(nb - 1, torch.arange(nparts, device=dev), wp2, nparts)   # (C, nparts)
    return (outs, (tr[:, nb:nb + nparts], ti[:, nb:nb + nparts]),
            (htr[ch, rows], hti[ch, rows]), tailf)
