"""Class-based parity API mirroring the reference's C++ surface.

The reference's four classes: ``Clcfft``/``Clrfft`` (``cl_fft.h``),
``Clpconv`` (``cl_conv.h:124-188``) and ``Cldconv`` (``cl_dconv.h:17-66``),
with their constructor shape, baked-in transform direction, status polling
via ``get_error``/``get_cl_err``, the message callback and in-place
host-array transforms, on top of the functional engines in ``ops/``.
Construction places the streaming state on the chosen device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from .ops import dconv as _dconv
from .ops import fft as _fft
from .ops import pconv as _pconv
from .ops.cuda import _build
from .ops.cuda import vmemfft as _vmemfft
from .ops.rfft import irfft_split, rfft_split
from .utils import profiling
from .utils.devices import get_device
from .utils.errors import ArgumentError, SizeError, Status
from .utils.logging import MessageCallback, resolve_callback
from .utils.numerics import is_pow2


class Clcfft:
    """Complex-to-complex FFT object (parity with cl_fft.h:29-70).

    device_index — card index (clGetDeviceIDs analog)
    size         — transform length N (power of two)
    fwd          — direction baked per object (cl_fft.cpp:88-90): forward
                   is DFT / N, inverse the unnormalized sum
    device       — None/"cuda" for card ``device_index``, or "cpu"

    Like the reference, the constructor records a failure (``get_error``)
    instead of raising; the methods then return that status.
    """

    def __init__(self, device_index: int = 0, size: int = 16, fwd: bool = True,
                 impl: str = "auto",
                 on_message: Optional[MessageCallback] = None,
                 user_data: Any = None,
                 device: Optional[Union[str, torch.device]] = None):
        self._err = Status.SUCCESS
        self._log = ""
        self._msg = resolve_callback(on_message)
        self._user_data = user_data
        try:
            if not is_pow2(size):
                raise SizeError(f"DFT size must be a power of two, got {size}")
            if impl not in _fft._IMPLS:
                raise ValueError(f"unknown impl {impl!r}, expected one of {_fft._IMPLS}")
            if impl == "vmem" and not _vmemfft.supported(size):
                raise ValueError(f"impl='vmem' needs a size in 2^10..2^20, got {size}")
            self.N = size
            self.forward = bool(fwd)
            self.impl = impl
            self.device = get_device(device_index, device, on_message, user_data)
        except Exception as e:  # constructor records, does not raise (parity)
            self._err = getattr(e, "status", Status.UNKNOWN)
            self._log = str(e)
            self._msg(str(e), self._user_data)

    def transform(self, c: np.ndarray) -> int:
        """In-place DFT on N complex values (Clcfft::transform parity,
        cl_fft.cpp:153-161). Returns a status code."""
        if self._err != Status.SUCCESS:
            return int(self._err)
        arr = np.ascontiguousarray(c, dtype=np.complex64).reshape(-1)
        if arr.size != self.N:
            raise SizeError(f"expected {self.N} complex values, got {arr.size}")
        z = torch.from_numpy(arr).to(self.device)
        y = torch.complex(*_fft.cfft_split((z.real, z.imag), self.forward, self.impl))
        np.copyto(np.asarray(c).reshape(-1), y.cpu().numpy())
        return int(Status.SUCCESS)

    def get_error(self) -> int:
        return int(self._err)

    def _route(self) -> str:
        n = self.N
        if not _fft.uses_vmem(n, torch.float32, self.device, self.impl):
            return f"torch.fft ({n} points)"
        if self.device.type == "cpu":
            return f"plain twin of fft_vmem ({n} points)"
        return f"CUDA {_vmemfft.route(n)}"

    def get_log(self) -> str:
        """Build-log parity surface (cl_fft.h:69): the reference returned
        the OpenCL JIT build log; here it is the device, the route this
        object's transform takes, and, for the CUDA kernels, their ptxas
        lines from the build of ``csrc/fft.cu``. It never raises."""
        if self._err != Status.SUCCESS:
            return self._log
        try:
            dev = self.device
            name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
            route = self._route()
            out = [f"device: {name} ({dev})", f"route: {route}"]
            if route.startswith("CUDA"):
                ptxas = [ln.strip() for ln in _build.build_log("fft").splitlines()
                         if "ptxas" in ln or "Used" in ln or "spill" in ln]
                out += ptxas or ["fft.cu: not built yet in this process"]
            return "\n".join(out)
        except Exception as e:              # log surface must never raise
            return f"{self._log}\n(log detail unavailable: {e})"


class Clrfft(Clcfft):
    """Real-to-complex / complex-to-real FFT object (cl_fft.h:74-111).

    size is the REAL length N; spectra have N/2 packed complex bins.
    """

    def __init__(self, device_index: int = 0, size: int = 16, fwd: bool = True,
                 impl: str = "auto",
                 on_message: Optional[MessageCallback] = None,
                 user_data: Any = None,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(device_index, size // 2, fwd, impl, on_message,
                         user_data, device)
        if self._err != Status.SUCCESS:
            return
        self.size = size
        try:   # same ctor-records contract as the parent
            if self.forward and (size < 4 or size % 4):
                raise ValueError(
                    f"real FFT size must be a multiple of 4 (even complex bin "
                    f"count) and >= 4, got {size}")
        except Exception as e:
            self._err = getattr(e, "status", Status.UNKNOWN)
            self._log = str(e)
            self._msg(str(e), self._user_data)

    def transform(self, c: np.ndarray, r: Optional[np.ndarray] = None) -> int:
        """Out-of-place or in-place real transform (cl_fft.cpp:267-296):
        forward reads N reals from `r` (or `c` viewed as reals) and writes
        N/2 packed complex into `c`; inverse reads `c`, writes reals to `r`
        (or into `c` viewed as reals).
        """
        if self._err != Status.SUCCESS:
            return int(self._err)
        c_view = np.asarray(c)
        if r is None and c_view.dtype != np.complex64:
            # the in-place contract reinterprets c's BYTES as float32
            # (cl_fft.cpp:267-296 operates on one float buffer)
            raise ArgumentError(
                f"in-place Clrfft.transform requires a complex64 buffer "
                f"(byte-viewed as float32), got dtype {c_view.dtype}; pass "
                f"a separate real array r= or convert c to complex64")
        if self.forward:
            src = c_view.view(np.float32).reshape(-1)[: self.size] if r is None \
                else np.asarray(r, dtype=np.float32).reshape(-1)
            if src.size != self.size:
                raise SizeError(f"expected {self.size} real values, got {src.size}")
            x = torch.from_numpy(src.copy()).to(self.device)
            out = torch.complex(*rfft_split(x, self.impl)).cpu().numpy()
            np.copyto(c_view.reshape(-1)[: self.size // 2], out)
        else:
            spec = np.ascontiguousarray(c_view, dtype=np.complex64).reshape(-1)
            if spec.size != self.size // 2:
                raise SizeError(
                    f"expected {self.size // 2} complex bins, got {spec.size}")
            z = torch.from_numpy(spec).to(self.device)
            y = irfft_split((z.real, z.imag), self.impl).cpu().numpy()
            dst = c_view.view(np.float32).reshape(-1) if r is None \
                else np.asarray(r).reshape(-1)
            np.copyto(dst[: self.size], y.astype(dst.dtype))
        return int(Status.SUCCESS)


class Clpconv:
    """Partitioned-convolution object (parity with cl_conv.h:124-188).

    cvs    — convolution (IR) size in samples
    pts    — partition size (power of two); nparts = cvs/pts
    errs/user_data — message callback surface (cl_conv.h:137-145)
    bin0_mode — "exact" (true convolution) or "compat" (see ops/pconv.py)
    device — None/"cuda" for card ``device_index``, or "cpu"

    Like the reference, the constructor records a failure (``get_cl_err``)
    instead of raising; the methods then return that status.

    On a card above pts 2048 (``ops/pconv._mac_unpack_kernel``) and out of
    a crossfade, ``convolution`` replays the engine's step graph
    (``ops/pconv.StepGraph``, one for each form) over state it writes in
    place: ``state`` then holds tensors that the next block overwrites, so
    copy it to keep it.
    """

    def __init__(self, device_index: int = 0, cvs: int = 1024, pts: int = 64,
                 errs: Optional[MessageCallback] = None, user_data: Any = None,
                 bin0_mode: str = "exact", impl: str = "auto",
                 device: Optional[Union[str, torch.device]] = None):
        self._err = Status.SUCCESS
        self._exc: Optional[Exception] = None
        self._msg = resolve_callback(errs)
        self._user_data = user_data
        self._xf: Optional[_pconv.XfadeState] = None   # an IR crossfade in progress
        self._fade_pos = self._fade_total = 0
        self._graphs: Dict[bool, _pconv.StepGraph] = {}   # by form: TV or not
        try:
            self.cfg = _pconv.PconvConfig.for_ir_length(
                cvs, pts, bin0_mode=bin0_mode, impl=impl)
            self.device = get_device(device_index, device, errs, user_data)
            self.state = _pconv.pconv_init(self.cfg, self.device)
        except Exception as e:  # constructor records, does not raise (parity)
            self._err = getattr(e, "status", Status.UNKNOWN)
            self._exc = e
            self._msg(str(e), self._user_data)

    def _end_fade(self) -> None:
        """Drop a fade in progress, keeping its live input ring."""
        if self._xf is not None:
            self.state = self._xf.state
            self._xf = None

    def push_ir(self, ir: np.ndarray) -> int:
        """Analyze an IR into the coefficient ring (cl_conv.cpp:353-388).
        An instant swap: it cancels a crossfade in progress on the live
        input ring."""
        if self._err != Status.SUCCESS:
            return int(self._err)
        ir = _block(ir, self.cfg.cvs, self.device, "IR")
        self._end_fade()
        self.state = _pconv.push_ir(self.cfg, self.state, ir)
        return int(Status.SUCCESS)

    def push_ir_xfade(self, ir: np.ndarray, fade_blocks: int = 8) -> int:
        """Click-free IR replacement on a live stream (beyond the
        reference, whose push_ir swaps at once, cl_conv.cpp:353-388; JAX
        ``api.py:232-264``).

        The next ``fade_blocks`` convolution() calls emit a per-sample
        linear blend from the outgoing to the incoming convolution (both
        exact over the whole input history); then the engine runs on the
        new IR alone. A second call before the fade ends adopts the previous
        target as the outgoing path and fades to the new one (the residual
        blend toward the abandoned target is dropped, so no more than two
        paths are ever kept).
        """
        if self._err != Status.SUCCESS:
            return int(self._err)
        ir = _block(ir, self.cfg.cvs, self.device, "IR")
        if fade_blocks < 1:
            raise ArgumentError(f"fade_blocks must be >= 1, got {fade_blocks}")
        self._end_fade()
        self._xf = _pconv.pconv_begin_xfade(self.cfg, self.state, ir)
        self._fade_pos, self._fade_total = 0, int(fade_blocks)
        return int(Status.SUCCESS)

    def convolution(self, output: np.ndarray, input1: np.ndarray,
                    input2: Optional[np.ndarray] = None) -> int:
        """One streaming block of pts samples (cl_conv.cpp:393-548).

        Two-argument form: LTI against the pushed IR (during a crossfade,
        one fade block). Three-argument form: time-varying, input2 streams
        into the coefficient ring; undefined during a crossfade, where it
        raises ArgumentError. Writes pts samples into ``output`` and
        returns a status code.

        Inside a traced request (a processor's ``fire``) its stages are the
        spans ``upload`` (the blocks to the device, or into the step graph's
        pinned buffer), ``step`` (the ``pconv_step{,_tv}`` enqueue, or the
        graph's replay) and ``download`` (the output read, which waits for
        the device).
        """
        if self._err != Status.SUCCESS:
            return int(self._err)
        if self._xf is not None and input2 is not None:
            raise ArgumentError(
                "time-varying streaming during an IR crossfade is undefined: let the "
                "fade finish or use push_ir for an instant swap")
        if self._xf is None and _pconv._mac_unpack_kernel(self.cfg, self.device):
            return self._replay(output, input1, input2)
        return self._eager(output, input1, input2)

    def _eager(self, output: np.ndarray, input1: np.ndarray,
               input2: Optional[np.ndarray]) -> int:
        """``convolution`` by the functional steps: the blocks to the
        device, ``pconv_step{,_tv}`` (a fade block during a crossfade), the
        output back."""
        with profiling.span("upload"):
            b1 = _block(input1, self.cfg.pts, self.device)
            b2 = None if input2 is None else _block(input2, self.cfg.pts, self.device)
        if self._xf is not None:
            ramp = _pconv._xfade_ramp(self.cfg, self._fade_pos, self._fade_total,
                                      self.device)
            self._xf, out = _pconv.pconv_step_xfade(self.cfg, self._xf, b1, ramp)
            self._fade_pos += 1
            if self._fade_pos >= self._fade_total:      # the ramp reached 1
                self._end_fade()
        elif b2 is None:
            self.state, out = _pconv.pconv_step(self.cfg, self.state, b1)
        else:
            self.state, out = _pconv.pconv_step_tv(self.cfg, self.state, b1, b2)
        with profiling.span("download"):
            _copy_out(output, out.cpu().numpy(), self.cfg.pts)
        return int(Status.SUCCESS)

    def _replay(self, output: np.ndarray, input1: np.ndarray,
                input2: Optional[np.ndarray]) -> int:
        """``convolution`` through the step graph of its form: the blocks
        into its pinned buffer, its firing, the output out of its pinned
        buffer."""
        tv = input2 is not None
        graph = self._graphs.get(tv)
        if graph is None:
            graph = self._graphs[tv] = _pconv.StepGraph(
                self.cfg, self.device, tv, on_message=lambda msg: self._msg(msg, self._user_data))
        with profiling.span("upload"):
            graph.x_np[0] = _samples(input1, self.cfg.pts)
            if tv:
                graph.x_np[1] = _samples(input2, self.cfg.pts)
        self.state = graph.step(self.state)
        with profiling.span("download"):
            _copy_out(output, graph.output(), self.cfg.pts)
        return int(Status.SUCCESS)

    def get_cl_err(self) -> int:
        return int(self._err)


class Cldconv:
    """Direct-convolution object (parity with cl_dconv.h:17-66).

    cvs    — IR size (irsize); vsiz — processing block size (vsize)
    errs/user_data — message callback surface
    delay_compat — reproduce the reference's extra sample of delay
    device — None/"cuda" for card ``device_index``, or "cpu"

    Like the reference, the constructor records a failure (``get_cl_err``)
    instead of raising; the methods then return that status.
    """

    def __init__(self, device_index: int = 0, cvs: int = 512, vsiz: int = 64,
                 errs: Optional[MessageCallback] = None, user_data: Any = None,
                 delay_compat: bool = False,
                 device: Optional[Union[str, torch.device]] = None):
        self._err = Status.SUCCESS
        self._exc: Optional[Exception] = None
        self._msg = resolve_callback(errs)
        self._user_data = user_data
        try:
            self.cfg = _dconv.DconvConfig(irsize=cvs, vsize=vsiz,
                                          delay_compat=delay_compat)
            self.device = get_device(device_index, device, errs, user_data)
            self.state = _dconv.dconv_init(self.cfg, self.device)
        except Exception as e:  # constructor records, does not raise (parity)
            self._err = getattr(e, "status", Status.UNKNOWN)
            self._exc = e
            self._msg(str(e), self._user_data)

    def push_ir(self, ir: np.ndarray) -> int:
        """Load the coefficients (cl_dconv.cpp:150-153)."""
        if self._err != Status.SUCCESS:
            return int(self._err)
        self.state = _dconv.push_ir(self.cfg, self.state,
                                    _block(ir, self.cfg.irsize, self.device, "IR"))
        return int(Status.SUCCESS)

    def convolution(self, output: np.ndarray, input1: np.ndarray,
                    input2: Optional[np.ndarray] = None) -> int:
        """One block of vsize samples (cl_dconv.cpp:109-148); the optional
        input2 streams time-varying coefficients."""
        if self._err != Status.SUCCESS:
            return int(self._err)
        b1 = _block(input1, self.cfg.vsize, self.device)
        if input2 is None:
            self.state, out = _dconv.dconv_step(self.cfg, self.state, b1)
        else:
            b2 = _block(input2, self.cfg.vsize, self.device)
            self.state, out = _dconv.dconv_step_tv(self.cfg, self.state, b1, b2)
        _copy_out(output, out.cpu().numpy(), self.cfg.vsize)
        return int(Status.SUCCESS)

    def get_cl_err(self) -> int:
        return int(self._err)


def _samples(samples: np.ndarray, n: int, what: str = "block") -> np.ndarray:
    """``samples`` as a flat float32 array of n samples; SizeError for any
    other length."""
    b = np.asarray(samples, dtype=np.float32).reshape(-1)
    if b.size != n:
        raise SizeError(f"{what} must have {n} samples, got {b.size}")
    return b


def _block(samples: np.ndarray, n: int, device: torch.device,
           what: str = "block") -> torch.Tensor:
    """``_samples`` as a tensor on ``device``."""
    return torch.from_numpy(_samples(samples, n, what)).to(device)


def _copy_out(output: np.ndarray, out: np.ndarray, n: int) -> None:
    dst = np.asarray(output)
    np.copyto(dst.reshape(-1)[:n], out, casting="unsafe")
