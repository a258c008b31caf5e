"""Class-based parity API mirroring the reference's C++ surface.

``Clpconv`` (``cl_conv.h:124-188``) and ``Cldconv`` (``cl_dconv.h:17-66``)
are ported so far: constructor shape, status polling via ``get_cl_err`` and
the message callback, on top of the functional engines in ``ops/pconv.py``
and ``ops/dconv.py``. Construction places the streaming state on the chosen
device.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from .ops import dconv as _dconv
from .ops import pconv as _pconv
from .utils.devices import get_device
from .utils.errors import SizeError, Status
from .utils.logging import MessageCallback, resolve_callback


class Clpconv:
    """Partitioned-convolution object (parity with cl_conv.h:124-188).

    cvs    — convolution (IR) size in samples
    pts    — partition size (power of two); nparts = cvs/pts
    errs/user_data — message callback surface (cl_conv.h:137-145)
    bin0_mode — "exact" (true convolution) or "compat" (see ops/pconv.py)
    device — None/"cuda" for card ``device_index``, or "cpu"

    Like the reference, the constructor records a failure (``get_cl_err``)
    instead of raising; the methods then return that status.
    """

    def __init__(self, device_index: int = 0, cvs: int = 1024, pts: int = 64,
                 errs: Optional[MessageCallback] = None, user_data: Any = None,
                 bin0_mode: str = "exact", impl: str = "auto",
                 device: Optional[Union[str, torch.device]] = None):
        self._err = Status.SUCCESS
        self._exc: Optional[Exception] = None
        self._msg = resolve_callback(errs)
        self._user_data = user_data
        try:
            self.cfg = _pconv.PconvConfig.for_ir_length(
                cvs, pts, bin0_mode=bin0_mode, impl=impl)
            self.device = get_device(device_index, device, errs, user_data)
            self.state = _pconv.pconv_init(self.cfg, self.device)
        except Exception as e:  # constructor records, does not raise (parity)
            self._err = getattr(e, "status", Status.UNKNOWN)
            self._exc = e
            self._msg(str(e), self._user_data)

    def push_ir(self, ir: np.ndarray) -> int:
        """Analyze an IR into the coefficient ring (cl_conv.cpp:353-388)."""
        if self._err != Status.SUCCESS:
            return int(self._err)
        self.state = _pconv.push_ir(self.cfg, self.state,
                                    _block(ir, self.cfg.cvs, self.device, "IR"))
        return int(Status.SUCCESS)

    def push_ir_xfade(self, ir: np.ndarray, fade_blocks: int = 8) -> int:
        raise NotImplementedError(
            "crossfaded IR replacement is not ported yet (ROADMAP queue 1 item 11)")

    def convolution(self, output: np.ndarray, input1: np.ndarray,
                    input2: Optional[np.ndarray] = None) -> int:
        """One streaming block of pts samples (cl_conv.cpp:393-548).

        Two-argument form: LTI against the pushed IR. Three-argument form:
        time-varying, input2 streams into the coefficient ring. Writes pts
        samples into ``output`` and returns a status code.
        """
        if self._err != Status.SUCCESS:
            return int(self._err)
        b1 = _block(input1, self.cfg.pts, self.device)
        if input2 is None:
            self.state, out = _pconv.pconv_step(self.cfg, self.state, b1)
        else:
            b2 = _block(input2, self.cfg.pts, self.device)
            self.state, out = _pconv.pconv_step_tv(self.cfg, self.state, b1, b2)
        _copy_out(output, out, self.cfg.pts)
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
        _copy_out(output, out, self.cfg.vsize)
        return int(Status.SUCCESS)

    def get_cl_err(self) -> int:
        return int(self._err)


def _block(samples: np.ndarray, n: int, device: torch.device,
           what: str = "block") -> torch.Tensor:
    """``samples`` as a float32 tensor of n samples on ``device``;
    SizeError for any other length."""
    b = np.asarray(samples, dtype=np.float32).reshape(-1)
    if b.size != n:
        raise SizeError(f"{what} must have {n} samples, got {b.size}")
    return torch.from_numpy(b).to(device)


def _copy_out(output: np.ndarray, out: torch.Tensor, n: int) -> None:
    dst = np.asarray(output)
    np.copyto(dst.reshape(-1)[:n], out.cpu().numpy().astype(dst.dtype))
