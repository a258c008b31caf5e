"""Class-based parity API mirroring the reference's C++ surface.

Only ``Clpconv`` (``cl_conv.h:124-188``) is ported so far: constructor
shape, status polling via ``get_cl_err`` and the message callback, on top
of the functional engine in ``ops/pconv.py``. Construction places the
streaming state on the chosen device.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

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
        ir = np.asarray(ir, dtype=np.float32).reshape(-1)
        if ir.size != self.cfg.cvs:
            raise SizeError(f"IR must have {self.cfg.cvs} samples, got {ir.size}")
        self.state = _pconv.push_ir(self.cfg, self.state,
                                    torch.from_numpy(ir).to(self.device))
        return int(Status.SUCCESS)

    def push_ir_xfade(self, ir: np.ndarray, fade_blocks: int = 8) -> int:
        raise NotImplementedError(
            "crossfaded IR replacement is not ported yet (ROADMAP queue 1 item 11)")

    def convolution(self, output: np.ndarray, input1: np.ndarray,
                    input2: Optional[np.ndarray] = None) -> int:
        """One LTI streaming block of pts samples (cl_conv.cpp:393-458):
        writes pts samples into ``output`` and returns a status code. The
        three-argument time-varying form is not ported yet."""
        if input2 is not None:
            raise NotImplementedError(
                "time-varying convolution is not ported yet (ROADMAP queue 1 item 4)")
        if self._err != Status.SUCCESS:
            return int(self._err)
        b1 = np.asarray(input1, dtype=np.float32).reshape(-1)
        if b1.size != self.cfg.pts:
            raise SizeError(f"block must have {self.cfg.pts} samples, got {b1.size}")
        self.state, out = _pconv.pconv_step(self.cfg, self.state,
                                            torch.from_numpy(b1).to(self.device))
        dst = np.asarray(output)
        np.copyto(dst.reshape(-1)[: self.cfg.pts], out.cpu().numpy().astype(dst.dtype))
        return int(Status.SUCCESS)

    def get_cl_err(self) -> int:
        return int(self._err)
