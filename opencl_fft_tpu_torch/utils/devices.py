"""Device selection.

The reference selects an OpenCL device by flat index (``clGetDeviceIDs`` +
``device_ids[i]``, e.g. ``csound/opcode.cpp:57-64``) and announces its
name. Here the index picks a CUDA card; the CPU is used only when the
caller asks for it by name, so a missing card is an error, never a silent
fall back.
"""

from __future__ import annotations

from typing import Any, List, Optional, Union

import torch

from .errors import DeviceError, Status
from .logging import MessageCallback, resolve_callback


def list_devices() -> List[torch.device]:
    """The CUDA cards, in index order (the ``clGetDeviceIDs`` analog); an
    empty list without one. The CPU is never listed: it is used only when
    asked for by name."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def get_device(device_index: int = 0,
               device: Optional[Union[str, torch.device]] = None,
               on_message: Optional[MessageCallback] = None,
               user_data: Any = None) -> torch.device:
    """Resolve the device an engine runs on, announcing it like the
    reference does.

    ``device=None`` or ``"cuda"`` selects ``cuda:{device_index}``; an
    explicit ``"cuda:i"`` or ``"cpu"`` is taken as given. Raises
    DeviceError (DEVICE_NOT_FOUND) when CUDA is asked for and absent, and
    (INVALID_DEVICE) when the index is out of range.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        resolve_callback(on_message)("using device: cpu", user_data)
        return dev
    if dev.type != "cuda":
        raise DeviceError(f"unsupported device type {dev.type!r}",
                          Status.INVALID_DEVICE)
    if not torch.cuda.is_available():
        raise DeviceError("failed to find a CUDA device!",
                          Status.DEVICE_NOT_FOUND)
    index = device_index if dev.index is None else dev.index
    count = torch.cuda.device_count()
    if index < 0 or index >= count:
        raise DeviceError(
            f"device index {index} out of range (found {count})",
            Status.INVALID_DEVICE)
    dev = torch.device("cuda", index)
    resolve_callback(on_message)(
        f"using device: {torch.cuda.get_device_name(dev)} ({dev})", user_data)
    return dev
