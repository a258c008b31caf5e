"""Message-callback surface.

The reference routes diagnostics through an optional ``(msg, userData)``
callback defaulting to stdout (``cl_conv.h:137-145``, ``cl_dconv.h:25-32``);
Csound installs ``err_msg`` -> ``csound->message`` (``csound/opcode.cpp:38-41``).

We keep the same shape: engines accept ``on_message: Callable[[str, Any], None]``
with a stdout default, so host applications can reroute diagnostics without
touching Python logging config. A standard :mod:`logging` bridge is provided.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Optional

MessageCallback = Callable[[str, Any], None]

_logger = logging.getLogger("opencl_fft_tpu_torch")


def default_message(msg: str, user_data: Any = None) -> None:
    """Default callback: print to stdout (parity with cl_conv.h:142-145)."""
    print(msg)


def logging_message(msg: str, user_data: Any = None) -> None:
    """Alternative callback that routes into the stdlib logging module."""
    _logger.info(msg)


def resolve_callback(cb: Optional[MessageCallback]) -> MessageCallback:
    return cb if cb is not None else default_message
