"""Streaming state across packages.

A ``PconvState`` (LTI or time-varying), an ``XfadeState`` (an IR crossfade
in progress), a ``DconvState`` and a zero-latency ``ZLState`` of the JAX
package and of this one have the same fields in the same layout, so a live
stream can move from one to the other mid-stream, mid-fade included. A
pconv state carries the IR spectra and the input ring, plus the overlap-add
tail and the ring pointers; a crossfade a pconv state and the outgoing IR's
ring and tail; a dconv state the delay line, the coefficient ring and its
pointer; a zero-latency state its block counter ``t``, the head's dconv
state and per segment its pconv state (``eng``), input buffer (``buf``)
and output queue (``queue``). The exchange format is numpy: a mapping (or
NamedTuple) of field name -> array, nested for the crossfade and the
zero-latency state.

States of every ring and compute dtype cross: a float64 state as float64
arrays, and a bf16 ring as float32 arrays (numpy has no bfloat16; the
widening is exact). ``*_from_numpy(..., cfg)`` puts each plane in the
config's dtype (a bf16 ring rounds back exactly); without a config the
planes are float32. The JAX package hands out bf16 rings as
``ml_dtypes.bfloat16`` arrays, which ``np.asarray(x, np.float32)`` widens
the same way. The sharded convolver's state (``parallel/sharded.py``)
crosses as the JAX package's global dict through ``shard_state`` and
``gather_state``, re-exported here.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from .models.lowlatency import ZLState, _SegState
from .ops.dconv import DconvConfig, DconvState
from .ops.pconv import PconvConfig, PconvState, XfadeState
from .parallel.sharded import gather_state, shard_state  # noqa: F401  (the sharded exchange)


def _fields(fields, state_type) -> Mapping[str, Any]:
    if hasattr(fields, "_asdict"):
        fields = fields._asdict()
    missing = set(state_type._fields) - set(fields)
    if missing:
        raise ValueError(f"missing {state_type.__name__} fields: {sorted(missing)}")
    return fields


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    """A copy of array a on ``device`` in ``dtype``: float64 through float64
    numpy, every other dtype (bf16 included) through float32."""
    npdt = np.float64 if dtype == torch.float64 else np.float32
    return torch.tensor(np.asarray(a, dtype=npdt), device=device).to(dtype)


def _array(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy: bf16 widened to float32, other dtypes kept."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _pointers(value, nparts: int, nch: int):
    """A ring pointer: a scalar becomes an int, a (C,) vector (a batched
    state's per-channel pointers) a tuple of C ints; both mod nparts."""
    a = np.asarray(value)
    if a.ndim == 0:
        return int(a) % nparts
    if a.shape != (nch,):
        raise ValueError(f"per-channel ring pointers must be ({nch},), got {a.shape}")
    return tuple(int(p) % nparts for p in a)


def pconv_state_from_numpy(fields: Union[Mapping[str, Any], tuple],
                           device: Union[str, torch.device],
                           cfg: Optional[PconvConfig] = None) -> PconvState:
    """Build a PconvState on ``device`` from numpy fields (for example the
    JAX package's ``PconvState`` mapped through ``np.asarray``). A batched
    state (``spec_h_re`` of rank 3, a leading channel axis) keeps that axis
    on every plane; its pointers may be scalars or per-channel vectors. The
    rings take ``cfg``'s storage dtype and the tail its compute dtype
    (float32 without a config)."""
    fields = _fields(fields, PconvState)
    hr = np.asarray(fields["spec_h_re"])
    if hr.ndim not in (2, 3):
        raise ValueError(f"spec_h_re must be ([C,] nparts, bins), got {hr.shape}")
    lead, (nparts, bins) = hr.shape[:-2], hr.shape[-2:]
    shapes = {"spec_x_re": (2 * nparts, bins), "spec_x_im": (2 * nparts, bins),
              "spec_h_re": (nparts, bins), "spec_h_im": (nparts, bins),
              "tail": (bins,)}
    planes = {}
    for name, shape in shapes.items():
        a = np.asarray(fields[name])
        if a.shape != lead + shape:
            raise ValueError(f"{name} must be {lead + shape}, got {a.shape}")
        dtype = torch.float32 if cfg is None else \
            cfg.compute_dtype if name == "tail" else cfg.storage_dtype
        planes[name] = _tensor(a, dtype, device)
    nch = lead[0] if lead else 1
    return PconvState(**planes, wp=_pointers(fields["wp"], nparts, nch),
                      wp2=_pointers(fields["wp2"], nparts, nch))


def pconv_state_to_numpy(state: PconvState) -> Dict[str, np.ndarray]:
    """The state's fields as numpy arrays, bf16 rings as float32 (ring
    pointers as int32 scalars, or int32 (C,) vectors when they are per
    channel: the JAX package's pointer type)."""
    out = {name: _array(getattr(state, name))
           for name in ("spec_x_re", "spec_x_im", "spec_h_re", "spec_h_im", "tail")}
    out["wp"] = np.asarray(state.wp, np.int32)
    out["wp2"] = np.asarray(state.wp2, np.int32)
    return out


def xfade_state_from_numpy(fields: Union[Mapping[str, Any], tuple],
                           device: Union[str, torch.device],
                           cfg: Optional[PconvConfig] = None) -> XfadeState:
    """Build an XfadeState (a crossfade in progress) on ``device`` from
    numpy fields: ``state`` (the PconvState fields, as for
    ``pconv_state_from_numpy``) and the outgoing path's ``old_h_re``,
    ``old_h_im`` and ``old_tail``, for example the JAX package's
    ``XfadeState`` mapped through ``np.asarray``; each plane in the dtype
    of its counterpart in ``state``."""
    fields = _fields(fields, XfadeState)
    state = pconv_state_from_numpy(fields["state"], device, cfg)
    old = {}
    for name, like in (("old_h_re", state.spec_h_re), ("old_h_im", state.spec_h_im),
                       ("old_tail", state.tail)):
        a = np.asarray(fields[name])
        if a.shape != tuple(like.shape):
            raise ValueError(f"{name} must be {tuple(like.shape)}, got {a.shape}")
        old[name] = _tensor(a, like.dtype, device)
    return XfadeState(state=state, **old)


def xfade_state_to_numpy(xf: XfadeState) -> Dict[str, Any]:
    """The crossfade's fields as numpy: ``state`` as
    ``pconv_state_to_numpy`` gives it, and the outgoing path's planes."""
    out: Dict[str, Any] = {"state": pconv_state_to_numpy(xf.state)}
    for name in ("old_h_re", "old_h_im", "old_tail"):
        out[name] = _array(getattr(xf, name))
    return out


def dconv_state_from_numpy(fields: Union[Mapping[str, Any], tuple],
                           device: Union[str, torch.device],
                           cfg: Optional[DconvConfig] = None) -> DconvState:
    """Build a DconvState on ``device`` from numpy fields (for example the
    JAX package's ``DconvState`` mapped through ``np.asarray``), in
    ``cfg``'s dtype (float32 without a config)."""
    fields = _fields(fields, DconvState)
    delay = np.asarray(fields["delay"])
    coefs = np.asarray(fields["coefs"])
    if delay.ndim != 1 or coefs.shape != delay.shape:
        raise ValueError(f"delay and coefs must be one (ring,) shape, got "
                         f"{delay.shape} and {coefs.shape}")
    dtype = torch.float32 if cfg is None else cfg.compute_dtype
    return DconvState(delay=_tensor(delay, dtype, device), coefs=_tensor(coefs, dtype, device),
                      wp=int(fields["wp"]) % delay.shape[0])


def dconv_state_to_numpy(state: DconvState) -> Dict[str, np.ndarray]:
    """The state's fields as numpy arrays (the ring pointer as an int32
    scalar, the JAX package's pointer type)."""
    return {"delay": state.delay.detach().cpu().numpy(),
            "coefs": state.coefs.detach().cpu().numpy(),
            "wp": np.asarray(state.wp, np.int32)}


def zl_state_from_numpy(fields: Union[Mapping[str, Any], tuple],
                        device: Union[str, torch.device]) -> ZLState:
    """Build a ZLState on ``device`` from numpy fields: ``t``, ``head`` (the
    DconvState fields) and ``segs``, one mapping per segment of ``eng``
    (the PconvState fields), ``buf`` (pts,) and ``queue`` (delay + 1, pts);
    for example the JAX package's ``ZLState`` as it is (its arrays go
    through ``np.asarray``). Assign it to a ``ZeroLatencyConvolver`` of the
    same IR, block and pmax."""
    fields = _fields(fields, ZLState)
    segs = []
    for seg in fields["segs"]:
        seg = _fields(seg, _SegState)
        eng = pconv_state_from_numpy(seg["eng"], device)
        pts = eng.tail.shape[-1]
        buf = np.asarray(seg["buf"], dtype=np.float32)
        queue = np.asarray(seg["queue"], dtype=np.float32)
        if buf.shape != (pts,) or queue.ndim != 2 or queue.shape[1] != pts \
                or queue.shape[0] < 2:
            raise ValueError(f"a segment of pts {pts} needs buf ({pts},) and queue "
                             f"(delay + 1 >= 2, {pts}), got {buf.shape} and {queue.shape}")
        segs.append(_SegState(eng=eng, buf=torch.tensor(buf, device=device),
                              queue=torch.tensor(queue, device=device)))
    return ZLState(t=int(np.asarray(fields["t"])),
                   head=dconv_state_from_numpy(fields["head"], device), segs=tuple(segs))


def zl_state_to_numpy(state: ZLState) -> Dict[str, Any]:
    """The zero-latency state's fields as numpy: ``t`` as an int32 scalar
    (the JAX package's counter type), ``head`` as ``dconv_state_to_numpy``
    gives it and ``segs`` a list of per-segment mappings (``eng`` as
    ``pconv_state_to_numpy`` gives it, ``buf``, ``queue``)."""
    return {"t": np.asarray(state.t, np.int32), "head": dconv_state_to_numpy(state.head),
            "segs": [{"eng": pconv_state_to_numpy(s.eng), "buf": s.buf.detach().cpu().numpy(),
                      "queue": s.queue.detach().cpu().numpy()} for s in state.segs]}
