"""Sharded execution of the FFT and partitioned-convolution engines on a
(dp, tp) mesh of ranks.

Counterpart of ``opencl_fft_tpu/parallel/sharded.py``, one program per rank
(``torch.distributed``) where the JAX package has one ``shard_map``:

  * ``sharded_fft``: the batch axis sharded over a mesh axis; each rank
    transforms its rows locally, no communication.

  * the sharded convolver (``make_sharded_pconv_step``, the crossfade
    ``make_sharded_pconv_xfade`` and ``sharded_push_ir``): channels shard
    over dp and the frequency-delay line (the partition axis) over tp. The
    input spectral ring is replicated over tp (one frame a block), the
    coefficient ring and the partition MAC are sharded, and one all_reduce
    of the (channels, bins) accumulators over tp completes the spectral
    accumulation: O(bins) floats a block, independent of the IR length.

The state is a dict in the JAX package's global layout (``sharded_pconv_init``):
spec_x (batch, nparts, bins), NOT doubled, replicated over tp; spec_h
(batch, nparts, bins) sharded over dp and tp; tail (batch, pts); the ring
pointers wp and wp2 shared. A rank holds its shard (``shard_state``): its
dp block of channels, and of spec_h its tp block of partitions, rows
[lo, lo + nparts/tp) with lo = tp index * nparts/tp. Blocks, IRs and outputs
are this rank's dp block of channels. Functions return a new state and do
not modify the one they are given.

The local MAC is plain PyTorch, as it is plain ``jnp`` in the JAX package:
the port's ``spectral_mac`` kernel reads a doubled ring, not this layout.
``ALL_REDUCES`` counts the all_reduce calls of these functions and
``ALL_REDUCE_ELEMENTS`` the elements they reduce, on this rank.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops import pconv as _p
from ..ops.cplx import Cplx
from ..ops.fft import fft_split
from ..ops.rfft import irfft_split
from .mesh import Mesh

ALL_REDUCES = 0
ALL_REDUCE_ELEMENTS = 0

_RINGS = ("spec_x_re", "spec_x_im", "spec_h_re", "spec_h_im")


def _all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum t over this rank's tp group, in place (the JAX ``psum``)."""
    global ALL_REDUCES, ALL_REDUCE_ELEMENTS
    dist.all_reduce(t, group=mesh.groups["tp"])
    ALL_REDUCES += 1
    ALL_REDUCE_ELEMENTS += t.numel()
    return t


def sharded_fft(x: Cplx, mesh: Mesh, sign: int = -1, impl: str = "auto",
                axis: str = "dp") -> Cplx:
    """Batched FFT with the leading axis sharded over ``axis``: x is this
    rank's split (rows, n) block of the batch. Pure data parallelism: no
    collective. ``mesh`` and ``axis`` are ignored, since each rank already
    holds its own rows; they keep the JAX signature."""
    del mesh, axis
    return fft_split(x, sign, impl)


def sharded_pconv_init(cfg: _p.PconvConfig, batch: int) -> Dict[str, np.ndarray]:
    """Zero state of a batched sharded convolver, in the JAX package's global
    layout as numpy: spec_x_* and spec_h_* (batch, nparts, bins), tail
    (batch, pts), float32; wp = 0 and wp2 = nparts - 1 as int32 scalars."""
    def z(*shape):
        return np.zeros(shape, np.float32)

    return dict(spec_x_re=z(batch, cfg.nparts, cfg.bins), spec_x_im=z(batch, cfg.nparts, cfg.bins),
                spec_h_re=z(batch, cfg.nparts, cfg.bins), spec_h_im=z(batch, cfg.nparts, cfg.bins),
                tail=z(batch, cfg.pts), wp=np.asarray(0, np.int32),
                wp2=np.asarray(cfg.nparts - 1, np.int32))


def _local_parts(nparts: int, mesh: Mesh) -> Tuple[int, int]:
    """(lo, count) of this rank's partition rows; nparts must divide over tp."""
    tp = mesh.shape["tp"]
    if nparts % tp:
        raise ValueError(f"nparts {nparts} must divide over tp={tp}")
    local = nparts // tp
    return mesh.coords["tp"] * local, local


def shard_state(fields: Mapping[str, object], mesh: Mesh) -> Dict[str, object]:
    """This rank's shard of a global sharded state (the torch form of the
    JAX ``state_shardings``): fields as ``sharded_pconv_init`` gives them,
    or the JAX package's sharded state mapped through ``np.asarray``.
    Returns float32 tensors on ``mesh.device`` and int pointers."""
    nparts = np.asarray(fields["spec_h_re"]).shape[1]
    lo, local = _local_parts(nparts, mesh)
    batch = np.asarray(fields["tail"]).shape[0]
    rows = mesh.rows(batch)

    def plane(name, parts=slice(None)):
        a = np.asarray(fields[name], np.float32)[rows, parts]
        return torch.tensor(a, device=mesh.device)          # a copy

    out = {name: plane(name) for name in ("spec_x_re", "spec_x_im", "tail")}
    out.update({name: plane(name, slice(lo, lo + local)) for name in ("spec_h_re", "spec_h_im")})
    out["wp"] = int(np.asarray(fields["wp"])) % nparts
    out["wp2"] = int(np.asarray(fields["wp2"])) % nparts
    return out


def gather_state(local: Mapping[str, object], mesh: Mesh) -> Dict[str, np.ndarray]:
    """The global state, as numpy, from every rank's shard (a collective:
    every rank calls it and gets the whole state; for exchange and tests,
    not for the per-block path)."""
    mine = {name: local[name].detach().cpu().numpy() for name in (*_RINGS, "tail")}
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, (mesh.coords["dp"], mesh.coords["tp"], mine))
    by = {(d, t): planes for d, t, planes in everyone}
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    out = {name: np.concatenate([by[(d, 0)][name] for d in range(dp)])
           for name in ("spec_x_re", "spec_x_im", "tail")}
    for name in ("spec_h_re", "spec_h_im"):
        out[name] = np.concatenate([np.concatenate([by[(d, t)][name] for t in range(tp)], 1)
                                    for d in range(dp)])
    out["wp"] = np.asarray(local["wp"], np.int32)
    out["wp2"] = np.asarray(local["wp2"], np.int32)
    return out


def _with_row(plane: torch.Tensor, row: torch.Tensor, slot: int) -> torch.Tensor:
    """A copy of (b, rows, bins) ``plane`` with (b, bins) ``row`` at row
    ``slot`` of every channel."""
    plane = plane.clone()
    plane[:, slot] = row.to(plane.dtype)
    return plane


def _local_mac(cfg: _p.PconvConfig, mesh: Mesh, x: Cplx, h: Cplx, wp: int) -> torch.Tensor:
    """This rank's part of the MAC at read pointer wp, stacked (2, b, bins):
    its partitions q in [lo, lo + local) pair input frame (wp + q) mod
    nparts with coefficient row q (cl_conv_kernels.h:104-113)."""
    lo, local = _local_parts(cfg.nparts, mesh)
    idx = (wp + lo + torch.arange(local, device=x[0].device)) % cfg.nparts
    return torch.stack(_p._window_mac(cfg, x[0][:, idx], x[1][:, idx], *h))


def _ola(cfg: _p.PconvConfig, acc: torch.Tensor, tail: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse transform of the stacked (2, ..., bins) accumulators and the
    overlap-add with ``tail``: (out, new tail)."""
    y = irfft_split((acc[0], acc[1]), cfg.impl)
    return (y[..., :cfg.pts] + tail) / cfg.pts, y[..., cfg.pts:].contiguous()


def _write_input(cfg: _p.PconvConfig, st: Dict[str, object], xr: torch.Tensor,
                 xi: torch.Tensor) -> int:
    """Write the input frame at slot wp of the replicated ring (every tp
    rank) and advance wp; returns the new wp, the MAC's read pointer."""
    st["spec_x_re"] = _with_row(st["spec_x_re"], xr, st["wp"])
    st["spec_x_im"] = _with_row(st["spec_x_im"], xi, st["wp"])
    st["wp"] = (st["wp"] + 1) % cfg.nparts
    return st["wp"]


def make_sharded_pconv_step(cfg: _p.PconvConfig, mesh: Mesh, tv: bool = True) -> Callable:
    """The sharded per-block step: ``step(state, block_x[, block_h]) ->
    (state, out)`` with (b, pts) blocks of this rank's channels. One
    all_reduce over tp a block, of the stacked (2, b, bins) accumulators
    (JAX ``sharded.py:106-180``)."""
    lo, local = _local_parts(cfg.nparts, mesh)

    def step(state, block_x: torch.Tensor, block_h: Optional[torch.Tensor] = None):
        if (block_h is not None) != tv:
            raise ValueError(f"a {'TV' if tv else 'LTI'} step takes "
                             f"{'two operands' if tv else 'one operand'}")
        st = dict(state)
        if tv:
            fr, fi = _p._forward_partition(cfg, torch.stack([block_x, block_h], 1))
            xr, xi, hr, hi = fr[:, 0], fi[:, 0], fr[:, 1], fi[:, 1]
            # the coefficient frame lands at global slot wp2, on the tp rank
            # whose partitions hold it
            if lo <= st["wp2"] < lo + local:
                st["spec_h_re"] = _with_row(st["spec_h_re"], hr, st["wp2"] - lo)
                st["spec_h_im"] = _with_row(st["spec_h_im"], hi, st["wp2"] - lo)
            st["wp2"] = (st["wp2"] - 1) % cfg.nparts
        else:
            xr, xi = _p._forward_partition(cfg, block_x)
        wp = _write_input(cfg, st, xr, xi)
        acc = _local_mac(cfg, mesh, (st["spec_x_re"], st["spec_x_im"]),
                         (st["spec_h_re"], st["spec_h_im"]), wp)
        out, st["tail"] = _ola(cfg, _all_reduce(acc, mesh), st["tail"])
        return st, out

    return step


def _local_coefs(cfg: _p.PconvConfig, mesh: Mesh, irs: torch.Tensor, wp2: int) -> Cplx:
    """This rank's coefficient rows of (b, cvs) IRs in ``push_ir``'s layout:
    partition p at slot (wp2 - p) mod nparts, so slot s holds partition
    (wp2 - s) mod nparts."""
    lo, local = _local_parts(cfg.nparts, mesh)
    hr, hi = _p._forward_partition(cfg, irs.reshape(irs.shape[0], cfg.nparts, cfg.pts))
    src = (wp2 - (lo + torch.arange(local, device=irs.device))) % cfg.nparts
    return hr[:, src], hi[:, src]


def sharded_push_ir(cfg: _p.PconvConfig, mesh: Mesh, state, irs: torch.Tensor):
    """Batched ``push_ir`` for the sharded state: irs (b, cvs) of this
    rank's channels (JAX ``sharded.py:291-317``). No communication."""
    hr, hi = _local_coefs(cfg, mesh, irs, state["wp2"])
    return dict(state, spec_h_re=hr.to(state["spec_h_re"].dtype).contiguous(),
                spec_h_im=hi.to(state["spec_h_im"].dtype).contiguous())


def make_sharded_pconv_xfade(cfg: _p.PconvConfig, mesh: Mesh) -> Tuple[Callable, Callable]:
    """(begin, step) of a click-free IR replacement on the sharded LTI
    engine: the sharded form of ``pconv_begin_xfade`` / ``pconv_step_xfade``
    (JAX ``sharded.py:183-289``).

    ``begin(state, irs, mask)`` starts a fade on this rank's channels where
    ``mask`` ((b,) bool) is True; irs (b, cvs), rows outside the mask
    unused. The others keep their coefficients and tail on both paths. The
    incoming path's tail is rebuilt from the replicated input ring: one
    all_reduce, once. ``step(xf, block, ramp)`` runs one faded block: both
    paths' local MACs ride one all_reduce of the stacked (2, 2, b, bins)
    accumulators. When the ramp reaches 1, continue with the plain step on
    ``xf``'s state keys (drop ``old_*``).
    """
    _local_parts(cfg.nparts, mesh)

    def begin(state, irs: torch.Tensor, mask: torch.Tensor):
        hr, hi = _local_coefs(cfg, mesh, irs, state["wp2"])
        m3 = mask[:, None, None]
        h_sel = (torch.where(m3, hr, state["spec_h_re"]), torch.where(m3, hi, state["spec_h_im"]))
        acc = _local_mac(cfg, mesh, (state["spec_x_re"], state["spec_x_im"]), h_sel,
                         state["wp"])
        _, tail_new = _ola(cfg, _all_reduce(acc, mesh), state["tail"])
        return dict(state, spec_h_re=h_sel[0], spec_h_im=h_sel[1],
                    tail=torch.where(mask[:, None], tail_new, state["tail"]),
                    old_h_re=state["spec_h_re"], old_h_im=state["spec_h_im"],
                    old_tail=state["tail"])

    def step(xf, block: torch.Tensor, ramp: torch.Tensor):
        st = dict(xf)
        wp = _write_input(cfg, st, *_p._forward_partition(cfg, block))
        x = (st["spec_x_re"], st["spec_x_im"])
        acc = torch.stack([_local_mac(cfg, mesh, x, (st["spec_h_re"], st["spec_h_im"]), wp),
                           _local_mac(cfg, mesh, x, (st["old_h_re"], st["old_h_im"]), wp)], 1)
        outs, tails = _ola(cfg, _all_reduce(acc, mesh),        # (2 paths, b, pts)
                           torch.stack([st["tail"], st["old_tail"]]))
        st["tail"], st["old_tail"] = tails[0], tails[1]
        ramp = torch.as_tensor(ramp, dtype=outs.dtype, device=outs.device)
        return st, outs[1] + ramp * (outs[0] - outs[1])

    return begin, step
