"""Rank programs of the multi-process tests of opencl_fft_tpu_torch.parallel
(tests/test_torch_parallel.py, tests/test_torch_dist_fft.py).

``opencl_fft_tpu_torch.parallel.dryrun.run_ranks`` starts the ranks by the
spawn method, and each rank imports the module of the function it runs.
So this module imports numpy, torch and the port only, never JAX or the
JAX package, and holds no tests: the test files compute the JAX references
in the parent process and hand the inputs over as numpy. Every function
here runs on each rank of one gloo group on the CPU and returns numpy.
"""

import functools
import importlib

import numpy as np
import torch

from opencl_fft_tpu_torch.ops import pconv as P
from opencl_fft_tpu_torch.parallel import sharded as S
from opencl_fft_tpu_torch.parallel.mesh import make_mesh

# the module (its ALL_TO_ALLS counter), which the package's dist_fft
# function shadows as an attribute
DF = importlib.import_module("opencl_fft_tpu_torch.parallel.dist_fft")


@functools.lru_cache(maxsize=None)
def _mesh(shape):
    """The gloo mesh of this shape, built once a process: every rank asks
    for the same shapes in the same order."""
    return make_mesh(shape, backend="gloo", device="cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def fft_case(shape, x, xi):
    """sharded_fft of this rank's rows of the (batch, n) planes."""
    mesh = _mesh(shape)
    rows = mesh.rows(x.shape[0])
    re, im = S.sharded_fft((_t(x[rows]), _t(xi[rows])), mesh)
    return {"coords": mesh.coords, "rows": rows, "re": re.numpy(), "im": im.numpy()}


def stream_case(shape, pts, nparts, irs, bx, bh=None, state=None):
    """A sharded stream: from ``state`` (global numpy fields) or from zero
    with ``irs`` (batch, cvs) pushed, one step a block of bx (and bh for
    TV) (nblocks, batch, pts). Returns this rank's outputs, the gathered
    final state and the all_reduce calls and elements of the steps."""
    mesh = _mesh(shape)
    cfg = P.PconvConfig.for_ir_length(pts * nparts, pts)
    batch = bx.shape[1]
    rows = mesh.rows(batch)
    if state is None:
        st = S.shard_state(S.sharded_pconv_init(cfg, batch), mesh)
        if irs is not None:
            st = S.sharded_push_ir(cfg, mesh, st, _t(irs[rows]))
    else:
        st = S.shard_state(state, mesh)
    step = S.make_sharded_pconv_step(cfg, mesh, tv=bh is not None)
    calls, elems = S.ALL_REDUCES, S.ALL_REDUCE_ELEMENTS
    outs = []
    for b in range(bx.shape[0]):
        args = (_t(bx[b, rows]),) if bh is None else (_t(bx[b, rows]), _t(bh[b, rows]))
        st, o = step(st, *args)
        outs.append(o.numpy())
    calls, elems = S.ALL_REDUCES - calls, S.ALL_REDUCE_ELEMENTS - elems
    return {"coords": mesh.coords, "rows": rows, "outs": np.stack(outs, 1),
            "state": S.gather_state(st, mesh), "all_reduces": calls,
            "all_reduce_elements": elems}


def roundtrip_case(shape, fields):
    """gather_state(shard_state(fields)): the global state back."""
    mesh = _mesh(shape)
    return S.gather_state(S.shard_state(fields, mesh), mesh)


def xfade_case(shape, pts, nparts, irs0, irs_new, mask, x, start, fade):
    """The crossfade schedule of the JAX test: the plain step, then from
    block ``start`` ``fade`` faded blocks (ramp rising to 1), then the plain
    step on the faded state's keys; beside it an engine that never swaps.
    Returns this rank's outputs of both, (batch rows, nblocks, pts)."""
    mesh = _mesh(shape)
    cfg = P.PconvConfig.for_ir_length(pts * nparts, pts)
    rows = mesh.rows(x.shape[1])

    def fresh():
        return S.sharded_push_ir(cfg, mesh, S.shard_state(S.sharded_pconv_init(cfg, irs0.shape[0]),
                                                          mesh), _t(irs0[rows]))

    step = S.make_sharded_pconv_step(cfg, mesh, tv=False)
    begin, step_xf = S.make_sharded_pconv_xfade(cfg, mesh)
    st, ref_st, xf = fresh(), fresh(), None
    outs, refs = [], []
    for i in range(x.shape[0]):
        blk = _t(x[i, rows])
        if i == start:
            xf = begin(st, _t(irs_new[rows]), _t(mask[rows]))
        if xf is not None and i - start < fade:
            ramp = (np.arange(pts, dtype=np.float32) + 1 + (i - start) * pts) \
                / np.float32(fade * pts)
            xf, o = step_xf(xf, blk, _t(ramp))
            if i - start == fade - 1:
                st, xf = {k: xf[k] for k in st}, None
        else:
            st, o = step(st, blk)
        ref_st, ro = step(ref_st, blk)
        outs.append(o.numpy())
        refs.append(ro.numpy())
    return {"coords": mesh.coords, "rows": rows, "outs": np.stack(outs, 1),
            "refs": np.stack(refs, 1)}


def dist_fft_case(shape, axis, x, sign):
    """dist_fft of the whole complex array x over ``axis``, and the
    all_to_all calls it made."""
    mesh = _mesh(shape)
    calls = DF.ALL_TO_ALLS
    y = DF.dist_fft(x, mesh, axis=axis, sign=sign)
    return {"y": y.numpy(), "all_to_alls": DF.ALL_TO_ALLS - calls}


def dist_fft_split_case(shape, axis, re, im):
    """dist_fft_split of this rank's block of the (..., n) planes."""
    mesh = _mesh(shape)
    d, i = mesh.shape[axis], mesh.coords[axis]
    blk = slice(i * re.shape[-1] // d, (i + 1) * re.shape[-1] // d)
    r, m = DF.dist_fft_split((_t(re[..., blk]), _t(im[..., blk])), mesh, axis)
    return {"block": blk, "re": r.numpy(), "im": m.numpy()}


def bad_mesh_case(shape, backend):
    """make_mesh's ValueError for a shape or backend that does not fit the
    group (every rank raises before any collective)."""
    try:
        make_mesh(shape, backend=backend, device="cpu")
    except ValueError as e:
        return str(e)
    return "no error"


def run_cases(cases):
    """Each (name, function name, args) of ``cases`` in turn on this rank:
    {name: result}."""
    return {name: globals()[fn](*args) for name, fn, args in cases}
