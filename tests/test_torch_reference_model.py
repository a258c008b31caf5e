"""The port against ``tests/reference_model.py`` (the literal numpy model of
the reference's OpenCL kernels, ``RefPconv`` and ``RefDconv``) on the CPU,
on the JAX tests' cases (``tests/test_pconv.py``, ``tests/test_dconv.py``)
at their bars: the partitioned engine with ``bin0_mode="compat"``, LTI and
time-varying, at 2e-4 of (max|expect| + 1); the direct engine with
``delay_compat=True``, LTI and time-varying, at 1e-4 of it. The streams
(``pconv_stream{,_tv}``, ``dconv_stream``) are held to the model too."""

import numpy as np
import pytest
import torch

from opencl_fft_tpu_torch.ops import dconv as D
from opencl_fft_tpu_torch.ops import pconv as P
from reference_model import RefDconv, RefPconv

torch.set_num_threads(1)
RNG = np.random.default_rng(42)
PCONV_BAR, DCONV_BAR = 2e-4, 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _close(got, expect, bar):
    np.testing.assert_allclose(np.asarray(got), expect,
                               atol=bar * (np.max(np.abs(expect)) + 1), rtol=0)


@pytest.mark.parametrize("pts,nparts", [(32, 1), (32, 3), (32, 8), (128, 8)])
def test_pconv_compat_matches_reference_model(pts, nparts):
    """bin0_mode='compat' tracks the literal reference math block by block,
    across ring wrap-arounds."""
    cvs = pts * nparts
    ir = RNG.standard_normal(cvs).astype(np.float32)
    cfg = P.PconvConfig.for_ir_length(cvs, pts, bin0_mode="compat")
    state = P.push_ir(cfg, P.pconv_init(cfg, "cpu"), _t(ir))
    ref = RefPconv(cvs, pts)
    ref.push_ir(ir.astype(np.float64))
    for _ in range(3 * nparts + 2):
        blk = RNG.standard_normal(pts).astype(np.float32)
        state, out = P.pconv_step(cfg, state, _t(blk))
        _close(out, ref.convolution(blk.astype(np.float64)), PCONV_BAR)


@pytest.mark.parametrize("pts,nparts", [(16, 2), (16, 5), (128, 8)])
def test_pconv_tv_matches_reference_model(pts, nparts):
    """Time-varying: both rings rotate (wp up, wp2 down) as
    cl_conv.cpp:460-548 does, across several wrap-arounds."""
    cvs = pts * nparts
    cfg = P.PconvConfig.for_ir_length(cvs, pts, bin0_mode="compat")
    state = P.pconv_init(cfg, "cpu")
    ref = RefPconv(cvs, pts)
    for _ in range(4 * nparts + 3):
        b1 = RNG.standard_normal(pts).astype(np.float32)
        b2 = RNG.standard_normal(pts).astype(np.float32)
        state, out = P.pconv_step_tv(cfg, state, _t(b1), _t(b2))
        _close(out, ref.convolution_tv(b1.astype(np.float64), b2.astype(np.float64)),
               PCONV_BAR)


@pytest.mark.parametrize("tv", [False, True])
def test_pconv_streams_match_reference_model(tv):
    """The whole-scan streams (the kernels' plain twins on the CPU), in
    compat mode, against the model's blocks."""
    pts, nparts, nb = 32, 4, 19
    cvs = pts * nparts
    cfg = P.PconvConfig.for_ir_length(cvs, pts, bin0_mode="compat")
    ref = RefPconv(cvs, pts)
    x = RNG.standard_normal((nb, pts)).astype(np.float32)
    h = RNG.standard_normal((nb, pts)).astype(np.float32)
    if tv:
        _, out = P.pconv_stream_tv(cfg, P.pconv_init(cfg, "cpu"), _t(x), _t(h))
        want = [ref.convolution_tv(a.astype(np.float64), b.astype(np.float64))
                for a, b in zip(x, h)]
    else:
        ir = RNG.standard_normal(cvs).astype(np.float32)
        ref.push_ir(ir.astype(np.float64))
        st = P.push_ir(cfg, P.pconv_init(cfg, "cpu"), _t(ir))
        _, out = P.pconv_stream(cfg, st, _t(x))
        want = [ref.convolution(a.astype(np.float64)) for a in x]
    _close(out.numpy().reshape(-1), np.concatenate(want), PCONV_BAR)


@pytest.mark.parametrize("irsize,vsize", [(8, 4), (17, 16), (64, 32), (128, 128)])
def test_dconv_compat_matches_reference_model(irsize, vsize):
    """delay_compat=True reproduces the reference's one-sample-late taps
    (cl_dconv.cpp:41) across many ring wrap-arounds."""
    cfg = D.DconvConfig(irsize=irsize, vsize=vsize, delay_compat=True)
    h = RNG.standard_normal(irsize).astype(np.float32)
    st = D.push_ir(cfg, D.dconv_init(cfg, "cpu"), _t(h))
    ref = RefDconv(irsize, vsize)
    ref.push_ir(h.astype(np.float64))
    for _ in range(10):
        blk = RNG.standard_normal(vsize).astype(np.float32)
        st, out = D.dconv_step(cfg, st, _t(blk))
        _close(out, ref.convolution(blk.astype(np.float64)), DCONV_BAR)


@pytest.mark.parametrize("irsize,vsize", [(8, 4), (48, 16)])
def test_dconv_tv_matches_reference_model(irsize, vsize):
    """Time-varying: coefficients stream into the ring at the delay line's
    positions (cl_dconv.cpp:134-148)."""
    cfg = D.DconvConfig(irsize=irsize, vsize=vsize, delay_compat=True)
    st = D.dconv_init(cfg, "cpu")
    ref = RefDconv(irsize, vsize)
    for _ in range(12):
        b1 = RNG.standard_normal(vsize).astype(np.float32)
        b2 = RNG.standard_normal(vsize).astype(np.float32)
        st, out = D.dconv_step_tv(cfg, st, _t(b1), _t(b2))
        _close(out, ref.convolution_tv(b1.astype(np.float64), b2.astype(np.float64)),
               DCONV_BAR)


@pytest.mark.parametrize("irsize,vsize", [(17, 16), (64, 32)])
def test_dconv_stream_matches_reference_model(irsize, vsize):
    """The direct whole-scan stream (the FIR kernel's twin on the CPU), in
    delay_compat mode, against the model's blocks."""
    cfg = D.DconvConfig(irsize=irsize, vsize=vsize, delay_compat=True)
    h = RNG.standard_normal(irsize).astype(np.float32)
    st = D.push_ir(cfg, D.dconv_init(cfg, "cpu"), _t(h))
    ref = RefDconv(irsize, vsize)
    ref.push_ir(h.astype(np.float64))
    x = RNG.standard_normal((9, vsize)).astype(np.float32)
    _, out = D.dconv_stream(cfg, st, _t(x))
    want = np.concatenate([ref.convolution(b.astype(np.float64)) for b in x])
    _close(out.numpy().reshape(-1), want, DCONV_BAR)
