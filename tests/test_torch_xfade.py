"""Port parity: crossfaded IR replacement in opencl_fft_tpu_torch
(``pconv_begin_xfade`` / ``pconv_step_xfade``, ``Clpconv.push_ir_xfade``,
``ClconvProcessor.set_ir``, ``Convolver.set_ir``, ``MatrixConvolver.set_ir``)
against opencl_fft_tpu and scipy on the same numpy-seeded inputs.

Ports of the JAX package's crossfade tests (``tests/test_pconv.py``,
``test_models.py``, ``test_stream.py``, ``test_api.py``): the blend oracle
(1-r)·conv(x, h_old) + r·conv(x, h_new) at the JAX tests' own bounds
(3e-5, 5e-5 * max), channels a fade leaves alone bit-equal to an engine
that never swapped, and each surface against its JAX counterpart at
2e-5 * max|JAX|. A fade crosses packages mid-stream through ``interop.py``
within 1e-5 * max. The card's route (the block-step kernels, here their
twins) is run on the CPU by taking the kernel branch of every per-block
function.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal as sps

from opencl_fft_tpu import api as japi
from opencl_fft_tpu import stream as jstream
from opencl_fft_tpu.models import convolver as JM
from opencl_fft_tpu.ops import pconv as J
from opencl_fft_tpu_torch import api as tapi
from opencl_fft_tpu_torch import models as M
from opencl_fft_tpu_torch import stream as tstream
from opencl_fft_tpu_torch.interop import xfade_state_from_numpy, xfade_state_to_numpy
from opencl_fft_tpu_torch.ops import pconv as P
from opencl_fft_tpu_torch.ops.cuda import blockstep as B
from opencl_fft_tpu_torch.ops.cuda import mac as MAC
from opencl_fft_tpu_torch.utils.errors import ArgumentError

torch.set_num_threads(1)

CPU = "cpu"
RINGS = ("spec_x_re", "spec_x_im", "spec_h_re", "spec_h_im", "tail")


def _quiet(msg, user_data):
    pass


def _close(got, ref, rel):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=rel * (np.abs(ref).max() + 1e-30), rtol=0)


def _ramp(pts, j, fade_blocks):
    return (np.arange(pts, dtype=np.float32) + 1 + j * pts) / np.float32(fade_blocks * pts)


def _blend(x, h_old, h_new, f0, f1, n):
    """(1-r)·conv(x, h_old) + r·conv(x, h_new) over n samples, r rising
    per sample over [f0, f1) to 1."""
    y_old = sps.fftconvolve(x, h_old)[:n]
    y_new = sps.fftconvolve(x, h_new)[:n]
    r = np.zeros(n, np.float32)
    r[f0:f1] = (np.arange(f1 - f0) + 1) / np.float32(f1 - f0)
    r[f1:] = 1.0
    return (1 - r) * y_old + r * y_new


@pytest.fixture(params=["plain", "kernels"])
def route(request, monkeypatch):
    """Each case on both routes of the per-block functions: the CPU's plain
    composition, and the card's block-step kernels (their twins, the
    kernel branch taken for CPU tensors)."""
    if request.param == "kernels":
        monkeypatch.setattr(P, "_block_kernels", lambda cfg, device: True)
    return request.param


def _launches():
    return (MAC.LAUNCHES, B.STEP_LAUNCHES, B.FWD_LAUNCHES, B.FWD_TV_LAUNCHES)


# ---------------------------------------------------------------------------
# pconv_begin_xfade / pconv_step_xfade
# ---------------------------------------------------------------------------

def test_xfade_blends_two_exact_convolutions(route):
    """During the fade the output is the per-sample blend of the two exact
    convolutions over the whole input history, then conv(x, h_new); the
    same as the JAX functions' (tests/test_pconv.py:313-353)."""
    pts, nparts, fade_blocks, nblocks, start = 64, 6, 4, 16, 7
    rng = np.random.default_rng(1)
    cfg, jcfg = P.PconvConfig(pts=pts, nparts=nparts), J.PconvConfig(pts=pts, nparts=nparts)
    h_old = rng.standard_normal(cfg.cvs).astype(np.float32)
    h_new = rng.standard_normal(cfg.cvs).astype(np.float32)
    x = rng.standard_normal(nblocks * pts).astype(np.float32)
    blocks = x.reshape(nblocks, pts)
    st = P.push_ir(cfg, P.pconv_init(cfg, CPU), torch.from_numpy(h_old))
    js = J.push_ir(jcfg, J.pconv_init(jcfg), h_old)
    outs, jouts, xf, jxf = [], [], None, None
    for i in range(nblocks):
        if i == start:
            xf = P.pconv_begin_xfade(cfg, st, torch.from_numpy(h_new))
            jxf = J.pconv_begin_xfade(jcfg, js, h_new)
        if xf is not None and i - start < fade_blocks:
            ramp = _ramp(pts, i - start, fade_blocks)
            xf, o = P.pconv_step_xfade(cfg, xf, torch.from_numpy(blocks[i]), ramp)
            jxf, jo = J.pconv_step_xfade(jcfg, jxf, blocks[i], ramp)
            if i - start == fade_blocks - 1:
                st, xf, js, jxf = xf.state, None, jxf.state, None
        else:
            st, o = P.pconv_step(cfg, st, torch.from_numpy(blocks[i]))
            js, jo = J.pconv_step(jcfg, js, blocks[i])
        outs.append(o.numpy())
        jouts.append(np.asarray(jo))
    got = np.concatenate(outs)
    expect = _blend(x, h_old, h_new, start * pts, (start + fade_blocks) * pts, got.size)
    _close(got, expect, 3e-5)
    _close(got, np.concatenate(jouts), 2e-5)


def test_xfade_is_deterministic(route):
    """Bitwise rerun stability (tests/test_pconv.py:356-371)."""
    pts, nparts = 32, 4
    rng = np.random.default_rng(2)
    cfg = P.PconvConfig(pts=pts, nparts=nparts)
    h0, h1 = (torch.from_numpy(rng.standard_normal(cfg.cvs).astype(np.float32))
              for _ in range(2))
    blk = torch.from_numpy(rng.standard_normal(pts).astype(np.float32))
    ramp = np.linspace(0, 1, pts, dtype=np.float32)
    st = P.push_ir(cfg, P.pconv_init(cfg, CPU), h0)
    st, _ = P.pconv_step(cfg, st, blk)
    a = P.pconv_step_xfade(cfg, P.pconv_begin_xfade(cfg, st, h1), blk, ramp)[1]
    b = P.pconv_step_xfade(cfg, P.pconv_begin_xfade(cfg, st, h1), blk, ramp)[1]
    assert torch.equal(a, b)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_fade_crosses_packages_mid_stream(direction):
    """A fade begun in one package, carried over mid-fade with
    xfade_state_{to,from}_numpy and finished in the other: outputs and the
    XfadeState within 1e-5 * max of the JAX package's own run."""
    pts, nparts, fade_blocks = 32, 4, 6
    rng = np.random.default_rng(3)
    cfg, jcfg = P.PconvConfig(pts=pts, nparts=nparts), J.PconvConfig(pts=pts, nparts=nparts)
    h0, h1 = (rng.standard_normal(cfg.cvs).astype(np.float32) for _ in range(2))
    blocks = rng.standard_normal((3 + fade_blocks, pts)).astype(np.float32)
    js = J.push_ir(jcfg, J.pconv_init(jcfg), h0)
    for b in blocks[:3]:
        js, _ = J.pconv_step(jcfg, js, b)
    ref = J.pconv_begin_xfade(jcfg, js, h1)
    ref_outs = []
    for j, b in enumerate(blocks[3:]):
        ref, o = J.pconv_step_xfade(jcfg, ref, b, _ramp(pts, j, fade_blocks))
        ref_outs.append(np.asarray(o))
    # the crossing run: two fade blocks on one side, the rest on the other
    if direction == "jax_to_port":
        xf = J.pconv_begin_xfade(jcfg, js, h1)
        for j, b in enumerate(blocks[3:5]):
            xf, o = J.pconv_step_xfade(jcfg, xf, b, _ramp(pts, j, fade_blocks))
        xf = xfade_state_from_numpy(xf, CPU)
        step = lambda f, b, r: P.pconv_step_xfade(cfg, f, torch.from_numpy(b), r)  # noqa: E731
    else:
        ts = P.push_ir(cfg, P.pconv_init(cfg, CPU), torch.from_numpy(h0))
        for b in blocks[:3]:
            ts, _ = P.pconv_step(cfg, ts, torch.from_numpy(b))
        xf = P.pconv_begin_xfade(cfg, ts, torch.from_numpy(h1))
        for j, b in enumerate(blocks[3:5]):
            xf, o = P.pconv_step_xfade(cfg, xf, torch.from_numpy(b), _ramp(pts, j, fade_blocks))
        n = xfade_state_to_numpy(xf)
        xf = J.XfadeState(state=J.PconvState(**{k: jnp.asarray(v) for k, v in n["state"].items()}),
                          **{k: jnp.asarray(n[k]) for k in ("old_h_re", "old_h_im", "old_tail")})
        step = lambda f, b, r: J.pconv_step_xfade(jcfg, f, b, r)  # noqa: E731
    for j, b in enumerate(blocks[5:], start=2):
        xf, o = step(xf, b, _ramp(pts, j, fade_blocks))
        _close(o, ref_outs[j], 1e-5)
    for name in RINGS:
        _close(getattr(xf.state, name), getattr(ref.state, name), 1e-5)
    for name in ("old_h_re", "old_h_im", "old_tail"):
        _close(getattr(xf, name), getattr(ref, name), 1e-5)
    assert (int(xf.state.wp), int(xf.state.wp2)) == (int(ref.state.wp), int(ref.state.wp2))


def test_xfade_interop_validates_shapes():
    cfg = P.PconvConfig(pts=16, nparts=2)
    n = xfade_state_to_numpy(P.pconv_begin_xfade(cfg, P.pconv_init(cfg, CPU),
                                                 torch.zeros(cfg.cvs)))
    n["old_tail"] = np.zeros(8, np.float32)
    with pytest.raises(ValueError, match=r"old_tail must be \(16,\)"):
        xfade_state_from_numpy(n, CPU)
    with pytest.raises(ValueError, match="missing XfadeState fields"):
        xfade_state_from_numpy({"state": n["state"]}, CPU)


# ---------------------------------------------------------------------------
# Clpconv (tests/test_api.py:143-205)
# ---------------------------------------------------------------------------

def test_clpconv_push_ir_xfade_surface(route):
    """TV streaming is refused mid-fade, and after fade_blocks calls the
    engine runs on the new IR alone; the same outputs as the JAX class."""
    pts, nparts, K = 32, 4, 2
    rng = np.random.default_rng(4)
    pc = tapi.Clpconv(0, pts * nparts, pts, _quiet, device=CPU)
    jc = japi.Clpconv(0, pts * nparts, pts, _quiet)
    h0, h1 = (rng.standard_normal(pts * nparts).astype(np.float32) for _ in range(2))
    x = rng.standard_normal(8 * pts).astype(np.float32)
    assert pc.push_ir(h0) == jc.push_ir(h0) == 0
    out, jout = np.zeros(pts, np.float32), np.zeros(pts, np.float32)
    for i in range(3):
        pc.convolution(out, x[i * pts:(i + 1) * pts])
    assert pc.push_ir_xfade(h1, fade_blocks=K) == 0
    with pytest.raises(ArgumentError, match="crossfade"):
        pc.convolution(out, x[:pts], x[:pts])
    for i in range(3):
        jc.convolution(jout, x[i * pts:(i + 1) * pts])
    jc.push_ir_xfade(h1, fade_blocks=K)
    outs, jouts = [], []
    for i in range(3, 8):
        pc.convolution(out, x[i * pts:(i + 1) * pts])
        jc.convolution(jout, x[i * pts:(i + 1) * pts])
        outs.append(out.copy())
        jouts.append(jout.copy())
    assert pc._xf is None
    y_new = sps.fftconvolve(x, h1)
    _close(np.concatenate(outs[K:]), y_new[(3 + K) * pts: 8 * pts], 3e-5)
    _close(np.concatenate(outs), np.concatenate(jouts), 2e-5)
    with pytest.raises(ArgumentError):
        pc.push_ir_xfade(h1, fade_blocks=0)


def test_clpconv_push_ir_mid_fade_keeps_live_ring(route):
    """An instant push_ir during a fade collapses to the live input ring
    (the blocks streamed during the fade included)."""
    pts, nparts = 32, 4
    rng = np.random.default_rng(5)
    pc = tapi.Clpconv(0, pts * nparts, pts, _quiet, device=CPU)
    h0, h1 = (rng.standard_normal(pts * nparts).astype(np.float32) for _ in range(2))
    pc.push_ir(h0)
    x = rng.standard_normal(6 * pts).astype(np.float32)
    out = np.zeros(pts, np.float32)
    pc.convolution(out, x[:pts])
    pc.push_ir_xfade(h1, fade_blocks=4)
    pc.convolution(out, x[pts: 2 * pts])
    pc.push_ir(h1)
    outs = []
    for i in range(2, 6):
        pc.convolution(out, x[i * pts:(i + 1) * pts])
        outs.append(out.copy())
    y_new = sps.fftconvolve(x, h1)
    _close(np.concatenate(outs), y_new[2 * pts: 6 * pts], 3e-5)


def test_clpconv_retarget_mid_fade_matches_jax(route):
    """A second push_ir_xfade mid-fade adopts the first target as the
    outgoing path (the JAX class's rule): same outputs as JAX, and the
    stream ends as conv(x, h2)."""
    pts, nparts = 32, 4
    rng = np.random.default_rng(6)
    pc = tapi.Clpconv(0, pts * nparts, pts, _quiet, device=CPU)
    jc = japi.Clpconv(0, pts * nparts, pts, _quiet)
    h0, h1, h2 = (rng.standard_normal(pts * nparts).astype(np.float32) for _ in range(3))
    x = rng.standard_normal(14 * pts).astype(np.float32)
    pc.push_ir(h0)
    jc.push_ir(h0)
    outs, jouts = [], []
    for i in range(14):
        if i == 2:
            pc.push_ir_xfade(h1, 4)
            jc.push_ir_xfade(h1, 4)
        if i == 4:
            pc.push_ir_xfade(h2, 3)
            jc.push_ir_xfade(h2, 3)
        o, jo = np.zeros(pts, np.float32), np.zeros(pts, np.float32)
        pc.convolution(o, x[i * pts:(i + 1) * pts])
        jc.convolution(jo, x[i * pts:(i + 1) * pts])
        outs.append(o)
        jouts.append(jo)
    got = np.concatenate(outs)
    _close(got, np.concatenate(jouts), 2e-5)
    _close(got[7 * pts:], sps.fftconvolve(x, h2)[7 * pts:14 * pts], 3e-5)


# ---------------------------------------------------------------------------
# ClconvProcessor.set_ir (tests/test_stream.py:186-234)
# ---------------------------------------------------------------------------

def test_clconv_set_ir_crossfade(route):
    """The emitted stream is the parts-delayed blend, then pure new; the
    same as the JAX processor's."""
    parts, fade_blocks, swap_at, nblocks = 64, 3, 4, 12
    rng = np.random.default_rng(7)
    h_old = rng.standard_normal(parts * 3).astype(np.float32)
    h_new = rng.standard_normal(parts * 3).astype(np.float32)
    x = rng.standard_normal(nblocks * parts).astype(np.float32)
    p = tstream.ClconvProcessor(h_old, parts, on_message=_quiet, device=CPU)
    jp = jstream.ClconvProcessor(h_old, parts, on_message=_quiet)
    outs, jouts = [], []
    for i in range(nblocks):
        if i == swap_at:
            p.set_ir(h_new, fade_blocks=fade_blocks)
            jp.set_ir(h_new, fade_blocks=fade_blocks)
        outs.append(p.process(x[i * parts:(i + 1) * parts]))
        jouts.append(jp.process(x[i * parts:(i + 1) * parts]))
    got = np.concatenate(outs)
    blended = _blend(x, h_old, h_new, swap_at * parts, (swap_at + fade_blocks) * parts,
                     got.size)
    expect = np.concatenate([np.zeros(parts, np.float32), blended])[:got.size]
    np.testing.assert_allclose(got, expect, atol=3e-5 * np.abs(blended).max(), rtol=0)
    _close(got, np.concatenate(jouts), 2e-5)


def test_clconv_set_ir_skip_size_scale_matches_jax():
    """set_ir's skip/size/scale preparation, the scale defaulting to the
    constructor's, against the JAX processor."""
    parts = 32
    rng = np.random.default_rng(8)
    table = rng.standard_normal(400).astype(np.float32)
    new = rng.standard_normal(500).astype(np.float32)
    x = rng.standard_normal(20 * parts).astype(np.float32)
    kw = dict(skip=10, size=300, scale=0.5, on_message=_quiet)
    p = tstream.ClconvProcessor(table, parts, device=CPU, **kw)
    jp = jstream.ClconvProcessor(table, parts, **kw)
    outs, jouts = [], []
    for i in range(20):
        if i == 5:
            p.set_ir(new, skip=40, size=250, fade_blocks=2)
            jp.set_ir(new, skip=40, size=250, fade_blocks=2)
        if i == 12:
            p.set_ir(new, skip=3, size=303, scale=0.25, fade_blocks=0)
            jp.set_ir(new, skip=3, size=303, scale=0.25, fade_blocks=0)
        outs.append(p.process(x[i * parts:(i + 1) * parts]))
        jouts.append(jp.process(x[i * parts:(i + 1) * parts]))
    _close(np.concatenate(outs), np.concatenate(jouts), 2e-5)


def test_clconv_set_ir_instant_and_errors():
    parts = 64
    rng = np.random.default_rng(9)
    ir = rng.standard_normal(parts * 2).astype(np.float32)
    p = tstream.ClconvProcessor(ir, parts, on_message=_quiet, device=CPU)
    p.process(np.zeros(parts, np.float32))
    p.set_ir(np.zeros(parts * 2, np.float32), fade_blocks=0)
    out = p.process(rng.standard_normal(parts).astype(np.float32))
    np.testing.assert_array_equal(out, np.zeros(parts, np.float32))
    with pytest.raises(ArgumentError, match="exceeds"):
        p.set_ir(np.zeros(parts * 5, np.float32))
    with pytest.raises(ArgumentError, match="bad skip/size"):
        p.set_ir(ir, skip=200)
    d = tstream.ClconvProcessor(ir, parts=1, block_size=64, on_message=_quiet, device=CPU)
    with pytest.raises(ArgumentError, match="partitioned"):
        d.set_ir(ir)


# ---------------------------------------------------------------------------
# Convolver.set_ir and MatrixConvolver.set_ir (tests/test_models.py)
# ---------------------------------------------------------------------------

def test_convolver_set_ir_crossfade_per_channel(route):
    """Only the swapped channel crossfades; the others are bit-equal to an
    engine that never swapped; the same outputs as the JAX Convolver; bulk
    paths refuse to run mid-fade (tests/test_models.py:219-270)."""
    pts, nparts, batch, K, swap_at, nblocks = 32, 4, 3, 2, 3, 10
    rng = np.random.default_rng(10)
    cfg = P.PconvConfig(pts=pts, nparts=nparts)
    jcfg = J.PconvConfig.for_ir_length(cfg.cvs, pts)
    irs0 = rng.standard_normal((batch, cfg.cvs)).astype(np.float32)
    ir_new = rng.standard_normal((1, cfg.cvs)).astype(np.float32)
    x = rng.standard_normal((nblocks, batch, pts)).astype(np.float32)
    conv, ref = M.Convolver(cfg, batch, device=CPU), M.Convolver(cfg, batch, device=CPU)
    jconv = JM.Convolver(jcfg, batch)
    for c in (conv, ref, jconv):
        c.push_ir(irs0)
    outs, refs, jouts = [], [], []
    for i in range(nblocks):
        if i == swap_at:
            conv.set_ir(ir_new, channels=[1], fade_blocks=K)
            jconv.set_ir(ir_new, channels=[1], fade_blocks=K)
        outs.append(conv.step(x[i]).numpy())
        refs.append(ref.step(x[i]).numpy())
        jouts.append(np.asarray(jconv.step(x[i])))
    got, unswapped = np.stack(outs), np.stack(refs)
    np.testing.assert_array_equal(got[:, 0], unswapped[:, 0])
    np.testing.assert_array_equal(got[:, 2], unswapped[:, 2])
    expect = _blend(x[:, 1].reshape(-1), irs0[1], ir_new[0], swap_at * pts,
                    (swap_at + K) * pts, nblocks * pts)
    _close(got[:, 1].reshape(-1), expect, 3e-5)
    _close(got, np.stack(jouts), 2e-5)
    conv.set_ir(ir_new, channels=[0], fade_blocks=4)
    with pytest.raises(RuntimeError, match="crossfade"):
        conv.stream(x)
    with pytest.raises(RuntimeError, match="crossfade"):
        conv.render(x)


def test_convolver_set_ir_instant_and_validation():
    """fade_blocks=0 is push_ir on the chosen channels
    (tests/test_models.py:273-302)."""
    pts, nparts, batch = 32, 2, 2
    rng = np.random.default_rng(11)
    cfg = P.PconvConfig(pts=pts, nparts=nparts)
    conv = M.Convolver(cfg, batch, device=CPU)
    irs = rng.standard_normal((batch, cfg.cvs)).astype(np.float32)
    conv.push_ir(irs)
    x = rng.standard_normal((batch, pts)).astype(np.float32)
    conv.step(x)
    new = rng.standard_normal((batch, cfg.cvs)).astype(np.float32)
    conv.set_ir(new, fade_blocks=0)
    ref = M.Convolver(cfg, batch, device=CPU)
    ref.push_ir(irs)
    ref.step(x)
    ref.push_ir(new)
    x2 = rng.standard_normal((batch, pts)).astype(np.float32)
    assert torch.equal(conv.step(x2), ref.step(x2))
    part = M.Convolver(cfg, batch, device=CPU)
    part.state = conv.state
    part.set_ir(irs[1:], channels=[1], fade_blocks=0)
    assert torch.equal(part.state.spec_h_re[0], conv.state.spec_h_re[0])
    with pytest.raises(ValueError, match="channels=None"):
        conv.set_ir(new[:1])
    with pytest.raises(ValueError, match="indices"):
        conv.set_ir(new, channels=[0, 1, 1])
    with pytest.raises(ValueError, match="duplicate"):
        conv.set_ir(new, channels=[1, 1])
    with pytest.raises(ValueError, match="out of range"):
        conv.set_ir(new[:1], channels=[5])
    with pytest.raises(ValueError, match="irs must be"):
        conv.set_ir(np.zeros((1, 7), np.float32), channels=[0])
    with pytest.raises(ValueError, match="fade_blocks must be >= 0"):
        conv.set_ir(new, fade_blocks=-1)


def test_convolver_push_ir_collapses_a_fade():
    pts, nparts, batch = 16, 4, 2
    rng = np.random.default_rng(12)
    cfg = P.PconvConfig(pts=pts, nparts=nparts)
    conv = M.Convolver(cfg, batch, device=CPU)
    irs, new = (rng.standard_normal((batch, cfg.cvs)).astype(np.float32) for _ in range(2))
    x = rng.standard_normal((6, batch, pts)).astype(np.float32)
    conv.push_ir(irs)
    conv.step(x[0])
    conv.set_ir(new, fade_blocks=4)
    conv.step(x[1])
    conv.push_ir(new)
    assert conv._xf is None
    got = conv.stream(x[2:])
    for c in range(batch):
        ref = sps.fftconvolve(x[:, c].reshape(-1), new[c])[2 * pts:6 * pts]
        _close(got[:, c].reshape(-1), ref, 3e-5)


def test_matrix_convolver_entry_hot_swap(route):
    """Swapping one matrix entry crossfades only that path; the JAX
    MatrixConvolver gives the same outputs (tests/test_models.py:335-377)."""
    pts, nparts, K, start, nblocks = 32, 4, 2, 3, 10
    rng = np.random.default_rng(13)
    cfg = P.PconvConfig(pts=pts, nparts=nparts)
    jcfg = J.PconvConfig.for_ir_length(cfg.cvs, pts)
    irs = rng.standard_normal((2, 2, cfg.cvs)).astype(np.float32)
    new = rng.standard_normal((1, cfg.cvs)).astype(np.float32)
    x = rng.standard_normal((nblocks, 2, pts)).astype(np.float32)
    m, jm = M.MatrixConvolver(cfg, 2, 2, device=CPU), JM.MatrixConvolver(jcfg, 2, 2)
    m.push_ir(irs)
    jm.push_ir(irs)
    outs, jouts = [], []
    for i in range(nblocks):
        if i == start:
            m.set_ir(new, entries=[(1, 0)], fade_blocks=K)
            jm.set_ir(new, entries=[(1, 0)], fade_blocks=K)
        outs.append(m.step(x[i]).numpy())
        jouts.append(np.asarray(jm.step(x[i])))
    got = np.stack(outs)
    xs = x.transpose(1, 0, 2).reshape(2, -1)
    T = nblocks * pts
    ref0 = sum(sps.fftconvolve(xs[i], irs[0, i])[:T] for i in range(2))
    _close(got[:, 0].reshape(-1), ref0, 5e-5)
    ref1 = _blend(xs[0], irs[1, 0], new[0], start * pts, (start + K) * pts, T) \
        + sps.fftconvolve(xs[1], irs[1, 1])[:T]
    _close(got[:, 1].reshape(-1), ref1, 5e-5)
    _close(got, np.stack(jouts), 2e-5)
    with pytest.raises(ValueError, match="out of range"):
        m.set_ir(new, entries=[(2, 0)])
    m.set_ir(irs, fade_blocks=0)
    with pytest.raises(ValueError, match=r"irs must be \(2, 2, 128\)"):
        m.set_ir(irs[:1])


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the block-step kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_convolver_set_ir_leaves_other_channels_bit_equal(cuda_device):
    """On a card (the block-step kernels) untouched channels stay bit-equal
    to an engine that never swapped; the swapped channel follows the blend
    oracle; the kernels were launched."""
    pts, nparts, batch, K, swap_at, nblocks = 64, 8, 5, 3, 4, 12
    rng = np.random.default_rng(14)
    cfg = P.PconvConfig(pts=pts, nparts=nparts)
    irs0 = rng.standard_normal((batch, cfg.cvs)).astype(np.float32)
    ir_new = rng.standard_normal((2, cfg.cvs)).astype(np.float32)
    x = rng.standard_normal((nblocks, batch, pts)).astype(np.float32)
    conv, ref = (M.Convolver(cfg, batch, device=cuda_device) for _ in range(2))
    conv.push_ir(irs0)
    ref.push_ir(irs0)
    before = _launches()
    outs, refs = [], []
    for i in range(nblocks):
        if i == swap_at:
            conv.set_ir(ir_new, channels=[1, 3], fade_blocks=K)
        outs.append(conv.step(x[i]))
        refs.append(ref.step(x[i]))
    got, unswapped = torch.stack(outs).cpu(), torch.stack(refs).cpu()
    assert all(a > b for a, b in zip(_launches()[:3], before[:3]))
    for c in (0, 2, 4):
        assert torch.equal(got[:, c], unswapped[:, c])
    for j, c in enumerate((1, 3)):
        expect = _blend(x[:, c].reshape(-1), irs0[c], ir_new[j], swap_at * pts,
                        (swap_at + K) * pts, nblocks * pts)
        _close(got[:, c].reshape(-1), expect, 5e-5)
