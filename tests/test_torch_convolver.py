"""Port parity: the serving models of opencl_fft_tpu_torch (``models/``)
against opencl_fft_tpu's ``models/convolver.py`` and scipy on the same
inputs.

Ports of the ``tests/test_models.py`` cases this slice covers, each also
held against the JAX class: outputs atol 2e-5 * max|JAX| (the JAX package's
stream-vs-step tolerance), scipy at the JAX test's own bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal as sps

from opencl_fft_tpu.models import convolver as JM
from opencl_fft_tpu.ops import pconv as J
from opencl_fft_tpu_torch import models as M
from opencl_fft_tpu_torch.interop import pconv_state_from_numpy, pconv_state_to_numpy
from opencl_fft_tpu_torch.ops import pconv as P
from opencl_fft_tpu_torch.ops.cuda import streamstep as S
from opencl_fft_tpu_torch.utils.errors import DeviceError

torch.set_num_threads(1)

CPU = "cpu"


def _close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, atol=rel * (np.abs(ref).max() + 1e-30), rtol=0)


def _cfgs(pts, nparts):
    return J.PconvConfig.for_ir_length(pts * nparts, pts), P.PconvConfig(pts=pts,
                                                                         nparts=nparts)


def test_convolver_batch_matches_scipy():
    pts, nparts, batch = 32, 4, 3
    rng = np.random.default_rng(31)
    jcfg, cfg = _cfgs(pts, nparts)
    irs = rng.standard_normal((batch, cfg.cvs)).astype(np.float32)
    x = rng.standard_normal((batch, cfg.cvs * 2)).astype(np.float32)
    conv, jconv = M.Convolver(cfg, batch, device=CPU), JM.Convolver(jcfg, batch)
    conv.push_ir(irs)
    jconv.push_ir(irs)
    outs, jouts = [], []
    for i in range(x.shape[1] // pts):
        outs.append(conv.step(x[:, i * pts:(i + 1) * pts]).numpy())
        jouts.append(np.asarray(jconv.step(x[:, i * pts:(i + 1) * pts])))
    got = np.concatenate(outs, axis=1)
    _close(got, np.concatenate(jouts, axis=1), 2e-5)
    for b in range(batch):
        _close(got[b], sps.fftconvolve(x[b], irs[b])[:got.shape[1]], 3e-5)


def test_tvconvolver_matches_single_channel_engine():
    pts, nparts, batch = 16, 4, 2
    rng = np.random.default_rng(32)
    jcfg, cfg = _cfgs(pts, nparts)
    tv, jtv = M.TVConvolver(cfg, batch, device=CPU), JM.TVConvolver(jcfg, batch)
    refs = [P.pconv_init(cfg, CPU) for _ in range(batch)]
    for _ in range(10):
        bx = rng.standard_normal((batch, pts)).astype(np.float32)
        bh = rng.standard_normal((batch, pts)).astype(np.float32)
        out = tv.step(bx, bh)
        _close(out, jtv.step(bx, bh), 2e-5)
        for b in range(batch):
            refs[b], o = P.pconv_step_tv(cfg, refs[b], torch.from_numpy(bx[b]),
                                         torch.from_numpy(bh[b]))
            np.testing.assert_allclose(out[b].numpy(), o.numpy(), atol=2e-5, rtol=0)


@pytest.mark.parametrize("forward", [True, False])
def test_batched_fft_model(forward):
    rng = np.random.default_rng(33)
    m, jm = M.BatchedFFT(128, forward, device=CPU), JM.BatchedFFT(128, forward)
    x = rng.standard_normal((4, 128)).astype(np.float32)
    y = rng.standard_normal((4, 128)).astype(np.float32)
    re, im = m((x, y))
    jre, jim = jm((x, y))
    ref = np.fft.fft(x + 1j * y) if forward else np.fft.ifft(x + 1j * y) * 128
    got = re.numpy() + 1j * im.numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5 * np.max(np.abs(ref)), rtol=0)
    _close(re, jre, 2e-5)
    _close(im, jim, 2e-5)
    with pytest.raises(ValueError, match="transform size"):
        m((x[:, :64], y[:, :64]))


def test_convolver_stream_matches_steps():
    pts, nparts, batch = 16, 2, 2
    rng = np.random.default_rng(34)
    jcfg, cfg = _cfgs(pts, nparts)
    irs = rng.standard_normal((batch, cfg.cvs)).astype(np.float32)
    blocks = rng.standard_normal((6, batch, pts)).astype(np.float32)
    c1 = M.Convolver(cfg, batch, device=CPU)
    c1.push_ir(irs)
    step_outs = np.stack([c1.step(b).numpy() for b in blocks])
    c2 = M.Convolver(cfg, batch, device=CPU)
    c2.push_ir(irs)
    before = S.BATCHED_LAUNCHES
    stream_outs = c2.stream(blocks).numpy()
    assert S.BATCHED_LAUNCHES == before                 # the CPU runs the twin
    _close(stream_outs, step_outs, 2e-5)
    jc = JM.Convolver(jcfg, batch)
    jc.push_ir(irs)
    _close(stream_outs, jc.stream(blocks), 2e-5)
    assert c2.state.wp == c1.state.wp == int(jc.state.wp)


def test_tvconvolver_stream_matches_steps():
    pts, nparts, batch = 16, 2, 2
    rng = np.random.default_rng(35)
    jcfg, cfg = _cfgs(pts, nparts)
    bx = rng.standard_normal((6, batch, pts)).astype(np.float32)
    bh = rng.standard_normal((6, batch, pts)).astype(np.float32)
    t1 = M.TVConvolver(cfg, batch, device=CPU)
    step = t1.step_fn()
    st = t1.state
    step_outs = []
    for i in range(6):
        st, o = step(st, torch.from_numpy(bx[i]), torch.from_numpy(bh[i]))
        step_outs.append(o.numpy())
    t2 = M.TVConvolver(cfg, batch, device=CPU)
    stream_outs = t2.stream(bx, bh).numpy()
    _close(stream_outs, np.stack(step_outs), 2e-5)
    jt = JM.TVConvolver(jcfg, batch)
    _close(stream_outs, jt.stream(bx, bh), 2e-5)
    assert (t2.state.wp, t2.state.wp2) == (st.wp, st.wp2) == \
        (int(jt.state.wp), int(jt.state.wp2))


def test_tvconvolver_fed_ir_partitions_cyclically_convolves():
    """From a zero state, feeding each channel's IR partitions cyclically
    through operand 2 gives the full linear convolution: partition j is
    written before any input block it multiplies arrives (the serving
    check of the smoke run, at a small size)."""
    pts, nparts, batch = 16, 4, 3
    rng = np.random.default_rng(36)
    cfg = P.PconvConfig(pts=pts, nparts=nparts)
    irs = rng.standard_normal((batch, cfg.cvs)).astype(np.float32)
    nb = 3 * nparts + 2
    x = rng.standard_normal((nb, batch, pts)).astype(np.float32)
    parts = irs.reshape(batch, nparts, pts)
    hb = np.stack([parts[:, t % nparts] for t in range(nb)])
    y = M.TVConvolver(cfg, batch, device=CPU).stream(x, hb).numpy()
    for b in range(batch):
        ref = sps.fftconvolve(x[:, b].reshape(-1).astype(np.float64),
                              irs[b].astype(np.float64))[:nb * pts]
        _close(y[:, b].reshape(-1), ref, 3e-5)


def test_matrix_convolver_true_stereo():
    """out[o] = sum_i conv(in[i], ir[o, i]): matches scipy per entry, the
    JAX MatrixConvolver, and stream() matches step-by-step."""
    pts, nparts, n_in, n_out = 32, 4, 2, 2
    rng = np.random.default_rng(37)
    jcfg, cfg = _cfgs(pts, nparts)
    irs = rng.standard_normal((n_out, n_in, cfg.cvs)).astype(np.float32)
    nblocks = 8
    x = rng.standard_normal((nblocks, n_in, pts)).astype(np.float32)
    m = M.MatrixConvolver(cfg, n_in, n_out, device=CPU)
    m.push_ir(irs)
    got = np.stack([m.step(x[i]).numpy() for i in range(nblocks)])
    xs = x.transpose(1, 0, 2).reshape(n_in, -1)
    for o in range(n_out):
        ref = sum(sps.fftconvolve(xs[i], irs[o, i])[:nblocks * pts] for i in range(n_in))
        _close(got[:, o].reshape(-1), ref, 5e-5)
    m2 = M.MatrixConvolver(cfg, n_in, n_out, device=CPU)
    m2.push_ir(irs)
    got2 = m2.stream(x).numpy()
    assert got2.shape == (nblocks, n_out, pts)
    _close(got2, got, 1e-5)
    jm = JM.MatrixConvolver(jcfg, n_in, n_out)
    jm.push_ir(irs)
    _close(got2, jm.stream(x), 2e-5)
    with pytest.raises(ValueError, match=r"irs must be \(2, 2, 128\)"):
        m.push_ir(irs[:1])
    with pytest.raises(ValueError, match=r"blocks must be \(2, 32\)"):
        m.step(x[0, :1])
    with pytest.raises(ValueError, match=r"blocks must be \(nblocks, 2, 32\)"):
        m.stream(x[:, :1])
    with pytest.raises(ValueError, match="n_in, n_out"):
        M.MatrixConvolver(cfg, 0, 2, device=CPU)


def test_jax_convolver_state_continues_in_the_port():
    """A JAX Convolver streams, its state crosses into the port through
    interop, and both continue on the same blocks; then back again."""
    pts, nparts, batch = 32, 4, 3
    rng = np.random.default_rng(38)
    jcfg, cfg = _cfgs(pts, nparts)
    irs = rng.standard_normal((batch, cfg.cvs)).astype(np.float32)
    blocks = rng.standard_normal((3, 11, batch, pts)).astype(np.float32)
    jc = JM.Convolver(jcfg, batch)
    jc.push_ir(irs)
    jc.stream(blocks[0])
    conv = M.Convolver(cfg, batch, device=CPU)
    conv.state = pconv_state_from_numpy(
        J.PconvState(*(np.asarray(f) for f in jc.state)), CPU)
    assert conv.state.wp == int(jc.state.wp) != 0
    _close(conv.stream(blocks[1]), jc.stream(blocks[1]), 2e-5)
    back = J.PconvState(**{k: jnp.asarray(v)
                           for k, v in pconv_state_to_numpy(conv.state).items()})
    jc2 = JM.Convolver(jcfg, batch)
    jc2.state = back
    _close(jc2.stream(blocks[2]), jc.stream(blocks[2]), 2e-5)


def test_steps_validate_shapes():
    cfg = P.PconvConfig(pts=16, nparts=2)
    conv = M.Convolver(cfg, 2, device=CPU)
    with pytest.raises(ValueError, match=r"blocks must be \(2, 16\)"):
        conv.step(np.zeros((16,), np.float32))
    with pytest.raises(ValueError, match=r"IR must have shape \(2, 32\)"):
        conv.push_ir(np.zeros((32,), np.float32))
    tv = M.TVConvolver(cfg, 2, device=CPU)
    with pytest.raises(ValueError, match="blocks_h"):
        tv.step(np.zeros((2, 16), np.float32), np.zeros((1, 16), np.float32))
    with pytest.raises(ValueError, match="at least one channel"):
        M.Convolver(cfg, 0, device=CPU)
    st = M.batched_state(cfg, 3, CPU)
    assert st.spec_x_re.shape == (3, 4, 16) and st.tail.shape == (3, 16)
    assert (st.wp, st.wp2) == (0, 1)


@pytest.mark.parametrize("kw,ring,tail", [
    ({"dtype": "f64"}, torch.float64, torch.float64),
    ({"ring_dtype": "bf16"}, torch.bfloat16, torch.float32),
])
def test_unported_surfaces_name_their_roadmap_item(kw, ring, tail):
    """The float64 (ROADMAP item 17) and bf16-ring (item 16) configs, once
    unported, now drive every model: rings and tails in their dtypes, and
    outputs against the float32 models at float32's 2e-5 and bf16's 5e-3
    of max|out|. The name is kept from when the options raised, so the
    case keeps its identity across versions."""
    rng = np.random.default_rng(33)
    irs = rng.standard_normal((2, 32)).astype(np.float32)
    x = rng.standard_normal((4, 2, 16)).astype(np.float32)
    tol = 5e-3 if ring == torch.bfloat16 else 2e-5
    for cfg_kw in ({}, kw):
        cfg = P.PconvConfig(pts=16, nparts=2, **cfg_kw)
        c, t = M.Convolver(cfg, 2, device=CPU), M.TVConvolver(cfg, 2, device=CPU)
        m = M.MatrixConvolver(cfg, 1, 2, device=CPU)
        c.push_ir(irs)
        m.push_ir(irs[:, None])
        got = (c.stream(x), t.stream(x, 0.5 * x), m.stream(x[:, :1]))
        if not cfg_kw:
            ref = got
            continue
        for state in (c.state, t.state, m._conv.state):
            assert state.spec_x_re.dtype == ring and state.spec_h_im.dtype == ring
            assert state.tail.dtype == tail
        for g, r in zip(got, ref):
            assert g.dtype == tail
            _close(g.double(), r.double(), tol)


def test_models_default_to_the_card():
    """Without a device the models ask for a CUDA card, which this machine
    may lack: they then raise instead of running on the CPU."""
    cfg = P.PconvConfig(pts=16, nparts=2)
    if torch.cuda.is_available():
        assert M.Convolver(cfg, 2).device.type == "cuda"
    else:
        with pytest.raises(DeviceError, match="CUDA"):
            M.Convolver(cfg, 2)
