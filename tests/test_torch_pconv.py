"""Port parity: the LTI partitioned-convolution engine of
opencl_fft_tpu_torch against opencl_fft_tpu on the same inputs.

pconv_stream is held against the JAX pconv_stream, through its Pallas
whole-scan kernel in interpret mode where the JAX package routes that
shape to it (pallas="stream") and through its XLA scan otherwise
(pallas="off"): outputs and tail atol 2e-5 * max|ref|, rings atol
1e-5 * max|ring|. convolve is held against scipy at 3e-5 * max|ref|, the
JAX package's own bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal as sps

from opencl_fft_tpu.ops import pconv as J
from opencl_fft_tpu_torch.interop import (pconv_state_from_numpy,
                                          pconv_state_to_numpy)
from opencl_fft_tpu_torch.ops import pconv as P

torch.set_num_threads(1)

RINGS = ("spec_x_re", "spec_x_im", "spec_h_re", "spec_h_im")


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_state_close(got, ref):
    for name in RINGS:
        g, r = _np(getattr(got, name)), _np(getattr(ref, name))
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g, r, atol=1e-5 * (np.abs(r).max() + 1e-30),
                                   rtol=0, err_msg=name)
    r_tail = _np(ref.tail)
    np.testing.assert_allclose(_np(got.tail), r_tail,
                               atol=2e-5 * np.abs(r_tail).max(), rtol=0)
    assert got.wp == int(ref.wp) and got.wp2 == int(ref.wp2)


def _assert_out_close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(_np(got), ref, atol=2e-5 * np.abs(ref).max(), rtol=0)


def _configs(pts, nparts, bin0_mode, pallas):
    jcfg = J.PconvConfig(pts=pts, nparts=nparts, bin0_mode=bin0_mode, pallas=pallas)
    return jcfg, P.PconvConfig(pts=pts, nparts=nparts, bin0_mode=bin0_mode)


def test_init_matches_jax():
    jcfg, tcfg = _configs(64, 4, "exact", "off")
    js, ts = J.pconv_init(jcfg), P.pconv_init(tcfg, "cpu")
    for name in RINGS + ("tail",):
        np.testing.assert_array_equal(_np(getattr(ts, name)), _np(getattr(js, name)))
    assert (ts.wp, ts.wp2) == (int(js.wp), int(js.wp2)) == (0, 3)


@pytest.mark.parametrize("pts,nparts", [(64, 4), (128, 8)])
def test_push_ir_matches_jax(pts, nparts):
    jcfg, tcfg = _configs(pts, nparts, "exact", "off")
    ir = np.random.default_rng(pts).standard_normal(pts * nparts).astype(np.float32)
    js = J.push_ir(jcfg, J.pconv_init(jcfg), jnp.asarray(ir))
    ts = P.push_ir(tcfg, P.pconv_init(tcfg, "cpu"), torch.from_numpy(ir))
    _assert_state_close(ts, js)


@pytest.mark.parametrize("bin0_mode", ["exact", "compat"])
@pytest.mark.parametrize("pts,nparts", [(64, 4), (128, 8)])
def test_step_matches_jax(pts, nparts, bin0_mode):
    jcfg, tcfg = _configs(pts, nparts, bin0_mode, "off")
    rng = np.random.default_rng(nparts)
    ir = rng.standard_normal(pts * nparts).astype(np.float32)
    blocks = rng.standard_normal((2 * nparts + 3, pts)).astype(np.float32)
    js = J.push_ir(jcfg, J.pconv_init(jcfg), jnp.asarray(ir))
    ts = P.push_ir(tcfg, P.pconv_init(tcfg, "cpu"), torch.from_numpy(ir))
    for blk in blocks:
        js, jo = J.pconv_step(jcfg, js, jnp.asarray(blk))
        ts, to = P.pconv_step(tcfg, ts, torch.from_numpy(blk))
        _assert_out_close(to, jo)
    _assert_state_close(ts, js)


# (pts, nparts, nb, JAX route): "stream" where the JAX package takes its
# whole-scan kernel for the shape, "off" (its XLA scan) elsewhere
STREAM_CASES = [(128, 8, 16, "stream"), (128, 8, 21, "stream"),
                (64, 4, 16, "off"), (64, 4, 21, "off"), (64, 8, 21, "off"),
                (128, 4, 21, "off")]


@pytest.mark.parametrize("bin0_mode", ["exact", "compat"])
@pytest.mark.parametrize("pts,nparts,nb,pallas", STREAM_CASES)
def test_stream_matches_jax_over_chained_calls(pts, nparts, nb, pallas, bin0_mode):
    jcfg, tcfg = _configs(pts, nparts, bin0_mode, pallas)
    assert jcfg._use_stream_kernel() == (pallas == "stream")
    rng = np.random.default_rng(pts + nparts + nb)
    ir = (0.2 * rng.standard_normal(pts * nparts)).astype(np.float32)
    blocks = rng.standard_normal((2, nb, pts)).astype(np.float32)
    js = J.push_ir(jcfg, J.pconv_init(jcfg), jnp.asarray(ir))
    ts = P.push_ir(tcfg, P.pconv_init(tcfg, "cpu"), torch.from_numpy(ir))
    for call in range(2):
        js, jo = J.pconv_stream(jcfg, js, jnp.asarray(blocks[call]))
        ts, to = P.pconv_stream(tcfg, ts, torch.from_numpy(blocks[call]))
        assert to.shape == (nb, pts)
        _assert_out_close(to, jo)
        _assert_state_close(ts, js)


def test_stream_equals_steps():
    cfg = P.PconvConfig(pts=32, nparts=3)
    rng = np.random.default_rng(3)
    ir = torch.from_numpy(rng.standard_normal(96).astype(np.float32))
    blocks = torch.from_numpy(rng.standard_normal((10, 32)).astype(np.float32))
    st = P.push_ir(cfg, P.pconv_init(cfg, "cpu"), ir)
    s_stream, outs = P.pconv_stream(cfg, st, blocks)
    steps = []
    for blk in blocks:
        st, o = P.pconv_step(cfg, st, blk)
        steps.append(o)
    _assert_out_close(outs, torch.stack(steps))
    _assert_state_close(s_stream, st)
    s_empty, empty = P.pconv_stream(cfg, s_stream, torch.zeros((0, 32)))
    assert empty.shape == (0, 32) and s_empty is s_stream


@pytest.mark.parametrize("nx,nh,pts", [(2000, 700, 16), (2000, 700, 64),
                                       (100, 1000, 32), (1000, 100, 32), (64, 64, 32)])
def test_convolve_matches_jax_and_scipy(nx, nh, pts):
    rng = np.random.default_rng(nx + nh + pts)
    x = rng.standard_normal(nx).astype(np.float32)
    h = rng.standard_normal(nh).astype(np.float32)
    got = P.convolve(x, h, pts, device="cpu").numpy()
    ref = sps.fftconvolve(x, h)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=3e-5 * np.abs(ref).max(), rtol=0)
    jref = np.asarray(J.convolve(jnp.asarray(x), jnp.asarray(h), pts))
    np.testing.assert_allclose(got, jref, atol=3e-5 * np.abs(jref).max(), rtol=0)


def test_convolve_needs_a_device_for_numpy_input():
    with pytest.raises(ValueError, match="device"):
        P.convolve(np.zeros(8, np.float32), np.zeros(4, np.float32), 4)
    out = P.convolve(torch.ones(8), torch.ones(4), 4)
    assert out.device.type == "cpu" and out.shape == (11,)


@pytest.mark.parametrize("k", [3, 8])
def test_state_hands_over_mid_stream(k):
    """JAX runs k blocks, the state crosses to the port, both continue on
    the same blocks; then the port's state crosses back."""
    pts, nparts = 64, 4
    jcfg, tcfg = _configs(pts, nparts, "exact", "off")
    rng = np.random.default_rng(k)
    ir = rng.standard_normal(pts * nparts).astype(np.float32)
    blocks = rng.standard_normal((k + 12, pts)).astype(np.float32)
    js = J.push_ir(jcfg, J.pconv_init(jcfg), jnp.asarray(ir))
    js, _ = J.pconv_stream(jcfg, js, jnp.asarray(blocks[:k]))
    ts = pconv_state_from_numpy(
        J.PconvState(*(np.asarray(f) for f in js)), "cpu")
    _assert_state_close(ts, js)
    js2, jo = J.pconv_stream(jcfg, js, jnp.asarray(blocks[k:k + 6]))
    ts, to = P.pconv_stream(tcfg, ts, torch.from_numpy(blocks[k:k + 6]))
    _assert_out_close(to, jo)
    back = J.PconvState(**{name: jnp.asarray(v)
                           for name, v in pconv_state_to_numpy(ts).items()})
    js3, jo3 = J.pconv_stream(jcfg, back, jnp.asarray(blocks[k + 6:]))
    _, jo_ref = J.pconv_stream(jcfg, js2, jnp.asarray(blocks[k + 6:]))
    _assert_out_close(jo3, jo_ref)


def test_interop_rejects_bad_fields():
    fields = pconv_state_to_numpy(P.pconv_init(P.PconvConfig(pts=16, nparts=2), "cpu"))
    bad = dict(fields, tail=np.zeros(8, np.float32))
    with pytest.raises(ValueError, match="tail"):
        pconv_state_from_numpy(bad, "cpu")
    with pytest.raises(ValueError, match="missing"):
        pconv_state_from_numpy({k: v for k, v in fields.items() if k != "wp"}, "cpu")


def test_config_validation():
    with pytest.raises(ValueError, match="power of two"):
        P.PconvConfig(pts=48, nparts=2)
    with pytest.raises(ValueError, match="partition"):
        P.PconvConfig(pts=64, nparts=0)
    with pytest.raises(ValueError, match="bin0_mode"):
        P.PconvConfig(pts=64, nparts=2, bin0_mode="half")
    with pytest.raises(ValueError, match="impl"):
        P.PconvConfig(pts=64, nparts=2, impl="stockham")
    with pytest.raises(ValueError, match="ring_dtype"):
        P.PconvConfig(pts=64, nparts=2, ring_dtype="f16")
    with pytest.raises(ValueError, match="dtype"):
        P.PconvConfig(pts=64, nparts=2, dtype="f16")
    bf16 = P.PconvConfig(pts=64, nparts=2, ring_dtype="bf16")
    assert (bf16.storage_dtype, bf16.compute_dtype) == (torch.bfloat16, torch.float32)
    f64 = P.PconvConfig(pts=64, nparts=2, dtype="f64")
    assert (f64.storage_dtype, f64.compute_dtype) == (torch.float64, torch.float64)
    assert not bf16._kernel_eligible() and not f64._kernel_eligible()
    assert P.PconvConfig(pts=64, nparts=2)._kernel_eligible()
    with pytest.raises(ValueError, match="reduced-width ring"):
        P.PconvConfig(pts=64, nparts=2, dtype="f64", ring_dtype="bf16")
    with pytest.raises(ValueError, match="multiple"):
        P.PconvConfig.for_ir_length(100, 64)
    cfg = P.PconvConfig.for_ir_length(256, 64, bin0_mode="compat")
    assert (cfg.nparts, cfg.bins, cfg.cvs, cfg.b0_scale) == (4, 64, 256, 1.0)


def test_stream_and_push_ir_validate_shapes():
    cfg = P.PconvConfig(pts=16, nparts=2)
    st = P.pconv_init(cfg, "cpu")
    with pytest.raises(ValueError, match="IR"):
        P.push_ir(cfg, st, torch.zeros(31))
    with pytest.raises(ValueError, match="blocks"):
        P.pconv_stream(cfg, st, torch.zeros(16))
    with pytest.raises(ValueError, match="blocks"):
        P.pconv_stream(cfg, st, torch.zeros((2, 8)))
    big = P.PconvConfig(pts=4096, nparts=1)
    out = P.pconv_stream(big, P.pconv_init(big, "cpu"), torch.zeros((1, 4096)))[1]
    assert out.shape == (1, 4096) and not out.any()


@pytest.mark.parametrize("tv", [False, True])
@pytest.mark.parametrize("pts,nparts", [(16, 5), (2048, 2)])
def test_stream_is_the_scan_twin_bit_for_bit(pts, nparts, tv):
    """Up to pts 2048, where the JAX package runs its dense-table scans,
    ``pconv_stream{,_tv}`` (the one-channel view of the batched streams)
    give the single-channel scan twin's bits: outputs, window, IR ring and
    tail, from a state whose pointers have moved."""
    from opencl_fft_tpu_torch.ops.cuda import streamstep as S

    cfg = P.PconvConfig(pts=pts, nparts=nparts)
    rng = np.random.default_rng(pts + tv)

    def f32(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    st = P.push_ir(cfg, P.pconv_init(cfg, "cpu"), f32(cfg.cvs))
    st = P.pconv_stream_tv(cfg, st, f32(3, pts), f32(3, pts))[0] if tv else \
        P.pconv_stream(cfg, st, f32(3, pts))[0]
    bx, bh = f32(7, pts), f32(7, pts)
    window = (st.spec_x_re[st.wp:st.wp + nparts], st.spec_x_im[st.wp:st.wp + nparts])
    h = (st.spec_h_re, st.spec_h_im)
    if tv:
        got_s, got = P.pconv_stream_tv(cfg, st, bx, bh)
        want, (wr, wi), (hr, hi), tail = S.stream_steps_fused_tv_plain(
            bx, bh, window, h, st.wp2, cfg.b0_scale, st.tail, pts)
    else:
        got_s, got = P.pconv_stream(cfg, st, bx)
        want, (wr, wi), tail = S.stream_steps_fused_plain(bx, window, h, cfg.b0_scale,
                                                         st.tail, pts)
        hr, hi = h
    wp = got_s.wp
    for g, w in ((got, want), (got_s.spec_x_re[wp:wp + nparts], wr),
                 (got_s.spec_x_im[wp:wp + nparts], wi), (got_s.spec_h_re, hr),
                 (got_s.spec_h_im, hi), (got_s.tail, tail)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert (got_s.wp, got_s.wp2) == ((st.wp + 7) % nparts,
                                     (st.wp2 - 7 * tv) % nparts)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the stream kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_stream_matches_cpu_twin(cuda_device):
    from opencl_fft_tpu_torch.ops.cuda import streamstep as S

    cfg = P.PconvConfig(pts=128, nparts=8)
    rng = np.random.default_rng(9)
    ir = torch.from_numpy(rng.standard_normal(1024).astype(np.float32))
    blocks = torch.from_numpy(rng.standard_normal((2, 21, 128)).astype(np.float32))
    tc = P.push_ir(cfg, P.pconv_init(cfg, "cpu"), ir)
    tg = P.push_ir(cfg, P.pconv_init(cfg, cuda_device), ir.to(cuda_device))
    before = S.BATCHED_LAUNCHES
    for call in range(2):
        tc, oc = P.pconv_stream(cfg, tc, blocks[call])
        tg, og = P.pconv_stream(cfg, tg, blocks[call].to(cuda_device))
        _assert_out_close(og.cpu(), oc)
    assert S.BATCHED_LAUNCHES == before + 2
    with pytest.raises(TypeError):
        P.pconv_stream(cfg, tg, blocks[0].double().to(cuda_device))
