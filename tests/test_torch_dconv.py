"""Port parity: the direct-FIR path of opencl_fft_tpu_torch against
opencl_fft_tpu on the same inputs.

The plain twin ``dstream_steps_plain`` is held against the JAX Pallas kernel
``dstream_steps`` in interpret mode, and ``toeplitz_slabs`` against the JAX
slabs (atol 1e-5 * max|ref|); the wrapper ``dstream_steps``, which takes
the coefficients, against both and float64 ``np.convolve``. ``dconv_step``, ``dconv_step_tv`` and
``dconv_stream`` are held against the JAX functions (its XLA scan,
pallas="off"), the class and opcode layers against their JAX counterparts,
at 2e-5 * max|ref| (the JAX package's ``convolve_direct`` bound) and the
delay line at 1e-6 * max|ref|. The CUDA kernel is held against the twin on
a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_fft_tpu import api as japi
from opencl_fft_tpu import stream as jstream
from opencl_fft_tpu.ops import dconv as J
from opencl_fft_tpu.ops.pallas import dstream as JD
from opencl_fft_tpu_torch import api as tapi
from opencl_fft_tpu_torch import stream as tstream
from opencl_fft_tpu_torch.interop import (dconv_state_from_numpy,
                                          dconv_state_to_numpy)
from opencl_fft_tpu_torch.ops import dconv as D
from opencl_fft_tpu_torch.ops.cuda import dstream as K
from opencl_fft_tpu_torch.utils.errors import ArgumentError, SizeError

torch.set_num_threads(1)


def _quiet(msg, user_data):
    pass


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, ref, rel=2e-5):
    ref = _np(ref)
    np.testing.assert_allclose(_np(got), ref, atol=rel * (np.abs(ref).max() + 1e-30),
                               rtol=0)


def _f(rng, *shape, s=1.0):
    return (s * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("irsize,vsize", [(128, 128), (256, 128), (96, 32)])
@pytest.mark.parametrize("off", [0, 1])
def test_toeplitz_slabs_match_jax(irsize, vsize, off):
    ir = _f(np.random.default_rng(irsize), irsize)
    want = np.asarray(JD.toeplitz_slabs(jnp.asarray(ir), irsize, vsize, off))
    got = K.toeplitz_slabs(torch.from_numpy(ir), irsize, vsize, off).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("irsize,vsize", [(128, 128), (256, 128)])
@pytest.mark.parametrize("nb", [8, 16])
def test_dstream_twin_matches_pallas_kernel(irsize, vsize, nb):
    rng = np.random.default_rng(irsize + nb)
    p = irsize // vsize
    blocks, carry0 = _f(rng, nb, vsize), _f(rng, p, vsize)
    slabs = np.array(JD.toeplitz_slabs(jnp.asarray(_f(rng, irsize)), irsize, vsize, 1))
    want = JD.dstream_steps(jnp.asarray(blocks), jnp.asarray(carry0), jnp.asarray(slabs),
                            vsize, interpret=True)
    seq = np.concatenate([carry0, blocks])
    got = K.dstream_steps_plain(torch.from_numpy(seq), torch.from_numpy(slabs), vsize)
    _close(got, want, 1e-5)


def _configs(irsize, vsize, delay_compat):
    return (J.DconvConfig(irsize=irsize, vsize=vsize, delay_compat=delay_compat,
                          pallas="off"),
            D.DconvConfig(irsize=irsize, vsize=vsize, delay_compat=delay_compat))


def _seeded(jcfg, tcfg, rng):
    ir = _f(rng, tcfg.irsize, s=0.3)
    return (J.push_ir(jcfg, J.dconv_init(jcfg), jnp.asarray(ir)),
            D.push_ir(tcfg, D.dconv_init(tcfg, "cpu"), torch.from_numpy(ir)))


def _assert_state_close(got, ref, scale):
    assert got.wp == int(ref.wp)
    np.testing.assert_allclose(_np(got.delay), _np(ref.delay), atol=1e-6 * scale, rtol=0)
    np.testing.assert_array_equal(_np(got.coefs), _np(ref.coefs))


@pytest.mark.parametrize("irsize,vsize", [(8, 4), (63, 32), (512, 64), (100, 128)])
@pytest.mark.parametrize("delay_compat", [False, True])
def test_step_matches_jax(irsize, vsize, delay_compat):
    jcfg, tcfg = _configs(irsize, vsize, delay_compat)
    rng = np.random.default_rng(irsize + vsize)
    js, ts = _seeded(jcfg, tcfg, rng)
    for _ in range(irsize // vsize + 3):
        blk = _f(rng, vsize)
        js, jo = J.dconv_step(jcfg, js, jnp.asarray(blk))
        ts, to = D.dconv_step(tcfg, ts, torch.from_numpy(blk))
        _close(to, jo)
    _assert_state_close(ts, js, 1.0)


@pytest.mark.parametrize("irsize,vsize", [(8, 4), (48, 16), (20, 16)])
@pytest.mark.parametrize("delay_compat", [False, True])
def test_step_tv_matches_jax(irsize, vsize, delay_compat):
    jcfg, tcfg = _configs(irsize, vsize, delay_compat)
    rng = np.random.default_rng(irsize)
    js, ts = J.dconv_init(jcfg), D.dconv_init(tcfg, "cpu")
    for _ in range(12):
        b1, b2 = _f(rng, vsize), _f(rng, vsize)
        js, jo = J.dconv_step_tv(jcfg, js, jnp.asarray(b1), jnp.asarray(b2))
        ts, to = D.dconv_step_tv(tcfg, ts, torch.from_numpy(b1), torch.from_numpy(b2))
        _close(to, jo)
    _assert_state_close(ts, js, 1.0)


# (irsize, vsize, nb): the JAX kernel's shapes (P = 1, 2), the reference
# model's, and shapes that are not a block multiple (P*vsize > irsize)
STREAM_CASES = [(128, 128, 19), (256, 128, 19), (8, 4, 10), (48, 16, 7),
                (100, 32, 9), (1000, 256, 5)]


@pytest.mark.parametrize("irsize,vsize,nb", STREAM_CASES)
@pytest.mark.parametrize("delay_compat", [False, True])
def test_stream_matches_jax_over_chained_calls(irsize, vsize, nb, delay_compat):
    """Two chained calls, then the state crosses to JAX through interop and
    back again, and both packages continue on the same blocks."""
    jcfg, tcfg = _configs(irsize, vsize, delay_compat)
    rng = np.random.default_rng(irsize + nb)
    js, ts = _seeded(jcfg, tcfg, rng)
    blocks = _f(rng, 3, nb, vsize)
    before = K.LAUNCHES
    for call in range(2):
        js, jo = J.dconv_stream(jcfg, js, jnp.asarray(blocks[call]))
        ts, to = D.dconv_stream(tcfg, ts, torch.from_numpy(blocks[call]))
        assert to.shape == (nb, vsize)
        _close(to, jo)
        _assert_state_close(ts, js, np.abs(blocks).max())
    assert K.LAUNCHES == before                 # the CPU runs the twin
    back = J.DconvState(**{k: jnp.asarray(v) for k, v in dconv_state_to_numpy(ts).items()})
    _, jo_b = J.dconv_stream(jcfg, back, jnp.asarray(blocks[2]))
    ts = dconv_state_from_numpy(J.DconvState(*(np.asarray(f) for f in js)), "cpu")
    _, jo = J.dconv_stream(jcfg, js, jnp.asarray(blocks[2]))
    _, to = D.dconv_stream(tcfg, ts, torch.from_numpy(blocks[2]))
    _close(jo_b, jo)
    _close(to, jo)


def test_stream_equals_steps():
    cfg = D.DconvConfig(irsize=70, vsize=16)
    rng = np.random.default_rng(4)
    st = D.push_ir(cfg, D.dconv_init(cfg, "cpu"), torch.from_numpy(_f(rng, 70)))
    blocks = torch.from_numpy(_f(rng, 9, 16))
    s_stream, outs = D.dconv_stream(cfg, st, blocks)
    steps = []
    for blk in blocks:
        st, o = D.dconv_step(cfg, st, blk)
        steps.append(o)
    _close(outs, torch.stack(steps))
    _assert_state_close(s_stream, st, 1.0)
    s_empty, empty = D.dconv_stream(cfg, s_stream, torch.zeros((0, 16)))
    assert empty.shape == (0, 16) and s_empty is s_stream


@pytest.mark.parametrize("irsize,vsize", [(8, 4), (63, 32), (512, 64), (100, 128)])
def test_convolve_direct_matches_numpy_and_jax(irsize, vsize):
    rng = np.random.default_rng(irsize * vsize)
    x, h = _f(rng, 1000), _f(rng, irsize)
    got = D.convolve_direct(x, h, vsize=vsize, device="cpu")
    ref = np.convolve(x.astype(np.float64), h.astype(np.float64))
    assert got.shape == ref.shape
    _close(got, ref)
    _close(got, J.convolve_direct(jnp.asarray(x), jnp.asarray(h), vsize=vsize))


def test_config_state_and_wrapper_checks():
    with pytest.raises(ValueError, match="positive"):
        D.DconvConfig(irsize=0, vsize=4)
    with pytest.raises(ValueError, match="dtype"):
        D.DconvConfig(irsize=4, vsize=4, dtype="f16")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 17"):
        D.DconvConfig(irsize=4, vsize=4, dtype="f64")
    cfg = D.DconvConfig(irsize=6, vsize=4, delay_compat=True)
    assert (cfg.ring, cfg.off, K.context_blocks(6, 4)) == (10, 0, 2)
    st = D.dconv_init(cfg, "cpu")
    with pytest.raises(ValueError, match="IR"):
        D.push_ir(cfg, st, torch.zeros(5))
    with pytest.raises(ValueError, match="blocks"):
        D.dconv_stream(cfg, st, torch.zeros((2, 3)))
    with pytest.raises(ValueError, match="device"):
        D.convolve_direct(np.zeros(8, np.float32), np.zeros(3, np.float32))
    z = torch.zeros
    with pytest.raises(ValueError, match="no new block"):
        K.dstream_steps(z(2, 4), z(6), 4, 1)
    with pytest.raises(ValueError, match="seq"):
        K.dstream_steps(z(5, 3), z(6), 4, 1)
    with pytest.raises(ValueError, match="ir must be"):
        K.dstream_steps(z(5, 4), z(2, 3), 4, 1)
    with pytest.raises(ValueError, match="off"):
        K.dstream_steps(z(5, 4), z(6), 4, 2)
    with pytest.raises(ValueError, match="slabs"):
        K.dstream_steps_plain(z(5, 4), z(12, 3), 4)
    meta = torch.zeros((5, 4), device="meta")
    with pytest.raises(ValueError, match="one device"):
        K.dstream_steps(meta, z(6), 4, 1)
    with pytest.raises(ValueError, match="no kernel"):
        K.dstream_steps(meta, torch.zeros(6, device="meta"), 4, 1)


@pytest.mark.parametrize("irsize,vsize,nb", [(128, 128, 8), (512, 128, 16), (256, 16, 8),
                                             (12, 3, 8), (100, 32, 1), (7, 3, 1)])
@pytest.mark.parametrize("delay_compat", [False, True])
def test_dstream_wrapper_matches_jax_and_numpy(irsize, vsize, nb, delay_compat):
    """The wrapper (its twin on the CPU) on the coefficients: the Toeplitz
    product of slabs built from the same taps, bit for bit; the JAX Pallas
    kernel in interpret mode where it runs (irsize a multiple of vsize, nb
    a multiple of 8; P = 1, 4, 16, vsize 3) at 1e-5; float64 np.convolve
    of the whole sequence at 1e-5 (P = 1, 4, 16, 34; vsize 3; nb 1)."""
    off = 0 if delay_compat else 1
    rng = np.random.default_rng(irsize + 7 * vsize + nb + off)
    p = K.context_blocks(irsize, vsize)
    seq, ir = _f(rng, p + nb, vsize), _f(rng, irsize, s=0.1)
    got = K.dstream_steps(torch.from_numpy(seq), torch.from_numpy(ir), vsize, off)
    assert got.shape == (nb, vsize)
    slabs = K.toeplitz_slabs(torch.from_numpy(ir), irsize, vsize, off)
    np.testing.assert_array_equal(
        got.numpy(), K.dstream_steps_plain(torch.from_numpy(seq), slabs, vsize).numpy())
    c = p * vsize - irsize + off
    s64 = seq.astype(np.float64).reshape(-1)
    want = np.convolve(s64, ir.astype(np.float64), "valid")[c:c + nb * vsize]
    _close(got.reshape(-1), want, 1e-5)
    if irsize % vsize == 0 and nb % 8 == 0:
        jslabs = JD.toeplitz_slabs(jnp.asarray(ir), irsize, vsize, off)
        jout = JD.dstream_steps(jnp.asarray(seq[p:]), jnp.asarray(seq[:p]), jslabs, vsize,
                                interpret=True)
        _close(got, jout, 1e-5)


def test_interop_rejects_bad_fields():
    fields = dconv_state_to_numpy(D.dconv_init(D.DconvConfig(irsize=6, vsize=4), "cpu"))
    with pytest.raises(ValueError, match="coefs"):
        dconv_state_from_numpy(dict(fields, coefs=np.zeros(9, np.float32)), "cpu")
    with pytest.raises(ValueError, match="missing"):
        dconv_state_from_numpy({k: v for k, v in fields.items() if k != "wp"}, "cpu")
    st = dconv_state_from_numpy(dict(fields, wp=np.int32(13)), "cpu")
    assert st.wp == 3 and st.delay.shape == (10,)


@pytest.mark.parametrize("delay_compat", [False, True])
def test_cldconv_matches_jax(delay_compat):
    cvs, vsiz = 40, 16
    rng = np.random.default_rng(12)
    j = japi.Cldconv(0, cvs, vsiz, _quiet, delay_compat=delay_compat)
    t = tapi.Cldconv(0, cvs, vsiz, _quiet, delay_compat=delay_compat, device="cpu")
    ir = _f(rng, cvs)
    assert j.push_ir(ir) == t.push_ir(ir) == 0
    for n in range(8):
        a, b = _f(rng, vsiz), _f(rng, vsiz)
        args = (a,) if n < 5 else (a, b)      # LTI, then time-varying
        jo, to = np.empty(vsiz, np.float32), np.empty(vsiz, np.float32)
        assert j.convolution(jo, *args) == t.convolution(to, *args) == 0
        _close(to, jo)
    with pytest.raises(SizeError):
        t.convolution(np.empty(vsiz, np.float32), np.zeros(vsiz - 1, np.float32))
    with pytest.raises(SizeError):
        t.push_ir(np.zeros(cvs + 1, np.float32))
    bad = tapi.Cldconv(0, 0, vsiz, _quiet, device="cpu")
    assert bad.get_cl_err() != 0
    assert bad.convolution(np.empty(vsiz, np.float32), a) == bad.get_cl_err()


def test_clconv_processor_direct_matches_jax():
    """parts=1 with skip/size and a 0dbfs scale: the JAX processor's output,
    and np.convolve with no latency."""
    skip, size, scale, bs = 5, 105, 0.5, 32
    rng = np.random.default_rng(13)
    table, x = _f(rng, 120), _f(rng, 10 * bs)
    jp = jstream.ClconvProcessor(table, 1, skip=skip, size=size, scale=scale,
                                 block_size=bs, on_message=_quiet)
    tp = tstream.ClconvProcessor(table, 1, skip=skip, size=size, scale=scale,
                                 block_size=bs, on_message=_quiet, device="cpu")
    assert tp.latency == jp.latency == 0
    jo = np.concatenate([jp.process(x[i:i + bs]) for i in range(0, x.size, bs)])
    to = np.concatenate([tp.process(x[i:i + bs]) for i in range(0, x.size, bs)])
    _close(to, jo)
    ref = np.convolve(x.astype(np.float64), table[skip:size].astype(np.float64) * scale)
    _close(to, ref[:x.size])
    with pytest.raises(ArgumentError):
        tp.process(x[:bs - 1])
    with pytest.raises(ArgumentError):
        tp.set_ir(table)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the dstream kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("irsize,vsize,nb", [(512, 512, 1880), (512, 512, 21), (7 * 128, 128, 200),
                                             (1000, 256, 40), (5, 3, 1), (3000, 64, 100)])
@pytest.mark.parametrize("off", [0, 1])
def test_cuda_dstream_kernel_matches_twin(cuda_device, irsize, vsize, nb, off):
    """The direct-FIR kernel at the smoke run's shapes (and one that stages
    its taps in three blocks) against the Toeplitz twin."""
    rng = np.random.default_rng(irsize + nb)
    p = K.context_blocks(irsize, vsize)
    seq = torch.from_numpy(_f(rng, p + nb, vsize)).to(cuda_device)
    ir = torch.from_numpy(_f(rng, irsize)).to(cuda_device)
    before = K.LAUNCHES
    got = K.dstream_steps(seq, ir, vsize, off)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before + 1
    assert got.shape == (nb, vsize)
    _close(got, K.dstream_steps_plain(seq, K.toeplitz_slabs(ir, irsize, vsize, off), vsize))


@pytest.mark.cuda
@pytest.mark.parametrize("delay_compat", [False, True])
def test_cuda_dconv_stream_matches_cpu_twin(cuda_device, delay_compat):
    cfg = D.DconvConfig(irsize=100, vsize=32, delay_compat=delay_compat)
    rng = np.random.default_rng(14)
    ir = torch.from_numpy(_f(rng, 100))
    blocks = torch.from_numpy(_f(rng, 2, 11, 32))
    tc = D.push_ir(cfg, D.dconv_init(cfg, "cpu"), ir)
    tg = D.push_ir(cfg, D.dconv_init(cfg, cuda_device), ir.to(cuda_device))
    before = K.LAUNCHES
    for call in range(2):
        tc, oc = D.dconv_stream(cfg, tc, blocks[call])
        tg, og = D.dconv_stream(cfg, tg, blocks[call].to(cuda_device))
        _close(og, oc)
    assert K.LAUNCHES == before + 2
    with pytest.raises(TypeError):
        D.dconv_stream(cfg, tg, blocks[0].double().to(cuda_device))
