"""Port parity: the FFT surface of opencl_fft_tpu_torch (the Clcfft/Clrfft
classes, the ClfftProcessor/ClrfftProcessor opcode layers, Bluestein
sizes, the complex-tensor wrappers and the rfft layout converters) against
the JAX package on the same inputs (atol 1e-5 * max|ref|), the routing of
fft_split, and, on a card, the main paths through the CUDA FFT kernels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_fft_tpu import api as japi
from opencl_fft_tpu import stream as jstream
from opencl_fft_tpu.ops import fft as jfft
from opencl_fft_tpu.ops import rfft as jrfft
from opencl_fft_tpu_torch import api as tapi
from opencl_fft_tpu_torch import models as tmodels
from opencl_fft_tpu_torch import stream as tstream
from opencl_fft_tpu_torch.ops import fft as tfft
from opencl_fft_tpu_torch.ops import pconv as tpconv
from opencl_fft_tpu_torch.ops import rfft as trfft
from opencl_fft_tpu_torch.ops.cuda import vmemfft as V
from opencl_fft_tpu_torch.utils.errors import ArgumentError, SizeError, Status

torch.set_num_threads(1)


def _quiet(msg, user_data):
    pass


def _cplx(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _close(got, ref, tol=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=tol * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("size", [16, 1024])
@pytest.mark.parametrize("fwd", [True, False])
def test_clcfft_matches_jax(size, fwd):
    data = _cplx(np.random.default_rng(size + fwd), size)
    j = japi.Clcfft(0, size, fwd, on_message=_quiet)
    t = tapi.Clcfft(0, size, fwd, on_message=_quiet, device="cpu")
    jb, tb = data.copy(), data.copy()
    assert j.transform(jb) == t.transform(tb) == 0
    _close(tb, jb)
    ref = np.fft.fft(data.astype(np.complex128)) / size if fwd \
        else np.fft.ifft(data.astype(np.complex128)) * size
    _close(tb, ref)
    assert t.get_error() == 0 and "route: torch.fft" in t.get_log()


def test_clcfft_status_and_errors():
    seen = []
    t = tapi.Clcfft(0, 1000, on_message=lambda m, u: seen.append((m, u)), user_data=7,
                    device="cpu")
    j = japi.Clcfft(0, 1000, on_message=_quiet)
    assert t.get_error() == j.get_error() == int(Status.INVALID_BUFFER_SIZE)
    assert t.transform(np.zeros(1000, np.complex64)) == int(Status.INVALID_BUFFER_SIZE)
    assert "power of two" in t.get_log() and seen[0][1] == 7
    t = tapi.Clcfft(0, 64, device="cpu", on_message=_quiet)
    with pytest.raises(SizeError):
        t.transform(np.zeros(32, np.complex64))
    for bad in (dict(impl="mm"), dict(impl="vmem")):
        assert tapi.Clcfft(0, 64, on_message=_quiet, device="cpu", **bad).get_error() \
            == int(Status.UNKNOWN)
    t = tapi.Clcfft(0, 1024, impl="vmem", on_message=_quiet, device="cpu")
    assert "plain twin of fft_vmem" in t.get_log()


@pytest.mark.parametrize("size", [64, 2048])
@pytest.mark.parametrize("fwd", [True, False])
@pytest.mark.parametrize("inplace", [True, False])
def test_clrfft_matches_jax(size, fwd, inplace):
    rng = np.random.default_rng(size + 2 * fwd + inplace)
    j = japi.Clrfft(0, size, fwd, on_message=_quiet)
    t = tapi.Clrfft(0, size, fwd, on_message=_quiet, device="cpu")
    if fwd:
        r = rng.standard_normal(size).astype(np.float32)
        jc, tc = np.zeros(size // 2, np.complex64), np.zeros(size // 2, np.complex64)
        if inplace:
            jc.view(np.float32)[:] = r
            tc.view(np.float32)[:] = r
            assert j.transform(jc) == t.transform(tc) == 0
        else:
            assert j.transform(jc, r) == t.transform(tc, r) == 0
        _close(tc, jc)
        std = trfft.packed_to_standard(torch.from_numpy(tc)).numpy()
        _close(std, np.fft.rfft(r.astype(np.float64)) * 2 / size)
    else:
        c = _cplx(rng, size // 2)
        if inplace:
            jc, tc = c.copy(), c.copy()
            assert j.transform(jc) == t.transform(tc) == 0
            _close(tc.view(np.float32), jc.view(np.float32))
        else:
            jr, tr = np.zeros(size, np.float32), np.zeros(size, np.float32)
            assert j.transform(c.copy(), jr) == t.transform(c.copy(), tr) == 0
            _close(tr, jr)


def test_clrfft_errors():
    t = tapi.Clrfft(0, 64, True, on_message=_quiet, device="cpu")
    with pytest.raises(ArgumentError):
        t.transform(np.zeros(32, np.complex128))
    with pytest.raises(SizeError):
        t.transform(np.zeros(32, np.complex64), np.zeros(60, np.float32))
    with pytest.raises(SizeError):
        tapi.Clrfft(0, 64, False, on_message=_quiet, device="cpu").transform(
            np.zeros(16, np.complex64))
    assert tapi.Clrfft(0, 100, on_message=_quiet, device="cpu").get_error() \
        == japi.Clrfft(0, 100, on_message=_quiet).get_error() == int(Status.INVALID_BUFFER_SIZE)
    assert tapi.Clrfft(0, 2, True, on_message=_quiet, device="cpu").get_error() \
        == japi.Clrfft(0, 2, True, on_message=_quiet).get_error() == int(Status.UNKNOWN)


@pytest.mark.parametrize("length", [1000, 1024])
@pytest.mark.parametrize("fwd", [True, False])
def test_clfft_processor_matches_jax(length, fwd):
    data = _cplx(np.random.default_rng(length + fwd), length)
    jp = jstream.ClfftProcessor(length, fwd, on_message=_quiet)
    tp = tstream.ClfftProcessor(length, fwd, on_message=_quiet, device="cpu")
    assert tp.n == jp.n == 1024
    _close(tp.process(data), jp.process(data))
    with pytest.raises(ArgumentError):
        tp.process(data[:-1])


@pytest.mark.parametrize("length", [1000, 1024])
@pytest.mark.parametrize("fwd", [True, False])
def test_clrfft_processor_matches_jax(length, fwd):
    rng = np.random.default_rng(3 * length + fwd)
    data = rng.standard_normal(length).astype(np.float32) if fwd else _cplx(rng, length // 2)
    jp = jstream.ClrfftProcessor(length, fwd, on_message=_quiet)
    tp = tstream.ClrfftProcessor(length, fwd, on_message=_quiet, device="cpu")
    got, ref = tp.process(data), jp.process(data)
    assert got.dtype == ref.dtype
    _close(got, ref)


@pytest.mark.parametrize("n", [3, 12, 100, 1000])
@pytest.mark.parametrize("sign", [-1, 1])
def test_bluestein_matches_jax_and_numpy(n, sign):
    z = _cplx(np.random.default_rng(n - sign), 2, n)
    x = (z.real.copy(), z.imag.copy())
    jr, ji = jfft.fft_split(tuple(map(jnp.asarray, x)), sign, scale=0.5)
    tr, ti = tfft.fft_split(tuple(map(torch.from_numpy, x)), sign, scale=0.5)
    _close(tr.numpy() + 1j * ti.numpy(), np.asarray(jr) + 1j * np.asarray(ji))
    zz = z.astype(np.complex128)
    ref = 0.5 * (np.fft.fft(zz) if sign == -1 else np.fft.ifft(zz) * n)
    _close(tr.numpy() + 1j * ti.numpy(), ref)


def test_bluestein_float64_and_vmem_core():
    """float64 Bluestein stays float64; with impl='vmem' a size whose padded
    core lies in 2^10..2^20 runs the core through fft_vmem (its twin on the
    CPU), and the result still matches numpy."""
    z = _cplx(np.random.default_rng(9), 3, 600).astype(np.complex128)
    got = tfft.fft(torch.from_numpy(z))
    assert got.dtype == torch.complex128
    _close(got.numpy(), np.fft.fft(z), 1e-12)
    x = tuple(torch.from_numpy(p.astype(np.float32).copy()) for p in (z.real, z.imag))
    core = tfft._bluestein_tables_np(600, -1)[2]
    assert V.supported(core)
    yr, yi = tfft._fft_bluestein(x, -1, "vmem")
    _close(yr.numpy() + 1j * yi.numpy(), np.fft.fft(z))


@pytest.mark.parametrize("op", ["cfft_fwd", "cfft_inv", "fft", "ifft", "fft_unnormalized"])
@pytest.mark.parametrize("n", [64, 100])
def test_complex_wrappers_match_jax(op, n):
    z = _cplx(np.random.default_rng(n + len(op)), 2, n)
    call = {"cfft_fwd": lambda m, a: m.cfft(a, True), "cfft_inv": lambda m, a: m.cfft(a, False),
            "fft": lambda m, a: m.fft(a), "ifft": lambda m, a: m.ifft(a),
            "fft_unnormalized": lambda m, a: m.fft_unnormalized(a, +1)}[op]
    ref = np.asarray(call(jfft, jnp.asarray(z)))
    got = call(tfft, torch.from_numpy(z))
    assert got.dtype == torch.complex64
    _close(got.numpy(), ref)


@pytest.mark.parametrize("n", [64, 1024])
def test_rfft_wrappers_and_layouts_match_jax(n):
    rng = np.random.default_rng(n)
    r = rng.standard_normal((2, n)).astype(np.float32)
    for unnormalized in (False, True):
        _close(trfft.rfft(torch.from_numpy(r), unnormalized=unnormalized).numpy(),
               np.asarray(jrfft.rfft(jnp.asarray(r), unnormalized=unnormalized)))
    c = _cplx(rng, 2, n // 2)
    _close(trfft.irfft(torch.from_numpy(c)).numpy(), np.asarray(jrfft.irfft(jnp.asarray(c))))
    std = trfft.packed_to_standard(torch.from_numpy(c))
    _close(std.numpy(), np.asarray(jrfft.packed_to_standard(jnp.asarray(c))))
    s = _cplx(rng, 2, n // 2 + 1)
    _close(trfft.standard_to_packed(torch.from_numpy(s)).numpy(),
           np.asarray(jrfft.standard_to_packed(jnp.asarray(s))))
    back = trfft.standard_to_packed(trfft.packed_to_standard(torch.from_numpy(c)))
    _close(back.numpy(), c)


def test_fft_split_routing_on_cpu():
    """On the CPU, impl='auto' stays on torch.fft at every size and
    impl='vmem' runs fft_vmem's twin; neither launches a kernel."""
    rng = np.random.default_rng(21)
    x = tuple(torch.from_numpy(rng.standard_normal((2, 1 << 12)).astype(np.float32))
              for _ in range(2))
    before = (V.LAUNCHES, V.FRONT2_LAUNCHES)
    a = tfft.fft_split(x, -1, scale=0.5)
    b = tfft.fft_split(x, -1, impl="vmem", scale=0.5)
    c = V.fft_vmem_plain(x, -1, 0.5)
    assert (V.LAUNCHES, V.FRONT2_LAUNCHES) == before
    _close(b[0].numpy() + 1j * b[1].numpy(), a[0].numpy() + 1j * a[1].numpy())
    np.testing.assert_array_equal(b[0].numpy(), c[0].numpy())
    assert tfft.uses_vmem(1 << 12, torch.float32, torch.device("cpu"), "vmem")
    assert not tfft.uses_vmem(1 << 12, torch.float32, torch.device("cpu"), "auto")
    for n, dt, want in ((1 << 10, torch.float32, True), (1 << 20, torch.float32, True),
                        (1 << 9, torch.float32, False), (1 << 21, torch.float32, False),
                        (1 << 12, torch.float64, False)):
        assert tfft.uses_vmem(n, dt, torch.device("cuda", 0), "auto") == want


def test_batched_fft_on_cpu_with_vmem_twin():
    z = _cplx(np.random.default_rng(2), 3, 1 << 11)
    m = tmodels.BatchedFFT(1 << 11, forward=False, impl="vmem", device="cpu")
    yr, yi = m((z.real.copy(), z.imag.copy()))
    _close(yr.numpy() + 1j * yi.numpy(), np.fft.ifft(z.astype(np.complex128)) * (1 << 11))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the FFT kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("size", [1 << 10, 1 << 18])
def test_cuda_clcfft_runs_the_kernel(cuda_device, size):
    data = _cplx(np.random.default_rng(size), size)
    t = tapi.Clcfft(0, size, True, on_message=_quiet)
    before = V.LAUNCHES + V.FRONT2_LAUNCHES
    b = data.copy()
    assert t.transform(b) == 0
    assert V.LAUNCHES + V.FRONT2_LAUNCHES == before + 1
    _close(b, np.fft.fft(data.astype(np.complex128)) / size)
    assert "csrc/fft.cu" in t.get_log() and "registers" in t.get_log()


@pytest.mark.cuda
def test_cuda_routing_batched_fft_and_pconv_step(cuda_device):
    rng = np.random.default_rng(4)
    x = tuple(torch.from_numpy(rng.standard_normal((16, 1 << 18)).astype(np.float32))
              .to(cuda_device) for _ in range(2))
    before = V.FRONT2_LAUNCHES
    yr, yi = tmodels.BatchedFFT(1 << 18, device=cuda_device)(x)
    assert V.FRONT2_LAUNCHES == before + 1
    ref = np.fft.fft(x[0].cpu().numpy().astype(np.float64) + 1j * x[1].cpu().numpy())
    _close(yr.cpu().numpy() + 1j * yi.cpu().numpy(), ref)
    before = V.LAUNCHES + V.FRONT2_LAUNCHES
    tfft.fft_split(tuple(p[:, :512] for p in x), -1)                # n < 2^10
    tfft.fft_split(tuple(p[:, :1024].double() for p in x), -1)      # float64
    assert V.LAUNCHES + V.FRONT2_LAUNCHES == before
    cfg = tpconv.PconvConfig.for_ir_length(4096, 1024)
    ir = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    blk = torch.from_numpy(rng.standard_normal(1024).astype(np.float32))
    sc = tpconv.push_ir(cfg, tpconv.pconv_init(cfg, "cpu"), ir)
    sg = tpconv.push_ir(cfg, tpconv.pconv_init(cfg, cuda_device), ir.to(cuda_device))
    before = V.LAUNCHES
    _, oc = tpconv.pconv_step(cfg, sc, blk)
    _, og = tpconv.pconv_step(cfg, sg, blk.to(cuda_device))
    assert V.LAUNCHES > before
    _close(og.cpu().numpy(), oc.numpy(), 2e-5)
