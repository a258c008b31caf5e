"""The port's precision API and the fault it repairs, on the CPU.

``set_fast_math`` / ``exact_precision`` keep the JAX package's semantics
(the cases of ``tests/test_fft.py``'s turbo and string-mode tests); the
port's transforms are true float32 in every mode. Every float32 product of
the port goes through ``exact_matmul``: under
``torch.set_float32_matmul_precision("medium")`` (bf16 products on the
CPU) and ``"high"``, ``convolve`` and ``convolve_direct`` stay within 5e-5
of float64 scipy (they were 2.02e-03 and 1.93e-03 before), each product
site stays at float32 accuracy, and the caller's setting is the same after
the call, also while the engine runs in a pipeline's worker thread. A
``cuda`` twin holds the same with TF32 on."""

import shutil
import threading

import numpy as np
import pytest
import torch
from scipy import signal as sps

import opencl_fft_tpu_torch as T
from opencl_fft_tpu_torch.ops import fft as F
from opencl_fft_tpu_torch.ops.cuda import dstream as DS
from opencl_fft_tpu_torch.ops.cuda import streamstep as SS
from opencl_fft_tpu_torch.ops.cuda import vmemfft as V
from opencl_fft_tpu_torch.ops import dconv as D
from opencl_fft_tpu_torch.ops import pconv as P
from opencl_fft_tpu_torch.utils.numerics import exact_matmul

TOL = 5e-5
RNG = np.random.default_rng(48000)


@pytest.fixture
def matmul_mode():
    """Set torch's process-wide float32 matmul precision for one test; the
    test's start and end setting is restored after it."""
    before = torch.get_float32_matmul_precision()

    def use(mode):
        torch.set_float32_matmul_precision(mode)
        return mode
    yield use
    torch.set_float32_matmul_precision(before)


def _rel(got, ref):
    got, ref = np.asarray(got).astype(np.complex128), np.asarray(ref).astype(np.complex128)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _signals():
    x = RNG.standard_normal(48000).astype(np.float32)
    h = RNG.standard_normal(4096).astype(np.float32)
    return x, h


def test_turbo_mode_policy():
    """"turbo" is recorded and exact_precision overrides it inside its
    scope (thread-local); the FFT stays float32-exact in every mode; the
    policy restores cleanly."""
    T.set_fast_math("turbo")
    try:
        assert F._fast_mode() == "turbo"
        with T.exact_precision():
            assert F._fast_mode() == "off"
            seen = []
            t = threading.Thread(target=lambda: seen.append(F._fast_mode()))
            t.start(); t.join()
            assert seen == ["turbo"]              # another thread keeps its policy
        assert F._fast_mode() == "turbo"
        x = RNG.standard_normal((2, 4096)).astype(np.float32)
        r, i = F.fft_split((torch.from_numpy(x), torch.zeros(2, 4096)), -1)
        ref = np.fft.fft(x.astype(np.float64))
        assert _rel(r.numpy() + 1j * i.numpy(), ref) < 1e-5
    finally:
        T.set_fast_math(None)
    assert F._fast_mode() == "auto"


def test_set_fast_math_string_modes_are_validated():
    try:
        for arg, mode in (("off", "off"), ("on", "on"), ("auto", "auto"), ("TURBO", "turbo"),
                          (True, "on"), (False, "off"), (None, "auto"), ("Off", "off")):
            T.set_fast_math(arg)
            assert F._fast_mode() == mode
        with pytest.raises(ValueError, match="unknown mode"):
            T.set_fast_math("fastest")
        assert F._fast_mode() == "off"            # a refused mode changes nothing
    finally:
        T.set_fast_math(None)


@pytest.mark.parametrize("mode", ["turbo", "on", "off", "auto"])
def test_every_mode_is_true_float32(mode):
    """On the port every mode gives the same bits: no transform runs on a
    reduced-precision product."""
    x = RNG.standard_normal((3, 2048)).astype(np.float32)
    planes = (torch.from_numpy(x), torch.zeros(3, 2048))
    base = F.fft_split(planes, -1)
    T.set_fast_math(mode)
    try:
        got = F.fft_split(planes, -1)
    finally:
        T.set_fast_math(None)
    assert all(torch.equal(a, b) for a, b in zip(got, base))


def test_exact_matmul_is_the_rounded_float64_product(matmul_mode):
    a = torch.from_numpy(RNG.standard_normal((37, 300)).astype(np.float32))
    b = torch.from_numpy(RNG.standard_normal((300, 65)).astype(np.float32))
    want = (a.double() @ b.double()).float()
    for mode in ("highest", "high", "medium"):
        matmul_mode(mode)
        got = exact_matmul(a, b)
        assert got.dtype == torch.float32 and torch.equal(got, want)
        assert torch.get_float32_matmul_precision() == mode
    d = exact_matmul(a.double(), b.double())
    assert d.dtype == torch.float64
    assert torch.equal(exact_matmul(a[0], b), want[0])


@pytest.mark.parametrize("pts", [128, 512])
def test_float64_tables_are_built_once_and_give_the_same_bits(matmul_mode, pts):
    """The constant tables' float64 copies are the exact widenings of the
    float32 tables, cached a device, so a product against one equals the
    product against the float32 table widened a call, bit for bit."""
    from opencl_fft_tpu_torch.ops.cuda.tables import fwd_table, post_table

    matmul_mode("medium")
    cpu = torch.device("cpu")
    for table in (fwd_table, post_table):
        t32, t64 = table(pts, cpu), table(pts, cpu, torch.float64)
        assert t64.dtype == torch.float64 and torch.equal(t64, t32.double())
        assert table(pts, cpu, torch.float64) is t64
        a = torch.from_numpy(RNG.standard_normal((9, t32.shape[0])).astype(np.float32))
        assert torch.equal(exact_matmul(a, t64), exact_matmul(a, t32))
    stack = V._dft_stack(32, -1, cpu)
    assert stack.dtype == torch.float64 and V._dft_stack(32, -1, cpu) is stack


@pytest.mark.parametrize("mode", ["medium", "high"])
def test_convolve_and_convolve_direct_under_reduced_precision(matmul_mode, mode):
    """The fault's reproduction: 48,000 samples with a 4,096-tap IR at pts
    512, and the direct engine with 512 taps, against float64 scipy."""
    matmul_mode(mode)
    x, h = _signals()
    y = T.convolve(torch.from_numpy(x), torch.from_numpy(h), 512).numpy()
    assert _rel(y, sps.fftconvolve(x.astype(np.float64), h.astype(np.float64))) <= TOL
    yd = T.convolve_direct(torch.from_numpy(x), torch.from_numpy(h[:512])).numpy()
    assert _rel(yd, sps.fftconvolve(x.astype(np.float64), h[:512].astype(np.float64))) <= TOL
    assert torch.get_float32_matmul_precision() == mode


def test_each_product_site_is_full_f32(matmul_mode):
    """Every product site under "medium", against its float64 value at
    float32 accuracy (2e-6 of the scale; bf16 products miss by ~1e-3):
    the forward partition, the direct step, the JAX kernels' table oracles,
    the FFT twin's DFT products and the Toeplitz twin."""
    matmul_mode("medium")
    cfg = P.PconvConfig.for_ir_length(512 * 4, 512)
    blk = torch.from_numpy(RNG.standard_normal((3, 512)).astype(np.float32))
    fr, fi = P._forward_partition(cfg, blk)
    cfg64 = P.PconvConfig.for_ir_length(512 * 4, 512, dtype="f64")
    r64, i64 = P._forward_partition(cfg64, blk.double())     # the float64 chain
    assert _rel(fr.numpy() + 1j * fi.numpy(), r64.numpy() + 1j * i64.numpy()) <= 2e-6
    fwd = SS._dense_frames(blk[:, None], 512)
    assert _rel(fwd[0][0].numpy(), fr.numpy()) <= 2e-6
    dcfg = D.DconvConfig(irsize=300, vsize=64)
    k = torch.from_numpy(RNG.standard_normal(300).astype(np.float32))
    st = D.push_ir(dcfg, D.dconv_init(dcfg, "cpu"), k)
    xs = RNG.standard_normal((3, 64)).astype(np.float32)
    outs = []
    for b in xs:
        st, o = D.dconv_step(dcfg, st, torch.from_numpy(b))
        outs.append(o.numpy())
    want = np.convolve(xs.reshape(-1).astype(np.float64), k.double().numpy())[:192]
    assert _rel(np.concatenate(outs), want) <= 2e-6
    z = RNG.standard_normal((4, 1 << 12)).astype(np.float32)
    yr, yi = V.fft_vmem_plain((torch.from_numpy(z), torch.zeros(4, 1 << 12)), -1)
    assert _rel(yr.numpy() + 1j * yi.numpy(), np.fft.fft(z.astype(np.float64))) <= 2e-6
    p = DS.context_blocks(96, 32)
    seq = torch.from_numpy(RNG.standard_normal((p + 8, 32)).astype(np.float32))
    ir = torch.from_numpy(RNG.standard_normal(96).astype(np.float32))
    got = DS.dstream_steps(seq, ir, 32, 1).reshape(-1).numpy()
    c = p * 32 - 96 + 1
    want = np.convolve(seq.double().reshape(-1).numpy(), ir.double().numpy(),
                       "valid")[c:c + 8 * 32]
    assert _rel(got, want) <= 2e-6
    assert torch.get_float32_matmul_precision() == "medium"


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ on PATH")
def test_engine_in_a_worker_thread_while_the_caller_holds_medium(matmul_mode):
    """The pipeline's worker runs the engine while the main thread holds
    "medium" and runs its own (reduced-precision) products: the engine's
    output is within 5e-5 of float64 scipy, and the main thread's setting
    and its products are untouched (exact_matmul sets no global flag)."""
    from opencl_fft_tpu_torch.runtime.pipeline import RealtimePipeline

    matmul_mode("medium")
    pts, nblocks = 512, 24
    cfg = P.PconvConfig.for_ir_length(4096, pts)
    h = RNG.standard_normal(cfg.cvs).astype(np.float32)
    x = RNG.standard_normal(nblocks * pts).astype(np.float32)
    a = torch.from_numpy(RNG.standard_normal((256, 256)).astype(np.float32))
    main_errs = []
    with RealtimePipeline(cfg, ir=h, prime_blocks=1, device="cpu") as pipe:
        pipe.push(x)
        while pipe.blocks_processed < nblocks:
            main = (a @ a).double()                    # the caller's own product
            main_errs.append(float((main - a.double() @ a.double()).abs().max()))
            assert torch.get_float32_matmul_precision() == "medium"
            pipe._check_error()
        pipe.wait_for_blocks(nblocks, timeout=120)
        got = pipe.pull((1 + nblocks) * pts)[pts:]
    ref = sps.fftconvolve(x.astype(np.float64), h.astype(np.float64))[:got.size]
    assert _rel(got, ref) <= TOL
    assert torch.get_float32_matmul_precision() == "medium"
    assert max(main_errs) > 1e-3        # the caller's own products stayed reduced


@pytest.mark.cuda
def test_convolve_with_tf32_on_the_card():
    """On a card with TF32 on (allow_tf32 and "high"): convolve (pts 512,
    4096 taps) and convolve_direct (512 taps) within 5e-5 of float64 scipy;
    the caller's settings unchanged; then TF32 off again."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    before = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        x, h = _signals()
        xd, hd = torch.from_numpy(x).cuda(), torch.from_numpy(h).cuda()
        y = T.convolve(xd, hd, 512).cpu().numpy()
        assert _rel(y, sps.fftconvolve(x.astype(np.float64), h.astype(np.float64))) <= TOL
        yd = T.convolve_direct(xd, hd[:512]).cpu().numpy()
        assert _rel(yd, sps.fftconvolve(x.astype(np.float64),
                                        h[:512].astype(np.float64))) <= TOL
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision(before[1])
        torch.backends.cuda.matmul.allow_tf32 = before[0]
