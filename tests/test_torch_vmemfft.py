"""Port parity: the batched FFT kernels' wrappers and plain twins of
opencl_fft_tpu_torch (``ops/cuda/vmemfft.py``) against the JAX package's
Pallas ``fft_vmem`` / ``fft_vmem_front2`` in interpret mode (atol 1e-4 *
max|ref|, the JAX tests' bf16x3 budget) and against float64 numpy (1e-5 *
max|ref|); their float64-built tables against the JAX builders; and, on a
card, each CUDA kernel against its twin (2e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_fft_tpu.ops import fft as jfft
from opencl_fft_tpu.ops.pallas import vmemfft as jvmem
from opencl_fft_tpu_torch.ops import fft as tfft
from opencl_fft_tpu_torch.ops.cuda import vmemfft as V

torch.set_num_threads(1)


def _planes(rng, shape):
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(2))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, ref, tol):
    got = np.asarray(got[0], np.float64) + 1j * np.asarray(got[1], np.float64)
    ref = np.asarray(ref[0], np.float64) + 1j * np.asarray(ref[1], np.float64) \
        if isinstance(ref, tuple) else np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=tol * np.abs(ref).max(), rtol=0)


def _numpy_dft(x, sign, scale):
    z = x[0].astype(np.float64) + 1j * x[1].astype(np.float64)
    n = z.shape[-1]
    return scale * (np.fft.fft(z) if sign == -1 else np.fft.ifft(z) * n)


@pytest.mark.parametrize("n", [1 << 13, 1 << 14, 1 << 15])
@pytest.mark.parametrize("sign", [-1, 1])
def test_fft_vmem_matches_jax(n, sign):
    """The wrapper (its twin on the CPU) and the twin called directly
    against the Pallas kernel in interpret mode; 2^14 is the single pass's
    largest size, 2^15 takes the two-pass factorization (256 x 128)."""
    x = _planes(np.random.default_rng(n + sign), (2, n))
    scale = 1.0 / np.sqrt(n)
    ref = jvmem.fft_vmem(tuple(map(jnp.asarray, x)), sign, interpret=True, scale=scale)
    before = (V.LAUNCHES, V.FRONT2_LAUNCHES)
    _close(V.fft_vmem(tuple(map(_t, x)), sign, scale), ref, 1e-4)
    _close(V.fft_vmem_plain(tuple(map(_t, x)), sign, scale), ref, 1e-4)
    assert (V.LAUNCHES, V.FRONT2_LAUNCHES) == before       # no kernel on the CPU


@pytest.mark.parametrize("sign", [-1, 1])
def test_fft_vmem_front2_matches_jax_plan_override(sign):
    """JAX's plan (16, 8, 256) runs two 16- and 8-point levels in the kernel
    and a 256-point leaf: the port's (128, 256) split."""
    n = 1 << 15
    x = _planes(np.random.default_rng(40 + sign), (2, n))
    ref = jvmem.fft_vmem_front2(tuple(map(jnp.asarray, x)), sign, interpret=True,
                                scale=0.5, plan_override=(16, 8, 256))
    _close(V.fft_vmem_front2(tuple(map(_t, x)), sign, 0.5, split=(128, 256)), ref, 1e-4)
    _close(V.fft_vmem_front2_plain(tuple(map(_t, x)), sign, 0.5, split=(128, 256)),
           ref, 1e-4)


@pytest.mark.parametrize("n,split", [(1 << 13, (64, 128)), (1 << 17, (512, 256)),
                                     (1 << 18, None)])
@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("twin", ["fft_vmem", "fft_vmem_front2"])
def test_twins_match_numpy(n, split, sign, twin):
    x = _planes(np.random.default_rng(n + 3 * sign), (1, n))
    ref = _numpy_dft(x, sign, 0.25)
    if twin == "fft_vmem":
        got = V.fft_vmem_plain(tuple(map(_t, x)), sign, 0.25)
    else:
        got = V.fft_vmem_front2_plain(tuple(map(_t, x)), sign, 0.25, split)
    _close(got, ref, 1e-5)


def test_leading_axes_and_strided_input():
    """Leading axes are flattened to rows and restored; a strided view (as
    rfft's unpack hands over) is read as its values."""
    rng = np.random.default_rng(5)
    n = 1 << 10
    big = _planes(rng, (2, 3, 2 * n))
    x = tuple(_t(p)[..., ::2] for p in big)
    assert not x[0].is_contiguous()
    got = V.fft_vmem(x, -1)
    assert got[0].shape == (2, 3, n)
    _close(got, _numpy_dft(tuple(p[..., ::2] for p in big), -1, 1.0), 1e-5)


def test_supported_matches_jax():
    for k in range(1, 23):
        for n in (1 << k, (1 << k) + 1, 3 << k):
            assert V.supported(n) == jvmem.supported(n), n
    assert [k for k in range(1, 23) if V.supported(1 << k)] == list(range(10, 21))


@pytest.mark.parametrize("n1,n2", [(16, 8), (128, 256), (256, 128), (1024, 256), (64, 64)])
@pytest.mark.parametrize("sign", [-1, 1])
def test_four_step_twiddle_bit_identical_to_jax(n1, n2, sign):
    tr, ti = V.four_step_twiddle_np(n1, n2, sign)
    jr, ji = jvmem._twiddle_np(n1, n2, sign)
    assert tr.dtype == np.float32 and tr.shape == (n1, n2)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(ti, ji)


@pytest.mark.parametrize("n", [2, 4, 256, 8192])
@pytest.mark.parametrize("sign", [-1, 1])
def test_stage_twiddle_bit_identical_to_jax(n, sign):
    """W_n^k for k < n/2 is row 1 of JAX's (2, n/2) level table; the whole
    table is the float64 value rounded once."""
    tr, ti = V.stage_twiddle_np(n, sign)
    jr, ji = jvmem._twiddle_np(2, n // 2, sign)
    np.testing.assert_array_equal(tr[: n // 2], jr[1])
    np.testing.assert_array_equal(ti[: n // 2], ji[1])
    w = np.exp(sign * 2j * np.pi * np.arange(n) / n)
    np.testing.assert_array_equal(tr, w.real.astype(np.float32))
    np.testing.assert_array_equal(ti, w.imag.astype(np.float32))


@pytest.mark.parametrize("n", [2, 8, 64])
@pytest.mark.parametrize("sign", [-1, 1])
def test_dft_matrix_matches_jax_leaf(n, sign):
    """The twins' DFT matrices against JAX's leaf matrix: the same values,
    except that reducing jk mod n in integers removes JAX's float64
    large-angle error (at most 4e-14 here) where the entry is 0."""
    wr, wi = V.dft_matrix_np(n, sign)
    m = jfft._leaf_matrix_np(n, sign)
    np.testing.assert_allclose(wr, m[:n, :n], atol=1e-13, rtol=0)
    np.testing.assert_allclose(wi, m[:n, n:], atol=1e-13, rtol=0)
    assert np.array_equal(wr[1], m[1, :n]) and np.array_equal(wi[1], m[1, n:])


@pytest.mark.parametrize("n", [3, 12, 100, 1000])
@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("npdt", [np.float32, np.float64])
def test_bluestein_tables_bit_identical_to_jax(n, sign, npdt):
    c, b, m = tfft._bluestein_tables_np(n, sign, npdt)
    jc, jb, jm = jfft._bluestein_tables_np(n, sign, npdt)
    assert m == jm and c.dtype == jc.dtype
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(b, jb)


def test_splits_and_validation():
    assert V.route(1 << 13) == ("rows", 1, 1 << 13)
    assert V.route(1 << 14) == ("rows", 1, 1 << 14)
    assert V.route(1 << 15) == ("two_pass", 256, 128)
    assert V.route(1 << 20) == ("two_pass", 1024, 1024)
    assert [V.route(n) for n in V.FRONT2_SIZES] == [("two_pass", 256, 1024),
                                                   ("two_pass", 1024, 512),
                                                   ("two_pass", 1024, 1024)]
    assert V.route(1 << 15, (128, 256)) == ("two_pass", 128, 256)
    for n, split in ((1 << 15, (64, 256)), (1 << 15, (1, 1 << 15)), (1 << 9, (16, 32)),
                     (1 << 15, (96, 341))):
        with pytest.raises(ValueError, match="fft_vmem_front2|unsupported size"):
            V.route(n, split)
    z = torch.zeros
    with pytest.raises(ValueError, match="unsupported size"):
        V.fft_vmem((z(4, 512), z(4, 512)), -1)
    with pytest.raises(ValueError, match="sign"):
        V.fft_vmem((z(1024), z(1024)), 0)
    with pytest.raises(ValueError, match="one shape"):
        V.fft_vmem((z(1024), z(2, 1024)), -1)
    with pytest.raises(ValueError, match="no rows"):
        V.fft_vmem((z(0, 1024), z(0, 1024)), -1)
    with pytest.raises(ValueError, match="no default split"):
        V.fft_vmem_front2((z(1 << 14), z(1 << 14)), 1)
    with pytest.raises(ValueError, match="sign"):
        V.fft_vmem_plain((z(1024), z(1024)), 2)


@pytest.mark.parametrize("k", range(10, 21))
def test_route_by_size(k):
    """One pass up to 2^14, two passes above, at 256 x n / 256 up to 2^18
    and 1024 x n / 1024 above; an explicit split always takes two passes.
    The route names its kernels."""
    n = 1 << k
    r = V.route(n)
    assert r.n1 * r.n2 == n and str(r).startswith(
        {"rows": "fft_rows_pipe_kernel",
         "two_pass": "fft_front_kernel + fft_rows_kernel"}[r.kind])
    if k <= 14:
        assert r == ("rows", 1, n)
    else:
        assert r == ("two_pass", 256 if k <= 18 else 1024, n // (256 if k <= 18 else 1024))
    split = (1 << (k // 2), 1 << (k - k // 2))
    assert V.route(n, split) == ("two_pass", *split)


def test_single_pass_and_leaf_reach():
    """The single pass reaches 2^14; a two-pass factor (the leaf's and the
    front's tile) stays at most 2^13, so a split with a 2^14 factor
    raises."""
    assert (V.SINGLE_PASS_MAX, V.LEAF_PASS_MAX) == (1 << 14, 1 << 13)
    assert V.route(V.SINGLE_PASS_MAX).kind == "rows"
    assert V.route(2 * V.SINGLE_PASS_MAX).kind == "two_pass"
    for n, split in (((1 << 15), (1 << 14, 2)), ((1 << 15), (2, 1 << 14)),
                     ((1 << 20), (64, 1 << 14)), ((1 << 14), (1, 1 << 14))):
        with pytest.raises(ValueError, match=f"powers of two in \\[2, {1 << 13}\\]"):
            V.route(n, split)
    assert V.route(1 << 14, (2, 1 << 13)) == ("two_pass", 2, 1 << 13)
    for n in V.FRONT2_SIZES + (1 << 15,):
        assert max(V.two_pass_split(n)) <= V.LEAF_PASS_MAX


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("sign", [-1, 1])
def test_single_pass_reach_twin_matches_numpy(rows, sign):
    """fft_vmem at 2^14, the single pass's largest size, through its twin
    (the wrapper on the CPU) against float64 numpy."""
    n = 1 << 14
    x = _planes(np.random.default_rng(rows + 7 * (sign + 2)), (rows, n))
    ref = _numpy_dft(x, sign, 0.5)
    _close(V.fft_vmem(tuple(map(_t, x)), sign, 0.5), ref, 1e-5)
    _close(V.fft_vmem_plain(tuple(map(_t, x)), sign, 0.5), ref, 1e-5)


@pytest.mark.parametrize("n,sign", [(1 << 16, -1), (1 << 17, 1), (1 << 18, -1), (1 << 18, 1)])
def test_default_route_twins_match_numpy(n, sign):
    """The twins at the two-pass route's factorization (256 x 256, 256 x
    512, 256 x 1024) against float64 numpy, 2 rows; the wrapper on the CPU."""
    x = _planes(np.random.default_rng(n - sign), (2, n))
    ref = _numpy_dft(x, sign, 0.5)
    _close(V.fft_vmem_plain(tuple(map(_t, x)), sign, 0.5), ref, 1e-5)
    _close(V.fft_vmem(tuple(map(_t, x)), sign, 0.5), ref, 1e-5)
    if n in V.FRONT2_SIZES:
        _close(V.fft_vmem_front2_plain(tuple(map(_t, x)), sign, 0.5), ref, 1e-5)


@pytest.mark.parametrize("n", [2, 16, 32, 512, 1024, 8192, 16384])
@pytest.mark.parametrize("sign", [-1, 1])
def test_pass_twiddle_table(n, sign):
    """Each Stockham pass after the first has its block of W_n^(r k), r <
    R, k = (j mod ns) n / (ns R), at (r - 1) ns + j mod ns: entries of the
    stage table, which is bit-identical to JAX's."""
    t = V.pass_twiddle_np(n, sign)
    wr, wi = V.stage_twiddle_np(n, sign)
    log_n, ns, off = n.bit_length() - 1, 1, 0
    for p in range((log_n + 3) // 4):
        radix = 1 << min(4, log_n - 4 * p)
        if ns > 1:
            for r in (1, radix - 1):
                for jm in (0, ns - 1):
                    e = jm * (n // (ns * radix)) * r
                    assert tuple(t[off + (r - 1) * ns + jm]) == (wr[e], wi[e])
            off += (radix - 1) * ns
        ns *= radix
    assert t.shape == (off, 2) and t.dtype == np.float32


@pytest.mark.parametrize("n1,n2", [(2, 8192), (16, 16384), (512, 2048), (512, 1024), (8, 2)])
@pytest.mark.parametrize("sign", [-1, 1])
def test_four_step_tables_compose_the_twiddle(n1, n2, sign):
    """A[k1, j2 mod 2^a] * B[k1, j2 >> a] is W_n^(k1 j2) to two float32
    roundings, and W_n^(k1 j) * S[k1, r] is W_n^(k1 (j + r n2 / R)); the
    tables hold (n1, 2^a + n2 / 2^a + 16) entries, not n."""
    ta, tb, ts = V.four_step_tables_np(n1, n2, sign)
    a = V.four_step_log_a(n2)
    assert ta.shape == (n1, 1 << a, 2) and tb.shape == (n1, n2 >> a, 2)
    ca, cb = ta[..., 0] + 1j * ta[..., 1], tb[..., 0] + 1j * tb[..., 1]
    k1, j2 = np.arange(n1)[:, None], np.arange(n2)[None, :]
    w = ca[k1, j2 & ((1 << a) - 1)] * cb[k1, j2 >> a]
    tr, ti = V.four_step_twiddle_np(n1, n2, sign)
    np.testing.assert_allclose(w, tr + 1j * ti, atol=3e-7, rtol=0)
    radix = min(16, n2)
    cs = ts[..., 0] + 1j * ts[..., 1]
    assert ts.shape == (n1, 16, 2)
    j = np.arange(n2 // radix)[None, :, None]
    r = np.arange(radix)[None, None, :]
    k = np.arange(n1)[:, None, None]
    np.testing.assert_allclose((ca[k, j & ((1 << a) - 1)] * cb[k, j >> a]) * cs[k, r],
                               (tr + 1j * ti)[k, j + r * (n2 // radix)], atol=5e-7, rtol=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the FFT kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,rows", [(1 << 10, 33), (1 << 13, 5), (1 << 15, 3), (1 << 17, 2),
                                    (1 << 19, 1), (1 << 20, 2)])
@pytest.mark.parametrize("sign", [-1, 1])
def test_cuda_fft_vmem_matches_twin(cuda_device, n, rows, sign):
    x = tuple(_t(p).to(cuda_device) for p in _planes(np.random.default_rng(n), (rows, n)))
    before = V.LAUNCHES + V.FRONT2_LAUNCHES
    got = V.fft_vmem(x, sign, 0.5)
    torch.cuda.synchronize()
    assert V.LAUNCHES + V.FRONT2_LAUNCHES == before + 1
    want = V.fft_vmem_plain(x, sign, 0.5)
    _close(tuple(g.cpu() for g in got), tuple(w.cpu() for w in want), 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n,split", [(1 << 15, (128, 256)), (1 << 18, None), (1 << 19, None),
                                     (1 << 20, None), (1 << 14, (8192, 2))])
def test_cuda_fft_vmem_front2_matches_twin(cuda_device, n, split):
    x = tuple(_t(p).to(cuda_device) for p in _planes(np.random.default_rng(n + 1), (3, n)))
    before = V.FRONT2_LAUNCHES
    got = V.fft_vmem_front2(x, 1, 1.0, split)
    torch.cuda.synchronize()
    assert V.FRONT2_LAUNCHES == before + 1
    _close(tuple(g.cpu() for g in got),
           tuple(w.cpu() for w in V.fft_vmem_front2_plain(x, 1, 1.0, split)), 2e-5)
    with pytest.raises(ValueError, match="float32"):
        V.fft_vmem_front2(tuple(p.double() for p in x), 1, 1.0, split)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1 << 10, 1 << 11, 1 << 12, 1 << 13, 1 << 14])
@pytest.mark.parametrize("rows", [1, 2, 7, 33, 257])
@pytest.mark.parametrize("sign", [-1, 1])
def test_cuda_single_pass_matches_twin(cuda_device, n, rows, sign):
    """The pipelined single pass (persistent CTAs, bulk copies into two
    stages; one stage at 2^14) against its twin (1e-6 of max|twin|) and
    float64 numpy, at one row, at row counts that leave the last tile
    short and at more tiles than CTAs; and on planes at an offset that is
    not 16-byte aligned, which the wrapper copies first."""
    rng = np.random.default_rng(n + rows + sign)
    x = tuple(_t(p).to(cuda_device) for p in _planes(rng, (rows, n)))
    assert V.route(n).kind == "rows"
    before = (V.LAUNCHES, V.FRONT2_LAUNCHES)
    got = V.fft_vmem(x, sign, 0.5)
    torch.cuda.synchronize()
    assert (V.LAUNCHES, V.FRONT2_LAUNCHES) == (before[0] + 1, before[1])
    want = tuple(w.cpu() for w in V.fft_vmem_plain(x, sign, 0.5))
    _close(tuple(g.cpu() for g in got), want, 1e-6)
    _close(tuple(g.cpu() for g in got), _numpy_dft(tuple(p.cpu().numpy() for p in x), sign, 0.5),
           5e-6)
    flat = tuple(torch.zeros(rows * n + 1, device=cuda_device) for _ in range(2))
    for f_, p in zip(flat, x):
        f_[1:] = p.reshape(-1)
    odd = tuple(f_[1:].view(rows, n) for f_ in flat)
    assert odd[0].is_contiguous() and odd[0].data_ptr() % 16 != 0
    _close(tuple(g.cpu() for g in V.fft_vmem(odd, sign, 0.5)),
           tuple(g.cpu() for g in got), 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1 << 15, 1 << 16, 1 << 17, 1 << 18])
@pytest.mark.parametrize("rows", [1, 3, 16])
@pytest.mark.parametrize("sign", [-1, 1])
def test_cuda_two_pass_route_matches_twin(cuda_device, n, rows, sign):
    """The default route above 2^14 (front pass, then the leaf with the
    twiddles) against its twin and float64 numpy."""
    x = tuple(_t(p).to(cuda_device) for p in _planes(np.random.default_rng(n + rows), (rows, n)))
    assert V.route(n).kind == "two_pass"
    before = (V.LAUNCHES, V.FRONT2_LAUNCHES)
    got = V.fft_vmem(x, sign, 0.5)
    torch.cuda.synchronize()
    assert (V.LAUNCHES, V.FRONT2_LAUNCHES) == (before[0], before[1] + 1)
    _close(tuple(g.cpu() for g in got), tuple(w.cpu() for w in V.fft_vmem_plain(x, sign, 0.5)),
           2e-5)
    _close(tuple(g.cpu() for g in got), _numpy_dft(tuple(p.cpu().numpy() for p in x), sign, 0.5),
           5e-5)
