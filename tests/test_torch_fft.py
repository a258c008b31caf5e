"""Port parity: split-complex and packed real FFTs of opencl_fft_tpu_torch
against the JAX package on the same inputs (atol 1e-5 * max|ref|)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_fft_tpu.ops import cplx as jcplx
from opencl_fft_tpu.ops import fft as jfft
from opencl_fft_tpu.ops import rfft as jrfft
from opencl_fft_tpu_torch.ops import cplx as tcplx
from opencl_fft_tpu_torch.ops import fft as tfft
from opencl_fft_tpu_torch.ops import rfft as trfft

torch.set_num_threads(1)

SIZES = [8, 64, 1024]


def _pair(rng, shape):
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(2))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, ref):
    got = [np.asarray(g) for g in got]
    ref = [np.asarray(r) for r in ref]
    scale = max(np.abs(r).max() for r in ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, atol=1e-5 * scale, rtol=0)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("sign", [-1, 1])
def test_fft_split_matches_jax(n, sign):
    x = _pair(np.random.default_rng(n + sign), (3, n))
    ref = jfft.fft_split(tuple(map(jnp.asarray, x)), sign)
    got = tfft.fft_split(tuple(map(_t, x)), sign)
    _close(got, ref)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("forward", [True, False])
def test_cfft_split_matches_jax(n, forward):
    x = _pair(np.random.default_rng(2 * n + forward), (2, n))
    ref = jfft.cfft_split(tuple(map(jnp.asarray, x)), forward)
    got = tfft.cfft_split(tuple(map(_t, x)), forward)
    _close(got, ref)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("unnormalized", [False, True])
def test_rfft_split_matches_jax(n, unnormalized):
    r = np.random.default_rng(3 * n).standard_normal((2, n)).astype(np.float32)
    ref = jrfft.rfft_split(jnp.asarray(r), unnormalized=unnormalized)
    got = trfft.rfft_split(_t(r), unnormalized=unnormalized)
    _close(got, ref)


@pytest.mark.parametrize("n", SIZES)
def test_irfft_split_matches_jax(n):
    c = _pair(np.random.default_rng(5 * n), (2, n // 2))
    ref = jrfft.irfft_split(tuple(map(jnp.asarray, c)))
    got = trfft.irfft_split(tuple(map(_t, c)))
    _close([got], [ref])


@pytest.mark.parametrize("m", SIZES)
@pytest.mark.parametrize("which", ["pack_forward", "unpack_inverse"])
def test_pack_unpack_match_jax(m, which):
    c = _pair(np.random.default_rng(7 * m), (2, m))
    ref = getattr(jrfft, which)(tuple(map(jnp.asarray, c)))
    got = getattr(trfft, which)(tuple(map(_t, c)))
    _close(got, ref)


def test_rfft_roundtrip_and_interleave():
    r = np.random.default_rng(11).standard_normal((4, 256)).astype(np.float32)
    back = trfft.irfft_split(trfft.rfft_split(_t(r))).numpy()
    np.testing.assert_allclose(back, r, atol=1e-5 * np.abs(r).max(), rtol=0)
    z = trfft.deinterleave(_t(r))
    np.testing.assert_array_equal(trfft.interleave(z).numpy(), r)


def test_fft_split_validation():
    x = (torch.zeros(8), torch.zeros(8))
    with pytest.raises(ValueError, match="unknown impl"):
        tfft.fft_split(x, -1, impl="mm")
    with pytest.raises(ValueError, match="sign"):
        tfft.fft_split(x, 0)
    with pytest.raises(ValueError, match="shapes differ"):
        tfft.fft_split((torch.zeros(8), torch.zeros(4)), -1)
    with pytest.raises(ValueError, match="empty"):
        tfft.fft_split((torch.zeros(0), torch.zeros(0)), -1)
    with pytest.raises(ValueError, match="power-of-two"):
        tfft.fft_split((torch.zeros(12), torch.zeros(12)), -1, impl="vmem")
    with pytest.raises(ValueError, match="unsupported size"):
        tfft.fft_split(x, -1, impl="vmem")
    with pytest.raises(ValueError, match="float32-only"):
        tfft.fft_split((torch.zeros(1024, dtype=torch.float64),) * 2, -1, impl="vmem")
    twelve = tfft.fft_split((torch.ones(12), torch.zeros(12)), -1)
    np.testing.assert_allclose(twelve[0].numpy(), np.fft.fft(np.ones(12)).real, atol=1e-5)
    with pytest.raises(ValueError, match="multiple of 4"):
        trfft.rfft_split(torch.zeros(6))
    one = tfft.fft_split((torch.ones(1), torch.zeros(1)), -1, scale=0.5)
    assert one[0].item() == 0.5


@pytest.mark.parametrize("op", ["cmul", "cadd", "csub"])
def test_split_binary_helpers_match_jax(op):
    rng = np.random.default_rng(17)
    a, b = _pair(rng, (5,)), _pair(rng, (5,))
    ref = getattr(jcplx, op)(tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b)))
    got = getattr(tcplx, op)(tuple(map(_t, a)), tuple(map(_t, b)))
    _close(got, ref)


def test_split_unary_helpers_match_jax():
    a = _pair(np.random.default_rng(19), (6,))
    ja, ta = tuple(map(jnp.asarray, a)), tuple(map(_t, a))
    _close(tcplx.conj(ta), jcplx.conj(ja))
    _close(tcplx.rot(ta), jcplx.rot(ja))
    _close(tcplx.cscale(ta, 0.25), jcplx.cscale(ja, 0.25))
    z = a[0] + 1j * a[1]
    _close(tcplx.from_complex(torch.from_numpy(z.astype(np.complex64))),
           jcplx.from_complex(jnp.asarray(z, jnp.complex64)))
    back = tcplx.to_complex(ta)
    assert back.dtype == torch.complex64
    np.testing.assert_array_equal(back.numpy(), z.astype(np.complex64))
    re, im = tcplx.from_complex(_t(a[0].astype(np.float64)))
    assert re.dtype == torch.float64 and not im.any()


def test_fft_split_keeps_float64():
    x = _pair(np.random.default_rng(13), (16,))
    got = tfft.fft_split(tuple(_t(a.astype(np.float64)) for a in x), -1)
    assert got[0].dtype == torch.float64
    ref = np.fft.fft(x[0].astype(np.float64) + 1j * x[1])
    np.testing.assert_allclose(got[0].numpy() + 1j * got[1].numpy(), ref,
                               atol=1e-12 * np.abs(ref).max(), rtol=0)
