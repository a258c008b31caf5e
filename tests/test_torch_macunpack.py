"""Port parity: the MAC-and-unpack kernel of opencl_fft_tpu_torch
(``ops/cuda/blockstep.py``: ``block_mac_unpack``) and the per-block route
above pts 2048 that runs it on a card (``ops/pconv._mac_unpack_inverse_ola``).

The twin is held against JAX's Pallas ``block_mac_unpack``
(``ops/pallas/blockstep.py:484``) in interpret mode at the JAX test's shapes
(``tests/test_pallas_kernels.py:60-83``), atol 1e-5 * max|JAX| (both sum the
partitions in float32 in other orders), and against a float64 numpy MAC and
unpack at shapes the TPU kernel does not take (nparts 1 and 3, bins 2, 16
and 96, a channel axis C = 3). The route is held against JAX's
``_mac_inverse_ola`` and the per-block functions (``pallas="off"``) at pts
4096 on states carried across packages, on both routes of the port (the
CPU's plain composition, and the card's composition with the twin, the
kernel branch taken for CPU tensors), at 1e-5 * max. The CUDA kernel is
held against the twin on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_fft_tpu.ops import pconv as J
from opencl_fft_tpu.ops.pallas import blockstep as JB
from opencl_fft_tpu_torch.interop import pconv_state_from_numpy, pconv_state_to_numpy
from opencl_fft_tpu_torch.ops import pconv as P
from opencl_fft_tpu_torch.ops.cuda import blockstep as B
from opencl_fft_tpu_torch.ops.cuda import mac as MAC
from opencl_fft_tpu_torch.ops.cuda.tables import unpack_twiddle
from opencl_fft_tpu_torch.ops.rfft import _half_twiddle_np, unpack_inverse

torch.set_num_threads(1)

TOL = 1e-5


def _close(got, ref, rel=TOL):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=rel * (np.abs(ref).max() + 1e-30), rtol=0)


def _ring(rng, nparts, bins, lead=()):
    """A doubled ring (both halves equal) and h planes, numpy float32."""
    def f(*shape, s=1.0):
        return (s * rng.standard_normal(shape)).astype(np.float32)

    ring = tuple(np.concatenate([a, a], -2) for a in (f(*lead, nparts, bins),
                                                      f(*lead, nparts, bins)))
    return ring, (f(*lead, nparts, bins, s=0.3), f(*lead, nparts, bins, s=0.3))


def _t(planes):
    return tuple(torch.from_numpy(np.ascontiguousarray(p)) for p in planes)


def _oracle(ring, h, rp, b0):
    """float64: the window MAC (bin 0 componentwise times b0), then the
    inverse unpack of ``rfft.unpack_inverse`` evaluated bin by bin."""
    xr, xi = (a.astype(np.float64) for a in ring)
    hr, hi = (a.astype(np.float64) for a in h)
    nparts, m = hr.shape[-2:]
    wr, wi = xr[..., rp:rp + nparts, :], xi[..., rp:rp + nparts, :]
    re = np.sum(wr * hr - wi * hi, axis=-2)
    im = np.sum(wr * hi + wi * hr, axis=-2)
    re[..., 0] = b0 * np.sum(wr[..., 0] * hr[..., 0], axis=-1)
    im[..., 0] = b0 * np.sum(wi[..., 0] * hi[..., 0], axis=-1)
    zr, zi = np.empty_like(re), np.empty_like(im)
    for k in range(m):
        j = (m - k) % m
        w = np.exp(1j * np.pi * k / m)
        er, ei = 0.5 * (re[..., k] + re[..., j]), 0.5 * (im[..., k] - im[..., j])
        o = -0.5 * (im[..., k] + im[..., j]) + 0.5j * (re[..., k] - re[..., j])
        zr[..., k], zi[..., k] = er + (w * o).real, ei + (w * o).imag
    zr[..., 0], zi[..., 0] = re[..., 0] + im[..., 0], re[..., 0] - im[..., 0]
    zr[..., m // 2], zi[..., m // 2] = re[..., m // 2], im[..., m // 2]
    return zr, zi


# ---------------------------------------------------------------------------
# the twin against the Pallas kernel and a float64 oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nparts,bins", [(8, 128), (16, 256), (32, 512)])
@pytest.mark.parametrize("rp", [0, 3, 7])
@pytest.mark.parametrize("b0", [1.0, 2.0])
def test_twin_matches_pallas_kernel(nparts, bins, rp, b0):
    ring, h = _ring(np.random.default_rng(nparts + rp), nparts, bins)
    jr, ji = JB.block_mac_unpack(tuple(map(jnp.asarray, ring)), tuple(map(jnp.asarray, h)),
                                 rp, b0, interpret=True)
    before = B.MAC_UNPACK_LAUNCHES
    zr, zi = B.block_mac_unpack(_t(ring), _t(h), rp, b0)
    assert B.MAC_UNPACK_LAUNCHES == before               # the CPU runs the twin
    _close(zr, jr)
    _close(zi, ji)


@pytest.mark.parametrize("nparts", [1, 3])
@pytest.mark.parametrize("bins", [2, 16, 96])
@pytest.mark.parametrize("lead", [(), (3,)])
@pytest.mark.parametrize("b0", [1.0, 2.0])
def test_twin_matches_float64_oracle(nparts, bins, lead, b0):
    """Shapes the TPU kernel does not take, every rp (the ring boundaries
    included), one channel or three; bins 2 has only the special bins 0
    and M/2."""
    ring, h = _ring(np.random.default_rng(nparts * bins + len(lead)), nparts, bins, lead)
    for rp in range(nparts):
        got = B.block_mac_unpack(_t(ring), _t(h), rp, b0)
        for g, r in zip(got, _oracle(ring, h, rp, b0)):
            assert g.shape == r.shape and g.is_contiguous()
            _close(g, r)


@pytest.mark.parametrize("lead", [(), (3,)])
def test_twin_mac_is_spectral_mac_plain(lead):
    """The twin is ``unpack_inverse`` of ``spectral_mac_plain``, bit for bit,
    and the kernel's twiddle table is ``unpack_inverse``'s and JAX's."""
    ring, h = _ring(np.random.default_rng(7), 5, 64, lead)
    got = B.block_mac_unpack_plain(_t(ring), _t(h), 2, 2.0)
    want = unpack_inverse(MAC.spectral_mac_plain(_t(ring), _t(h), 2, 2.0))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for bins in (2, 64, 4096):
        tr, ti = unpack_twiddle(bins, torch.device("cpu"))
        jr, ji = JB._unpack_twiddle_np(bins)
        assert np.array_equal(tr.numpy(), jr[0]) and np.array_equal(ti.numpy(), ji[0])
        assert all(np.array_equal(a.numpy(), b) for a, b in zip((tr, ti),
                                                                  _half_twiddle_np(bins, +1)))


def test_wrapper_validates_arguments():
    z = torch.zeros
    h = (z(4, 16), z(4, 16))
    with pytest.raises(ValueError, match="rp must be an int in \\[0, 4\\)"):
        B.block_mac_unpack((z(8, 16), z(8, 16)), h, 4, 1.0)
    with pytest.raises(ValueError, match="doubled-ring planes"):
        B.block_mac_unpack((z(4, 16), z(4, 16)), h, 0, 1.0)
    with pytest.raises(ValueError, match="bins must be >= 2"):
        B.block_mac_unpack((z(2, 1), z(2, 1)), (z(1, 1), z(1, 1)), 0, 1.0)
    meta = torch.zeros((8, 16), device="meta")
    with pytest.raises(ValueError, match="one device"):
        B.block_mac_unpack((meta, meta), h, 0, 1.0)


# ---------------------------------------------------------------------------
# the route at pts 4096 against JAX
# ---------------------------------------------------------------------------

PTS, NPARTS = 4096, 2


@pytest.fixture(params=["plain", "mac_unpack"])
def route(request, monkeypatch):
    """Each case on both routes of the per-block functions above pts 2048:
    the CPU's plain composition, and the card's (``block_mac_unpack``'s
    twin, the kernel branch taken for CPU tensors)."""
    if request.param == "mac_unpack":
        monkeypatch.setattr(P, "_mac_unpack_kernel", lambda cfg, device: True)
    return request.param


def _configs():
    return P.PconvConfig(pts=PTS, nparts=NPARTS), J.PconvConfig(pts=PTS, nparts=NPARTS,
                                                                 pallas="off")


def _live_jax_state(jcfg, rng, nblocks=3):
    """A JAX state with an IR pushed and a few blocks streamed."""
    ir = (0.2 * rng.standard_normal(jcfg.cvs)).astype(np.float32)
    js = J.push_ir(jcfg, J.pconv_init(jcfg), ir)
    for _ in range(nblocks):
        js, _ = J.pconv_step(jcfg, js, rng.standard_normal(PTS).astype(np.float32))
    return js


def _jax_fields(js):
    return {k: np.asarray(v) for k, v in js._asdict().items()}


def test_shape_rule():
    """On a card the per-block MAC goes through block_mac_unpack exactly
    where the block-step kernels stop (pts > 2048); never on the CPU."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert P._mac_unpack_kernel(P.PconvConfig(pts=4096, nparts=2), cuda)
    assert not P._mac_unpack_kernel(P.PconvConfig(pts=2048, nparts=2), cuda)
    assert not P._mac_unpack_kernel(P.PconvConfig(pts=4096, nparts=2), cpu)
    for pts in (1024, 2048, 4096, 8192):
        cfg = P.PconvConfig(pts=pts, nparts=2)
        assert P._block_kernels(cfg, cuda) != P._mac_unpack_kernel(cfg, cuda)
    cfg = P.PconvConfig(pts=PTS, nparts=NPARTS)
    before = B.MAC_UNPACK_LAUNCHES
    P.pconv_step(cfg, P.pconv_init(cfg, "cpu"), torch.ones(PTS))
    assert B.MAC_UNPACK_LAUNCHES == before


def test_mac_unpack_inverse_ola_matches_jax():
    """The card's MAC + inverse + OLA (``_mac_unpack_inverse_ola``, the twin
    on CPU tensors) on a state carried over from JAX, against JAX's
    ``_mac_inverse_ola`` at every rp, and against the port's plain
    composition."""
    cfg, jcfg = _configs()
    js = _live_jax_state(jcfg, np.random.default_rng(3))
    ts = pconv_state_from_numpy(_jax_fields(js), "cpu")
    for rp in range(NPARTS):
        jout, jtail = J._mac_inverse_ola(jcfg, js, jnp.asarray(rp, jnp.int32))
        out, tail = P._mac_unpack_inverse_ola(cfg, ts, rp)
        assert tail.is_contiguous()
        _close(out, jout)
        _close(tail, jtail)
        pout, ptail = P._inverse_and_ola(cfg, ts, P._spectral_mac(cfg, ts, rp))
        _close(out, pout)
        _close(tail, ptail)


@pytest.mark.parametrize("tv", [False, True])
def test_steps_at_4096_match_jax(route, tv):
    """``pconv_step`` / ``pconv_step_tv`` streaming 6 blocks at pts 4096 from
    a state carried over from JAX (the TV step writes the coefficient frame
    at wp2 before the MAC reads the ring), outputs and states against
    JAX's."""
    cfg, jcfg = _configs()
    rng = np.random.default_rng(10 + tv)
    js = _live_jax_state(jcfg, rng)
    ts = pconv_state_from_numpy(_jax_fields(js), "cpu")
    for _ in range(6):
        bx = rng.standard_normal(PTS).astype(np.float32)
        bh = (0.2 * rng.standard_normal(PTS)).astype(np.float32)
        if tv:
            js, jo = J.pconv_step_tv(jcfg, js, bx, bh)
            ts, to = P.pconv_step_tv(cfg, ts, torch.from_numpy(bx), torch.from_numpy(bh))
        else:
            js, jo = J.pconv_step(jcfg, js, bx)
            ts, to = P.pconv_step(cfg, ts, torch.from_numpy(bx))
        _close(to, jo)
    got = pconv_state_to_numpy(ts)
    for name, want in _jax_fields(js).items():
        _close(got[name], want)


def test_xfade_at_4096_matches_jax(route):
    """``pconv_begin_xfade`` then 4 ``pconv_step_xfade`` blocks at pts 4096
    from a state carried over from JAX, against JAX's, then a plain step of
    the faded-in state."""
    cfg, jcfg = _configs()
    rng = np.random.default_rng(20)
    js = _live_jax_state(jcfg, rng)
    ts = pconv_state_from_numpy(_jax_fields(js), "cpu")
    new_ir = (0.2 * rng.standard_normal(cfg.cvs)).astype(np.float32)
    jxf = J.pconv_begin_xfade(jcfg, js, new_ir)
    txf = P.pconv_begin_xfade(cfg, ts, torch.from_numpy(new_ir))
    _close(txf.state.tail, jxf.state.tail)
    for pos in range(4):
        bx = rng.standard_normal(PTS).astype(np.float32)
        ramp = P._xfade_ramp(cfg, pos, 4, torch.device("cpu"))
        jxf, jo = J.pconv_step_xfade(jcfg, jxf, bx, ramp.numpy())
        txf, to = P.pconv_step_xfade(cfg, txf, torch.from_numpy(bx), ramp)
        _close(to, jo)
    bx = rng.standard_normal(PTS).astype(np.float32)
    _, jo = J.pconv_step(jcfg, jxf.state, bx)
    _, to = P.pconv_step(cfg, txf.state, torch.from_numpy(bx))
    _close(to, jo)


# ---------------------------------------------------------------------------
# the CUDA kernel against the twin on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the MAC-and-unpack kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nparts,bins,lead", [(1, 4096, ()), (255, 4096, ()), (5, 96, (3,)),
                                              (3, 2, ()), (256, 4096, (4,)), (7, 100, ()),
                                              (2, 33, (2,)), (8, 128, ()), (300, 65, ())])
def test_cuda_kernel_matches_twin(cuda_device, nparts, bins, lead):
    """Within 3e-6 of the twin, bit-equal on a second launch, and bit-equal
    to ``unpack_inverse`` of the ``spectral_mac`` kernel (the same plan, MAC
    and slice-order sum); nparts below the cluster size and odd bins
    included."""
    ring, h = _ring(np.random.default_rng(nparts + bins), nparts, bins, lead)
    ring_d = tuple(p.to(cuda_device) for p in _t(ring))
    h_d = tuple(p.to(cuda_device) for p in _t(h))
    for rp in sorted({0, 1 % nparts, nparts - 1}):
        for b0 in (1.0, 2.0):
            got = B.block_mac_unpack(ring_d, h_d, rp, b0)
            again = B.block_mac_unpack(ring_d, h_d, rp, b0)
            want = B.block_mac_unpack_plain(ring_d, h_d, rp, b0)
            same = unpack_inverse(MAC.spectral_mac(ring_d, h_d, rp, b0))
            torch.cuda.synchronize()
            for g, a, w, s in zip(got, again, want, same):
                assert g.is_contiguous()
                _close(g, w.cpu(), 3e-6)
                assert torch.equal(g, a) and torch.equal(g, s)


@pytest.mark.cuda
@pytest.mark.parametrize("nparts,bins", [(256, 4096), (5, 96)])
def test_cuda_kernel_channel_independent(cuda_device, nparts, bins):
    """Channel c of a 16-channel call is bit-equal to the same ring alone
    at C = 1 (the plan takes no channel count)."""
    ring, h = _ring(np.random.default_rng(nparts * bins), nparts, bins, (16,))
    ring_d = tuple(p.to(cuda_device) for p in _t(ring))
    h_d = tuple(p.to(cuda_device) for p in _t(h))
    many = B.block_mac_unpack(ring_d, h_d, nparts - 1, 2.0)
    for c in (0, 9, 15):
        alone = B.block_mac_unpack(tuple(p[c:c + 1].contiguous() for p in ring_d),
                                   tuple(p[c:c + 1].contiguous() for p in h_d), nparts - 1, 2.0)
        torch.cuda.synchronize()
        for m_, a in zip(many, alone):
            assert torch.equal(m_[c], a[0])
