"""Port parity: the time-varying sliding-window MAC of opencl_fft_tpu_torch
(``ops/cuda/slidemac.py``: ``macflow_tv``, ``macflow_tv_batched`` and their
twin ``slide_mac_tv_plain``) against the JAX package on the same
numpy-seeded inputs: the Pallas kernels of ``ops/pallas/macflow.py`` in
interpret mode at the phases they take (c = 0 mod 8; nparts 16-64, bins
128), the JAX gather evaluation ``ops/decomposed._tv_mac_xla`` at the
phases they do not, and a float64 numpy loop at shapes the TPU kernel does
not take (nparts 1 and 3, odd bins). Tolerance: atol 1e-5 * max|reference|
(every evaluation sums the partitions in float32, in different orders).
The CUDA kernel is held against the twin on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_fft_tpu.ops import pconv as JP
from opencl_fft_tpu.ops.decomposed import _tv_mac_xla
from opencl_fft_tpu.ops.pallas import macflow as JF
from opencl_fft_tpu_torch.ops.cuda import slidemac as S

torch.set_num_threads(1)

TOL = 1e-5


def _close(got, ref, rel=TOL):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=rel * (np.abs(ref).max() + 1e-30), rtol=0)


def _planes(rng, *shape):
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(2))


def _t(planes, device="cpu"):
    return tuple(torch.from_numpy(p).to(device) for p in planes)


def _j(planes):
    return tuple(map(jnp.asarray, planes))


def _oracle(x, h, nout, nparts, b0, c):
    """float64 loop over one channel: acc[t] = sum_p x[t+p] (*)
    h[t + nparts-1 - ((t - nparts+1 + p + c) mod nparts)], bin 0
    componentwise times b0."""
    xr, xi, hr, hi = (a.astype(np.float64) for a in (*x, *h))
    acc_r = np.zeros((nout, xr.shape[1]))
    acc_i = np.zeros_like(acc_r)
    for t in range(nout):
        for p in range(nparts):
            a, b = t + p, t + nparts - 1 - (t - nparts + 1 + p + c) % nparts
            acc_r[t, 1:] += xr[a, 1:] * hr[b, 1:] - xi[a, 1:] * hi[b, 1:]
            acc_i[t, 1:] += xr[a, 1:] * hi[b, 1:] + xi[a, 1:] * hr[b, 1:]
            acc_r[t, 0] += b0 * xr[a, 0] * hr[b, 0]
            acc_i[t, 0] += b0 * xi[a, 0] * hi[b, 0]
    return acc_r, acc_i


@pytest.mark.parametrize("nparts,nb", [(16, 24), (32, 8), (64, 40), (16, 11)])
@pytest.mark.parametrize("c", [0, 8, 16])
def test_macflow_tv_twin_matches_pallas_kernel(nparts, nb, c):
    rng = np.random.default_rng(nparts * nb + c)
    xtl, htl = _planes(rng, nparts - 1 + nb, 128), _planes(rng, nparts - 1 + nb, 128)
    jr, ji = JF.macflow_tv(_j(xtl), _j(htl), nb, nparts, 2.0, c=c % nparts, interpret=True)
    before = S.MACFLOW_TV_LAUNCHES
    gr, gi = S.macflow_tv(_t(xtl), _t(htl), nb, nparts, 2.0, c)
    assert S.MACFLOW_TV_LAUNCHES == before          # the CPU runs the twin
    _close(gr, np.asarray(jr)[:nb])
    _close(gi, np.asarray(ji)[:nb])


@pytest.mark.parametrize("batch,nparts,nb,c", [(2, 16, 13, 0), (3, 16, 8, 8), (2, 32, 9, 16)])
@pytest.mark.parametrize("b0", [1.0, 2.0])
def test_macflow_tv_batched_twin_matches_pallas_kernel(batch, nparts, nb, c, b0):
    rng = np.random.default_rng(batch * nparts + nb + c)
    xtl = _planes(rng, batch, nparts - 1 + nb, 128)
    htl = _planes(rng, batch, nparts - 1 + nb, 128)
    jr, ji = JF.macflow_tv_batched(_j(xtl), _j(htl), nb, nparts, b0, c=c, interpret=True)
    before = S.MACFLOW_TV_BATCHED_LAUNCHES
    gr, gi = S.macflow_tv_batched(_t(xtl), _t(htl), nb, nparts, b0, c)
    assert S.MACFLOW_TV_BATCHED_LAUNCHES == before
    _close(gr, np.asarray(jr)[:, :nb])
    _close(gi, np.asarray(ji)[:, :nb])


@pytest.mark.parametrize("nparts,nb", [(16, 24), (32, 13)])
@pytest.mark.parametrize("off", [3, 5, -1])
def test_twin_matches_jax_gathers_off_phase(nparts, nb, off):
    """Phases the JAX kernel does not take (its engine routes them to
    ``_tv_mac_xla``): c = 3, 5 and nparts-1."""
    c = off % nparts
    rng = np.random.default_rng(nparts + nb + c)
    xtl, htl = _planes(rng, nparts - 1 + nb, 64), _planes(rng, nparts - 1 + nb, 64)
    cfg = JP.PconvConfig(pts=64, nparts=nparts)
    wp2 = jnp.int32((nparts - 1 - c) % nparts)
    jr, ji = _tv_mac_xla(cfg, _j(xtl), _j(htl), nb, 2.0, wp2)
    gr, gi = S.macflow_tv(_t(xtl), _t(htl), nb, nparts, 2.0, c)
    _close(gr, jr)
    _close(gi, ji)


@pytest.mark.parametrize("nparts,bins,nb,c", [(1, 16, 4, 0), (3, 24, 7, 1), (3, 5, 2, 2),
                                              (9, 48, 13, 4)])
@pytest.mark.parametrize("b0", [1.0, 2.0])
def test_twin_matches_oracle_at_odd_shapes(nparts, bins, nb, c, b0):
    """nparts below the kernel's two-row path (and 9), bins not a multiple
    of 128; the single-channel wrapper equals each channel of the batched
    one."""
    rng = np.random.default_rng(nparts * bins + nb + c)
    x, h = _planes(rng, 2, nparts - 1 + nb, bins), _planes(rng, 2, nparts - 1 + nb, bins)
    got = S.macflow_tv_batched(_t(x), _t(h), nb, nparts, b0, c)
    for ch in range(2):
        ref = _oracle(tuple(p[ch] for p in x), tuple(p[ch] for p in h), nb, nparts, b0, c)
        one = S.macflow_tv(tuple(p[ch] for p in _t(x)), tuple(p[ch] for p in _t(h)), nb,
                           nparts, b0, c)
        for g, o, r in zip(got, one, ref):
            _close(g[ch], r)
            np.testing.assert_array_equal(o.numpy(), g[ch].numpy())


def test_phase_is_taken_mod_nparts():
    rng = np.random.default_rng(11)
    x, h = _planes(rng, 1, 7 + 5, 16), _planes(rng, 1, 7 + 5, 16)
    a = S.macflow_tv_batched(_t(x), _t(h), 5, 8, 2.0, 3)
    b = S.macflow_tv_batched(_t(x), _t(h), 5, 8, 2.0, 3 + 8)
    for g, r in zip(a, b):
        np.testing.assert_array_equal(g.numpy(), r.numpy())


def test_twin_chunks_bound_its_windows(monkeypatch):
    """The twin's output chunking changes nothing but memory."""
    rng = np.random.default_rng(7)
    x, h = _planes(rng, 2, 6 + 19, 32), _planes(rng, 2, 6 + 19, 32)
    whole = S.slide_mac_tv_plain(_t(x), _t(h), 19, 7, 2.0, 5)
    monkeypatch.setattr(S, "_PLAIN_CHUNK_ELEMS", 1)
    for g, r in zip(S.slide_mac_tv_plain(_t(x), _t(h), 19, 7, 2.0, 5), whole):
        np.testing.assert_array_equal(g.numpy(), r.numpy())


def test_wrappers_validate_shapes():
    z = torch.zeros
    ok = (z(2, 11, 16), z(2, 11, 16))
    with pytest.raises(ValueError, match="timelines of >= 11 rows"):
        S.macflow_tv_batched((z(2, 10, 16), z(2, 10, 16)), ok, 8, 4, 1.0)
    with pytest.raises(ValueError, match="timelines of >= 11 rows"):
        S.macflow_tv_batched(ok, (z(2, 10, 16), z(2, 10, 16)), 8, 4, 1.0)
    with pytest.raises(ValueError, match="differ in channels or bins"):
        S.macflow_tv_batched(ok, (z(3, 11, 16), z(3, 11, 16)), 8, 4, 1.0)
    with pytest.raises(ValueError, match="one \\(C, rows, bins\\) shape"):
        S.macflow_tv_batched((z(2, 11, 16), z(2, 12, 16)), ok, 8, 4, 1.0)
    with pytest.raises(ValueError, match="nparts >= 1"):
        S.macflow_tv_batched(ok, ok, 8, 0, 1.0)
    with pytest.raises(ValueError, match="macflow_tv: xtl planes"):
        S.macflow_tv(ok, (ok[0][0], ok[1][0]), 8, 4, 1.0)
    meta = torch.zeros((2, 11, 16), device="meta")
    with pytest.raises(ValueError, match="one device"):
        S.macflow_tv_batched((meta, meta), ok, 8, 4, 1.0)


@pytest.mark.parametrize("C,nout,bins,nparts,want", [
    (64, 8, 512, 256, 4),        # a K = 8 chunk: 256 CTAs, split 4 ways
    (64, 470, 512, 256, 1),      # the render shape fills the card unsplit
    (1, 1880, 512, 256, 2),      # macflow_tv at the headline: 940 CTAs
    (64, 8, 512, 255, 4),        # nparts % S != 0
    (2, 21, 16, 9, 8),           # a tiny grid takes the most slices
    (3, 13, 48, 3, 2),           # nparts < TV_MAX_SLICES caps S at nparts
    (2, 5, 16, 1, 1)])
def test_tv_q_slices_plan(C, nout, bins, nparts, want):
    """S = 1 where the unsplit grid is more than the card's 132 SMs x 8
    groups of 128 threads hold at once, else at least 2 and as many as
    still fit; a power of two, at most TV_MAX_SLICES and nparts."""
    s = S.tv_q_slices(C, nout, bins, nparts)
    assert s == want
    assert s & (s - 1) == 0 and 1 <= s <= min(S.TV_MAX_SLICES, nparts)
    # on a card of one SM only the smallest grids split
    assert (S.tv_q_slices(C, nout, bins, nparts, sms=1) > 1) == (
        -(-nout // 8) * -(-bins // 128) * C <= 8 and nparts > 1)


@pytest.mark.parametrize("nparts", [1, 2, 3, 7, 9, 255, 256])
@pytest.mark.parametrize("slices", [1, 2, 4, 8])
def test_q_ranges_cover_each_partition_once(nparts, slices):
    """The kernel's split of [0, nparts) into q-slices: contiguous, in
    slice order, every partition exactly once, empty slices where nparts <
    slices, sizes within one of each other."""
    ranges = S.q_ranges(nparts, slices)
    assert len(ranges) == slices and ranges[0][0] == 0 and ranges[-1][1] == nparts
    covered = [q for q0, q1 in ranges for q in range(q0, q1)]
    assert covered == list(range(nparts))
    sizes = [q1 - q0 for q0, q1 in ranges]
    assert min(sizes) >= 0 and max(sizes) - min(sizes) <= 1
    if nparts < slices:
        assert sizes.count(0) == slices - nparts


@pytest.mark.parametrize("sms,want", [(66, 2), (132, 4), (264, 8), (1056, 8)])
def test_tv_q_slices_follows_the_card(sms, want):
    """The K = 8 chunk's 256 CTAs split as far as the card's SMs hold them
    at once: a card of twice the SMs takes twice the slices, up to
    TV_MAX_SLICES."""
    assert S.tv_q_slices(64, 8, 512, 256, sms=sms) == want


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the TV sliding-MAC kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("batch,nparts,bins,nout,c", [
    (1, 1, 16, 3, 0), (3, 3, 48, 13, 2), (2, 256, 512, 40, 5), (17, 8, 128, 8, 7)])
@pytest.mark.parametrize("b0", [1.0, 2.0])
def test_cuda_kernel_matches_twin(cuda_device, batch, nparts, bins, nout, c, b0):
    rng = np.random.default_rng(nparts + nout + c)
    x = _t(_planes(rng, batch, nparts - 1 + nout, bins), cuda_device)
    h = _t(_planes(rng, batch, nparts - 1 + nout, bins), cuda_device)
    before = (S.MACFLOW_TV_LAUNCHES, S.MACFLOW_TV_BATCHED_LAUNCHES)
    got = S.macflow_tv_batched(x, h, nout, nparts, b0, c)
    got_1 = S.macflow_tv((x[0][0], x[1][0]), (h[0][0], h[1][0]), nout, nparts, b0, c)
    torch.cuda.synchronize()
    assert (S.MACFLOW_TV_LAUNCHES, S.MACFLOW_TV_BATCHED_LAUNCHES) == tuple(
        n + 1 for n in before)
    want = S.slide_mac_tv_plain(x, h, nout, nparts, b0, c)
    for g, g1, w in zip(got, got_1, want):
        _close(g, w.cpu(), 2e-5)
        _close(g1, w[0].cpu(), 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,nparts,bins,nout,c", [
    (64, 256, 512, 8, 3), (5, 256, 512, 8, 5), (3, 9, 48, 13, 4), (1, 3, 16, 7, 2),
    (7, 1, 128, 9, 0), (2, 255, 130, 8, 11)])
@pytest.mark.parametrize("slices", [None, 2, 4, 8])
def test_cuda_split_kernel_matches_twin(cuda_device, monkeypatch, batch, nparts, bins, nout,
                                        c, slices):
    """The q-split TV kernel (the plan's choice, and 2, 4, 8 slices forced
    in place of it) against the twin within 1e-6 of max|twin|, at nparts
    1, 3, 9, 255 and 256 (fewer partitions than slices, nparts % slices !=
    0), odd channel and bin counts and phases off the 8-row alignment;
    twice the same launch gives the same bits (the slices are summed in a
    fixed order)."""
    if slices is not None:
        monkeypatch.setattr(S, "tv_q_slices", lambda *a, **k: slices)
    rng = np.random.default_rng(batch + nparts + nout + c)
    x = _t(_planes(rng, batch, nparts - 1 + nout, bins), cuda_device)
    h = _t(_planes(rng, batch, nparts - 1 + nout, bins), cuda_device)
    before = S.MACFLOW_TV_BATCHED_LAUNCHES
    got = S.macflow_tv_batched(x, h, nout, nparts, 2.0, c)
    again = S.macflow_tv_batched(x, h, nout, nparts, 2.0, c)
    torch.cuda.synchronize()
    assert S.MACFLOW_TV_BATCHED_LAUNCHES == before + 2
    want = S.slide_mac_tv_plain(x, h, nout, nparts, 2.0, c)
    for g, a, w in zip(got, again, want):
        _close(g, w.cpu(), 1e-6)
        assert torch.equal(g, a)
