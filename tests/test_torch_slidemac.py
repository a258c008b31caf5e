"""Port parity: the sliding-window spectral MAC of opencl_fft_tpu_torch
(``ops/cuda/slidemac.py``: ``chunk_mac``, ``macflow_lti``,
``macflow_lti_batched`` and their twin) against the JAX Pallas kernels of
``ops/pallas/chunkmac.py`` and ``ops/pallas/macflow.py`` in interpret mode,
on the same numpy-seeded inputs: atol 1e-5 * max|JAX| (both sum the
partitions in float32 in different orders). The JAX kernels take
nparts % 8 == 0 and bins % 128 == 0 (chunk_mac also a multiple of 8
outputs), so the comparison runs at bins 128 and nparts 8-64; other shapes
(any nparts >= 1, bins, output count) are held against a float64 numpy
loop at atol 1e-5 * max|oracle|. The route rule (``slide_route``: the
scans' tiled MAC for long timelines, the q-split kernel for short ones) is
held to its rule and its split to every partition once; the CUDA kernel is
held against the twin on a card, on both routes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_fft_tpu.ops.pallas import chunkmac as JC
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


def _oracle(x, h, nout, b0):
    """float64 loop: acc[c, t] = sum_q x[c, t+q] (*) h[c, q], bin 0
    componentwise times b0."""
    xr, xi = (a.astype(np.float64) for a in x)
    hr, hi = (a.astype(np.float64) for a in h)
    nparts = hr.shape[1]
    acc_r = np.zeros((xr.shape[0], nout, xr.shape[2]))
    acc_i = np.zeros_like(acc_r)
    for t in range(nout):
        wr, wi = xr[:, t:t + nparts], xi[:, t:t + nparts]
        acc_r[:, t] = np.sum(wr * hr - wi * hi, axis=1)
        acc_i[:, t] = np.sum(wr * hi + wi * hr, axis=1)
        acc_r[:, t, 0] = b0 * np.sum(wr[..., 0] * hr[..., 0], axis=1)
        acc_i[:, t, 0] = b0 * np.sum(wi[..., 0] * hi[..., 0], axis=1)
    return acc_r, acc_i


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("nparts,groups", [(8, 1), (16, 2)])
@pytest.mark.parametrize("b0", [1.0, 2.0])
def test_chunk_mac_twin_matches_pallas_kernel(batch, nparts, groups, b0):
    bins, gb = 128, JC.pick_group_blocks(nparts, 128)
    rng = np.random.default_rng(batch + nparts + groups)
    tl = _planes(rng, batch, nparts + gb * groups, bins)
    h = _planes(rng, batch, nparts, bins)
    jr, ji = JC.chunk_mac(tuple(map(jnp.asarray, tl)), tuple(map(jnp.asarray, h)), b0,
                          interpret=True)
    before = S.CHUNKMAC_LAUNCHES
    gr, gi = S.chunk_mac(_t(tl), _t(h), b0)
    assert S.CHUNKMAC_LAUNCHES == before          # the CPU runs the twin
    _close(gr, jr)
    _close(gi, ji)


@pytest.mark.parametrize("nparts,nb", [(8, 8), (16, 11), (64, 40)])
@pytest.mark.parametrize("b0", [1.0, 2.0])
def test_macflow_lti_twin_matches_pallas_kernel(nparts, nb, b0):
    rng = np.random.default_rng(nparts * nb)
    xtl = _planes(rng, nparts - 1 + nb, 128)
    h = _planes(rng, nparts, 128)
    jr, ji = JF.macflow_lti(tuple(map(jnp.asarray, xtl)), tuple(map(jnp.asarray, h)), nb,
                            b0, interpret=True)
    gr, gi = S.macflow_lti(_t(xtl), _t(h), nb, b0)
    _close(gr, np.asarray(jr)[:nb])
    _close(gi, np.asarray(ji)[:nb])


@pytest.mark.parametrize("batch,nparts,nb", [(2, 8, 13), (3, 16, 8)])
def test_macflow_lti_batched_twin_matches_pallas_kernel(batch, nparts, nb):
    rng = np.random.default_rng(batch * nparts + nb)
    xtl = _planes(rng, batch, nparts - 1 + nb, 128)
    h = _planes(rng, batch, nparts, 128)
    jr, ji = JF.macflow_lti_batched(tuple(map(jnp.asarray, xtl)),
                                    tuple(map(jnp.asarray, h)), nb, 2.0, interpret=True)
    gr, gi = S.macflow_lti_batched(_t(xtl), _t(h), nb, 2.0)
    _close(gr, np.asarray(jr)[:, :nb])
    _close(gi, np.asarray(ji)[:, :nb])


@pytest.mark.parametrize("batch,nparts,bins,nout", [
    (1, 1, 16, 1), (2, 3, 64, 5), (1, 37, 64, 13), (3, 5, 24, 9), (2, 3, 1, 4)])
@pytest.mark.parametrize("b0", [1.0, 2.0])
def test_twin_matches_oracle_at_odd_shapes(batch, nparts, bins, nout, b0):
    """Shapes the TPU kernels do not take: nparts not a multiple of 8, bins
    not of 128, nout not of 8; the three wrappers agree with each other."""
    rng = np.random.default_rng(nparts * bins + nout)
    x = _planes(rng, batch, nparts - 1 + nout, bins)
    h = _planes(rng, batch, nparts, bins)
    ref = _oracle(x, h, nout, b0)
    got = S.macflow_lti_batched(_t(x), _t(h), nout, b0)
    for g, r in zip(got, ref):
        _close(g, r)
    pad = tuple(np.concatenate([p, np.zeros((batch, 1, bins), np.float32)], 1) for p in x)
    for g, r in zip(S.chunk_mac(_t(pad), _t(h), b0), got):
        np.testing.assert_array_equal(g.numpy(), r.numpy())
    for c in range(batch):
        one = S.macflow_lti(tuple(p[c] for p in _t(x)), tuple(p[c] for p in _t(h)), nout, b0)
        for g, r in zip(one, got):
            _close(g, r[c])


def test_twin_chunks_bound_its_windows(monkeypatch):
    """The twin's output chunking changes nothing but memory."""
    rng = np.random.default_rng(7)
    x, h = _planes(rng, 2, 6 + 19, 32), _planes(rng, 2, 7, 32)
    whole = S.slide_mac_plain(_t(x), _t(h), 19, 2.0)
    monkeypatch.setattr(S, "_PLAIN_CHUNK_ELEMS", 1)
    for g, r in zip(S.slide_mac_plain(_t(x), _t(h), 19, 2.0), whole):
        np.testing.assert_array_equal(g.numpy(), r.numpy())


def test_wrappers_validate_shapes():
    z = torch.zeros
    h = (z(2, 4, 16), z(2, 4, 16))
    with pytest.raises(ValueError, match="timeline of >= 11 rows"):
        S.macflow_lti_batched((z(2, 10, 16), z(2, 10, 16)), h, 8, 1.0)
    with pytest.raises(ValueError, match="h planes"):
        S.macflow_lti_batched((z(2, 11, 16), z(2, 11, 16)), (z(3, 4, 16), z(3, 4, 16)), 8,
                              1.0)
    with pytest.raises(ValueError, match="0 outputs"):
        S.chunk_mac((z(2, 4, 16), z(2, 4, 16)), h, 1.0)
    with pytest.raises(ValueError, match="one \\(C, rows, bins\\) shape"):
        S.chunk_mac((z(2, 9, 16), z(2, 8, 16)), h, 1.0)
    with pytest.raises(ValueError, match="macflow_lti: xtl planes"):
        S.macflow_lti((z(1, 11, 16), z(1, 11, 16)), h, 8, 1.0)
    meta = torch.zeros((2, 11, 16), device="meta")
    with pytest.raises(ValueError, match="one device"):
        S.macflow_lti_batched((meta, meta), h, 8, 1.0)
    assert S.chunk_mac((z(2, 5, 16), z(2, 5, 16)), h, 1.0)[0].shape == (2, 1, 16)


@pytest.mark.parametrize("C,nout,bins,nparts,route,how", [
    # the main-path shapes (nparts 256, bins 512): offline render 1 x 1880,
    # 16 x 470 and 64 x 470 on the tiled MAC, the K = 8 chunk split in 4
    (1, 1880, 512, 256, "tiled", S.MacPlan(8, 16, 64, 256)),
    (16, 470, 512, 256, "tiled", S.MacPlan(8, 16, 64, 256)),
    (64, 470, 512, 256, "tiled", S.MacPlan(8, 16, 64, 256)),
    (64, 8, 512, 256, "split", 4),
    # nout below one full tile (64 outputs), below MAC_TT, nparts below the
    # slices, one partition, bins not a multiple of 32
    (2, 40, 512, 256, "split", 8), (17, 8, 128, 8, "split", 8), (1, 7, 33, 3, "split", 2),
    (1, 1, 16, 1, "split", 1), (3, 64, 100, 70, "split", 8),
    # long enough for the tiled MAC at small widths (the grid still fills the
    # card) and not (it does not)
    (1, 1880, 16, 3, "tiled", S.MacPlan(1, 8, 8, 32)), (1, 1000, 16, 3, "split", 2)])
def test_slide_route_by_shape(C, nout, bins, nparts, route, how):
    assert S.slide_route(C, nout, bins, nparts) == (route, how)


@pytest.mark.parametrize("C,nout,bins,nparts", [(64, 8, 512, 256), (2, 40, 512, 256),
                                                (1, 7, 33, 3), (1, 1, 16, 1), (3, 9, 64, 5)])
@pytest.mark.parametrize("route", ["tiled", "split"])
def test_forced_routes_cover_every_output_bin_and_partition_once(C, nout, bins, nparts, route):
    """Either route at any shape: the q-split grid (MAC_TT outputs x
    MAC_THREADS bins a CTA, every slice's partitions) and the tiled grid
    (the plan's G * TT outputs x TILE_BINS bins, the stages' partitions)
    reach each (output, bin) once and each partition once a thread."""
    got, how = S.slide_route(C, nout, bins, nparts, force=route)
    assert got == route
    if route == "split":
        assert 1 <= how <= S.TV_MAX_SLICES
        outs = [t for bx in range(-(-nout // S.MAC_TT)) for j in range(S.MAC_TT)
                for t in (bx * S.MAC_TT + j,) if t < nout]
        bins_ = [k for by in range(-(-bins // S.MAC_THREADS)) for lane in range(S.MAC_THREADS)
                 for k in (by * S.MAC_THREADS + lane,) if k < bins]
        parts = [q for q0, q1 in S.q_ranges(nparts, how) for q in range(q0, q1)]
    else:
        T = how.outs
        outs = [t for bx in range(-(-nout // T)) for j in range(T) for t in (bx * T + j,)
                if t < nout]
        bins_ = [k for by in range(-(-bins // S.TILE_BINS)) for lane in range(S.TILE_BINS)
                 for k in (by * S.TILE_BINS + lane,) if k < bins]
        parts = [ch * how.q + u for ch in range(-(-nparts // how.q))
                 for u in range(min(how.q, nparts - ch * how.q))]
        assert how.ring & (how.ring - 1) == 0 and how.ring >= 2 * how.q + T - 1
    assert outs == list(range(nout)) and bins_ == list(range(bins))
    assert parts == list(range(nparts))


def test_slide_route_rejects_unknown_route():
    with pytest.raises(ValueError, match="no sliding-MAC route"):
        S.slide_route(1, 8, 16, 4, force="dense")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the sliding-MAC kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("batch,nparts,bins,nout", [
    (1, 1, 16, 1), (3, 37, 64, 13), (2, 256, 512, 40), (17, 8, 128, 8)])
@pytest.mark.parametrize("b0", [1.0, 2.0])
def test_cuda_kernel_matches_twin(cuda_device, batch, nparts, bins, nout, b0):
    rng = np.random.default_rng(nparts + nout)
    x = _t(_planes(rng, batch, nparts + nout, bins), cuda_device)
    h = _t(_planes(rng, batch, nparts, bins), cuda_device)
    before = (S.CHUNKMAC_LAUNCHES, S.MACFLOW_LAUNCHES, S.MACFLOW_BATCHED_LAUNCHES)
    got = S.chunk_mac(x, h, b0)
    got_b = S.macflow_lti_batched(x, h, nout, b0)
    got_1 = S.macflow_lti((x[0][0], x[1][0]), (h[0][0], h[1][0]), nout, b0)
    torch.cuda.synchronize()
    assert (S.CHUNKMAC_LAUNCHES, S.MACFLOW_LAUNCHES, S.MACFLOW_BATCHED_LAUNCHES) == tuple(
        n + 1 for n in before)
    want = S.slide_mac_plain(x, h, nout, b0)
    for g, gb, g1, w in zip(got, got_b, got_1, want):
        _close(g, w.cpu(), 2e-5)
        _close(gb, w.cpu(), 2e-5)
        _close(g1, w[0].cpu(), 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,nparts,bins,nout", [
    (1, 1, 16, 1), (3, 37, 64, 21), (2, 256, 512, 40), (64, 256, 512, 8), (1, 5, 33, 70),
    (2, 70, 100, 300), (1, 256, 512, 1880)])
@pytest.mark.parametrize("route", ["tiled", "split"])
def test_cuda_routes_match_twin(cuda_device, monkeypatch, batch, nparts, bins, nout, route):
    """Both routes at edge shapes (nout below MAC_TT and not a multiple of
    a tile, nparts below the slices, bins not a multiple of 32, one
    partition), bit-equal on a second launch."""
    rng = np.random.default_rng(nparts + nout + bins)
    x = _t(_planes(rng, batch, nparts + nout, bins), cuda_device)
    h = _t(_planes(rng, batch, nparts, bins), cuda_device)
    own = S.slide_route
    monkeypatch.setattr(S, "slide_route", lambda *a, **k: own(*a, **k, force=route))
    got = S.macflow_lti_batched(x, h, nout, 2.0)
    again = S.macflow_lti_batched(x, h, nout, 2.0)
    torch.cuda.synchronize()
    want = S.slide_mac_plain(x, h, nout, 2.0)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        _close(g, w.cpu(), 2e-5)
