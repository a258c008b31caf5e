"""Port parity: the block-step kernels of opencl_fft_tpu_torch
(``ops/cuda/mac.py``: ``spectral_mac``; ``ops/cuda/blockstep.py``:
``block_step_fused``, ``block_step_fwd_fused``, ``block_step_fwd_fused_tv``)
against the JAX Pallas kernels of ``ops/pallas/mac.py`` and
``ops/pallas/blockstep.py`` in interpret mode, on the same numpy-seeded
inputs: atol 1e-5 * max|JAX| (both sum the partitions in float32 in other
orders; the twins transform by FFTs, the JAX kernels by dense tables). The
JAX kernels take nparts % 8 == 0 and bins % 128 == 0, so the comparison
runs at (8, 128), (16, 256) and (256, 128); other shapes (nparts 3, bins
16) and a channel axis (C = 3) are held against a float64 numpy loop on the
dense tables, and every pts 2..2048 at nparts 1, 3 and 256 against a
float64 oracle from the packed real transforms (``ops/rfft.py`` in float64,
itself pinned to the tables). The card route of ``pconv_step{,_tv}``,
composed from the twins on the CPU, streams 20 blocks against JAX's
``pallas="blockf"`` route at 2e-5 * max, JAX's own bound between its
routes. The kernels' transform tiles (``step_plan``) are held to the tile
shapes the kernels take; the CUDA kernels are held against the twins on a
card.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_fft_tpu.ops import pconv as J
from opencl_fft_tpu.ops.pallas import blockstep as JB
from opencl_fft_tpu.ops.pallas import mac as JMAC
from opencl_fft_tpu_torch.ops import pconv as P
from opencl_fft_tpu_torch.ops.cuda import blockstep as B
from opencl_fft_tpu_torch.ops.cuda import mac as MAC
from opencl_fft_tpu_torch.ops.cuda import streamstep as S
from opencl_fft_tpu_torch.ops.cuda.tables import _wfwd_np, _wpost_np
from opencl_fft_tpu_torch.ops.rfft import irfft_split, rfft_split

torch.set_num_threads(1)

TOL = 1e-5
SHAPES = [(8, 128), (16, 256), (256, 128)]


def _close(got, ref, rel=TOL):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=rel * (np.abs(ref).max() + 1e-30), rtol=0)


def _inputs(rng, nparts, bins, lead=()):
    """A doubled ring (both halves equal), h planes, a tail and two blocks
    (numpy float32, a leading channel axis when given)."""
    def f(*shape, s=1.0):
        return (s * rng.standard_normal(shape)).astype(np.float32)

    ring = tuple(np.concatenate([a, a], -2) for a in (f(*lead, nparts, bins),
                                                      f(*lead, nparts, bins)))
    h = (f(*lead, nparts, bins, s=0.3), f(*lead, nparts, bins, s=0.3))
    return ring, h, f(*lead, bins), f(2, *lead, bins)


def _t(planes):
    return tuple(torch.from_numpy(np.ascontiguousarray(p)) for p in planes)


def _j(planes):
    return tuple(jnp.asarray(p) for p in planes)


def plan_slices(nparts, plan):
    """The one-launch MAC's slices in slice order, as ``mac_cluster_kernel``
    (csrc/blockstep.cu) cuts them: [q0, q1) partitions each, the cluster's
    trailing empty ones left out."""
    return [(q0, min(q0 + plan.qchunk, nparts)) for q0 in range(0, nparts, plan.qchunk)]


def plan_tiles(bins, plan, unpack):
    """Each cluster's bins, column by column, as ``mac_cluster_kernel`` maps
    them: ``spectral_mac``'s column u of tile t is bin t * tile + u;
    ``block_mac_unpack``'s column u < tile / 2 is bin k = t * tile / 2 + u
    <= bins / 2 and column tile / 2 + u its mirror (bins - k) mod bins.
    Columns past the last bin are left out."""
    t, half = plan.tile, bins // 2
    if not unpack:
        return [list(range(i * t, min((i + 1) * t, bins))) for i in range(-(-bins // t))]
    pairs = t // 2
    tiles = []
    for i in range(-(-(half + 1) // pairs)):
        ks = [k for k in range(i * pairs, (i + 1) * pairs) if k <= half]
        tiles.append(ks + [(bins - k) % bins for k in ks])
    return tiles


# ---------------------------------------------------------------------------
# each twin against its Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nparts,bins", SHAPES)
@pytest.mark.parametrize("rp", [0, 3, 7])
@pytest.mark.parametrize("b0", [1.0, 2.0])
def test_spectral_mac_twin_matches_pallas_kernel(nparts, bins, rp, b0):
    ring, h, _, _ = _inputs(np.random.default_rng(nparts + rp), nparts, bins)
    jr, ji = JMAC.spectral_mac(_j(ring), _j(h), rp, b0, interpret=True)
    before = MAC.LAUNCHES
    gr, gi = MAC.spectral_mac(_t(ring), _t(h), rp, b0)
    assert MAC.LAUNCHES == before                 # the CPU runs the twin
    _close(gr, jr)
    _close(gi, ji)


@pytest.mark.parametrize("nparts,bins", SHAPES)
@pytest.mark.parametrize("rp", [0, 3, 7])
@pytest.mark.parametrize("b0", [1.0, 2.0])
def test_block_step_fused_twin_matches_pallas_kernel(nparts, bins, rp, b0):
    ring, h, tail, _ = _inputs(np.random.default_rng(10 + nparts + rp), nparts, bins)
    jout, jtail = JB.block_step_fused(_j(ring), _j(h), rp, b0, jnp.asarray(tail), bins,
                                      interpret=True)
    before = B.STEP_LAUNCHES
    out, new_tail = B.block_step_fused(_t(ring), _t(h), rp, b0, torch.from_numpy(tail), bins)
    assert B.STEP_LAUNCHES == before
    _close(out, jout)
    _close(new_tail, jtail)


def _assert_ring_written(new, old, fresh, rows):
    """new == old except rows ``rows``, which hold ``fresh``."""
    for n, o, f in zip(new, old, fresh):
        n = n.numpy()
        keep = np.ones(n.shape[-2], bool)
        keep[list(rows)] = False
        np.testing.assert_array_equal(n[..., keep, :], o[..., keep, :])
        for r in rows:
            _close(n[..., r, :], f)


@pytest.mark.parametrize("nparts,bins", SHAPES)
@pytest.mark.parametrize("rp", [0, 3, 7])
@pytest.mark.parametrize("b0", [1.0, 2.0])
def test_block_step_fwd_fused_twin_matches_pallas_kernel(nparts, bins, rp, b0):
    """rp = 0 puts the fresh frame at slot nparts - 1, the ring's last row
    pair; the JAX kernel returns the frame, the twin the written ring."""
    ring, h, tail, blocks = _inputs(np.random.default_rng(20 + nparts + rp), nparts, bins)
    jout, jtail, jfr, jfi = JB.block_step_fwd_fused(
        jnp.asarray(blocks[0]), _j(ring), _j(h), rp, b0, jnp.asarray(tail), bins,
        interpret=True)
    before = B.FWD_LAUNCHES
    out, new_tail, x2 = B.block_step_fwd_fused(torch.from_numpy(blocks[0]), _t(ring), _t(h),
                                               rp, b0, torch.from_numpy(tail), bins)
    assert B.FWD_LAUNCHES == before
    _close(out, jout)
    _close(new_tail, jtail)
    wp = (rp - 1) % nparts
    _assert_ring_written(x2, ring, (jfr, jfi), (wp, wp + nparts))


@pytest.mark.parametrize("nparts,bins", SHAPES)
@pytest.mark.parametrize("rp", [0, 3, 7])
@pytest.mark.parametrize("wp2", [0, 7])
@pytest.mark.parametrize("b0", [1.0, 2.0])
def test_block_step_fwd_fused_tv_twin_matches_pallas_kernel(nparts, bins, rp, wp2, b0):
    ring, h, tail, blocks = _inputs(np.random.default_rng(30 + nparts + rp + wp2), nparts,
                                    bins)
    jout, jtail, jfr, jfi, jhr, jhi = JB.block_step_fwd_fused_tv(
        jnp.asarray(blocks), _j(ring), _j(h), rp, wp2, b0, jnp.asarray(tail), bins,
        interpret=True)
    before = B.FWD_TV_LAUNCHES
    out, new_tail, x2, hn = B.block_step_fwd_fused_tv(
        torch.from_numpy(blocks), _t(ring), _t(h), rp, wp2, b0, torch.from_numpy(tail), bins)
    assert B.FWD_TV_LAUNCHES == before
    _close(out, jout)
    _close(new_tail, jtail)
    wp = (rp - 1) % nparts
    _assert_ring_written(x2, ring, (jfr, jfi), (wp, wp + nparts))
    _assert_ring_written(hn, h, (jhr, jhi), (wp2,))


# ---------------------------------------------------------------------------
# odd shapes and a channel axis against a float64 loop
# ---------------------------------------------------------------------------

def _oracle_step(ring, h, rp, b0, tail, pts, fresh_x=None, fresh_h=None, wp2=None):
    """float64: the fresh rows substituted, the window MAC (bin 0
    componentwise times b0), y = [acc_re | acc_im] @ wpost, the OLA."""
    xr, xi = (a.astype(np.float64).copy() for a in ring)
    hr, hi = (a.astype(np.float64).copy() for a in h)
    nparts = hr.shape[-2]
    if fresh_x is not None:
        wp = (rp - 1) % nparts
        for plane, f in zip((xr, xi), (fresh_x[..., :pts], fresh_x[..., pts:])):
            plane[..., wp, :] = plane[..., wp + nparts, :] = f
    if fresh_h is not None:
        hr[..., wp2, :], hi[..., wp2, :] = fresh_h[..., :pts], fresh_h[..., pts:]
    wr, wi = xr[..., rp:rp + nparts, :], xi[..., rp:rp + nparts, :]
    acc_r = np.sum(wr * hr - wi * hi, axis=-2)
    acc_i = np.sum(wr * hi + wi * hr, axis=-2)
    acc_r[..., 0] = b0 * np.sum(wr[..., 0] * hr[..., 0], axis=-1)
    acc_i[..., 0] = b0 * np.sum(wi[..., 0] * hi[..., 0], axis=-1)
    y = np.concatenate([acc_r, acc_i], -1) @ _wpost_np(pts).astype(np.float64)
    return (acc_r, acc_i), (y[..., :pts] + tail) / pts, y[..., pts:], (xr, xi), (hr, hi)


@pytest.mark.parametrize("nparts,bins,lead", [(3, 16, ()), (3, 16, (3,)), (8, 32, (3,)),
                                              (1, 16, (2,))])
@pytest.mark.parametrize("b0", [1.0, 2.0])
def test_twins_match_float64_oracle(nparts, bins, lead, b0):
    """Shapes the TPU kernels do not take, one channel or three; every rp
    (the ring boundaries included) and, for TV, wp2 at both ends."""
    rng = np.random.default_rng(nparts * bins + len(lead))
    ring, h, tail, blocks = _inputs(rng, nparts, bins, lead)
    wfwd = _wfwd_np(bins).astype(np.float64)
    frames = blocks.astype(np.float64) @ wfwd
    for rp in range(nparts):
        acc, out, ntail, _, _ = _oracle_step(ring, h, rp, b0, tail, bins)
        for g, r in zip(MAC.spectral_mac(_t(ring), _t(h), rp, b0), acc):
            _close(g, r)
        for g, r in zip(B.block_step_fused(_t(ring), _t(h), rp, b0, torch.from_numpy(tail),
                                           bins), (out, ntail)):
            _close(g, r)
        _, out, ntail, x2, _ = _oracle_step(ring, h, rp, b0, tail, bins, fresh_x=frames[0])
        got = B.block_step_fwd_fused(torch.from_numpy(blocks[0]), _t(ring), _t(h), rp, b0,
                                     torch.from_numpy(tail), bins)
        for g, r in zip((got[0], got[1], *got[2]), (out, ntail, *x2)):
            _close(g, r)
        for wp2 in {0, nparts - 1}:
            _, out, ntail, x2, hn = _oracle_step(ring, h, rp, b0, tail, bins,
                                                 fresh_x=frames[0], fresh_h=frames[1], wp2=wp2)
            got = B.block_step_fwd_fused_tv(torch.from_numpy(blocks), _t(ring), _t(h), rp, wp2,
                                            b0, torch.from_numpy(tail), bins)
            for g, r in zip((got[0], got[1], *got[2], *got[3]), (out, ntail, *x2, *hn)):
                _close(g, r)


def _frames64(blocks, pts):
    """float64 packed frames of blocks (..., pts): the unnormalized packed
    real transform (``rfft_split``) of the block zero-padded to 2 pts."""
    frame = np.concatenate([blocks, np.zeros_like(blocks)], -1).astype(np.float64)
    fr, fi = rfft_split(torch.from_numpy(frame), unnormalized=True)
    return np.concatenate([fr.numpy(), fi.numpy()], -1)


def _fft_oracle(ring, h, rp, b0, tail, pts, fresh_x=None, fresh_h=None, wp2=None):
    """``_oracle_step`` with the inverse as the packed inverse real
    transform (``irfft_split``) in float64, for pts whose dense table is
    too large to build in a test."""
    xr, xi = (a.astype(np.float64).copy() for a in ring)
    hr, hi = (a.astype(np.float64).copy() for a in h)
    nparts = hr.shape[-2]
    if fresh_x is not None:
        wp = (rp - 1) % nparts
        for plane, f in zip((xr, xi), (fresh_x[..., :pts], fresh_x[..., pts:])):
            plane[..., wp, :] = plane[..., wp + nparts, :] = f
    if fresh_h is not None:
        hr[..., wp2, :], hi[..., wp2, :] = fresh_h[..., :pts], fresh_h[..., pts:]
    wr, wi = xr[..., rp:rp + nparts, :], xi[..., rp:rp + nparts, :]
    acc_r = np.sum(wr * hr - wi * hi, axis=-2)
    acc_i = np.sum(wr * hi + wi * hr, axis=-2)
    acc_r[..., 0] = b0 * np.sum(wr[..., 0] * hr[..., 0], axis=-1)
    acc_i[..., 0] = b0 * np.sum(wi[..., 0] * hi[..., 0], axis=-1)
    y = irfft_split((torch.from_numpy(acc_r), torch.from_numpy(acc_i))).numpy()
    return (acc_r, acc_i), (y[..., :pts] + tail) / pts, y[..., pts:], (xr, xi), (hr, hi)


@pytest.mark.parametrize("pts", [2, 16, 128])
def test_fft_oracle_matches_table_oracle(pts):
    """The float64 transform oracle is the dense-table oracle (the tables
    are float32, so within their rounding)."""
    rng = np.random.default_rng(pts)
    ring, h, tail, blocks = _inputs(rng, 3, pts, (2,))
    frames = _frames64(blocks, pts)
    np.testing.assert_allclose(frames, blocks.astype(np.float64) @ _wfwd_np(pts), rtol=0,
                               atol=1e-6 * np.abs(frames).max())
    got = _fft_oracle(ring, h, 1, 2.0, tail, pts, frames[0], frames[1], 2)
    want = _oracle_step(ring, h, 1, 2.0, tail, pts, frames[0], frames[1], 2)
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize("pts", [2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048])
@pytest.mark.parametrize("nparts", [1, 3, 256])
def test_twins_match_float64_oracle_at_every_pts(pts, nparts):
    """The FFT-chain twins at every pts the per-block kernels take on the
    main paths, one partition (the zero-latency segments), three, and the
    headline 256; rp at both ring ends, wp2 at both ends."""
    rng = np.random.default_rng(pts + nparts)
    ring, h, tail, blocks = _inputs(rng, nparts, pts)
    frames = _frames64(blocks, pts)
    for rp in sorted({0, nparts - 1}):
        acc, out, ntail, _, _ = _fft_oracle(ring, h, rp, 2.0, tail, pts)
        for g, r in zip(B.block_step_fused(_t(ring), _t(h), rp, 2.0, torch.from_numpy(tail),
                                           pts), (out, ntail)):
            _close(g, r)
        _, out, ntail, x2, _ = _fft_oracle(ring, h, rp, 2.0, tail, pts, fresh_x=frames[0])
        got = B.block_step_fwd_fused(torch.from_numpy(blocks[0]), _t(ring), _t(h), rp, 2.0,
                                     torch.from_numpy(tail), pts)
        for g, r in zip((got[0], got[1], *got[2]), (out, ntail, *x2)):
            _close(g, r)
        for wp2 in sorted({0, nparts - 1}):
            _, out, ntail, x2, hn = _fft_oracle(ring, h, rp, 2.0, tail, pts, frames[0],
                                                frames[1], wp2)
            got = B.block_step_fwd_fused_tv(torch.from_numpy(blocks), _t(ring), _t(h), rp, wp2,
                                            2.0, torch.from_numpy(tail), pts)
            for g, r in zip((got[0], got[1], *got[2], *got[3]), (out, ntail, *x2, *hn)):
                _close(g, r)


@pytest.mark.parametrize("pts", [2, 64, 512])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_twins_match_dense_table_chain(pts, lead):
    """The FFT-chain twins against the JAX kernels' chain in float32 (the
    scans' oracle: ``_dense_frames``, ``_post_ola_plain``, one block)."""
    rng = np.random.default_rng(pts + len(lead))
    ring, h, tail, blocks = _inputs(rng, 3, pts, lead)
    tb = torch.from_numpy(blocks)
    fr, fi = S._dense_frames(tb.reshape(1, -1, pts), pts)
    frames = (fr.reshape(tb.shape), fi.reshape(tb.shape))
    got = B.block_step_fwd_fused_tv(tb, _t(ring), _t(h), 1, 2, 2.0, torch.from_numpy(tail), pts)
    x2 = tuple(B._with_row(p, f[0], 0, 3) for p, f in zip(_t(ring), frames))
    hn = tuple(B._with_row(p, f[1], 2) for p, f in zip(_t(h), frames))
    acc = MAC.spectral_mac_plain(x2, hn, 1, 2.0)
    one = tuple(a.reshape(-1, 1, pts) for a in acc)
    outs, tails = S._post_ola_plain(*one, torch.from_numpy(tail).reshape(-1, pts), pts)
    for g, w in zip((got[0], got[1], *got[2], *got[3]),
                    (outs[0].reshape(tail.shape), tails.reshape(tail.shape), *x2, *hn)):
        _close(g, w.numpy())


@pytest.mark.parametrize("pts", [2, 64, 512, 2048])
def test_one_transform_gives_both_halves(pts):
    """The kernels' inverse transforms U(acc) once: its second half is the
    first half of the transform of U(pm acc), pm = (-1)^k, which the scans'
    chain takes as the next block's tail (``streamstep._fft_post_ola``)."""
    rng = np.random.default_rng(pts)
    acc = tuple(torch.from_numpy(rng.standard_normal((3, pts)).astype(np.float32))
                for _ in range(2))
    tail = torch.from_numpy(rng.standard_normal((3, pts)).astype(np.float32))
    out, new_tail = B._post(acc, tail, pts)
    outs, tails = S._fft_post_ola(acc[0][:, None], acc[1][:, None], tail, pts)
    _close(out, outs[0].numpy(), 1e-6)
    _close(new_tail, tails.numpy(), 1e-6)


def _log2(n):
    return n.bit_length() - 1


@pytest.mark.parametrize("pts", [2 ** k for k in range(1, 15)])
def test_step_plan_tiles_are_ones_the_kernels_take(pts):
    """Both tiles hold 16..2^13 values (one row of 2^14 at pts 2^14): the
    forward 2^11 or one row, the inverse up to 16 rows (a thread a bin)."""
    fwd, inv = B.step_plan(pts)
    for log_b in (fwd, inv):
        values = _log2(pts) + log_b
        assert log_b >= 0 and 4 <= values and (values <= 13 or (values == 14 and log_b == 0))
    assert (pts << fwd) == max(pts, 1 << 11)
    assert 1 << inv == min(16, max(1, (1 << 13) // pts))


PLAN_NPARTS = [1, 3, 8, 255, 256, 1024]
PLAN_BINS = [2, 16, 96, 512, 4096]


@pytest.mark.parametrize("nparts", PLAN_NPARTS)
@pytest.mark.parametrize("bins", PLAN_BINS)
def test_mac_plan_covers_every_partition_and_bin_once(nparts, bins):
    """The one-launch MAC's plan: its slices take every partition once, in
    ascending order, none empty and no more than the cluster's CTAs times
    their thread groups; its tiles take every bin once (``spectral_mac``);
    a cluster the card launches and a CTA of whole warps."""
    plan = MAC.mac_plan(nparts, bins)
    slices = plan_slices(nparts, plan)
    assert [q for q0, q1 in slices for q in range(q0, q1)] == list(range(nparts))
    assert all(q1 > q0 for q0, q1 in slices)
    assert len(slices) <= plan.cluster * plan.ways and plan.cluster * plan.ways * plan.qchunk \
        >= nparts
    assert 1 <= plan.cluster <= MAC.CLUSTER_PORTABLE
    assert plan.tile % 32 == 0 and plan.tile * plan.ways <= MAC.CLUSTER_THREADS
    tiles = plan_tiles(bins, plan, unpack=False)
    assert all(len(t) <= plan.tile for t in tiles)
    assert sorted(k for t in tiles for k in t) == list(range(bins))


@pytest.mark.parametrize("nparts", PLAN_NPARTS)
@pytest.mark.parametrize("bins", PLAN_BINS)
def test_mac_plan_tiles_cover_every_pair_once(nparts, bins):
    """``block_mac_unpack``'s tiles at ``spectral_mac``'s plan: every pair
    k <= M/2 once, with its mirror (M - k) mod M in the same tile, so every
    bin is on chip beside the accumulator its unpack reads; the slices take
    every partition once in ascending order."""
    plan = MAC.mac_plan(nparts, bins)
    tiles = plan_tiles(bins, plan, unpack=True)
    owners = []
    for t in tiles:
        assert len(t) <= plan.tile and len(t) % 2 == 0
        ks, mirrors = t[:len(t) // 2], t[len(t) // 2:]
        assert mirrors == [(bins - k) % bins for k in ks]
        owners += ks
    assert owners == list(range(bins // 2 + 1))
    assert {k for t in tiles for k in t} == set(range(bins))
    slices = plan_slices(nparts, plan)
    assert [q for q0, q1 in slices for q in range(q0, q1)] == list(range(nparts))
    assert len(slices) <= plan.cluster * plan.ways <= MAC.MAC_SLICES
    assert plan.cluster <= MAC.CLUSTER_PORTABLE


def test_mac_plan_takes_no_channel_count():
    """The plan depends on (nparts, bins) only: one channel's bits do not
    depend on how many share the call, and both kernels cut alike."""
    assert list(inspect.signature(MAC.mac_plan).parameters) == ["nparts", "bins"]
    assert MAC.mac_plan(256, 512) == MAC.ClusterPlan(8, 4, 8, 32)
    assert MAC.mac_plan(255, 4096) == MAC.mac_plan(256, 4096) == MAC.ClusterPlan(8, 2, 16, 128)


@pytest.mark.parametrize("pts", [1, 24, 1 << 15])
def test_card_route_takes_power_of_two_pts_up_to_2_14(pts):
    with pytest.raises(ValueError, match="power-of-two pts in \\[2, 16384\\]"):
        B._card_tables("block_step_fused", pts, False, torch.device("cpu"))


def test_twin_outputs_are_contiguous_and_inputs_untouched():
    rng = np.random.default_rng(5)
    ring, h, tail, blocks = _inputs(rng, 4, 16, (3,))
    args = (_t(ring), _t(h))
    before = [p.clone() for p in (*args[0], *args[1])]
    got = B.block_step_fwd_fused_tv(torch.from_numpy(blocks), *args, 1, 2, 2.0,
                                    torch.from_numpy(tail), 16)
    for t in (got[0], got[1], *got[2], *got[3]):
        assert t.is_contiguous()
    for b, a in zip(before, (*args[0], *args[1])):
        assert torch.equal(b, a)


def test_wrappers_validate_arguments():
    z = torch.zeros
    ring, h = (z(8, 16), z(8, 16)), (z(4, 16), z(4, 16))
    with pytest.raises(ValueError, match="rp must be an int in \\[0, 4\\)"):
        MAC.spectral_mac(ring, h, 4, 1.0)
    with pytest.raises(ValueError, match="doubled-ring planes"):
        MAC.spectral_mac((z(4, 16), z(4, 16)), h, 0, 1.0)
    with pytest.raises(ValueError, match="bins \\(16\\) must equal pts \\(8\\)"):
        B.block_step_fused(ring, h, 0, 1.0, z(8), 8)
    with pytest.raises(ValueError, match="tail must be"):
        B.block_step_fused(ring, h, 0, 1.0, z(3, 16), 16)
    with pytest.raises(ValueError, match="block must be"):
        B.block_step_fwd_fused(z(8), ring, h, 0, 1.0, z(16), 16)
    with pytest.raises(ValueError, match="wp2 must be an int"):
        B.block_step_fwd_fused_tv(z(2, 16), ring, h, 0, 4, 1.0, z(16), 16)
    meta = torch.zeros((8, 16), device="meta")
    with pytest.raises(ValueError, match="one device"):
        B.block_step_fused((meta, meta), h, 0, 1.0, z(16), 16)


# ---------------------------------------------------------------------------
# the card route, composed from the twins, against JAX's blockf route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tv", [False, True])
def test_card_route_streams_like_jax_blockf(tv):
    """20 blocks through ``_step_fused`` / ``_step_tv_fused`` (the route
    pconv_step{,_tv} take on a card) against JAX's pconv_step{,_tv} with
    pallas="blockf" (its fused block-step kernels in interpret mode), the
    port's state chained through every block."""
    pts, nparts, nblocks = 128, 8, 20
    rng = np.random.default_rng(40 + tv)
    jcfg = J.PconvConfig(pts=pts, nparts=nparts, pallas="blockf")
    cfg = P.PconvConfig(pts=pts, nparts=nparts)
    assert jcfg._use_pallas_blockstep_fwd()
    ir = (0.2 * rng.standard_normal(cfg.cvs)).astype(np.float32)
    blocks = rng.standard_normal((nblocks, pts)).astype(np.float32)
    coefs = (0.3 * rng.standard_normal((nblocks, pts))).astype(np.float32)
    js = J.push_ir(jcfg, J.pconv_init(jcfg), ir)
    ts = P.push_ir(cfg, P.pconv_init(cfg, "cpu"), torch.from_numpy(ir))
    jo, to = [], []
    for b, c in zip(blocks, coefs):
        if tv:
            js, o = J.pconv_step_tv(jcfg, js, b, c)
            ts, g = P._step_tv_fused(cfg, ts, torch.from_numpy(b), torch.from_numpy(c))
        else:
            js, o = J.pconv_step(jcfg, js, b)
            ts, g = P._step_fused(cfg, ts, torch.from_numpy(b))
        jo.append(np.asarray(o))
        to.append(g.numpy())
    _close(np.concatenate(to), np.concatenate(jo), 2e-5)
    for name in ("spec_x_re", "spec_x_im", "spec_h_re", "spec_h_im", "tail"):
        _close(getattr(ts, name), getattr(js, name), 2e-5)
    assert (ts.wp, ts.wp2) == (int(js.wp), int(js.wp2))


def test_block_kernels_shape_rule():
    """On a card the per-block functions launch the kernels up to pts =
    2048 (the JAX package's routing; above it block_mac_unpack's route);
    beyond, and on the CPU, the plain composition."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert P._block_kernels(P.PconvConfig(pts=2048, nparts=2), cuda)
    assert not P._block_kernels(P.PconvConfig(pts=4096, nparts=2), cuda)
    assert not P._block_kernels(P.PconvConfig(pts=512, nparts=2), cpu)
    cfg = P.PconvConfig(pts=16, nparts=4)
    st = P.pconv_init(cfg, "cpu")
    before = (B.FWD_LAUNCHES, B.FWD_TV_LAUNCHES, B.STEP_LAUNCHES, MAC.LAUNCHES)
    st, _ = P.pconv_step(cfg, st, torch.ones(16))
    P.pconv_step_tv(cfg, st, torch.ones(16), torch.ones(16))
    assert (B.FWD_LAUNCHES, B.FWD_TV_LAUNCHES, B.STEP_LAUNCHES, MAC.LAUNCHES) == before
    vec = st._replace(wp=(1, 1))
    with pytest.raises(ValueError, match="shared by every channel"):
        P._step_fused(cfg, vec, torch.ones(16))


# ---------------------------------------------------------------------------
# the CUDA kernels against the twins on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the block-step kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on(planes, dev):
    return tuple(p.to(dev) for p in planes)


@pytest.mark.cuda
@pytest.mark.parametrize("nparts,bins,lead", [(3, 16, ()), (3, 16, (3,)), (256, 512, ()),
                                              (256, 512, (5,))])
def test_cuda_kernels_match_twins(cuda_device, nparts, bins, lead):
    rng = np.random.default_rng(nparts + len(lead))
    ring, h, tail, blocks = _inputs(rng, nparts, bins, lead)
    ring_d, h_d = _on(_t(ring), cuda_device), _on(_t(h), cuda_device)
    tail_d = torch.from_numpy(tail).to(cuda_device)
    blocks_d = torch.from_numpy(blocks).to(cuda_device)
    for rp in sorted({0, 1, nparts - 1}):
        for b0 in (1.0, 2.0):
            pairs = [(MAC.spectral_mac(ring_d, h_d, rp, b0),
                      MAC.spectral_mac_plain(ring_d, h_d, rp, b0)),
                     (B.block_step_fused(ring_d, h_d, rp, b0, tail_d, bins),
                      B.block_step_fused_plain(ring_d, h_d, rp, b0, tail_d, bins))]
            got = B.block_step_fwd_fused(blocks_d[0], ring_d, h_d, rp, b0, tail_d, bins)
            want = B.block_step_fwd_fused_plain(blocks_d[0], ring_d, h_d, rp, b0, tail_d, bins)
            pairs.append(((got[0], got[1], *got[2]), (want[0], want[1], *want[2])))
            for wp2 in sorted({0, nparts - 1}):
                got = B.block_step_fwd_fused_tv(blocks_d, ring_d, h_d, rp, wp2, b0, tail_d,
                                                bins)
                want = B.block_step_fwd_fused_tv_plain(blocks_d, ring_d, h_d, rp, wp2, b0,
                                                       tail_d, bins)
                pairs.append(((got[0], got[1], *got[2], *got[3]),
                              (want[0], want[1], *want[2], *want[3])))
            torch.cuda.synchronize()
            for gs, ws in pairs:
                for g, w in zip(gs, ws):
                    assert g.is_contiguous()
                    _close(g, w.cpu(), 2e-5)


def _flat(outputs):
    """A step's (out, new_tail, *rings) as a list of tensors."""
    return [outputs[0], outputs[1], *(t for ring in outputs[2:] for t in ring)]


@pytest.mark.cuda
@pytest.mark.parametrize("nparts,pts,lead", [(1, 2, ()), (3, 64, (3,)), (1, 2048, ()),
                                             (256, 2048, ()), (8, 4096, ()), (2, 16384, ()),
                                             (3, 16384, (2,)), (256, 512, (64,))])
def test_cuda_steps_match_twins_at_every_tile_shape(cuda_device, nparts, pts, lead):
    """The transform kernels at the ends of their range (pts 2, 2^14) and
    at the main paths' shapes: within 2e-5 of the twins, bit-equal on a
    second launch, and the fused step's output bit-equal to
    ``block_step_fused`` on the ring it wrote (a crossfade's two paths)."""
    rng = np.random.default_rng(nparts + pts)
    ring, h, tail, blocks = _inputs(rng, nparts, pts, lead)
    ring_d, h_d = _on(_t(ring), cuda_device), _on(_t(h), cuda_device)
    tail_d = torch.from_numpy(tail).to(cuda_device)
    blocks_d = torch.from_numpy(blocks).to(cuda_device)
    rp, wp2 = 1 % nparts, nparts - 1
    for kern, plain in (
            (lambda: B.block_step_fused(ring_d, h_d, rp, 2.0, tail_d, pts),
             lambda: B.block_step_fused_plain(ring_d, h_d, rp, 2.0, tail_d, pts)),
            (lambda: B.block_step_fwd_fused(blocks_d[0], ring_d, h_d, rp, 2.0, tail_d, pts),
             lambda: B.block_step_fwd_fused_plain(blocks_d[0], ring_d, h_d, rp, 2.0, tail_d,
                                                  pts)),
            (lambda: B.block_step_fwd_fused_tv(blocks_d, ring_d, h_d, rp, wp2, 2.0, tail_d, pts),
             lambda: B.block_step_fwd_fused_tv_plain(blocks_d, ring_d, h_d, rp, wp2, 2.0,
                                                     tail_d, pts))):
        got, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        for g, a, w in zip(_flat(got), _flat(again), _flat(want)):
            assert g.is_contiguous() and torch.equal(g, a)
            _close(g, w.cpu(), 2e-5)
    out, new_tail, x2 = B.block_step_fwd_fused(blocks_d[0], ring_d, h_d, rp, 2.0, tail_d, pts)
    out2, tail2 = B.block_step_fused(x2, h_d, rp, 2.0, tail_d, pts)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(new_tail, tail2)


@pytest.mark.cuda
@pytest.mark.parametrize("nparts,bins,lead", [(1, 64, ()), (3, 16, ()), (5, 96, (3,)),
                                              (7, 100, ()), (255, 4096, ()), (256, 512, ()),
                                              (300, 33, (2,))])
def test_cuda_spectral_mac_one_launch_matches_twin(cuda_device, nparts, bins, lead):
    """The one-launch MAC at nparts below the cluster size, odd bins and the
    main paths' shapes: within 3e-6 of the twin and bit-equal on a second
    launch."""
    rng = np.random.default_rng(nparts * bins + len(lead))
    ring, h, _, _ = _inputs(rng, nparts, bins, lead)
    ring_d, h_d = _on(_t(ring), cuda_device), _on(_t(h), cuda_device)
    for rp in sorted({0, 1 % nparts, nparts - 1}):
        for b0 in (1.0, 2.0):
            before = MAC.LAUNCHES
            got = MAC.spectral_mac(ring_d, h_d, rp, b0)
            again = MAC.spectral_mac(ring_d, h_d, rp, b0)
            want = MAC.spectral_mac_plain(ring_d, h_d, rp, b0)
            torch.cuda.synchronize()
            assert MAC.LAUNCHES == before + 2
            for g, a, w in zip(got, again, want):
                assert g.is_contiguous() and torch.equal(g, a)
                _close(g, w.cpu(), 3e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("nparts,bins", [(256, 512), (3, 16)])
def test_cuda_spectral_mac_channel_independent(cuda_device, nparts, bins):
    """Channel c of a 16-channel call is bit-equal to the same ring alone
    (no channel axis and a channel axis of 1)."""
    rng = np.random.default_rng(nparts + bins)
    ring, h, _, _ = _inputs(rng, nparts, bins, (16,))
    ring_d, h_d = _on(_t(ring), cuda_device), _on(_t(h), cuda_device)
    many = MAC.spectral_mac(ring_d, h_d, 1 % nparts, 2.0)
    for c in (0, 7, 15):
        ring_c = tuple(p[c].contiguous() for p in ring_d)
        h_c = tuple(p[c].contiguous() for p in h_d)
        alone = MAC.spectral_mac(ring_c, h_c, 1 % nparts, 2.0)
        one = MAC.spectral_mac(tuple(p[None] for p in ring_c), tuple(p[None] for p in h_c),
                               1 % nparts, 2.0)
        torch.cuda.synchronize()
        for m_, a, o in zip(many, alone, one):
            assert torch.equal(m_[c], a) and torch.equal(m_[c], o[0])
