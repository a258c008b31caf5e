"""Port parity: the whole-scan LTI stream kernel.

The plain twin ``stream_steps_fused_plain`` is held against the JAX Pallas
kernel ``stream_steps_fused`` run in interpret mode on the same inputs
(outputs and tail atol 2e-5 * max|ref|, the JAX package's own stream-vs-scan
tolerance; final window atol 1e-5 * max|w|). The CUDA kernel is held
against the twin on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_fft_tpu.ops.pallas import blockstep as jblock
from opencl_fft_tpu.ops.pallas.streamstep import \
    stream_steps_fused as jax_stream_steps_fused
from opencl_fft_tpu_torch.ops.cuda import streamstep as S
from opencl_fft_tpu_torch.ops.cuda import tables as T

torch.set_num_threads(1)


def _inputs(seed, pts, nparts, nb):
    rng = np.random.default_rng(seed)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return dict(blocks=f(nb, pts), w0r=f(nparts, pts), w0i=f(nparts, pts),
                hr=0.2 * f(nparts, pts), hi=0.2 * f(nparts, pts), tail=f(pts))


def _run_plain(d, b0, pts, fn=S.stream_steps_fused_plain, device="cpu"):
    t = {k: torch.from_numpy(v).to(device) for k, v in d.items()}
    outs, (wr, wi), tail = fn(t["blocks"], (t["w0r"], t["w0i"]),
                              (t["hr"], t["hi"]), b0, t["tail"], pts)
    return [x.cpu().numpy() for x in (outs, wr, wi, tail)]


def _assert_stream_close(got, ref):
    outs, wr, wi, tail = got
    r_outs, r_wr, r_wi, r_tail = (np.asarray(x) for x in ref)
    np.testing.assert_allclose(outs, r_outs, atol=2e-5 * np.abs(r_outs).max(), rtol=0)
    np.testing.assert_allclose(tail, r_tail, atol=2e-5 * np.abs(r_tail).max(), rtol=0)
    wscale = max(np.abs(r_wr).max(), np.abs(r_wi).max())
    np.testing.assert_allclose(wr, r_wr, atol=1e-5 * wscale, rtol=0)
    np.testing.assert_allclose(wi, r_wi, atol=1e-5 * wscale, rtol=0)


@pytest.mark.parametrize("pts,nparts", [(64, 4), (64, 8), (128, 4), (128, 8)])
@pytest.mark.parametrize("nb", [8, 16])
@pytest.mark.parametrize("b0", [1.0, 2.0])
def test_plain_twin_matches_pallas_kernel(pts, nparts, nb, b0):
    d = _inputs(pts + nparts + nb, pts, nparts, nb)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    outs, (wr, wi), tail = jax_stream_steps_fused(
        j["blocks"], (j["w0r"], j["w0i"]), (j["hr"], j["hi"]), b0, j["tail"],
        pts, interpret=True)
    _assert_stream_close(_run_plain(d, b0, pts), (outs, wr, wi, tail))


@pytest.mark.parametrize("pts", [8, 64, 512])
def test_tables_bit_identical_to_jax(pts):
    np.testing.assert_array_equal(T._wfwd_np(pts), jblock._wfwd_np(pts))
    np.testing.assert_array_equal(T._wpost_np(pts), jblock._wpost_np(pts))
    for fwd in (True, False):
        np.testing.assert_array_equal(T._pack_matrix_np(pts, fwd),
                                      jblock._pack_matrix_np(pts, fwd))


def test_library_path_hashes_shared_headers(tmp_path, monkeypatch):
    """An edit to a shared csrc/*.cuh header names a new library, so a
    stale build is never reused."""
    from opencl_fft_tpu_torch.ops.cuda import _build

    (tmp_path / "k.cu").write_text('#include "tile.cuh"\n')
    (tmp_path / "tile.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    (tmp_path / "tile.cuh").write_text("// v2\n")
    second = _build.library_path("k")
    assert second != first
    (tmp_path / "other.cuh").write_text("\n")
    assert _build.library_path("k") not in (first, second)
    assert first.parent == second.parent == _build.BUILD_DIR


def test_wrapper_runs_twin_on_cpu_without_counting():
    d = _inputs(1, 16, 3, 5)
    before = S.BATCHED_LAUNCHES
    got = _run_plain(d, 2.0, 16, fn=S.stream_steps_fused)
    want = _run_plain(d, 2.0, 16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert S.BATCHED_LAUNCHES == before


def test_wrapper_checks_arguments():
    z = torch.zeros
    w = (z(4, 16), z(4, 16))
    with pytest.raises(ValueError, match="blocks"):
        S.stream_steps_fused(z(16), w, w, 1.0, z(16), 16)
    with pytest.raises(ValueError, match="blocks"):
        S.stream_steps_fused(z(0, 16), w, w, 1.0, z(16), 16)
    with pytest.raises(ValueError, match="tail"):
        S.stream_steps_fused(z(2, 16), w, w, 1.0, z(8), 16)
    with pytest.raises(ValueError, match="w0 im"):
        S.stream_steps_fused(z(2, 16), (z(4, 16), z(3, 16)), w, 1.0, z(16), 16)
    meta = torch.zeros((2, 16), device="meta")
    with pytest.raises(ValueError, match="one device"):
        S.stream_steps_fused(meta, w, w, 1.0, z(16), 16)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("pts,nparts,nb", [(2, 3, 5), (4, 1, 2), (8, 9, 200), (64, 37, 70),
                                           (128, 3, 130), (256, 63, 65), (1024, 16, 129),
                                           (2048, 64, 470)])
def test_cuda_kernel_matches_twin_at_edge_shapes(cuda_device, pts, nparts, nb):
    """nb not a multiple of a MAC tile, nparts below MAC_TT and not a
    multiple of a stage, pts 2..2048: kernel against twin, and the same
    bits from a second launch."""
    d = _inputs(9 * nb + nparts, pts, nparts, nb)
    got = _run_plain(d, 2.0, pts, fn=S.stream_steps_fused, device=cuda_device)
    again = _run_plain(d, 2.0, pts, fn=S.stream_steps_fused, device=cuda_device)
    assert all(np.array_equal(a, b) for a, b in zip(got, again))
    _assert_stream_close(got, _run_plain(d, 2.0, pts, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("pts,nparts,nb", [(16, 1, 1), (64, 5, 21), (128, 8, 16),
                                           (512, 256, 40)])
@pytest.mark.parametrize("b0", [1.0, 2.0])
def test_cuda_kernel_matches_twin(cuda_device, pts, nparts, nb, b0):
    d = _inputs(7 * nb + nparts, pts, nparts, nb)
    before = S.BATCHED_LAUNCHES
    got = _run_plain(d, b0, pts, fn=S.stream_steps_fused, device=cuda_device)
    torch.cuda.synchronize()
    assert S.BATCHED_LAUNCHES == before + 1
    want = _run_plain(d, b0, pts, device=cuda_device)
    _assert_stream_close(got, want)


# ---------------------------------------------------------------------------
# the FFT-chain twin at every pts the engine runs through these wrappers
# ---------------------------------------------------------------------------

PTS_ALL = [2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048]
B0 = [pytest.param(1.0, id="compat"), pytest.param(2.0, id="exact")]


@pytest.mark.parametrize("pts", PTS_ALL)
@pytest.mark.parametrize("b0", B0)
def test_fft_twin_matches_pallas_kernel_at_every_pts(pts, b0):
    """The twin's chains are FFT-sized (``_fft_frames``, ``_fft_post_ola``);
    the JAX kernel's are dense DFT products: same scan within 2e-5."""
    nparts, nb = 3, 8
    d = _inputs(3 * pts + int(b0), pts, nparts, nb)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    outs, (wr, wi), tail = jax_stream_steps_fused(
        j["blocks"], (j["w0r"], j["w0i"]), (j["hr"], j["hi"]), b0, j["tail"],
        pts, interpret=True)
    _assert_stream_close(_run_plain(d, b0, pts), (outs, wr, wi, tail))


# ---------------------------------------------------------------------------
# the kernels' plans: every row, output, bin and partition exactly once
# ---------------------------------------------------------------------------

def _tile_rows(pts, rows, seqs, log_b):
    """Rows each CTA of the transform kernels takes: seqs x cdiv(rows, B)
    CTAs of B = 2^log_b rows, the ones past a sequence's end idle."""
    b = 1 << log_b
    return [[(s, r) for r in range(i * b, min((i + 1) * b, rows))]
            for s in range(seqs) for i in range(-(-rows // b))]


@pytest.mark.parametrize("pts,rows,seqs", [
    (512, 1880, 1), (512, 1881, 1), (512, 470 * 64, 1), (512, 471, 64), (64, 63, 1),
    (128, 4, 3), (2, 5, 1), (2, 1, 1), (4, 1, 1), (2048, 117 * 64, 1), (2048, 118, 64),
    (1 << 13, 10, 2), (1 << 14, 3, 1), (1 << 15, 3, 2)])
def test_fft_tile_plan_covers_every_row_once(pts, rows, seqs):
    log_b = S.fft_tile_log_b(pts, rows, seqs)
    log_l = pts.bit_length() - 1
    if log_l > 14:
        assert log_b == 0                          # the four-step takes no tile plan
        return
    values = 1 << (log_l + log_b)
    assert 16 <= values <= (1 << 14 if log_l == 14 else 1 << 13)
    ctas = _tile_rows(pts, rows, seqs, log_b)
    covered = [sr for cta in ctas for sr in cta]
    assert sorted(covered) == [(s, r) for s in range(seqs) for r in range(rows)]
    assert all(ctas)                               # no CTA without a row
    # the grid fills the card (a CTA an SM of 132) unless a CTA is already
    # down to a warp or to one row
    assert len(ctas) >= 132 or values <= 512 or log_b == 0 or log_l + log_b <= 4


MAC_SHAPES = [
    # (C, nb, bins, nparts): serving, headline, cell 12, nb not a multiple of
    # G * MAC_TT, nparts < MAC_TT, nparts not a multiple of the stage
    (64, 470, 512, 256), (1, 1880, 512, 256), (1, 470, 4096, 256), (16, 470, 4096, 256),
    (3, 21, 64, 5), (2, 70, 64, 37), (1, 130, 128, 3), (3, 65, 256, 63), (4, 9, 32, 7),
    (1, 1, 16, 1), (2, 3, 128, 8), (1, 200, 8, 9), (64, 8, 512, 256), (1, 40, 64, 2048),
    # the LTI sliding MAC's tiled route (nb = its outputs): the 16-channel
    # render, bins not a multiple of 32, few partitions
    (16, 470, 512, 256), (2, 300, 100, 70), (1, 70, 33, 5)]


def _mac_cover(plan, nb, bins, nparts):
    """The tiled MAC's loops as ``csrc/scan_mac.cuh`` runs them (the grid is
    a product of output tiles, bin tiles and channels): the outputs t <
    nb of every (CTA, warp, j), the bins k < bins of every (CTA, lane), the
    partitions in the order the stages reach them, and per stage the ring
    slots of the rows the CTA reads and of the rows the next stage writes
    while it does."""
    T, q = plan.outs, plan.q
    outs = [t for bx in range(-(-nb // T)) for g in range(plan.groups)
            for j in range(plan.tt) for t in (bx * T + g * plan.tt + j,) if t < nb]
    bins_ = [k for by in range(-(-bins // S.TILE_BINS)) for lane in range(S.TILE_BINS)
             for k in (by * S.TILE_BINS + lane,) if k < bins]
    chunks = -(-nparts // q)
    parts = [ch * q + u for ch in range(chunks) for u in range(min(q, nparts - ch * q))]
    rings = []
    for ch in range(chunks):
        q0, qn = ch * q, min(q, nparts - ch * q)
        read = range(q0, q0 + qn + T - 1)           # window rows gt + q + j
        written = range(0)
        if ch + 1 < chunks:
            q1 = q0 + q
            written = range(q1 + T - 1, q1 + min(q, nparts - q1) + T - 1)
        rings.append(({r % plan.ring for r in read}, {r % plan.ring for r in written},
                      len(read)))
    return outs, bins_, parts, rings


@pytest.mark.parametrize("nch,nb,bins,nparts", MAC_SHAPES)
@pytest.mark.parametrize("tv", [False, True])
def test_mac_plan_covers_every_output_bin_and_partition_once(nch, nb, bins, nparts, tv):
    plan = S.mac_plan(nch, nb, bins, nparts, tv)
    # what the CUDA entries check (MacPlan::ok) even where the plan goes
    # unused (a TV scan below MAC_TT partitions runs the per-thread MAC)
    assert 1 <= plan.groups <= S.TILE_MAX_GROUPS and plan.tt in (S.MAC_TT, S.TILE_TT_MAX)
    assert plan.q % plan.tt == 0
    assert plan.ring & (plan.ring - 1) == 0 and plan.ring >= 2 * plan.q + plan.outs - 1
    if tv and nparts < S.MAC_TT:
        return
    if tv:
        assert plan.outs <= nparts
    outs, bins_, parts, rings = _mac_cover(plan, nb, bins, nparts)
    assert outs == list(range(nb)) and bins_ == list(range(bins))
    assert parts == list(range(nparts))             # each once, ascending
    for read, written, nread in rings:
        assert len(read) == nread                  # no two live rows share a slot
        assert not read & written                  # the next stage lands beside them
