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


def test_post_ola_table_is_wpost_halves_swapped():
    w = T._wpost_np(16)
    w2 = T.post_ola_table(16, torch.device("cpu")).numpy()
    np.testing.assert_array_equal(w2[:32], w[:, 16:])
    np.testing.assert_array_equal(w2[32:], w[:, :16])


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
    before = S.LAUNCHES
    got = _run_plain(d, 2.0, 16, fn=S.stream_steps_fused)
    want = _run_plain(d, 2.0, 16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert S.LAUNCHES == before


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
@pytest.mark.parametrize("pts,nparts,nb", [(16, 1, 1), (64, 5, 21), (128, 8, 16),
                                           (512, 256, 40)])
@pytest.mark.parametrize("b0", [1.0, 2.0])
def test_cuda_kernel_matches_twin(cuda_device, pts, nparts, nb, b0):
    d = _inputs(7 * nb + nparts, pts, nparts, nb)
    before = S.LAUNCHES
    got = _run_plain(d, b0, pts, fn=S.stream_steps_fused, device=cuda_device)
    torch.cuda.synchronize()
    assert S.LAUNCHES == before + 1
    want = _run_plain(d, b0, pts, device=cuda_device)
    _assert_stream_close(got, want)
