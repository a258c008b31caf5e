"""Port parity: the distributed single-transform FFT of
opencl_fft_tpu_torch.parallel.dist_fft (all_to_all transposes over gloo
ranks on the CPU) against opencl_fft_tpu.parallel.dist_fft on the 8 virtual
CPU devices, numpy and the single-device FFT, on the same inputs.

Every case of tests/test_parallel.py's TestDistFFT has a counterpart, at
d = 8 (mesh (1, 8) over tp) and d = 4 (over tp of (2, 4) and over dp of
(4, 2)): a transpose in the wrong order shows only at d > 1. One group of 8
ranks, spawned once for the module, runs every case (tests/
test_torch_ranks.py). Bounds are the JAX tests': 3e-5 of max|ref| against
numpy, 2e-5 against the single-device FFT and for the round trip.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import test_torch_ranks as R
from opencl_fft_tpu.ops.fft import fft_unnormalized as jax_fft_unnormalized
from opencl_fft_tpu.parallel import dist_fft as JDF
from opencl_fft_tpu.parallel.mesh import make_mesh as jax_mesh
from opencl_fft_tpu_torch.ops.fft import fft_unnormalized
from opencl_fft_tpu_torch.parallel import Mesh, dist_fft
from opencl_fft_tpu_torch.parallel.dist_fft import _factor_for_mesh
from opencl_fft_tpu_torch.parallel.dryrun import run_ranks

torch.set_num_threads(1)

D_MESHES = [((1, 8), "tp"), ((2, 4), "tp"), ((4, 2), "dp")]


def _c(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _inputs():
    rng = np.random.default_rng(13)
    return {"n10": _c(rng, 1 << 10), "n14": _c(rng, 1 << 14), "batch": _c(rng, 3, 4096),
            "single": _c(rng, 8192), "d": _c(rng, 2, 1 << 12)}


@pytest.fixture(scope="module")
def ranks():
    """One group of 8 gloo ranks runs every case: {case: [per-rank result]}."""
    inp = _inputs()
    cases = [(f"n{k}", "dist_fft_case", ((1, 8), "tp", inp[f"n{k}"], -1)) for k in (10, 14)]
    cases += [("single", "dist_fft_case", ((1, 8), "tp", inp["single"], -1))]
    cases += [("fwd", "dist_fft_case", ((1, 8), "tp", inp["batch"], -1))]
    fwd = np.fft.fft(inp["batch"]).astype(np.complex64)
    cases += [("back", "dist_fft_case", ((1, 8), "tp", fwd, +1))]
    cases += [(("d", s, a), "dist_fft_case", (s, a, inp["d"], -1)) for s, a in D_MESHES]
    x = inp["batch"]
    cases += [("split", "dist_fft_split_case", ((1, 8), "tp", x.real.copy(), x.imag.copy()))]
    per_rank = run_ranks(8, R.run_cases, cases, timeout=600)
    return {name: [r[name] for r in per_rank] for name, _, _ in cases}


def _jax_dist_fft(x, shape=(1, 8), axis="tp", sign=-1):
    return np.asarray(JDF.dist_fft(x, jax_mesh(shape), axis=axis, sign=sign))


def _close(got, ref, tol):
    np.testing.assert_allclose(got, ref, atol=tol * np.max(np.abs(ref)), rtol=0)


def _every_rank(results):
    """dist_fft returns the whole spectrum on every rank: all equal."""
    for r in results[1:]:
        assert np.array_equal(r["y"], results[0]["y"])
    return results[0]["y"]


@pytest.mark.parametrize("k", [10, 14])
def test_matches_numpy(ranks, k):
    x = _inputs()[f"n{k}"]
    got = _every_rank(ranks[f"n{k}"])
    ref = np.fft.fft(x)
    _close(got, ref, 3e-5)
    _close(got, _jax_dist_fft(x), 3e-5)


def test_inverse_and_batch(ranks):
    x = _inputs()["batch"]
    fwd = _every_rank(ranks["fwd"])
    _close(fwd, np.fft.fft(x), 3e-5)
    back = _every_rank(ranks["back"]) / 4096
    _close(back, x, 2e-5)
    _close(back * 4096, _jax_dist_fft(np.fft.fft(x).astype(np.complex64), sign=+1), 2e-5)


def test_matches_single_device_fft(ranks):
    x = _inputs()["single"]
    got = _every_rank(ranks["single"])
    _close(got, fft_unnormalized(torch.from_numpy(x), -1).numpy(), 2e-5)
    _close(got, np.asarray(jax_fft_unnormalized(x, -1)), 2e-5)


@pytest.mark.parametrize("shape,axis", D_MESHES)
def test_four_ranks_over_either_axis(ranks, shape, axis):
    """d = 4 over tp and over dp (the other axis's ranks repeat the work),
    and d = 8: the transposes land every element at its natural index."""
    x = _inputs()["d"]
    got = _every_rank(ranks[("d", shape, axis)])
    _close(got, np.fft.fft(x), 3e-5)
    _close(got, _jax_dist_fft(x, shape, axis), 3e-5)


def test_three_all_to_alls_a_transform(ranks):
    """Each transform is three transposes, one all_to_all each (re and im
    travel together), on every rank."""
    for name in ("n10", "n14", "single", "fwd", "back"):
        assert all(r["all_to_alls"] == 3 for r in ranks[name]), name


def test_split_blocks_assemble_in_natural_order(ranks):
    """dist_fft_split on each rank's block: rank i holds spectrum elements
    [i n/8, (i+1) n/8) of every batch row."""
    x = _inputs()["batch"]
    res = sorted(ranks["split"], key=lambda r: r["block"].start)
    got = np.concatenate([r["re"] + 1j * r["im"] for r in res], -1)
    _close(got, np.fft.fft(x), 3e-5)


def test_rejects_unshardable():
    mesh = Mesh(shape={"dp": 1, "tp": 8}, coords={"dp": 0, "tp": 0}, groups={},
                device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError):
        dist_fft(np.zeros(8, np.complex64), mesh, axis="tp")
    with pytest.raises(ValueError):
        dist_fft(np.zeros(96, np.complex64), mesh, axis="tp")


@pytest.mark.parametrize("n,d", [(1 << 10, 8), (1 << 14, 8), (1 << 12, 4), (1 << 20, 1),
                                 (64, 8), (1 << 11, 2)])
def test_factors_match_jax(n, d):
    assert _factor_for_mesh(n, d) == JDF._factor_for_mesh(n, d)
    assert len(jax.devices()) >= 8
