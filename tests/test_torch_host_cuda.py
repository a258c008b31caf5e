"""The host layer on a card (no JAX in this file: the card's tests compare
with the port's own plain routes). Skipped without a card: the
real-time pipeline's worker launches ``block_step_fwd_fused{,_tv}`` once a
block and its output after the priming is the card's own step chain bit
for bit; ``dryrun_multichip(4)`` runs with its defaults on one card (gloo
ranks sharing it). Without a card the pipeline refuses to start
(DeviceError), the port's device rule."""

import shutil

import numpy as np
import pytest
import torch

from opencl_fft_tpu_torch.ops import pconv as P
from opencl_fft_tpu_torch.parallel import balanced_shape, dryrun_multichip
from opencl_fft_tpu_torch.runtime.pipeline import RealtimePipeline
from opencl_fft_tpu_torch.utils.errors import DeviceError

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ on PATH")

RNG = np.random.default_rng(12)


def _run(pipe, pushes, nblocks, prime, tv=False):
    with pipe:
        for blk in pushes:
            if tv:
                pipe.push(*blk)
            else:
                pipe.push(blk)
        pipe.wait_for_blocks(nblocks, timeout=120)
        got = pipe.pull((prime + nblocks) * pipe.block)
    assert pipe.underrun_samples == 0 and pipe.overrun_samples == 0
    np.testing.assert_array_equal(got[: prime * pipe.block], 0.0)
    return got[prime * pipe.block:]


def test_pipeline_defaults_to_the_card():
    """The pipeline's engine runs on the card unless the caller asks for the
    CPU: without a card, DeviceError."""
    if torch.cuda.is_available():
        pytest.skip("checks the machine without a card")
    with pytest.raises(DeviceError):
        RealtimePipeline(P.PconvConfig.for_ir_length(64 * 4, 64))


@pytest.mark.cuda
@pytest.mark.parametrize("tv", [False, True])
def test_pipeline_on_the_card_launches_the_block_step(tv):
    """On a card the worker thread runs each block through one
    block_step_fwd_fused{,_tv} launch: the launch count equals the blocks,
    and the output after the priming is the card's own step chain bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the block-step kernels have no CPU mode)")
    from opencl_fft_tpu_torch.ops.cuda import blockstep as BS

    cfg = P.PconvConfig.for_ir_length(512 * 16, 512)
    nblocks, prime = 30, 2
    ir = RNG.standard_normal(cfg.cvs).astype(np.float32) * 0.1
    bx = RNG.standard_normal((nblocks, 512)).astype(np.float32)
    bh = RNG.standard_normal((nblocks, 512)).astype(np.float32)
    dev = torch.device("cuda")
    st = P.pconv_init(cfg, dev)
    if not tv:
        st = P.push_ir(cfg, st, torch.from_numpy(ir).to(dev))
    own = []
    for i in range(nblocks):
        x = torch.from_numpy(bx[i]).to(dev)
        st, o = (P.pconv_step_tv(cfg, st, x, torch.from_numpy(bh[i]).to(dev)) if tv
                 else P.pconv_step(cfg, st, x))
        own.append(o.cpu().numpy())
    n0 = BS.FWD_TV_LAUNCHES if tv else BS.FWD_LAUNCHES
    pipe = RealtimePipeline(cfg, ir=None if tv else ir, tv=tv, prime_blocks=prime)
    got = _run(pipe, list(zip(bx, bh)) if tv else list(bx), nblocks, prime, tv=tv)
    n1 = BS.FWD_TV_LAUNCHES if tv else BS.FWD_LAUNCHES
    assert n1 - n0 == nblocks
    np.testing.assert_array_equal(got, np.concatenate(own))


@pytest.mark.cuda
def test_dryrun_multichip_defaults_share_one_card():
    """On a machine with a card, dryrun_multichip(4) runs with its defaults:
    four gloo ranks share the cards when there are fewer than four."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    got = dryrun_multichip(4)
    assert got["shape"] == balanced_shape(4)
    assert got["err"] <= 1e-4 * got["scale"]
    assert got["dist_fft_err"] <= 3e-5
