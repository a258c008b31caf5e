"""Port parity: the Clpconv class and the ClconvProcessor opcode layer of
opencl_fft_tpu_torch against opencl_fft_tpu, the error surface, and the
rule that the port never imports JAX or the JAX package."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import signal as sps

from opencl_fft_tpu import api as japi
from opencl_fft_tpu import stream as jstream
from opencl_fft_tpu_torch import api as tapi
from opencl_fft_tpu_torch import stream as tstream
from opencl_fft_tpu_torch.ops import pconv as tpconv
from opencl_fft_tpu_torch.utils.devices import get_device
from opencl_fft_tpu_torch.utils.errors import DeviceError, SizeError, Status

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _quiet(msg, user_data):
    pass


@pytest.mark.parametrize("bin0_mode", ["exact", "compat"])
def test_clpconv_matches_jax(bin0_mode):
    cvs, pts = 256, 64
    rng = np.random.default_rng(1)
    ir = rng.standard_normal(cvs).astype(np.float32)
    j = japi.Clpconv(0, cvs, pts, _quiet, bin0_mode=bin0_mode)
    t = tapi.Clpconv(0, cvs, pts, _quiet, bin0_mode=bin0_mode, device="cpu")
    assert j.push_ir(ir) == t.push_ir(ir) == 0
    for _ in range(7):
        blk = rng.standard_normal(pts).astype(np.float32)
        jo, to = np.empty(pts, np.float32), np.empty(pts, np.float32)
        assert j.convolution(jo, blk) == t.convolution(to, blk) == 0
        np.testing.assert_allclose(to, jo, atol=2e-5 * np.abs(jo).max(), rtol=0)


@pytest.mark.parametrize("host_block", [100, 64, 17])
def test_clconv_processor_matches_jax_and_scipy(host_block):
    """Ragged host blocks into parts=64, with skip/size and a 0dbfs scale:
    same output as the JAX processor, and the scipy oracle delayed by
    latency == parts."""
    parts, skip, size, scale = 64, 10, 300, 0.5
    rng = np.random.default_rng(host_block)
    table = rng.standard_normal(400).astype(np.float32)
    x = rng.standard_normal(1500).astype(np.float32)
    jp = jstream.ClconvProcessor(table, parts, skip=skip, size=size, scale=scale,
                                 on_message=_quiet)
    tp = tstream.ClconvProcessor(table, parts, skip=skip, size=size, scale=scale,
                                 on_message=_quiet, device="cpu")
    assert tp.latency == jp.latency == parts
    jo, to = [], []
    for i in range(0, x.size, host_block):
        jo.append(jp.process(x[i:i + host_block]))
        to.append(tp.process(x[i:i + host_block]))
    jo, to = np.concatenate(jo), np.concatenate(to)
    np.testing.assert_allclose(to, jo, atol=2e-5 * np.abs(jo).max(), rtol=0)
    ref = sps.fftconvolve(x, table[skip:size] * scale)[: x.size - parts]
    np.testing.assert_allclose(to[parts:], ref, atol=3e-5 * np.abs(ref).max(), rtol=0)
    assert np.all(to[:parts] == 0)


def test_wrong_sizes_raise_size_error():
    t = tapi.Clpconv(0, 128, 32, _quiet, device="cpu")
    with pytest.raises(SizeError):
        t.push_ir(np.zeros(100, np.float32))
    with pytest.raises(SizeError):
        t.convolution(np.empty(32, np.float32), np.zeros(31, np.float32))


def test_cuda_absent_is_a_device_error():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(DeviceError) as e:
        get_device(0, "cuda")
    assert e.value.status == Status.DEVICE_NOT_FOUND
    t = tapi.Clpconv(0, 128, 32, _quiet, device="cuda")
    assert t.get_cl_err() == Status.DEVICE_NOT_FOUND
    assert t.push_ir(np.zeros(128, np.float32)) == Status.DEVICE_NOT_FOUND
    with pytest.raises(DeviceError):
        tstream.ClconvProcessor(np.ones(128, np.float32), 32, on_message=_quiet)


def test_device_selection():
    assert get_device(0, "cpu", _quiet) == torch.device("cpu")
    with pytest.raises(DeviceError) as e:
        get_device(0, "meta", _quiet)
    assert e.value.status == Status.INVALID_DEVICE
    if torch.cuda.is_available():
        with pytest.raises(DeviceError):
            get_device(torch.cuda.device_count(), None, _quiet)


def test_unported_surfaces_raise():
    """parts=0 is ported (the zero-latency engine): it dispatches, with no
    added latency. bf16 rings and float64 compute are ported too: they
    construct and stream, against the float32 engine at bf16's 5e-3 and
    float32's 1e-5 of max|out|; only float64 on bf16 rings raises, as in the
    JAX package. The name is kept from when these surfaces raised, so the
    case keeps its identity across versions."""
    ir = np.ones(64, np.float32)
    p = tstream.ClconvProcessor(ir, 0, device="cpu", on_message=_quiet)
    assert p.zero_latency and p.latency == 0 and not p.dconv
    np.testing.assert_allclose(p.process(np.eye(1, 64, dtype=np.float32)[0]), ir,
                               atol=1e-6, rtol=0)
    rng = np.random.default_rng(5)
    h = torch.from_numpy(rng.standard_normal(128).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((6, 64)).astype(np.float32))
    outs = {}
    for kw in ({}, {"ring_dtype": "bf16"}, {"dtype": "f64"}):
        cfg = tpconv.PconvConfig(pts=64, nparts=2, **kw)
        st = tpconv.push_ir(cfg, tpconv.pconv_init(cfg, "cpu"), h)
        outs[tuple(kw.values())] = tpconv.pconv_stream(cfg, st, x)[1].double().numpy()
    ref = outs[()]
    for key, tol in ((("bf16",), 5e-3), (("f64",), 1e-5)):
        np.testing.assert_allclose(outs[key], ref, atol=tol * np.abs(ref).max(), rtol=0)
    with pytest.raises(ValueError, match="reduced-width ring"):
        tpconv.PconvConfig(pts=64, nparts=1, dtype="f64", ring_dtype="bf16")


def test_constructor_records_bad_config():
    t = tapi.Clpconv(0, 100, 64, _quiet, device="cpu")
    assert t.get_cl_err() == Status.UNKNOWN
    assert t.convolution(np.empty(64, np.float32), np.zeros(64, np.float32)) \
        == Status.UNKNOWN


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("top", ["opencl_fft_tpu_torch", "chip_smoke.py"])
def test_port_never_imports_jax(top):
    target = REPO / top
    files = sorted(target.rglob("*.py")) if target.is_dir() else [target]
    assert files
    for f in files:
        for mod in _imports(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "opencl_fft_tpu"), f"{f}: {mod}"
