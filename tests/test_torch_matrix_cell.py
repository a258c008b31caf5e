"""The convolution-matrix cell of the benchmark (``mimo16x16_stream470``)
and what it reads in the port: ``MatrixConvolver`` against the plain
reference of ``tests/matrix_reference.py`` on seeded random IRs; the cell
run whole on the CPU at a tiny size through ``audiobench.run.main`` (in a
process of its own, which loads no JAX), correct against the benchmark's
reference and failed by its bfloat16 control; the matrix layer's spans and
counters (``models/convolver.py``), recorded exactly while a profiler
records; the readers the cell reports on synthetic records; and the frozen
least-work count of a matrix scan."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from audiobench import catalog, program, reference_matrix, roofline_matrix
from opencl_fft_tpu_torch import models as M
from opencl_fft_tpu_torch.ops import pconv as P
from opencl_fft_tpu_torch.utils import profiling as PF

from matrix_reference import matrix_convolve

REPO = Path(__file__).resolve().parents[1]
CELL = "mimo16x16_stream470"
# the per-layer metrics the cell reports: the matrix layer's own, and the
# scan cells' (the same scan entry at C = n_out n_in; ``scan_roofline`` over
# the loop's own least-work count, ``roofline_matrix``)
MATRIX_METRICS = ("fan_mb_per_block.matrix",)
SCAN_METRICS = ("scan_roofline", "device_idle_pct.batch", "prelaunch_us_per_call.batch",
                "idle_prelaunch_pct.batch")
TINY_CONFIG = dict(inputs=3, outputs=2, taps=256, partition=16, sample_rate=4000)
TINY_MIX = dict(blocks=5, check_calls=3)
RUNS = {"untraced": (0, 0), "traced": (1, 0), "control": (0, 1)}
N_IN, N_OUT = 3, 5
F32 = 4


def _rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    got = got.to(torch.float64)
    return float((got - ref).abs().max() / ref.abs().max())


def _matrix(pts: int, nparts: int, seed: int):
    """A MatrixConvolver of N_IN inputs and N_OUT outputs on the CPU with
    seeded IRs pushed, and the IRs."""
    gen = torch.Generator().manual_seed(seed)
    cfg = P.PconvConfig(pts=pts, nparts=nparts)
    irs = torch.randn((N_OUT, N_IN, cfg.cvs), generator=gen)
    m = M.MatrixConvolver(cfg, N_IN, N_OUT, device="cpu")
    m.push_ir(irs)
    return m, irs


def _blocks(nblocks: int, pts: int, seed: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed + 1000)
    return torch.randn((nblocks, N_IN, pts), generator=gen)


def _samples(blocks: torch.Tensor) -> torch.Tensor:
    """(nblocks, channels, pts) -> (channels, nblocks * pts)."""
    return blocks.permute(1, 0, 2).reshape(blocks.shape[1], -1)


# -- the port against the plain reference -------------------------------------

SHAPES = [(16, 4), (16, 8), (32, 5)]


@pytest.mark.parametrize("pts, nparts", SHAPES)
@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("via", ["stream", "step"])
def test_matrix_against_the_reference(pts, nparts, seed, via):
    """3 in x 5 out, 2 nparts + 3 blocks from a zero history: ``stream`` as
    two chained calls, or ``step`` block by block; float32 rounding only."""
    m, irs = _matrix(pts, nparts, seed)
    x = _blocks(2 * nparts + 3, pts, seed)
    if via == "stream":
        cut = nparts + 1
        got = torch.cat([m.stream(x[:cut]), m.stream(x[cut:])])
    else:
        got = torch.stack([m.step(b) for b in x])
    assert got.shape == (len(x), N_OUT, pts)
    ref = matrix_convolve(_samples(x), irs)
    assert _rel_err(_samples(got), ref) < 1e-5


def test_reference_is_the_sum_of_the_pairs_convolutions():
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((2, 40), generator=gen, dtype=torch.float64)
    h = torch.randn((3, 2, 7), generator=gen, dtype=torch.float64)
    ref = matrix_convolve(x, h)
    for o in range(3):
        want = sum(np.convolve(x[i].numpy(), h[o, i].numpy())[:40] for i in range(2))
        np.testing.assert_allclose(ref[o].numpy(), want, atol=1e-12)


def test_benchmark_reference_is_the_plain_reference():
    """``audiobench/reference_matrix.py`` (on ``reference.lti_tail``, by
    outputs in groups) gives the tail of the plain reference."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((3, 300), generator=gen)
    h = torch.randn((5, 3, 64), generator=gen)
    want = matrix_convolve(x, h)[:, -80:]
    got = reference_matrix.matrix_tail(x, h, 80, outputs=2)
    assert got.dtype == torch.float64 and got.shape == (5, 80)
    assert torch.allclose(got, want, atol=1e-10)


@pytest.mark.parametrize("path", ["tests/matrix_reference.py",
                                  "audiobench/reference_matrix.py"])
def test_references_import_nothing_of_either_package(path):
    src = (REPO / path).read_text()
    assert "opencl_fft" not in src and "jax" not in src.lower()


# -- the cell, run whole at a tiny size ---------------------------------------

_SCRIPT = """
import sys
import torch
from audiobench import run
torch.set_num_threads(1)
for trace, control in {runs}:
    rc = run.main(["--workload", "{cell}", "--seed", "3000000019", "--seconds", "0.4",
                   "--trace", str(trace), "--control", str(control)],
                  root=sys.argv[1], device="cpu")
    print("RC", rc, flush=True)
print("LOADED", " ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _update(path: Path, changes: dict) -> None:
    data = json.loads(path.read_text())
    data.update(changes)
    path.write_text(json.dumps(data))


@pytest.fixture(scope="module")
def lines(tmp_path_factory) -> dict:
    """The cell's (exit code, last line) untraced, traced and as its
    control, on a copy of the benchmark cut to a tiny size; and the
    top-level modules the process loaded."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "audiobench", root / "audiobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cell = catalog.cell(catalog.benchmark(root), CELL)
    _update(root / "audiobench" / "configs" / f"{cell['config']}.json", TINY_CONFIG)
    _update(root / "audiobench" / "traffic" / f"{cell['traffic']}.json", TINY_MIX)
    script = _SCRIPT.format(runs=tuple(RUNS.values()), cell=CELL)
    proc = subprocess.run([sys.executable, "-c", script, str(root)], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out, last, loaded = [], None, None
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            last = json.loads(line)
        elif line.startswith("RC "):
            out.append((int(line.split()[1]), last))
            last = None
        elif line.startswith("LOADED "):
            loaded = set(line.split()[1:])
    assert len(out) == len(RUNS) and loaded, proc.stdout[-4000:]
    return dict(zip(RUNS, out), loaded=loaded)


def test_cell_is_correct_against_the_reference(lines):
    rc, line = lines["untraced"]
    assert rc == 0 and line["correct"] and line["failed"] == 0
    assert set(line["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert line["metrics"]["audio_s_per_s"]["value"] > 0
    assert 0 <= line["checks"]["max_rel_err"]["value"] <= 1e-5
    assert line["checks"]["max_rel_err"]["limit"] == 1e-4


def test_traced_run_reads_the_matrix_metrics(lines):
    """The CPU has no device trace, so the device readers find nothing;
    the program's counters read no fan-out or fan-in bytes (every block
    takes the matrix scan), and its spans the inner scan's host time up to
    the launch."""
    rc, line = lines["traced"]
    assert rc == 0 and line["correct"]
    got = line["metrics"]
    assert set(got) == {"fan_mb_per_block.matrix", "prelaunch_us_per_call.batch"}
    assert got["prelaunch_us_per_call.batch"]["value"] > 0
    assert got["fan_mb_per_block.matrix"] == {"value": 0.0, "unit": "MB"}


def test_control_fails_its_limit(lines):
    rc, line = lines["control"]
    assert rc == 0 and not line["correct"]
    assert line["checks"]["max_rel_err"]["value"] > line["checks"]["max_rel_err"]["limit"]


def test_no_jax_in_the_cell(lines):
    assert "opencl_fft_tpu_torch" in lines["loaded"]
    assert not lines["loaded"] & {"jax", "jaxlib", "flax", "opencl_fft_tpu"}


def test_configuration_states_the_deployment():
    bench = catalog.benchmark(REPO)
    cell = catalog.cell(bench, CELL)
    cfg = catalog.config(REPO, cell["config"])
    assert cell["chips"] == 1 and cfg["reduced"] == []
    assert (cfg["kind"], cfg["inputs"], cfg["outputs"]) == ("matrix", 16, 16)
    assert (cfg["taps"], cfg["partition"], cfg["sample_rate"], cfg["dtype"]) == (
        1 << 17, 512, 48000, "float32")
    assert {"source", "assumed", "guarantees", "deployment"} <= set(cfg)
    mix = catalog.traffic(REPO, cell["traffic"])
    assert mix == dict(mix, loop="matrix", blocks=470, segments=4, check_calls=8)
    assert catalog.limits(REPO, CELL)["max_rel_err"] == 1e-4
    (e2e,) = [m for m in bench["end_to_end"] if m["name"] == "audio_s_per_s"]
    assert CELL in e2e["workloads"] and e2e["bound"] == 0.08
    for name in MATRIX_METRICS + SCAN_METRICS:
        (m,) = [m for m in bench["per_layer"] if m["name"] == name]
        assert m["moves"] == "audio_s_per_s"
        assert m["workloads"] == ([CELL] if name in MATRIX_METRICS
                                  else ["lti2p17_stream64", "tv2p22_stream1", CELL])


# -- the matrix layer's spans and counters ------------------------------------

PTS, NPARTS = 16, 4


@pytest.fixture(autouse=True)
def _fresh():
    PF.reset()
    yield
    PF.reset()


def _matrix_counters() -> dict:
    return {k: v for k, v in PF.counters().items() if k.startswith("matrix.")}


def _profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _within(inner, outer) -> bool:
    return outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


@pytest.mark.parametrize("sizes", [(4, 3), (7, 1), (2, 5)])
def test_stream_counters_are_exact(sizes):
    """The matrix scan tiles nothing and sums no per-pair output: 0 fan
    bytes."""
    nblocks, calls = sizes
    m, _ = _matrix(PTS, NPARTS, 6)
    with _profiled():
        for c in range(calls):
            m.stream(_blocks(nblocks, PTS, c))
    n = nblocks * calls
    assert _matrix_counters() == {
        "matrix.calls": calls, "matrix.blocks": n, "matrix.pairs": N_OUT * N_IN * n,
        "matrix.fan_bytes": 0}


def test_step_counters_are_exact():
    m, _ = _matrix(PTS, NPARTS, 7)
    with _profiled():
        for b in _blocks(6, PTS, 7):
            m.step(b)
    assert _matrix_counters() == {
        "matrix.calls": 6, "matrix.blocks": 6, "matrix.pairs": N_OUT * N_IN * 6,
        "matrix.fan_bytes": 2 * N_OUT * N_IN * PTS * F32 * 6}
    assert PF.counters()["step.blocks"] == 6


@pytest.mark.parametrize("via", ["stream", "step"])
def test_spans_nest_as_stated(via):
    """Each call is a ``matrix`` request. ``step``: ``fanout``, the inner
    step, ``fanin``, in that order. ``stream`` (the matrix scan): no fan
    spans, and a ``stream`` request of its own inside the matrix request's
    time, with the entry's ``window``, ``launch`` and ``ring`` spans."""
    m, _ = _matrix(PTS, NPARTS, 8)
    x = _blocks(5, PTS, 8)
    with _profiled():
        for _ in range(3):
            if via == "stream":
                m.stream(x)
            else:
                m.step(x[0])
    sp = PF.spans()
    tops = [s for s in sp if s.parent is None and s.name == "matrix"]
    assert len(tops) == 3
    for top in tops:
        kids = sorted((s for s in sp if s.request == top.request and s.parent == "matrix"),
                      key=lambda s: s.start_ns)
        names = [s.name for s in kids]
        assert names == ([] if via == "stream" else ["fanout", "step", "fanin"])
        assert all(_within(s, top) for s in kids)
    inner = [s for s in sp if s.parent is None and s.name == "stream"]
    if via == "stream":
        assert len(inner) == 3
        for top, s in zip(sorted(tops, key=lambda s: s.start_ns),
                          sorted(inner, key=lambda s: s.start_ns)):
            assert _within(s, top)
            kids = sorted((k for k in sp if k.request == s.request and k.parent == "stream"),
                          key=lambda k: k.start_ns)
            assert [k.name for k in kids] == ["window", "launch", "ring"]
            assert all(_within(k, s) for k in kids)
    else:
        assert inner == []


def test_window_calls_pair_the_inner_stream_requests():
    """``audiobench/program.window_calls`` pairs each harness ``call``
    with the call's inner ``stream`` request, as for the scan cells."""
    m, _ = _matrix(PTS, NPARTS, 9)
    x = _blocks(4, PTS, 9)
    with _profiled():
        for _ in range(4):
            m.stream(x)
    calls = [("call", 0.1 * i, 0.1 * i + 0.05) for i in range(4)]
    got = program.window_calls({"spans": calls})
    assert len(got) == 4
    assert all(s.name == "stream" and launch is not None for _, s, launch in got)


def test_nothing_is_recorded_with_the_profiler_off():
    m, _ = _matrix(PTS, NPARTS, 10)
    x = _blocks(4, PTS, 10)
    m.stream(x)
    m.step(x[0])
    assert PF.spans() == [] and _matrix_counters() == {}


@pytest.mark.parametrize("via, asked_a_call", [("step", 1), ("stream", 1)])
def test_each_layer_asks_once_a_call(monkeypatch, via, asked_a_call):
    """The matrix layer asks ``enabled()`` once a call, traced or not, and
    hands its answer to the inner ``stream`` request of the matrix scan;
    ``step``'s inner step does not ask."""
    asked = []
    real = PF.enabled

    def enabled():
        asked.append(1)
        return real()

    monkeypatch.setattr(PF, "enabled", enabled)
    m, _ = _matrix(PTS, NPARTS, 11)
    x = _blocks(3, PTS, 11)
    call = m.stream if via == "stream" else (lambda b: m.step(b[0]))
    for _ in range(3):
        call(x)
    with _profiled():
        for _ in range(2):
            call(x)
    assert len(asked) == 5 * asked_a_call and _matrix_counters()["matrix.calls"] == 2


@pytest.mark.parametrize("via", ["stream", "step"])
def test_traced_output_is_the_untraced_output(via):
    (a, _), (b, _) = _matrix(PTS, NPARTS, 12), _matrix(PTS, NPARTS, 12)
    x = _blocks(2 * NPARTS, PTS, 12)

    def run(m):
        if via == "stream":
            return torch.cat([m.stream(x[:3]), m.stream(x[3:])])
        return torch.stack([m.step(blk) for blk in x])

    ya = run(a)
    with _profiled():
        yb = run(b)
    assert torch.equal(ya, yb)


# -- the cell's readers --------------------------------------------------------

def _read(name, rec):
    return catalog.reader(REPO, name)(rec)


def _record(**kw) -> dict:
    rec = {"window_s": 4.0, "device": [], "spans": [], "counters": {}, "untraced": {}}
    rec.update(kw)
    return rec


def test_readers_on_synthetic_records(monkeypatch):
    counts = {"matrix.calls": 100, "matrix.blocks": 47_000,
              "matrix.pairs": 256 * 47_000, "matrix.fan_bytes": 1_048_576 * 47_000}
    monkeypatch.setattr(program, "counters", lambda: counts)
    device = [("mac_tile_kernel", 0.0, 1.5), ("fft_fwd_kernel", 1.5, 2.0),
              ("Memcpy DtoD", 2.0, 3.0), ("cat", 2.5, 3.0)]
    rec = _record(device=device, counters={"calls": 100, "least_s": 0.6})
    assert _read("fan_mb_per_block.matrix", rec) == pytest.approx(1.048576)
    # kernels busy 2.5 s (the copy is no kernel): 0.6 / 2.5
    assert _read("scan_roofline", rec) == pytest.approx(24.0)


@pytest.mark.parametrize("program_counters", [None, {}, {"step.blocks": 3}])
def test_readers_find_nothing_where_nothing_was_recorded(monkeypatch, program_counters):
    """A program with no ``matrix.*`` counters (an older checkout, or none
    at all), a window with no kernel: None."""
    if program_counters is None:
        monkeypatch.setattr(program, "_profiling", lambda: None)
    else:
        monkeypatch.setattr(program, "counters", lambda: program_counters)
    assert _read("fan_mb_per_block.matrix", _record()) is None
    assert _read("scan_roofline", _record(counters={"least_s": 0.6})) is None
    assert _read("scan_roofline", _record(device=[("k", 0.0, 1.0)],
                                          counters={"least_s": 0.0})) is None


# -- the frozen least work ------------------------------------------------------

def test_least_work_of_the_cell():
    """A 470-block call at 16 x 16, nparts 256, pts 512: 126.16 GFLOP of
    MAC and 0.385 of 32 transforms of 1,024 points a block, 126.55 in all,
    1.889 ms at 67 TFLOP/s, bound by operations (~0.1 ms of bytes)."""
    mac = 8.0 * 256 * 470 * 256 * 512
    fft = 32 * 470 * 2.5 * 1024 * 10
    assert mac / 1e9 == pytest.approx(126.165, abs=5e-4)
    assert fft / 1e9 == pytest.approx(0.385, abs=5e-4)
    flops = roofline_matrix.matrix_flops(16, 16, 470, 256, 512)
    assert flops == mac + fft and flops / 1e9 == pytest.approx(126.55, abs=5e-3)
    nbytes = roofline_matrix.matrix_bytes(16, 16, 470, 256, 512)
    irs, rings = 256 * 256 * 512 * 8, 2 * 16 * 256 * 512 * 8
    io, tails = 32 * 470 * 512 * 4, 2 * 16 * 512 * 4
    assert nbytes == irs + rings + io + tails
    assert nbytes / 3.35e12 * 1e3 == pytest.approx(0.0995, abs=5e-4)
    least, what = roofline_matrix.matrix_least_ms(16, 16, 470, 256, 512)
    assert least == pytest.approx(1.889, abs=5e-4) and what == "operations"


def test_least_work_of_a_one_by_one_matrix_is_the_scan():
    """At 1 x 1 the matrix is one LTI channel: ``roofline.scan_flops``'s
    count, whose bytes read the IR ring once as well."""
    from audiobench import roofline
    assert roofline_matrix.matrix_flops(1, 1, 470, 256, 512) == roofline.scan_flops(
        1, 470, 256, 512, False)
    assert roofline_matrix.matrix_bytes(1, 1, 470, 256, 512) == roofline.scan_bytes(
        1, 470, 256, 512, False)
