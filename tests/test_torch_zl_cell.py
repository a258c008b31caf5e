"""The zero-latency cell of the benchmark (``zl2p20_live64``) and what it
reads in the port: the cell run whole on the CPU at a tiny size through
``audiobench.run.main`` (in a process of its own, which loads no JAX),
correct against the plain reference at zero latency and failed by its
bfloat16 control; the zero-latency scheduler's spans and counters
(``models/lowlatency.py``), recorded exactly while a profiler records; and
the cell's four readers on synthetic records."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from audiobench import catalog, program
from opencl_fft_tpu_torch import stream as tstream
from opencl_fft_tpu_torch.models import ZeroLatencyConvolver, plan_segments
from opencl_fft_tpu_torch.utils import profiling as PF

REPO = Path(__file__).resolve().parents[1]
CELL = "zl2p20_live64"
TINY_CONFIG = dict(taps=4096, block_size=16, pmax=256, sample_rate=4000)
TINY_MIX = dict(samples=16, pool_samples=16 * 16 * 6, check_runs=4)
ZL_METRICS = ("zl_step_us_per_callback.zl", "zl_download_us_per_callback.zl",
              "ops_per_callback.zl", "terminal_callback_us.zl")
RUNS = {"untraced": (0, 0), "traced": (1, 0), "control": (0, 1)}

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
"""


def _update(path: Path, changes: dict) -> None:
    data = json.loads(path.read_text())
    data.update(changes)
    path.write_text(json.dumps(data))


@pytest.fixture(scope="module")
def lines(tmp_path_factory) -> dict:
    """The cell's (exit code, last line) untraced, traced and as its
    control, on a copy of the benchmark cut to a tiny size."""
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
    out, last = [], None
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            last = json.loads(line)
        elif line.startswith("RC "):
            out.append((int(line.split()[1]), last))
            last = None
    assert len(out) == len(RUNS), proc.stdout[-4000:]
    return dict(zip(RUNS, out))


def test_cell_is_correct_against_the_reference(lines):
    rc, line = lines["untraced"]
    assert rc == 0 and line["correct"] and line["failed"] == 0
    assert set(line["metrics"]) == {"audio_s_per_s.opcode", "setup_s"}
    assert line["metrics"]["audio_s_per_s.opcode"]["value"] > 0
    assert 0 <= line["checks"]["max_rel_err"]["value"] <= 1e-5
    assert line["checks"]["max_rel_err"]["limit"] == 1e-4


def test_traced_run_reads_the_zl_metrics(lines):
    """The CPU has no device trace, so ``ops_per_callback.zl`` finds
    nothing; the program's counters and the loop's clock read."""
    rc, line = lines["traced"]
    assert rc == 0 and line["correct"]
    got = line["metrics"]
    assert set(got) == set(ZL_METRICS) - {"ops_per_callback.zl"}
    assert all(got[m]["value"] > 0 for m in got)
    assert got["zl_step_us_per_callback.zl"]["unit"] == "us"


def test_control_fails_its_limit(lines):
    rc, line = lines["control"]
    assert rc == 0 and not line["correct"]
    assert line["checks"]["max_rel_err"]["value"] > line["checks"]["max_rel_err"]["limit"]


def test_configuration_states_the_deployment():
    bench = catalog.benchmark(REPO)
    cell = catalog.cell(bench, CELL)
    cfg = catalog.config(REPO, cell["config"])
    assert cell["chips"] == 1 and cfg["reduced"] == []
    assert (cfg["parts"], cfg["block_size"], cfg["pmax"], cfg["taps"]) == (0, 64, 4096, 1 << 20)
    assert {"source", "assumed", "plan", "guarantees", "deployment"} <= set(cfg)
    mix = catalog.traffic(REPO, cell["traffic"])
    assert mix["loop"] == "zerolatency" and mix["samples"] == cfg["block_size"]
    for name in ZL_METRICS:
        (m,) = [m for m in bench["per_layer"] if m["name"] == name]
        assert m["workloads"] == [CELL] and m["moves"] == "audio_s_per_s.opcode"


def test_spans_a_callback_fit_the_buffer():
    """A step records ``zl``, ``head``, ``segments``, ``download`` and a
    ``step`` a firing: at the cell's plan at most 6 a callback on the mean,
    so that a traced window of 4 s stays inside the 65,536 spans kept while
    a callback takes over 366 µs."""
    cfg = catalog.config(REPO, catalog.cell(catalog.benchmark(REPO), CELL)["config"])
    plan = plan_segments(cfg["taps"], cfg["block_size"], cfg["pmax"])
    fires = sum(cfg["block_size"] / s.pts for s in plan)
    assert [s.pts for s in plan] == [64 << i for i in range(7)] and plan[-1].nparts == 255
    assert 4 + fires <= 6


# -- the scheduler's spans and counters --------------------------------------

IR = np.random.default_rng(7).standard_normal(4096).astype(np.float32)
B, PMAX = 16, 256


@pytest.fixture(autouse=True)
def _fresh():
    PF.reset()
    yield
    PF.reset()


def _zl_counters() -> dict:
    return {k: v for k, v in PF.counters().items() if k.startswith("zl.")}


def _profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _blocks(n: int) -> np.ndarray:
    return np.random.default_rng(n).standard_normal((n, B)).astype(np.float32)


@pytest.mark.parametrize("via", ["engine", "processor"])
@pytest.mark.parametrize("n", [1, 16, 37])
def test_counters_count_steps_and_firings(via, n):
    """After n steps from t = 0: zl.steps n, zl.fires the sum over the
    segments of floor(n / r), zl.terminal_fires floor(n / r_last)."""
    if via == "engine":
        eng = ZeroLatencyConvolver(IR, block=B, pmax=PMAX, device="cpu")
    else:
        eng = tstream.ClconvProcessor(IR, 0, block_size=B, pmax=PMAX, device="cpu")
    rs = [s.pts // B for s in plan_segments(IR.size, B, PMAX)]
    with _profiled():
        for x in _blocks(n):
            eng.process(x)
    c = _zl_counters()
    assert c["zl.steps"] == n
    assert c["zl.fires"] == sum(n // r for r in rs)
    assert c["zl.terminal_fires"] == n // rs[-1]
    assert c["zl.step_ns"] > 0 and c["zl.download_ns"] > 0
    assert PF.counters()["step.blocks"] == c["zl.fires"]


def _within(inner, outer) -> bool:
    return outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def test_spans_nest_as_stated():
    """Each step is a ``zl`` request: ``head``, ``segments`` (each
    firing's ``step`` inside it) and ``download``, in that order."""
    zl = ZeroLatencyConvolver(IR, block=B, pmax=PMAX, device="cpu")
    n = 16
    with _profiled():
        for x in _blocks(n):
            zl.process(x)
    sp = PF.spans()
    reqs = {s.request: s for s in sp if s.parent is None}
    assert len(reqs) == n and {s.name for s in reqs.values()} == {"zl"}
    for r, top in reqs.items():
        kids = sorted((s for s in sp if s.request == r and s.parent == "zl"),
                      key=lambda s: s.start_ns)
        assert [s.name for s in kids] == ["head", "segments", "download"]
        assert all(_within(s, top) for s in kids)
        steps = [s for s in sp if s.request == r and s.name == "step"]
        assert steps and all(s.parent == "segments" and _within(s, kids[1]) for s in steps)
    assert len([s for s in sp if s.name == "step"]) == _zl_counters()["zl.fires"]


def test_render_is_a_request_a_step_without_download():
    zl = ZeroLatencyConvolver(IR, block=B, pmax=PMAX, device="cpu")
    x = _blocks(3).reshape(-1)
    with _profiled():
        y = zl.render(x)
    n = -(-(x.size + IR.size - 1) // B)
    assert _zl_counters()["zl.steps"] == n and "zl.download_ns" not in _zl_counters()
    sp = PF.spans()
    assert len([s for s in sp if s.name == "zl"]) == n
    assert not [s for s in sp if s.name == "download"]
    np.testing.assert_allclose(y, np.convolve(x, IR), atol=3e-5 * np.abs(y).max())


def test_nothing_is_recorded_with_the_profiler_off():
    zl = ZeroLatencyConvolver(IR, block=B, pmax=PMAX, device="cpu")
    for x in _blocks(20):
        zl.process(x)
    zl.render(_blocks(2).reshape(-1))
    assert PF.spans() == [] and _zl_counters() == {}


def test_the_processor_asks_once_a_callback(monkeypatch):
    """``ClconvProcessor.process`` hands its one ``enabled()`` answer to
    the engine: one question a callback, traced or not."""
    asked = []
    real = PF.enabled

    def enabled():
        asked.append(1)
        return real()

    monkeypatch.setattr(PF, "enabled", enabled)
    p = tstream.ClconvProcessor(IR, 0, block_size=B, pmax=PMAX, device="cpu")
    for x in _blocks(5):
        p.process(x)
    with _profiled():
        for x in _blocks(4):
            p.process(x)
    assert len(asked) == 9 and _zl_counters()["zl.steps"] == 4


def test_traced_output_is_the_untraced_output():
    a = ZeroLatencyConvolver(IR, block=B, pmax=PMAX, device="cpu")
    b = ZeroLatencyConvolver(IR, block=B, pmax=PMAX, device="cpu")
    xs = _blocks(20)
    ya = [a.process(x) for x in xs]
    with _profiled():
        yb = [b.process(x) for x in xs]
    np.testing.assert_array_equal(np.concatenate(ya), np.concatenate(yb))


# -- the cell's readers --------------------------------------------------------

def _read(name, rec):
    return catalog.reader(REPO, name)(rec)


def _record(**kw) -> dict:
    rec = {"window_s": 4.0, "device": [], "spans": [], "counters": {}, "untraced": {}}
    rec.update(kw)
    return rec


def test_readers_on_synthetic_records(monkeypatch):
    counts = {"zl.steps": 1000, "zl.fires": 1980, "zl.terminal_fires": 15,
              "zl.step_ns": 1000 * 350_500, "zl.download_ns": 1000 * 120_250}
    monkeypatch.setattr(program, "counters", lambda: counts)
    rec = _record(device=[("op", 0.0, 1e-6)] * 450, counters={"callbacks": 10},
                  untraced={"callbacks": 640, "terminal_callbacks": 4, "terminal_s": 0.0084})
    assert _read("zl_step_us_per_callback.zl", rec) == pytest.approx(350.5)
    assert _read("zl_download_us_per_callback.zl", rec) == pytest.approx(120.25)
    assert _read("ops_per_callback.zl", rec) == pytest.approx(45.0)
    assert _read("terminal_callback_us.zl", rec) == pytest.approx(2100.0)


@pytest.mark.parametrize("program_counters", [None, {}, {"process.callbacks": 5,
                                                        "step.blocks": 1}])
def test_readers_find_nothing_where_nothing_was_recorded(monkeypatch, program_counters):
    """A program with no ``zl.*`` counters (an older checkout, or none at
    all), a window with no device row and no terminal callback: None."""
    if program_counters is None:
        monkeypatch.setattr(program, "_profiling", lambda: None)
    else:
        monkeypatch.setattr(program, "counters", lambda: program_counters)
    rec = _record(counters={"callbacks": 0}, untraced={"terminal_callbacks": 0})
    for name in ZL_METRICS:
        assert _read(name, rec) is None
    assert _read("ops_per_callback.zl", _record(device=[("op", 0, 1)])) is None
