"""The harness on the CPU at tiny sizes: discovery by name, the last line,
the plain reference against each entry the cells drive, and the check that
no module of JAX or of the JAX package was loaded."""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from audiobench import catalog, reference, run
from audiobench.conftest import CELLS, LTI_INSERTS, REPO, add_cell, run_cell

DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


def _tree_digest(root: Path) -> str:
    h = hashlib.sha256()
    for p in sorted([root / "BENCHMARK.json", *(root / "audiobench").rglob("*")]):
        if p.is_file() and "__pycache__" not in p.parts:
            h.update(str(p.relative_to(root)).encode() + p.read_bytes())
    return h.hexdigest()


def test_a_cell_is_added_by_files_and_an_entry(tiny_root, capsys):
    """A new configuration, mix, metric and cell, each found by its name,
    with no file of the benchmark edited."""
    before = _tree_digest(REPO)
    ab = tiny_root / "audiobench"
    cfg = json.loads((ab / "configs" / "lti_ir2p17_m512_44k.json").read_text())
    cfg.update(name="lti_short", taps=128)
    (ab / "configs" / "lti_short.json").write_text(json.dumps(cfg))
    (ab / "traffic" / "stream2_3.json").write_text(json.dumps(
        {"loop": "scan", "channels": 2, "blocks": 3, "segments": 2, "check_calls": 2}))
    (ab / "metrics" / "calls_traced.py").write_text(
        "def read(rec):\n    return float(rec['counters']['calls'] + rec['untraced']['calls'])\n")
    (ab / "limits" / "lti_short_stream2.json").write_text('{"max_rel_err": 1e-4}')
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "lti_short_stream2", "config": "lti_short",
                               "traffic": "stream2_3", "chips": 1, "why": "a test cell"})
    bench["end_to_end"][0]["workloads"].append("lti_short_stream2")
    bench["per_layer"].append({"name": "calls_traced", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "entry",
                               "moves": "audio_s_per_s", "workloads": ["lti_short_stream2"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    rc, line = run_cell(tiny_root, "lti_short_stream2", capsys)
    assert rc == 0 and line["correct"] and set(line["metrics"]) == {"audio_s_per_s", "setup_s"}
    rc, line = run_cell(tiny_root, "lti_short_stream2", capsys, trace=1)
    assert rc == 0 and line["correct"]
    assert line["metrics"]["calls_traced"]["value"] == line["attempted"]
    assert _tree_digest(REPO) == before


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(tiny_root, capsys, cell, trace):
    """The schema of the last line: the cell's metrics for the mode, each
    with its unit, the device, and the numbers compared, last."""
    rc, line = run_cell(tiny_root, cell, capsys, trace=trace)
    assert rc == 0
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert set(keys) <= {"correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"}
    bench = catalog.benchmark(tiny_root)
    group = bench["per_layer"] if trace else bench["end_to_end"]
    units = {m["name"]: m["unit"] for m in group if catalog.applies(m, cell)}
    if trace:       # the CPU has no device trace: the readers of it find nothing
        assert set(line["metrics"]) <= set(units)
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == set(units)
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name] and m["value"] > 0
    assert DEVICE_KEYS <= set(line["device"]) and line["device"]["count"] == 1
    assert set(line["checks"]) == {"max_rel_err"}
    assert set(line["checks"]["max_rel_err"]) == {"value", "limit"}
    assert line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_entry_against_the_reference(tiny_root, capsys, cell):
    """Each entry the window drives, chained over the window's calls,
    against the plain reference: float32 rounding only."""
    rc, line = run_cell(tiny_root, cell, capsys, seed=7)
    assert rc == 0 and line["correct"]
    assert line["checks"]["max_rel_err"]["value"] < 2e-6


@pytest.mark.parametrize("trace", [0, 1])
def test_lti_inserts_added_from_data(tiny_root, capsys, trace):
    """The callbacks loop drives ClconvProcessor inserts too: a cell of
    four of them, added from data alone, against the plain reference."""
    add_cell(tiny_root, *LTI_INSERTS)
    rc, line = run_cell(tiny_root, LTI_INSERTS[0], capsys, trace=trace, seed=11)
    assert rc == 0 and line["correct"]
    assert line["checks"]["max_rel_err"]["value"] < 2e-6


def test_traced_run_reads_the_host_clock_untraced(tiny_root, capsys):
    """With --trace 1 the window runs untraced, then traced: the host-clock
    reader takes the first part, the device readers the second."""
    rc, line = run_cell(tiny_root, "tv2p22_csound_ksmps64", capsys, trace=1, seconds=0.4)
    assert rc == 0 and line["correct"]
    assert line["metrics"]["accum_us_per_callback.opcode"]["value"] > 0
    assert line["device"]["window_s"] < 0.3


@pytest.mark.parametrize("cell", CELLS)
def test_no_jax_in_a_run(tiny_root, capsys, cell):
    run_cell(tiny_root, cell, capsys, trace=1)
    assert run.forbidden_modules() == []
    assert "opencl_fft_tpu_torch" in sys.modules


def test_a_forbidden_module_fails_the_run(tiny_root, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax.numpy", sys.modules["json"])
    rc, line = run_cell(tiny_root, "lti2p17_stream64", capsys)
    assert rc != 0 and line is None
    monkeypatch.delitem(sys.modules, "jax.numpy")
    monkeypatch.setitem(sys.modules, "jaxlib", sys.modules["json"])
    assert run.forbidden_modules() == ["jaxlib"]
    monkeypatch.delitem(sys.modules, "jaxlib")
    monkeypatch.setitem(sys.modules, "opencl_fft_tpu_torchx", sys.modules["json"])
    assert run.forbidden_modules() == []


def test_without_a_card_there_is_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, "-m", "audiobench.run", "--workload",
                           "lti2p17_stream64", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2 and proc.stdout.strip() == ""


def test_without_the_program_there_is_no_result(tiny_root):
    """A directory that holds only the benchmark's own files fails."""
    env = dict(os.environ, PYTHONPATH="")
    code = ("import sys; from audiobench import run; "
            "sys.exit(run.main(['--workload', 'lti2p17_stream64', '--seed', '1', "
            "'--seconds', '0.2', '--trace', '0'], device='cpu'))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tiny_root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "opencl_fft_tpu_torch" in proc.stderr


def test_reference_imports_nothing_of_the_program():
    src = Path(reference.__file__).read_text()
    assert "opencl_fft" not in src and "jax" not in src.replace("JAX", "")


def test_tv_reference_is_lti_when_fed_an_ir():
    """Fed an IR's partitions cyclically as the second operand, the TV
    definition is the linear convolution."""
    gen = torch.Generator().manual_seed(5)
    pts, nparts, nb = 8, 4, 11
    x = torch.randn(nb * pts, generator=gen, dtype=torch.float64)
    ir = torch.randn(nparts * pts, generator=gen, dtype=torch.float64)
    hb = ir.reshape(nparts, pts)[torch.arange(nb) % nparts]
    tv = reference.tv_tail(x.reshape(nb, pts), hb, 0, nb, nparts).reshape(-1)
    lti = reference.lti_tail(x, ir, nb * pts)
    assert torch.allclose(tv, lti, atol=1e-12)
