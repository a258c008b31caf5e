"""The port's sweep harness (``opencl_fft_tpu_torch/bench/sweep.py``) on the
CPU. The eight cases of ``tests/test_sweep_harness.py``, each run through
the port's ``run_sweep`` and the JAX package's on the same fake points:
both publish the same results, ``table.tex`` and ``plot.csv``; the history
pooling, the CPU-oracle rows and the command line; the H100 floor; and one
real point of the port's engine on the CPU."""

import json
import sys

import numpy as np
import pytest
import torch

from opencl_fft_tpu.bench import sweep as JS
from opencl_fft_tpu_torch.bench import sweep as S
from opencl_fft_tpu_torch.ops.pconv import PconvConfig


@pytest.fixture
def fake_points(monkeypatch):
    """Patch both harnesses' rt_ratio with one deterministic schedule of
    estimates each ({(pts, L): [est0, ...]}, consumed in order; None raises
    the harness's Unmeasurable). Returns the port's call counts."""
    calls = {"port": {}, "jax": {}}

    def install(schedule):
        def fake(mod, tag):
            def rt(pts, ir_len, scan_blocks=512, reps=4, tv=True, **kw):
                seq = schedule[(pts, ir_len)]
                i = calls[tag].get((pts, ir_len), 0)
                calls[tag][(pts, ir_len)] = i + 1
                v = seq[min(i, len(seq) - 1)]
                if v is None:
                    raise mod.Unmeasurable("stubbed")
                return v
            return rt
        monkeypatch.setattr(S, "rt_ratio", fake(S, "port"))
        monkeypatch.setattr(JS, "rt_ratio", fake(JS, "jax"))
        return calls["port"]
    yield install
    assert calls["port"] == calls["jax"]       # the same estimates were asked for


def _both(tmp_path, *args, **kw):
    """run_sweep of the port and of JAX on the same arguments: the port's
    results and prefix, after holding every artifact equal."""
    out, jout = str(tmp_path / "port"), str(tmp_path / "jax")
    merge = kw.pop("merge_json", None)
    res = S.run_sweep(*args, out_prefix=out, merge_json=merge, **kw)
    jres = JS.run_sweep(*args, out_prefix=jout, merge_json=merge, **kw)
    assert res == jres
    for ext in ("_table.tex", "_plot.csv"):
        assert open(out + ext).read() == open(jout + ext).read()
    assert json.load(open(out + ".json")) == json.load(open(jout + ".json"))
    return res, out


def test_median_combining_rejects_one_bad_window(fake_points, tmp_path):
    fake_points({(512, 1 << 16): [500.0, 4000.0, 520.0],
                 (512, 1 << 17): [400.0, 410.0, 390.0]})
    res, _ = _both(tmp_path, [512], [1 << 16, 1 << 17], row_repeats=3)
    assert res["M=512,L=2^16"] == 520.0
    assert res["M=512,L=2^17"] == 400.0


def test_unmeasurable_points_are_omitted_not_clamped(fake_points, tmp_path):
    fake_points({(512, 1 << 16): [None, None, None],
                 (512, 1 << 17): [300.0, 300.0, 300.0]})
    res, out = _both(tmp_path, [512], [1 << 16, 1 << 17], row_repeats=3)
    assert "M=512,L=2^16" not in res
    assert res["M=512,L=2^17"] == 300.0
    assert "--" in open(out + "_table.tex").read()


def test_monotonic_repair_remedians_both_endpoints(fake_points, tmp_path):
    calls = fake_points({(512, 1 << 16): [200.0, 200.0, 500.0, 500.0, 500.0],
                         (512, 1 << 17): [450.0] * 5})
    res, _ = _both(tmp_path, [512], [1 << 16, 1 << 17], row_repeats=3)
    assert calls[(512, 1 << 16)] > 3 and calls[(512, 1 << 17)] > 3
    assert res["M=512,L=2^16"] >= res["M=512,L=2^17"] / 1.15


def test_merge_preserves_other_rows_and_replaces_target(fake_points, tmp_path):
    pj = tmp_path / "prior.json"
    pj.write_text(json.dumps({"M=2048,L=2^16": 800.0, "M=512,L=2^16": 999.0}))
    fake_points({(512, 1 << 16): [500.0, 500.0, 500.0]})
    res, out = _both(tmp_path, [512], [1 << 16], row_repeats=3, merge_json=str(pj))
    assert res["M=2048,L=2^16"] == 800.0
    assert res["M=512,L=2^16"] == 500.0
    table = open(out + "_table.tex").read()
    assert "2048" in table and "512" in table


def test_floor_scales_with_ir_length_and_stays_generous():
    """The H100 floor grows with nparts (more ring bytes a call) and with
    the operand count, and is a bandwidth bound 5x generous: at the
    headline shape it is far below a block's measured time."""
    small = PconvConfig.for_ir_length(1 << 16, 512)
    big = PconvConfig.for_ir_length(1 << 20, 512)
    f_small = S.floor_per_block(small, 512, True)
    f_big = S.floor_per_block(big, 512, True)
    assert f_big > f_small > 0
    assert S.floor_per_block(small, 512, False) < f_small
    cfg = PconvConfig.for_ir_length(1 << 17, 512)
    nbytes = 48 * cfg.nparts * cfg.bins + 512 * 4 * 3 * 512
    assert S.floor_per_block(cfg, 512, True) == pytest.approx(nbytes / 512 / (5 * 3.35e12))


def test_merge_falls_back_to_prior_on_unmeasurable(fake_points, tmp_path):
    pj = tmp_path / "prior.json"
    pj.write_text(json.dumps({"M=512,L=2^16": 777.0}))
    fake_points({(512, 1 << 16): [None, None, None]})
    res, _ = _both(tmp_path, [512], [1 << 16], row_repeats=3, merge_json=str(pj))
    assert res["M=512,L=2^16"] == 777.0


def test_median_chain_delta_contract():
    from opencl_fft_tpu_torch.utils.profiling import median_chain_delta

    seq = iter([0.010, 0.010, 0.050, 0.050, 0.012, 0.011, 0.049, 0.048,
                0.010, 0.010, 0.054, 0.052])
    d, n = median_chain_delta(lambda k: next(seq), 4, 1e-3)
    assert n == 3 and 8e-3 < d < 11e-3
    d, n = median_chain_delta(lambda k: 0.010, 4, 1e-3)
    assert d is None and n == 0


def test_median_chain_delta_min_chain_span():
    from opencl_fft_tpu_torch.utils.profiling import median_chain_delta

    calls = []

    def timed(k):
        calls.append(k)
        return 1e-3 * k

    d, n = median_chain_delta(timed, 4, 1e-5, min_chain_s=0.05)
    assert n == 3 and abs(d - 1e-3) < 1e-9
    assert max(calls) - 1 >= 50
    calls.clear()
    d, n = median_chain_delta(timed, 2, 1e-9, min_chain_s=10.0, max_reps_scale=8)
    assert n >= 2 and abs(d - 1e-3) < 1e-9
    assert max(calls) - 1 <= 16


def test_history_pools_across_runs_and_cpu_rows(fake_points, tmp_path):
    """A second run pools its estimates with the first's (the median of the
    windows kept), a reset drops them; a <prefix>_cpu.json adds the CPU and
    speedup rows to the table: the same artifacts as the JAX harness."""
    for sub in ("port", "jax"):
        (tmp_path / f"{sub}_cpu.json").write_text(json.dumps({"M=512,L=2^16": 10.0}))
    fake_points({(512, 1 << 16): [100.0, 300.0, 50.0, 70.0]})
    res, out = _both(tmp_path, [512], [1 << 16], row_repeats=1)
    assert res["M=512,L=2^16"] == 100.0
    res, out = _both(tmp_path, [512], [1 << 16], row_repeats=1)
    assert res["M=512,L=2^16"] == 200.0                 # median of 100, 300
    hist = json.load(open(out + "_history.json"))
    assert hist["M=512,L=2^16"]["windows"] == [100.0, 300.0]
    assert hist["M=512,L=2^16"]["fp"] == S._code_fingerprint()
    res, out = _both(tmp_path, [512], [1 << 16], row_repeats=1, reset_history=True)
    assert res["M=512,L=2^16"] == 50.0
    table = open(out + "_table.tex").read()
    assert "512 (cpu) & 10" in table and "512 (speedup) & 5.0" in table


def test_stale_fingerprint_history_is_discarded(fake_points, tmp_path):
    out = str(tmp_path / "port")
    with open(out + "_history.json", "w") as f:
        json.dump({"M=512,L=2^16": {"fp": "stale", "windows": [9999.0]},
                   "M=512,L=2^17": [8888.0]}, f)
    fake_points({(512, 1 << 16): [100.0]})
    res = S.run_sweep([512], [1 << 16], out_prefix=out, row_repeats=1)
    assert res["M=512,L=2^16"] == 100.0
    fake_points({(512, 1 << 16): [100.0]})
    JS.run_sweep([512], [1 << 16], out_prefix=str(tmp_path / "jax"), row_repeats=1)


def test_command_line_quick(fake_points, tmp_path, monkeypatch):
    """``--quick --repeats 1`` measures the quick grid (M 2^9, 2^11 x L
    2^16, 2^18) and writes the three artifacts."""
    sched = {(m, L): [1000.0 - m / 8 - L / 1e4] for m in (512, 2048)
             for L in (1 << 16, 1 << 18)}
    fake_points(sched)
    out = str(tmp_path / "q")
    monkeypatch.setattr(sys, "argv", ["sweep", "--quick", "--repeats", "1", "--out", out,
                                      "--device", "cpu"])
    S.main()
    res = json.load(open(out + ".json"))
    assert sorted(res) == sorted(f"M={m},L=2^{l}" for m in (512, 2048) for l in (16, 18))
    assert open(out + "_plot.csv").read().startswith("log2L,M512,M2048\n")
    JS.run_sweep([512, 2048], [1 << 16, 1 << 18], out_prefix=str(tmp_path / "jq"),
                 row_repeats=1)


@pytest.mark.parametrize("tv", [True, False])
def test_rt_ratio_on_the_cpu(tv):
    """One real point of the port's engine on the CPU (small scans): a
    finite positive ratio, and the CPU-oracle arm's in-process timing."""
    r = S.rt_ratio(256, 1 << 11, scan_blocks=8, reps=2, tv=tv, device="cpu")
    assert np.isfinite(r) and r > 0
    c = S.cpu_rt_ratio_inprocess(256, 1 << 11, scan_blocks=8, repeats=1, tv=tv)
    assert np.isfinite(c) and c > 0


def test_cpu_oracle_merges(tmp_path, monkeypatch):
    monkeypatch.setattr(S, "cpu_rt_ratio_inprocess", lambda pts, L, tv=True: pts / 8 + L / 1e4)
    path = tmp_path / "cpu.json"
    path.write_text(json.dumps({"M=512,L=2^16": 1.5}))
    got = S.measure_cpu_oracle([512, 2048], [1 << 9, 1 << 16], str(path))
    assert got["M=512,L=2^16"] == 1.5                    # kept
    assert got["M=512,L=2^9"] == round(64 + 512 / 1e4, 1)
    assert "M=2048,L=2^9" not in got                     # L < M skipped
    assert json.load(open(path)) == got


def test_command_line_makes_the_out_directory(tmp_path, monkeypatch):
    """``--out`` is a path prefix; its directory is made if missing."""
    monkeypatch.setattr(S, "rt_ratio", lambda pts, ir_len, **kw: 500.0 - pts / 8)
    out = tmp_path / "a" / "b" / "sw"
    monkeypatch.setattr(sys, "argv", ["sweep", "--quick", "--repeats", "1", "--out", str(out),
                                      "--device", "cpu"])
    S.main()
    assert (out.parent / "sw.json").is_file() and (out.parent / "sw_table.tex").is_file()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_paths_timer_needs_a_card():
    """``bench/paths.py`` times on the card only: without one its worker
    refuses before building or timing anything."""
    from opencl_fft_tpu_torch.bench import paths

    with pytest.raises(RuntimeError, match="no CUDA card"):
        paths.worker(str(paths.ROOT), 1)
