"""Head-tracked binaural room synthesis in the port: ``MatrixConvolver``'s
BRIR bank (``fill_bank``) and its per-input switch (``switch``), against
the plain reference of ``tests/brs_reference.py`` on seeded random IRs at
3 sources x 2 ears x 8 orientations, cvs 256, pts 32; against
``set_ir`` of the same time-domain IRs (one crossfade-begin path:
bit-equal on the CPU); the switch's spans and counters; and on a card, the
bank switch against ``set_ir`` at the benchmark cell's shape.

Tolerances: the program computes in float32 against a float64 reference,
so outputs agree to float32 rounding of a partitioned convolution and a
blend (~1e-6 of the output's peak); ``TOL`` = 1e-5 of the peak leaves
room, and bfloat16 rings (~3e-3) fail it.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from audiobench import reference_brs
from opencl_fft_tpu_torch import models as M
from opencl_fft_tpu_torch.ops import pconv as P
from opencl_fft_tpu_torch.utils import profiling as PF

from brs_reference import convolutions, render

N_IN, N_OUT, D, PTS, NPARTS = 3, 2, 8, 32, 8
TOL = 1e-5
F32 = 4


def _rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.to(torch.float64) - ref).abs().max() / ref.abs().max())


def _bank(seed: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((N_IN, D, N_OUT, PTS * NPARTS), generator=gen)


def _engine(bank: torch.Tensor, ring_dtype: str = "f32") -> M.MatrixConvolver:
    cfg = P.PconvConfig(pts=PTS, nparts=NPARTS, ring_dtype=ring_dtype)
    m = M.MatrixConvolver(cfg, N_IN, N_OUT, device="cpu")
    m.fill_bank(bank[:2])                    # in two chunks of inputs
    m.fill_bank(bank[2:], first=2)
    return m


def _inputs(nblocks: int, seed: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed + 1000)
    return torch.randn((nblocks, N_IN, PTS), generator=gen)


def _samples(blocks: torch.Tensor) -> torch.Tensor:
    return blocks.permute(1, 0, 2).reshape(blocks.shape[1], -1)


def _pair_irs(bank: torch.Tensor, index) -> torch.Tensor:
    """(n_out, n_in, cvs): the IRs ``set_ir`` takes for bank ``index``."""
    return bank[np.arange(N_IN), np.asarray(index)].permute(1, 0, 2)


def _run(m, x, switches):
    out = []
    for t in range(len(x)):
        if t in switches:
            m.switch(*switches[t])
        out.append(m.step(x[t]))
    return torch.stack(out)


@pytest.fixture(params=["plain", "kernels"])
def route(request, monkeypatch):
    """Each case on the CPU's plain composition and on the card's route
    (the block-step kernels' twins, taken for CPU tensors)."""
    if request.param == "kernels":
        monkeypatch.setattr(P, "_block_kernels", lambda cfg, device: True)
    return request.param


# -- against the plain reference ----------------------------------------------

@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("per_input", [False, True])
def test_switch_every_block(route, seed, per_input):
    """A new orientation on every block, crossfaded over the block, for 14
    blocks: the one head yaw of every source, or one index an input."""
    bank, nblocks = _bank(seed), 14
    rng = np.random.default_rng(seed)
    switches, prev = {}, None
    for t in range(nblocks):
        while True:
            index = rng.integers(0, D, N_IN) if per_input else np.full(N_IN, rng.integers(D))
            if prev is None or (index != prev).all():
                break
        switches[t], prev = (index, 0 if t == 0 else 1), index
    x = _inputs(nblocks, seed)
    got = _run(_engine(bank), x, switches)
    ref = render(_samples(x), bank, switches, nblocks, PTS)
    assert _rel_err(got, ref) < TOL


def test_fade_retargeted_mid_fade(route):
    """A 3-block fade from block 4, retargeted at block 5: input 0 again,
    input 1 only then; input 2 stays. Then a 3-block fade that runs out."""
    bank, nblocks = _bank(4), 16
    switches = {0: ([1, 2, 3], 0), 4: ([5, 2, 3], 3), 5: ([6, 7, 3], 3),
                10: ([6, 0, 3], 3)}
    x = _inputs(nblocks, 4)
    m = _engine(bank)
    got = _run(m, x, switches)
    assert m._conv._xf is None
    ref = render(_samples(x), bank, switches, nblocks, PTS)
    assert _rel_err(got, ref) < TOL


def test_instant_switch(route):
    """``fade_blocks=0`` is ``set_ir``'s instant swap, bit for bit; from
    the block after it the output is the new IRs' exact convolution."""
    bank, nblocks = _bank(5), 10
    switches = {0: ([1, 2, 3], 0), 4: ([4, 2, 0], 0)}
    x = _inputs(nblocks, 5)
    got = _run(_engine(bank), x, switches)
    m = M.MatrixConvolver(P.PconvConfig(pts=PTS, nparts=NPARTS), N_IN, N_OUT, device="cpu")
    want = []
    for t in range(nblocks):
        if t in switches:
            m.set_ir(_pair_irs(bank, switches[t][0]), fade_blocks=0)
        want.append(m.step(x[t]))
    assert torch.equal(got, torch.stack(want))
    ref = render(_samples(x), bank, switches, nblocks, PTS)
    keep = [t for t in range(nblocks) if t != 4]
    assert _rel_err(got[keep], ref[keep]) < TOL
    assert _rel_err(got[4], ref[4]) > TOL       # the click: the old tail's block


def test_bfloat16_rings_fail_the_tolerance():
    bank, nblocks = _bank(6), 12
    switches = {t: ([t % D, (t + 3) % D, (2 * t) % D], 0 if t == 0 else 1)
                for t in range(nblocks)}
    x = _inputs(nblocks, 6)
    got = _run(_engine(bank, ring_dtype="bf16"), x, switches)
    assert _rel_err(got, render(_samples(x), bank, switches, nblocks, PTS)) > TOL


def test_reference_convolutions_are_numpy_s():
    gen = torch.Generator().manual_seed(7)
    x = torch.randn((2, 50), generator=gen, dtype=torch.float64)
    h = torch.randn((2, 3, 2, 9), generator=gen, dtype=torch.float64)
    ys = convolutions(x, h)
    for s in range(2):
        for d in range(3):
            for e in range(2):
                want = np.convolve(x[s].numpy(), h[s, d, e].numpy())[:50]
                np.testing.assert_allclose(ys[s, d, e].numpy(), want, atol=1e-12)


def test_benchmark_reference_is_the_plain_reference():
    """``audiobench/reference_brs.ear_block`` (a one-block fade, on
    ``reference.lti_tail``) gives the plain reference's faded block, and
    ``brirs`` draws each BRIR from its own seed."""
    bank, nblocks = _bank(8).double(), 9
    switches = {0: ([1, 2, 3], 0), 8: ([4, 5, 6], 1)}
    x = _samples(_inputs(nblocks, 8)).double()
    ref = render(x, bank, switches, nblocks, PTS)[8]
    got = reference_brs.ear_block(x, bank[np.arange(N_IN), [1, 2, 3]],
                                  bank[np.arange(N_IN), [4, 5, 6]], PTS)
    assert got.shape == (N_OUT, PTS) and torch.allclose(got, ref, atol=1e-10)
    cpu = torch.device("cpu")
    whole = reference_brs.brirs(9, range(3), range(4), 2, 64, cpu)
    one = reference_brs.brirs(9, [2], [3], 2, 64, cpu)
    assert whole.shape == (3, 4, 2, 64) and torch.equal(whole[2, 3], one[0, 0])
    assert not torch.equal(whole[0, 0, 0], whole[0, 0, 1])
    assert not torch.equal(whole[0, 0, 0], reference_brs.brirs(10, [0], [0], 1, 64, cpu)[0, 0, 0])


@pytest.mark.parametrize("path", ["tests/brs_reference.py", "audiobench/reference_brs.py"])
def test_references_import_nothing_of_either_package(path):
    from pathlib import Path
    src = (Path(__file__).resolve().parents[1] / path).read_text()
    assert "opencl_fft" not in src and "jax" not in src.lower()


# -- one crossfade-begin path ------------------------------------------------------

@pytest.mark.parametrize("fade_blocks", [1, 2])
def test_bank_switch_is_set_ir(route, fade_blocks):
    """A switch of every input is ``set_ir`` of the whole matrix; of some
    inputs, ``set_ir`` of their entries; bit for bit on the CPU."""
    bank, nblocks = _bank(11), 12
    rng = np.random.default_rng(11)
    x = _inputs(nblocks, 11)
    a, b = _engine(bank), M.MatrixConvolver(P.PconvConfig(pts=PTS, nparts=NPARTS), N_IN, N_OUT,
                                            device="cpu")
    held = np.full(N_IN, -1)
    for t in range(nblocks):
        if t % fade_blocks == 0:
            index = rng.integers(0, D, N_IN)
            index[0] = (held[0] + 1) % D        # input 0 always changes
            if t % 3 == 1:
                index[1] = held[1]              # input 1 keeps its orientation
            a.switch(index, fade_blocks)
            if (index != held).all():
                b.set_ir(_pair_irs(bank, index), fade_blocks=fade_blocks)
            else:
                ins = np.flatnonzero(index != held)
                entries = [(o, i) for o in range(N_OUT) for i in ins]
                b.set_ir(torch.stack([bank[i, index[i], o] for o, i in entries]),
                         entries=entries, fade_blocks=fade_blocks)
            held = index
        assert torch.equal(a.step(x[t]), b.step(x[t]))


def test_unchanged_index_is_a_plain_step(route):
    """A switch that changes no index does nothing: the output is a plain
    step's, and a fade in flight runs on. The pairs of an input a switch
    leaves alone keep their planes and tails bit for bit."""
    bank, nblocks = _bank(12), 10
    x = _inputs(nblocks, 12)
    a, b = _engine(bank), _engine(bank)
    for m in (a, b):
        m.switch([1, 2, 3], 0)
    for t in range(3):
        a.switch([1, 2, 3], 1)
        assert torch.equal(a.step(x[t]), b.step(x[t]))
    a.switch([5, 2, 3], 2)
    b.switch([5, 2, 3], 2)
    for t in range(3, 6):
        a.switch([5, 2, 3], 1)                  # mid-fade, unchanged: the fade runs on
        assert torch.equal(a.step(x[t]), b.step(x[t]))
    c = _engine(bank)
    c.switch([1, 2, 3], 0)
    for t in range(3):
        c.step(x[t])
    for t in range(3, nblocks):
        c.step(x[t])
    # pairs (o, 1) and (o, 2) of ``a`` never switched after block 0
    rows = [o * N_IN + i for o in range(N_OUT) for i in (1, 2)]
    for t in range(6, nblocks):
        a.step(x[t])
    for name in ("spec_h_re", "spec_h_im", "tail"):
        assert torch.equal(getattr(a._conv.state, name)[rows], getattr(c._conv.state, name)[rows])


def test_stream_switch_step_stream(route):
    """The compact state of the matrix scan converts to the pair state for
    a switch; the fade's steps, then a stream again, follow the
    reference; a stream mid-fade refuses."""
    bank, nblocks = _bank(13), 14
    switches = {0: ([1, 2, 3], 0), 5: ([4, 2, 7], 2)}
    x = _inputs(nblocks, 13)
    m = _engine(bank)
    m.switch(*switches[0])
    got = [m.stream(x[:5])]
    assert m._compact is not None
    m.switch(*switches[5])
    assert m._compact is None
    got.append(m.step(x[5])[None])
    with pytest.raises(RuntimeError, match="crossfade"):
        m.stream(x[6:8])
    got.append(m.step(x[6])[None])
    got.append(m.stream(x[7:]))
    got = torch.cat(got)
    assert _rel_err(got, render(_samples(x), bank, switches, nblocks, PTS)) < TOL


def test_validation():
    bank = _bank(15)
    cfg = P.PconvConfig(pts=PTS, nparts=NPARTS)
    m = M.MatrixConvolver(cfg, N_IN, N_OUT, device="cpu")
    with pytest.raises(RuntimeError, match="fill_bank"):
        m.switch([0, 0, 0])
    with pytest.raises(ValueError, match="irs must be"):
        m.fill_bank(bank[..., :-1])
    with pytest.raises(ValueError, match="irs must be"):
        m.fill_bank(bank[:, :, :1])
    with pytest.raises(ValueError, match="out of range"):
        m.fill_bank(bank[:2], first=2)
    m.fill_bank(bank)
    for bad in ([0, 0], [0, 0, 0, 0], [[0, 0, 0]], [0.0, 1.0, 2.0], [0, D, 0], [-1, 0, 0]):
        with pytest.raises(ValueError, match="index"):
            m.switch(bad)
    with pytest.raises(ValueError, match="fade_blocks"):
        m.switch([0, 1, 2], -1)
    m.switch(np.array([0, 1, 2], np.int32), 0)


def test_a_new_bank_of_other_orientations_replaces_the_old():
    """``fill_bank`` of another D allocates anew; the inputs it filled
    switch again even to an index they hold."""
    bank = _bank(16)
    m = _engine(bank)
    m.switch([1, 1, 1], 0)
    m.fill_bank(bank[:, :4])
    assert m._bank[0].shape[1] == 4
    with pytest.raises(ValueError, match="out of range"):
        m.switch([5, 1, 1])
    x = _inputs(4, 16)
    m.switch([1, 1, 1], 0)
    ref = _engine(bank)
    ref.switch([1, 1, 1], 0)
    for t in range(4):
        assert torch.equal(m.step(x[t]), ref.step(x[t]))


def test_a_fill_in_chunks_is_one_fill(monkeypatch):
    """Analysed a few orientations at a time or all at once, the bank
    holds the same planes, bit for bit."""
    bank = _bank(20)
    whole = _engine(bank)
    monkeypatch.setattr(M.convolver, "_FILL_ROWS", 2 * N_OUT * NPARTS + 1)
    chunked = _engine(bank)
    for a, b in zip(whole._bank, chunked._bank):
        assert torch.equal(a, b)


# -- the cell, run whole at a tiny size in a process of its own ------------------

_SCRIPT = """
import json, shutil, sys
from pathlib import Path
import torch
from audiobench import catalog, run
torch.set_num_threads(1)
repo, root = Path(sys.argv[1]), Path(sys.argv[2])
shutil.copy(repo / "BENCHMARK.json", root / "BENCHMARK.json")
shutil.copytree(repo / "audiobench", root / "audiobench",
                ignore=shutil.ignore_patterns("__pycache__"))
cell = catalog.cell(catalog.benchmark(root), "brs24x2_headturn")
for kind, name, changes in (("configs", cell["config"], {config}),
                            ("traffic", cell["traffic"], {mix})):
    path = root / "audiobench" / kind / (name + ".json")
    path.write_text(json.dumps(dict(json.loads(path.read_text()), **changes)))
for trace, control in ((0, 0), (1, 0), (0, 1)):
    rc = run.main(["--workload", "brs24x2_headturn", "--seed", "3100000019", "--seconds",
                   "0.4", "--trace", str(trace), "--control", str(control)],
                  root=root, device="cpu")
    print("RC", rc, flush=True)
print("LOADED", " ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_the_cell_runs_without_jax(tmp_path):
    """The cell ``brs24x2_headturn`` at 3 sources x 2 ears x 8 yaws through
    ``audiobench.run`` on the CPU, in a process that loads no JAX:
    correct untraced and traced (the switch's and the step's span readers
    read), not correct as its bfloat16 control."""
    import json
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parents[1]
    script = _SCRIPT.format(
        config=dict(inputs=3, outputs=2, orientations=8, taps=256, partition=32,
                    sample_rate=4000),
        mix=dict(pool_samples=2048, check_blocks=4, yaw_limit_deg=3, turn_max_deg=1))
    proc = subprocess.run([sys.executable, "-c", script, str(repo), str(tmp_path)], cwd=repo,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines, last, loaded = [], None, set()
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            last = json.loads(line)
        elif line.startswith("RC "):
            assert line == "RC 0"
            lines.append(last)
        elif line.startswith("LOADED "):
            loaded = set(line.split()[1:])
    untraced, traced, control = lines
    assert untraced["correct"] and traced["correct"] and not control["correct"]
    assert untraced["checks"]["max_rel_err"]["value"] < 2e-6
    assert set(traced["metrics"]) == {"switch_us_per_block.brs",
                                      "step_enqueue_us_per_block.opcode"}
    assert control["checks"]["max_rel_err"]["value"] > 1e-4
    assert "opencl_fft_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "opencl_fft_tpu"}


# -- spans and counters --------------------------------------------------------------

@pytest.fixture
def fresh():
    PF.reset()
    yield
    PF.reset()


def _profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _within(inner, outer) -> bool:
    return outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def test_spans_and_counters(fresh):
    """While a profiler records: the allocation counts ``bank.bytes``;
    each switch that changes an index is a ``switch`` request with its
    ``gather`` span inside and counts the pairs switched and the planes
    written; each fade block is an ``xfade`` span, holding the step, inside
    the ``matrix`` request. A switch of one input gathers its pairs' planes
    and writes the whole ring besides."""
    bank, nblocks = _bank(17), 5
    x = _inputs(nblocks, 17)
    plane = NPARTS * PTS * F32
    with _profiled():
        m = _engine(bank)
        for t in range(nblocks):
            m.switch([t, t + 2, (t + 4) % D], 1)
            m.step(x[t])
        m.switch([4, 6, 0], 1)                  # no change: nothing recorded
        m.switch([4, 7, 0], 1)                  # input 1 alone
        m.step(x[0])
    c = PF.counters()
    assert c["bank.bytes"] == 2 * N_IN * D * N_OUT * plane
    assert c["xfade.switches"] == N_IN * N_OUT * nblocks + N_OUT
    assert c["xfade.blocks"] == nblocks + 1
    assert c["bank.gather_bytes"] == (2 * N_IN * N_OUT * plane * nblocks
                                      + 2 * N_OUT * plane + 2 * N_IN * N_OUT * plane)
    sp = PF.spans()
    switches = [s for s in sp if s.name == "switch" and s.parent is None]
    assert len(switches) == nblocks + 1
    for s in switches:
        kids = [k for k in sp if k.request == s.request and k.parent == "switch"]
        assert [k.name for k in kids] == ["gather"] and _within(kids[0], s)
    tops = [s for s in sp if s.name == "matrix" and s.parent is None]
    assert len(tops) == nblocks + 1
    for top in tops:
        kids = sorted((k for k in sp if k.request == top.request and k.parent == "matrix"),
                      key=lambda k: k.start_ns)
        assert [k.name for k in kids] == ["fanout", "xfade", "fanin"]
        (step,) = [k for k in sp if k.request == top.request and k.parent == "xfade"]
        assert step.name == "step" and _within(step, kids[1])


def test_nothing_is_recorded_with_the_profiler_off(fresh):
    m = _engine(_bank(18))
    m.switch([1, 2, 3], 1)
    m.step(_inputs(1, 18)[0])
    assert PF.spans() == [] and PF.counters().get("xfade.switches") is None


# -- on a card ---------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the block-step kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_bank_switch_is_set_ir_at_the_cells_shape(cuda_device):
    """24 sources x 2 ears, pts 512, nparts 128, 3 orientations: a bank
    switch on every block (one-block fades) against ``set_ir`` of the same
    IRs. The bank analyses 6 IRs at a time and ``set_ir`` 48, and cuBLAS
    keeps no promise that a row's float64 product is the same at other
    row counts, so a plane may differ in its float32 rounding: the outputs
    agree within 1e-6 of their peak (float32 rounding of the planes alone,
    ~1e-7)."""
    n_in, n_out, d, pts, nparts, nblocks = 24, 2, 3, 512, 128, 6
    gen = torch.Generator(device=cuda_device).manual_seed(19)
    bank = torch.randn((n_in, d, n_out, pts * nparts), generator=gen, device=cuda_device)
    bank *= torch.exp(-torch.arange(pts * nparts, device=cuda_device) / 8192.0)
    x = torch.randn((nblocks, n_in, pts), generator=gen, device=cuda_device)
    cfg = P.PconvConfig(pts=pts, nparts=nparts)
    a = M.MatrixConvolver(cfg, n_in, n_out, device=cuda_device)
    b = M.MatrixConvolver(cfg, n_in, n_out, device=cuda_device)
    for s in range(n_in):
        a.fill_bank(bank[s:s + 1], first=s)
    got, want = [], []
    for t in range(nblocks):
        index = np.full(n_in, t % d)
        a.switch(index, 0 if t == 0 else 1)
        b.set_ir(bank[np.arange(n_in), index].permute(1, 0, 2), fade_blocks=0 if t == 0 else 1)
        got.append(a.step(x[t]))
        want.append(b.step(x[t]))
    got, want = torch.stack(got).cpu().double(), torch.stack(want).cpu().double()
    assert float((got - want).abs().max() / want.abs().max()) < 1e-6
