"""The processors' direct accumulate path (``stream._accumulate``): a
callback that cannot fill the partition, on 1-D float32 arrays, is a few
numpy slice operations on the accumulator's buffers. Held bit for bit
against the path every other callback takes (``_feed``), on the native and
the numpy accumulator, for both processors; its outputs are fresh arrays;
other inputs keep the old path; and on the native accumulator it makes no
call into the C++ runtime."""

import shutil

import numpy as np
import pytest

from opencl_fft_tpu_torch import runtime
from opencl_fft_tpu_torch import stream as tstream

PARTS = 8192

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ on PATH")


def _quiet(message, user_data):
    pass


def _processor(kind: str, acc: str, scale: float = 1.0):
    """A processor at partition 8192 on the CPU, on the ``acc`` accumulator."""
    if kind == "tv":
        proc = tstream.CltvconvProcessor(PARTS, 2 * PARTS, scale=scale, device="cpu",
                                         on_message=_quiet)
    else:
        ir = np.random.default_rng(5).standard_normal(12000).astype(np.float32)
        proc = tstream.ClconvProcessor(ir, PARTS, scale=scale, device="cpu",
                                       on_message=_quiet)
    proc._acc = tstream.make_accumulator(PARTS, 2 if kind == "tv" else 1,
                                         native=acc == "native")
    assert isinstance(proc._acc, runtime.NativeBlockAccumulator) == (acc == "native")
    return proc


def _signals(k: int, calls: int):
    x = np.random.default_rng(k).standard_normal((2, k * calls)).astype(np.float32)
    return x[0], x[1]


def _freeze(i: int):
    """freeze1 / freeze2 of callback i: each toggled mid-partition."""
    return i % 7 not in (3, 4), i % 11 not in (5, 6, 7)


def _run(proc, kind: str, k: int, calls: int, as_input=lambda v: v):
    """The outputs and counts of ``calls`` callbacks of k samples."""
    a, b = _signals(k, calls)
    outs, cnts = [], []
    for i in range(calls):
        sl = slice(i * k, (i + 1) * k)
        if kind == "tv":
            f1, f2 = _freeze(i)
            outs.append(proc.process(as_input(a[sl]), as_input(b[sl]), freeze1=f1, freeze2=f2))
        else:
            outs.append(proc.process(as_input(a[sl])))
        cnts.append(proc._acc.cnt)
    return outs, cnts


def _counting(monkeypatch):
    """Count the callbacks that ``_accumulate`` takes."""
    taken = []
    direct = tstream._accumulate

    def counted(*args, **kw):
        out = direct(*args, **kw)
        taken.append(out is not None)
        return out

    monkeypatch.setattr(tstream, "_accumulate", counted)
    return taken


@pytest.mark.parametrize("acc", ["native", "numpy"])
@pytest.mark.parametrize("kind,scale", [("tv", 1.0), ("tv", 0.7), ("lti", 1.0), ("lti", 0.7)])
@pytest.mark.parametrize("k", [64, 100, 8191])
def test_direct_path_equals_the_feed_path(monkeypatch, kind, scale, acc, k):
    """Over three partitions' callbacks (k dividing the partition,
    straddling its boundary, one short of it; the TV freezes toggled
    mid-partition), the outputs, counts and input buffers of the direct path
    equal those of ``_feed`` alone (tolerance 0)."""
    calls = 3 * PARTS // k + 2
    proc = _processor(kind, acc, scale)
    taken = _counting(monkeypatch)
    got, got_cnt = _run(proc, kind, k, calls)
    assert sum(taken) == sum(1 for c in [0] + got_cnt[:-1] if c + k < PARTS) > 0
    monkeypatch.setattr(tstream, "_accumulate", lambda *a, **kw: None)
    ref = _processor(kind, acc, scale)
    want, want_cnt = _run(ref, kind, k, calls)
    assert got_cnt == want_cnt
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and np.array_equal(g, w)
    assert np.array_equal(proc._acc.bufin, ref._acc.bufin)
    assert np.array_equal(proc._acc.bufout, ref._acc.bufout)
    if acc == "native":                        # the C++ count follows at the next firing
        proc._acc.feed(np.zeros((proc._acc.n_streams, PARTS), np.float32),
                       lambda buf: buf[0])
        assert proc._acc.cnt == proc._acc._lib.acc_cnt(proc._acc._h) == got_cnt[-1]


@pytest.mark.parametrize("acc", ["native", "numpy"])
@pytest.mark.parametrize("kind", ["tv", "lti"])
def test_outputs_are_fresh_arrays(kind, acc):
    """No output shares memory with the accumulator, and one kept across
    firings keeps its values."""
    proc = _processor(kind, acc, 0.5)
    outs, _ = _run(proc, kind, 64, 2 * PARTS // 64)
    kept = [o.copy() for o in outs]
    _run(proc, kind, 64, PARTS // 64)
    for o, c in zip(outs, kept):
        assert not np.shares_memory(o, proc._acc.bufin)
        assert not np.shares_memory(o, proc._acc.bufout)
        assert np.array_equal(o, c)
    assert any(np.any(o) for o in outs)


@pytest.mark.parametrize("kind", ["tv", "lti"])
@pytest.mark.parametrize("as_input", [lambda v: v.tolist(), lambda v: v.astype(np.float64),
                                      lambda v: v[None, :]],
                         ids=["list", "float64", "2-D"])
def test_other_inputs_take_the_feed_path_with_the_same_answers(monkeypatch, kind, as_input):
    """Lists, float64 and 2-D blocks of the same float32 values: the old
    path, the same answers bit for bit."""
    calls = 2 * PARTS // 64 + 3
    want, want_cnt = _run(_processor(kind, "native", 0.7), kind, 64, calls)
    taken = _counting(monkeypatch)
    got, got_cnt = _run(_processor(kind, "native", 0.7), kind, 64, calls, as_input)
    assert not any(taken)
    assert got_cnt == want_cnt
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("kind", ["tv", "lti"])
def test_accumulate_only_callbacks_make_no_native_call(monkeypatch, kind):
    """127 callbacks of 64 samples into a partition of 8192 with every
    function of the C++ accumulator but its constructor and destructor
    raising, and ``np.ctypeslib``; the 128th fires through it."""
    proc = _processor(kind, "native", 0.7)
    lib = proc._acc._lib

    def crossing(*args):
        raise AssertionError("a call into the C++ accumulator")

    for name in ("acc_cnt", "acc_set_cnt", "acc_bufin", "acc_bufout", "acc_feed", "acc_full",
                 "acc_set_bufout"):
        monkeypatch.setattr(lib, name, crossing)
    monkeypatch.setattr(np.ctypeslib, "as_array", crossing)
    outs, cnts = _run(proc, kind, 64, PARTS // 64 - 1)
    assert cnts == [64 * (i + 1) for i in range(PARTS // 64 - 1)]
    monkeypatch.undo()
    a, b = _signals(64, 1)
    out = proc.process(a, b) if kind == "tv" else proc.process(a)
    assert proc._acc.cnt == 0 and out.shape == (64,)
    assert lib.acc_cnt(proc._acc._h) == 0
