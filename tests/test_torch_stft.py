"""Port parity: the STFT layer of opencl_fft_tpu_torch (``ops/stft.py``:
``frame``, ``stft``, ``istft``, ``spectrogram``) against opencl_fft_tpu's
``ops/stft.py``, on every case of ``tests/test_stft.py`` (framing, round
trip at three (nfft, hop) pairs, scipy magnitudes, the spectrogram peak,
batched input) and on the same numpy-seeded inputs through both functions,
at 1e-5 of max|JAX|. ``istft`` is compared with JAX's on the interior
[nfft, T - nfft), the range ``tests/test_stft.py`` holds to the input: at
the first and last samples the window-square sum is near 0 and the COLA
division magnifies each package's rounding.
"""

import numpy as np
import pytest
import torch
from scipy import signal as sps

from opencl_fft_tpu.ops import stft as JS
from opencl_fft_tpu_torch.ops import stft as S

torch.set_num_threads(1)

RNG = np.random.default_rng(61)
TOL = 1e-5


def _close(got, ref, rel=TOL):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=rel * (np.abs(ref).max() + 1e-30), rtol=0)


def test_frame_shapes_and_content():
    x = np.arange(10, dtype=np.float32)
    f = S.frame(x, nfft=4, hop=2, device="cpu").numpy()
    assert f.shape == (4, 4)
    np.testing.assert_array_equal(f[0], [0, 1, 2, 3])
    np.testing.assert_array_equal(f[1], [2, 3, 4, 5])
    np.testing.assert_array_equal(f[3], [6, 7, 8, 9])
    for t, nfft, hop in ((10, 4, 2), (3, 8, 4), (17, 8, 3), (8, 8, 8)):
        x = np.arange(t, dtype=np.float32)
        np.testing.assert_array_equal(S.frame(torch.from_numpy(x), nfft, hop).numpy(),
                                      np.asarray(JS.frame(x, nfft, hop)))


@pytest.mark.parametrize("nfft,hop", [(256, 128), (512, 128), (1024, 256)])
def test_roundtrip(nfft, hop):
    x = RNG.standard_normal(8192).astype(np.float32)
    spec = S.stft(x, nfft, hop, device="cpu")
    y = S.istft(spec, nfft, hop, length=8192).numpy()
    # edges lose energy below COLA coverage; compare the interior
    lo, hi = nfft, 8192 - nfft
    np.testing.assert_allclose(y[lo:hi], x[lo:hi], atol=1e-4 * np.max(np.abs(x)), rtol=0)
    jspec = JS.stft(x, nfft, hop)
    for g, w in zip(spec, jspec):
        _close(g, w)
    jy = np.asarray(JS.istft(jspec, nfft, hop, length=8192))
    assert y.shape == jy.shape
    _close(y[lo:hi], jy[lo:hi])


def test_matches_scipy_magnitudes():
    x = RNG.standard_normal(4096).astype(np.float32)
    nfft, hop = 512, 256
    re, im = S.stft(x, nfft, hop, device="cpu")
    ours = np.sqrt(re.numpy() ** 2 + im.numpy() ** 2)
    _, _, Z = sps.stft(x, nperseg=nfft, noverlap=nfft - hop,
                       window="hann", boundary=None, padded=True)
    theirs = np.abs(Z).T * (S.hann_np(nfft).sum())       # undo scipy's 1/win.sum()
    n = min(ours.shape[0], theirs.shape[0])
    np.testing.assert_allclose(ours[:n], theirs[:n], atol=2e-3 * theirs.max(), rtol=0)
    jr, ji = JS.stft(x, nfft, hop)
    _close(ours, np.sqrt(np.asarray(jr) ** 2 + np.asarray(ji) ** 2))


def test_spectrogram_peak():
    sr, nfft = 8192, 1024
    t = np.arange(sr) / sr
    x = np.sin(2 * np.pi * 1024 * t).astype(np.float32)  # bin 128 at nfft=1024
    p = S.spectrogram(x, nfft, nfft // 2, device="cpu").numpy()
    assert (np.argmax(p, axis=-1) == 128).all()
    _close(p, JS.spectrogram(x, nfft, nfft // 2))


def test_batched():
    x = RNG.standard_normal((3, 4096)).astype(np.float32)
    re, im = S.stft(torch.from_numpy(x), 512, 256)
    assert re.shape[0] == 3 and re.shape[-1] == 257
    jr, ji = JS.stft(x, 512, 256)
    _close(re, jr)
    _close(im, ji)
    y = S.istft((re, im), 512, 256, length=4096)
    jy = np.asarray(JS.istft((jr, ji), 512, 256, length=4096))
    _close(y[:, 512:-512], jy[:, 512:-512])


def test_custom_window_and_default_hop():
    """A caller's window and hop = nfft // 2 by default, as in JAX."""
    x = RNG.standard_normal(3000).astype(np.float32)
    win = np.hanning(256).astype(np.float32) + 0.1
    got = S.stft(x, 256, window=win, device="cpu")
    want = JS.stft(x, 256, window=win)
    for g, w in zip(got, want):
        _close(g, w)
    y = S.istft(got, 256, window=win, length=3000).numpy()
    jy = np.asarray(JS.istft(want, 256, window=win, length=3000))
    _close(y[256:-256], jy[256:-256])


def test_rejects_bad_arguments():
    with pytest.raises(ValueError, match="power of two"):
        S.stft(np.zeros(1000, np.float32), 1000, device="cpu")
    with pytest.raises(ValueError, match="pass device="):
        S.stft(np.zeros(1000, np.float32), 256)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the FFT kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nfft,hop", [(1024, 256), (4096, 1024)])
def test_cuda_matches_cpu(cuda_device, nfft, hop):
    """On the card (the FFT kernel, fold's fixed-order sums): the same
    spectra and round trip as the CPU within 1e-5, and istft twice is
    bit-equal (deterministic)."""
    x = RNG.standard_normal(48000).astype(np.float32)
    spec = S.stft(x, nfft, hop, device=cuda_device)
    cpu = S.stft(x, nfft, hop, device="cpu")
    for g, w in zip(spec, cpu):
        _close(g, w)
    y1 = S.istft(spec, nfft, hop, length=x.size)
    y2 = S.istft(spec, nfft, hop, length=x.size)
    assert torch.equal(y1, y2)
    _close(y1[nfft:-nfft], S.istft(cpu, nfft, hop, length=x.size)[nfft:-nfft])
