"""The plain reference: what each entry the benchmark drives must output,
worked out from the inputs alone in float64 with ``torch.fft``.

It imports nothing of the program. LTI is the linear convolution of the
input with the impulse response. Time-varying (TV) convolution is the
``cltvconv`` opcode's definition (the upstream ``cl_conv.cpp:460-548``, as
restated in numpy by ``tests/reference_model.py``): both operands are cut
into pts-sample blocks, and output block t is the overlap-add of

    A_t = sum over k in [0, nparts) of  x_{t-k} (*) h_{t - ((t-k) mod nparts)}

where (*) is the linear convolution of two pts-sample blocks: the input
block of age k meets the newest coefficient block whose index has the
residue k. Fed an IR's partitions cyclically as h, that is the LTI
convolution. Blocks before the stream's first are zero.

``precision="bf16"`` is the control: the same arithmetic with every
operand, spectrum and product rounded to bfloat16 (float32 sums), the
precision below the configuration's float32.
"""

from __future__ import annotations

import torch


def _round(t: torch.Tensor, precision: str) -> torch.Tensor:
    """t rounded to bfloat16 part by part for the control, else as is."""
    if precision == "f64":
        return t
    if t.is_complex():
        return torch.complex(t.real.to(torch.bfloat16).float(),
                             t.imag.to(torch.bfloat16).float())
    return t.to(torch.bfloat16).float()


def _real(precision: str) -> torch.dtype:
    return torch.float64 if precision == "f64" else torch.float32


def lti_tail(x: torch.Tensor, ir: torch.Tensor, n: int, precision: str = "f64"
             ) -> torch.Tensor:
    """The last n samples of the linear convolution x (*) ir, row by row.

    x: (..., S) input samples, the last of them aligned with the last
    output sample; either x holds at least len(ir) - 1 samples before the
    first output sample, or x starts where the stream starts (zeros before).
    ir: (..., L). Returns (..., n) in float64 (float32 for the control)."""
    dt = _real(precision)
    x = _round(x.to(dt), precision)
    ir = _round(ir.to(dt), precision)
    s, taps = x.shape[-1], ir.shape[-1]
    nfft = 1 << (s + taps - 1 - 1).bit_length()
    spec = _round(torch.fft.rfft(x, nfft), precision) * _round(torch.fft.rfft(ir, nfft),
                                                               precision)
    y = torch.fft.irfft(_round(spec, precision), nfft)
    return y[..., s - n:s].to(torch.float64)


def tv_tail(xb: torch.Tensor, hb: torch.Tensor, first: int, n: int, nparts: int,
            precision: str = "f64", chunk: int = 8) -> torch.Tensor:
    """The last n output blocks of the time-varying convolution.

    xb, hb: (..., T, pts) blocks of the two operands whose first row has
    the absolute block index ``first``; the output blocks returned are
    first + T - n .. first + T - 1. Either the rows reach nparts blocks
    before the first output's predecessor, or ``first`` is 0. Returns
    (..., n, pts) in float64."""
    dt = _real(precision)
    pts = xb.shape[-1]
    nt = xb.shape[-2]
    X = _round(torch.fft.rfft(_round(xb.to(dt), precision), 2 * pts), precision)
    H = _round(torch.fft.rfft(_round(hb.to(dt), precision), 2 * pts), precision)
    k = torch.arange(nparts, device=xb.device)
    zero = torch.zeros(X.shape[:-2] + (1, X.shape[-1]), dtype=X.dtype, device=X.device)
    Xz, Hz = torch.cat([zero, X], -2), torch.cat([zero, H], -2)   # row 0: before the stream

    def frames(ts: torch.Tensor) -> torch.Tensor:
        """A_t for the absolute block indices ts, as (..., len(ts), 2 pts)."""
        t = ts[:, None]
        jx = t - k                                    # the input block of age k
        jh = t - torch.remainder(t - k, nparts)       # the newest coefficient block of residue k
        if bool((((jx >= 0) & (jx < first)) | ((jh >= 0) & (jh < first))).any()):
            raise ValueError("a block before the rows given is needed")
        rx = torch.where(jx >= 0, jx - first + 1, 0)
        rh = torch.where(jh >= 0, jh - first + 1, 0)
        acc = (Xz[..., rx, :] * Hz[..., rh, :])
        acc = _round(acc, precision).sum(-2)
        return torch.fft.irfft(_round(acc, precision), 2 * pts)

    last = first + nt
    outs = []
    prev = frames(torch.arange(last - n - 1, last - n, device=xb.device))[..., 0, :]
    for c0 in range(last - n, last, chunk):
        ts = torch.arange(c0, min(c0 + chunk, last), device=xb.device)
        a = frames(ts)
        for i in range(a.shape[-2]):
            outs.append(a[..., i, :pts] + prev[..., pts:])
            prev = a[..., i, :]
    return torch.stack(outs, -2).to(torch.float64)


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / max |ref| (inf for a non-finite output)."""
    got = got.to(torch.float64)
    ref = ref.to(torch.float64)
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-300))
