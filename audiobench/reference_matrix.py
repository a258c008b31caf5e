"""The plain reference of a convolution matrix, for the matrix cells: the
last n samples of each output y_o = sum_i x_i (*) h_{o,i}, on
``reference.lti_tail`` (float64 ``torch.fft``, or bfloat16 for a control
reference) by broadcasting the inputs (1, n_in, S) against the IRs
(n_out, n_in, L), then summed over the inputs. It imports nothing of the
program."""

from __future__ import annotations

import torch

from .reference import lti_tail


def matrix_tail(x: torch.Tensor, irs: torch.Tensor, n: int, precision: str = "f64",
                outputs: int = 4) -> torch.Tensor:
    """x: (n_in, S) input samples, aligned as for ``lti_tail``; irs:
    (n_out, n_in, L). Returns (n_out, n) in float64, computed ``outputs``
    outputs at a time so that the pairs' spectra fit beside the program's
    answers."""
    rows = []
    for o in range(0, irs.shape[0], outputs):
        pairs = lti_tail(x[None], irs[o:o + outputs], n, precision)   # (k, n_in, n)
        rows.append(pairs.sum(dim=1))
    return torch.cat(rows)
