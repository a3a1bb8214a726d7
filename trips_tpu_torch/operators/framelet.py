"""Piecewise-linear tight-frame (framelet) analysis operator.

Counterpart of ``trips_tpu/operators/framelet.py`` (reference:
``trips/utilities/operators.py:50-113``): the filter bank (H0, H1, H2) as
banded matrices with reflected boundary corrections, stacked over levels
into ``W_n ((2l+1)n, n)``, and the 2D analysis operator
``(W_n @ X @ W_m^T).flatten(order='F')``. ``W_n`` and ``W_m`` are built
once on the host in float64 and held densely on the device: an apply is
two matrix products, a ``matmat`` two batched ones over its columns.

Deviation (deliberate, the JAX package's): the reference recursion
(``create_analysis_operator_rec``, operators.py:85-99) skips composing the
deepest level with the accumulated low-pass filter, which breaks the tight
frame W^T W = I for l >= 2. The low-pass chain is composed here — identical
for l = 1 — so ``W.T @ W == I`` for all levels.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import DEFAULT, resolve
from ..core.linop import LinearOperator


def construct_filters(level, n):
    """Level-``level`` banded filters (reference construct_H, operators.py:50-82)."""
    from scipy import sparse

    l = level  # noqa: E741
    e = np.ones(n)
    H0 = (
        sparse.spdiags(e, -l, n, n) + sparse.spdiags(2 * e, 0, n, n) + sparse.spdiags(e, l, n, n)
    ).tolil()
    H1 = (sparse.spdiags(-e, -l, n, n) + sparse.spdiags(e, l, n, n)).tolil()
    H2 = (
        sparse.spdiags(-e, -l, n, n) + sparse.spdiags(2 * e, 0, n, n) + sparse.spdiags(-e, l, n, n)
    ).tolil()
    for j in range(l):
        H0[j, l - j - 1] += 1
        H0[-j - 1, -l + j] += 1
        H1[j, l - j - 1] -= 1
        H1[-j - 1, -l + j] += 1
        H2[j, l - j - 1] -= 1
        H2[-j - 1, -l + j] -= 1
    return (
        (H0 / 4).toarray(),
        (H1 * (np.sqrt(2) / 4)).toarray(),
        (H2 / 4).toarray(),
    )


def analysis_matrix(n, l):  # noqa: E741
    """Stacked multi-level analysis operator W ((2l+1)n, n), tight frame."""
    lowpass = np.eye(n)
    high_rows = []
    for level in range(1, l + 1):
        H0, H1, H2 = construct_filters(level, n)
        high_rows.append(np.vstack([H1 @ lowpass, H2 @ lowpass]))
        lowpass = H0 @ lowpass
    return np.vstack([lowpass] + high_rows[::-1])


class FrameletOperator(LinearOperator):
    """2D framelet analysis operator (reference create_framelet_operator,
    operators.py:102-113): forward ``(W_n @ X @ W_m^T)`` vectorized in
    F-order, adjoint ``(W_n^T @ Y @ W_m)`` the same; ``X`` is the F-order
    ``(n, m)`` image of ``x``."""

    def __init__(self, n, m, l, dtype=torch.float32, device=DEFAULT):  # noqa: E741
        self.n, self.m, self.l = n, m, l
        self.device = resolve(device)
        self.dtype = dtype
        self.Wn = torch.tensor(analysis_matrix(n, l), dtype=dtype,
                               device=self.device)
        self.Wm = torch.tensor(analysis_matrix(m, l), dtype=dtype,
                               device=self.device)
        self.shape = (n * (2 * l + 1) * m * (2 * l + 1), n * m)

    @staticmethod
    def _apply(X, rows, cols, left, right):
        """F-order columns ``X (rows*cols, k)`` -> ``left @ img @ right`` of
        each ``(rows, cols)`` image, F-order, ``(out, k)``."""
        k = X.shape[1]
        img = X.T.reshape(k, cols, rows).transpose(1, 2)
        out = torch.matmul(torch.matmul(left, img), right)
        return out.transpose(1, 2).reshape(k, -1).T

    def matmat(self, X):
        return self._apply(X, self.n, self.m, self.Wn, self.Wm.T)

    def rmatmat(self, Y):
        s = 2 * self.l + 1
        return self._apply(Y, self.n * s, self.m * s, self.Wn.T, self.Wm)

    def matvec(self, x):
        return self.matmat(x[:, None])[:, 0]

    def rmatvec(self, y):
        return self.rmatmat(y[:, None])[:, 0]
