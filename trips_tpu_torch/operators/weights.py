"""Majorization-minimization reweighting for MMGKS.

Counterpart of ``trips_tpu/operators/weights.py`` (reference:
``trips/utilities/weights.py:29-68`` and ``trips/solvers/MMGKS.py:56-93``),
elementwise on the solution's device.

The spatial operator inside the isoTV and GS weights is the pylops centered
first derivative (``operators_old.py:22-45``): interior stencil
0.5*(x[i+1]-x[i-1]) with zero boundary rows, not the forward-difference
regularization operator.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import DEFAULT, resolve
from ..core.linop import LinearOperator


def smoothed_holder_weights(x, epsilon, p):
    """z = (x^2 + eps^2)^(p/2 - 1)  (weights.py:66-68)."""
    return (x**2 + epsilon**2) ** (p / 2 - 1)


class CenteredDerivative2D(LinearOperator):
    """pylops-style centered 2D first derivative (operators_old.py:35-45):
    [kron(I, D_c); kron(D_c, I)] with D_c the centered stencil, zero edges.
    Shape (2*nx*ny, nx*ny); applies ``(n, k)`` columns at once."""

    capturable = True

    def __init__(self, nx, ny, device=DEFAULT):
        self.nx, self.ny = nx, ny
        self.shape = (2 * nx * ny, nx * ny)
        self.device = resolve(device)

    def matvec(self, x):
        cols = tuple(x.shape[1:])
        X = x.reshape(self.nx, self.ny, *cols)
        d1 = torch.zeros_like(X)  # along axis 1 (within a row)
        d1[:, 1:-1] = 0.5 * (X[:, 2:] - X[:, :-2])
        d0 = torch.zeros_like(X)
        d0[1:-1, :] = 0.5 * (X[2:, :] - X[:-2, :])
        return torch.cat([d1.reshape(-1, *cols), d0.reshape(-1, *cols)])

    def rmatvec(self, y):
        nx, ny = self.nx, self.ny
        cols = tuple(y.shape[1:])
        Y1 = y[: nx * ny].reshape(nx, ny, *cols)
        Y0 = y[nx * ny:].reshape(nx, ny, *cols)
        Z = y.new_zeros((nx, ny, *cols))
        Z[:, 2:] += 0.5 * Y1[:, 1:-1]
        Z[:, :-2] += -0.5 * Y1[:, 1:-1]
        Z[2:, :] += 0.5 * Y0[1:-1, :]
        Z[:-2, :] += -0.5 * Y0[1:-1, :]
        return Z.reshape(-1, *cols)

    matmat = matvec
    rmatmat = rmatvec


def iso_tv_weights(x, u, nx, ny, nt, epsilon, qnorm):
    """Isotropic-TV weights for dynamic problems (MMGKS.py:61-78).

    x: current solution, frame-major (nt*nx*ny,); u = L @ x with L the
    dynamic TV operator (spatial rows first, then the time block). The x/y
    derivative pairs per pixel per frame are coupled isotropically; the time
    block keeps smoothed-Holder weights.

    Deviation (deliberate, as in the JAX package): the reference reshapes
    the frame-major solution with ``x.reshape(nx**2, nt)`` in C order
    (MMGKS.py:68), pairing unrelated pixels across frames; here pixel p of
    frame t is paired with itself.
    """
    Ls = CenteredDerivative2D(nx, ny, device=x.device)
    spacen = nx * ny
    spacent = spacen * nt
    X = x.reshape(nt, spacen).T  # (pixels, frames)
    LsX = Ls.matmat(X)  # (2*nx*ny, nt)
    L1, L2 = LsX[:spacen, :], LsX[spacen: 2 * spacen, :]
    weightx = (L1**2 + L2**2 + epsilon**2) ** ((qnorm - 2) / 4)
    # per-frame blocks of [d/dx; d/dy] weights, frame-major like L's rows
    wx_frames = torch.cat([weightx.T, weightx.T], dim=1)  # (nt, 2*spacen)
    weightt = (u[2 * spacent:] ** 2 + epsilon**2) ** ((qnorm - 2) / 4)
    return torch.cat([wx_frames.reshape(-1), weightt.reshape(-1)])


def gs_weights(x, Ls_matmat, nx, ny, nt, qnorm):
    """Group-sparsity weights (MMGKS.py:79-91): couple each spatial-derivative
    row across the nt frames, then tile over frames.

    The reference adds ``np.exp(2)`` (not epsilon^2) inside the power, a
    quirk kept for parity (MMGKS.py:87-89); its C-order frame-major reshape
    is fixed as in :func:`iso_tv_weights`.
    """
    X = x.reshape(nt, nx * ny).T  # (pixels, frames)
    D = Ls_matmat(X)  # (nrows, nt)
    row_energy = torch.sum(D**2, dim=1)
    wr = (row_energy + np.exp(2)) ** (qnorm / 2 - 1)
    return wr.repeat(nt)
