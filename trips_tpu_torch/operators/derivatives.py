"""Derivative regularization operators, matrix-free.

Counterpart of ``trips_tpu/operators/derivatives.py`` (reference:
``trips/utilities/operators.py:24-45``), with its conventions: forward
differences with sign ``x_i - x_{i+1}``,

- 1D: (n-1, n),   row i: x[i] - x[i+1]
- 2D: [ kron(I_nx, D_ny) ; kron(D_nx, I_ny) ] on x = vec(X), X (nx, ny)
  C-order (the reference's layout for square images; general nx != ny)
- spacetime: [ kron(I_nt, D2d) ; kron(D_nt, I_{nx*ny}) ]

Each apply is shifts and subtractions on the reshaped image; the 1D and 2D
operators apply ``(n, k)`` columns at once. The adjoints add the slices
into a zeros tensor in the JAX package's order (``.at[].add`` there).
``*_matrix`` build the reference's scipy matrices for tests. ``device``:
the CUDA card unless "cpu" is asked for.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import DEFAULT, resolve
from ..core.linop import LinearOperator


class FirstDerivative1D(LinearOperator):
    """Reference: gen_first_derivative_operator (operators.py:24-28)."""

    def __init__(self, n, device=DEFAULT):
        self.shape = (n - 1, n)
        self.device = resolve(device)

    def matvec(self, x):
        return x[:-1] - x[1:]

    def rmatvec(self, y):
        z = y.new_zeros((1,) + tuple(y.shape[1:]))
        return torch.cat([y, z]) - torch.cat([z, y])

    matmat = matvec
    rmatmat = rmatvec


class FirstDerivative2D(LinearOperator):
    """Reference: gen_first_derivative_operator_2D (operators.py:30-36), in
    the general form for nx != ny (the JAX package's). Row order:
    [per-row differences (axis 1); per-column differences (axis 0)]."""

    def __init__(self, nx, ny, device=DEFAULT):
        self.nx, self.ny = nx, ny
        self.shape = (nx * (ny - 1) + (nx - 1) * ny, nx * ny)
        self.device = resolve(device)

    def matvec(self, x):
        cols = tuple(x.shape[1:])
        X = x.reshape(self.nx, self.ny, *cols)
        d1 = X[:, :-1] - X[:, 1:]  # within-row (kron(I, D))
        d0 = X[:-1, :] - X[1:, :]  # across rows (kron(D, I))
        return torch.cat([d1.reshape(-1, *cols), d0.reshape(-1, *cols)])

    def rmatvec(self, y):
        nx, ny = self.nx, self.ny
        cols = tuple(y.shape[1:])
        n1 = nx * (ny - 1)
        Y1 = y[:n1].reshape(nx, ny - 1, *cols)
        Y0 = y[n1:].reshape(nx - 1, ny, *cols)
        z = y.new_zeros((nx, ny, *cols))
        z[:, :-1] += Y1
        z[:, 1:] -= Y1
        z[:-1, :] += Y0
        z[1:, :] -= Y0
        return z.reshape(-1, *cols)

    matmat = matvec
    rmatmat = rmatvec


class SpaceTimeDerivative(LinearOperator):
    """Anisotropic space+time TV operator for dynamic CT (reference:
    gen_spacetime_derivative_operator, operators.py:39-45):
    ``[kron(I_nt, D_spatial); kron(D_nt, I_{nx*ny})]``; the frames are the
    columns of one spatial apply."""

    def __init__(self, nx, ny, nt, device=DEFAULT):
        self.nx, self.ny, self.nt = nx, ny, nt
        self.spatial = FirstDerivative2D(nx, ny, device=device)
        self.device = self.spatial.device
        s = self.spatial.shape[0]
        self.shape = (nt * s + (nt - 1) * nx * ny, nt * nx * ny)

    def matvec(self, x):
        X = x.reshape(self.nt, self.nx * self.ny)
        sp = self.spatial.matmat(X.T).T.reshape(-1)
        tm = (X[:-1] - X[1:]).reshape(-1)
        return torch.cat([sp, tm])

    def rmatvec(self, y):
        nx, ny, nt = self.nx, self.ny, self.nt
        s = self.spatial.shape[0]
        Ysp = y[: nt * s].reshape(nt, s)
        Ytm = y[nt * s:].reshape(nt - 1, nx * ny)
        out = self.spatial.rmatmat(Ysp.T).T.contiguous()
        out[:-1] += Ytm
        out[1:] -= Ytm
        return out.reshape(-1)


class CenteredSpaceTimeDerivative(LinearOperator):
    """Dynamic TV operator with pylops-style centered stencils (reference:
    ``operators_old.py:47-60``): per frame the centered 2D derivative
    ``[d/dx; d/dy]`` (frame-major), then the centered time block; shape
    (3*nx*ny*nt, nx*ny*nt)."""

    def __init__(self, nx, ny, nt, device=DEFAULT):
        from .weights import CenteredDerivative2D

        self.nx, self.ny, self.nt = nx, ny, nt
        self.spatial = CenteredDerivative2D(nx, ny, device=device)
        self.device = self.spatial.device
        self.shape = (3 * nx * ny * nt, nx * ny * nt)

    def matvec(self, x):
        p = self.nx * self.ny
        X = x.reshape(self.nt, p)
        sp = self.spatial.matmat(X.T).T.reshape(-1)
        # 0.5*(X[t+1] - X[t-1]), zero first and last rows
        tm = torch.zeros_like(X)
        tm[1:-1] = 0.5 * (X[2:] - X[:-2])
        return torch.cat([sp, tm.reshape(-1)])

    def rmatvec(self, y):
        p, nt = self.nx * self.ny, self.nt
        Ysp = y[: 2 * p * nt].reshape(nt, 2 * p)
        Ytm = y[2 * p * nt:].reshape(nt, p)
        out = self.spatial.rmatmat(Ysp.T).T.contiguous()
        out[2:] += 0.5 * Ytm[1:-1]
        out[:-2] += -0.5 * Ytm[1:-1]
        return out.reshape(-1)


# -- scipy mirrors for tests / export ------------------------------------

def first_derivative_matrix(n):
    from scipy import sparse

    D = sparse.diags(np.ones(n - 1), offsets=1)
    return (sparse.identity(n) - D).tocsr()[:-1, :]


def first_derivative_2d_matrix(nx, ny):
    from scipy import sparse

    return sparse.vstack(
        [
            sparse.kron(sparse.identity(nx), first_derivative_matrix(ny)),
            sparse.kron(first_derivative_matrix(nx), sparse.identity(ny)),
        ]
    ).tocsr()


def spacetime_derivative_matrix(nx, ny, nt):
    from scipy import sparse

    D2 = first_derivative_2d_matrix(nx, ny)
    return sparse.vstack(
        [
            sparse.kron(sparse.identity(nt), D2),
            sparse.kron(first_derivative_matrix(nt), sparse.identity(nx * ny)),
        ]
    ).tocsr()
