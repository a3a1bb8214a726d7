"""Blur (deconvolution) forward operators.

Counterpart of ``trips_tpu/operators/blur.py``. Reference semantics:

- 1D: ``scipy.ndimage.convolve1d(x, PSF, mode=bc)`` with a full-length
  Gaussian/defocus PSF (``trips/test_problems/Deblurring1D.py:51-82``);
  the adjoint applies the reversed PSF.
- 2D: ``scipy.ndimage.convolve(X, PSF, mode='reflect')`` with a small
  Gaussian PSF (``trips/test_problems/Deblurring2D.py:48-73``); the adjoint
  applies the 180-degree-flipped PSF under the same boundary condition.

- 1D: the PSF is full-length, so the operator is the dense ``(n, n)``
  matrix of ``convolve1d`` (built once on the host in float64, then cast),
  one matrix product per apply.
- 2D: scipy's ``'reflect'`` is NumPy's ``'symmetric'`` pad (the edge sample
  repeated), which torch's ``pad`` lacks: the pad is an index gather, then
  one ``conv2d`` (a correlation, so ``matvec`` passes the flipped PSF)
  over all columns of a ``matmat`` at once.

Neither ``rmatvec`` is the transpose of its ``matvec`` under the boundary
handling: both mirror the reference's reversed/flipped-PSF adjoint.
Operators hold their tensors in ``dtype`` on ``device`` (the CUDA card
unless "cpu" is asked for).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import DEFAULT, resolve
from ..core.linop import DenseOperator, LinearOperator


# -- PSFs ---------------------------------------------------------------

def gauss_psf_1d(n, parameter):
    """Reference Gauss1D (Deblurring1D.py:63-69): full-length normalized."""
    x = np.arange(-np.fix(n / 2), np.ceil(n / 2))
    psf = np.exp(-0.5 * (x**2) / (parameter**2))
    psf /= psf.sum()
    center = int(np.argmax(psf))
    return psf, center


def defocus_psf_1d(n, parameter):
    """Reference Defocus1D (Deblurring1D.py:70-82)."""
    center = int(np.fix(n / 2))
    if parameter == 0:
        psf = np.zeros(n)
        psf[center] = 1.0
    else:
        psf = np.ones(n) / (np.pi * parameter**2)
        mask = (np.arange(1, n + 1) - center) ** 2 > parameter**2
        psf[mask] = 0
        psf = psf / psf.sum()
    return psf, center


def gauss_psf_2d(dim, spread):
    """Reference Gauss (Deblurring2D.py:48-64)."""
    m, n = dim
    s1, s2 = (spread, spread) if np.isscalar(spread) else (spread[0], spread[1])
    x = np.arange(-np.fix(n / 2), np.ceil(n / 2))
    y = np.arange(-np.fix(m / 2), np.ceil(m / 2))
    X, Y = np.meshgrid(x, y)
    psf = np.exp(-0.5 * ((X**2) / (s1**2) + (Y**2) / (s2**2)))
    psf /= psf.sum()
    mm, nn = np.where(psf == psf.max())
    return psf, np.array([mm[0], nn[0]], dtype=int)


# -- 1D blur ------------------------------------------------------------

def _convolve1d_matrix(psf, n, mode):
    """``scipy.ndimage.convolve1d(., psf, mode)`` as a dense matrix: column
    j is the blur of e_j."""
    from scipy.ndimage import convolve1d

    return convolve1d(np.eye(n), psf, mode=mode, axis=0)


class Blur1D(DenseOperator):
    """Reference forward_Op_1D (Deblurring1D.py:93-102) as a dense matrix.

    ``rmatvec``/``rmatmat`` apply the reversed-PSF matrix ``_adj``, the
    reference's adjoint (Deblurring1D.py:59-62), which for full-length
    PSFs is not the transpose of ``mat`` under the boundary handling."""

    def __init__(self, n, parameter=None, boundary_condition="reflect",
                 psf=None, dtype=torch.float32, device=DEFAULT):
        if psf is None:
            psf, _ = gauss_psf_1d(n, parameter)
        self.psf = np.asarray(psf)
        self.boundary_condition = boundary_condition
        dev = resolve(device)
        fwd = _convolve1d_matrix(self.psf, n, boundary_condition)
        super().__init__(torch.tensor(fwd, dtype=dtype, device=dev))
        self._adj = torch.tensor(
            _convolve1d_matrix(self.psf[::-1], n, boundary_condition),
            dtype=dtype, device=dev)

    def rmatvec(self, y):
        return self._adj @ y

    def rmatmat(self, Y):
        return self._adj @ Y


# -- 2D blur ------------------------------------------------------------

def _symmetric_index(n, lo, hi):
    """Indices of NumPy's ``pad(mode='symmetric')`` of a length-``n`` axis by
    ``(lo, hi)``: the axis mirrored with its edge sample repeated, period
    2n (any pad width)."""
    j = np.arange(-lo, n + hi) % (2 * n)
    return np.where(j >= n, 2 * n - 1 - j, j)


class Blur2D(LinearOperator):
    """Reference forward_Op (Deblurring2D.py:66-73): ``matvec`` is
    ``scipy.ndimage.convolve(X, psf, mode='reflect')`` on the C-order
    ``(nx, ny)`` image, ``rmatvec`` the same with the flipped PSF.

    scipy's convolve centres a ``(p, q)`` kernel at ``(p // 2, q // 2)``;
    as a correlation with the flipped kernel over the symmetric-padded
    image that is the pad split ``lo = p - 1 - p // 2``, ``hi = p // 2``
    (even sizes included)."""

    def __init__(self, dim, spread, nx, ny, psf=None, dtype=torch.float32,
                 device=DEFAULT):
        if psf is None:
            psf, _ = gauss_psf_2d(dim, spread)
        self.device = resolve(device)
        self.dtype = dtype
        self.psf = torch.tensor(np.asarray(psf), dtype=dtype,
                                device=self.device)
        self.nx, self.ny = nx, ny
        self.shape = (nx * ny, nx * ny)
        p, q = self.psf.shape
        self._rows = torch.from_numpy(_symmetric_index(
            nx, p - 1 - p // 2, p // 2)).to(self.device)
        self._cols = torch.from_numpy(_symmetric_index(
            ny, q - 1 - q // 2, q // 2)).to(self.device)
        # conv2d correlates: the forward blur passes the flipped PSF
        self._fwd_w = torch.flip(self.psf, (0, 1))[None, None].contiguous()
        self._adj_w = self.psf[None, None].contiguous()

    def _apply(self, X, w):
        """Columns ``X (nx*ny, k)`` -> the blur of each, one ``conv2d``."""
        k = X.shape[1]
        img = X.T.reshape(k, 1, self.nx, self.ny)
        img = img.index_select(2, self._rows).index_select(3, self._cols)
        out = torch.nn.functional.conv2d(img, w)
        return out.reshape(k, -1).T

    def matvec(self, x):
        return self._apply(x[:, None], self._fwd_w)[:, 0]

    def rmatvec(self, y):
        return self._apply(y[:, None], self._adj_w)[:, 0]

    def matmat(self, X):
        return self._apply(X, self._fwd_w)

    def rmatmat(self, Y):
        return self._apply(Y, self._adj_w)
