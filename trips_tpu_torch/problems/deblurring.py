"""Deblurring test problems (1D and 2D).

Counterpart of ``trips_tpu/problems/deblurring.py`` (API parity with
``trips/test_problems/Deblurring1D.py`` and ``Deblurring2D.py``): forward
operators on ``device`` (the CUDA card unless ``device="cpu"``) in
``dtype`` (float32 unless asked), ground-truth signal/image generation,
anti-inverse-crime data generation (padded grid, other boundary handling
than the solver's operator), and noise.

Data generation and noise run on the host with NumPy/SciPy, the JAX
package's code as it is, global ``np.random`` calls in the same order: a
seeded run gives both packages the same bytes.
"""
from __future__ import annotations

import os

import numpy as np
import scipy.linalg as sla
import torch
from scipy.ndimage import convolve, convolve1d

from ..core.device import DEFAULT, resolve
from ..operators.blur import Blur1D, Blur2D, gauss_psf_1d, gauss_psf_2d
from ..utils.images import build_x_true, image_to_new_size, load_image_mat


class Deblurring1D:
    """Reference: Deblurring1D (Deblurring1D.py:41-234)."""

    def __init__(self, **kwargs):
        self.seed = kwargs.pop("seed", 2022)
        self.device = resolve(kwargs.pop("device", DEFAULT))
        self.dtype = kwargs.pop("dtype", torch.float32)
        self.grid_points = None
        self.ny = 1
        self.parameter = None
        self.boundary_condition = None
        self.CommitCrime = kwargs.get("CommitCrime", False)

    def forward_Op_1D(self, parameter, nx, boundary_condition="reflect"):
        self.grid_points = nx
        self.parameter = parameter
        self.boundary_condition = boundary_condition
        self.PSF, self.center = gauss_psf_1d(nx, parameter)
        self.op = Blur1D(nx, parameter, boundary_condition, dtype=self.dtype,
                         device=self.device)
        return self.op

    # alias used in some demos
    forward_Op = forward_Op_1D

    def gen_xtrue(self, N, test):
        """Signals: 'sigma', 'piecewise', 'curve0'..'curve3'
        (Deblurring1D.py:144-197)."""
        self.grid_points = N
        if test == "sigma":
            x = np.linspace(-2.5, 2.5, N)
            return np.piecewise(x, [x < 0, x >= 0], [-1, 1])
        if test == "piecewise":
            values = np.array([0, 1, 0, 0, 0, 0, 0, 0.25, 0, 1, 0])
            edges = [0.10, 0.15, 0.20, 0.25, 0.35, 0.38, 0.45, 0.55, 0.75, 0.8, 1.0]
            xx = np.linspace(0, 1, N)
            out = np.zeros(N)
            lo = 0.0
            for v, hi in zip(values, edges):
                out[(xx >= lo) & (xx < hi)] = v
                lo = hi
            out[xx == 1.0] = values[-1]
            return out
        if test == "curve0":
            h = np.pi / N
            g = -np.pi / 2 + np.arange(0.5, N, 1) * h
            return 2 * np.exp(-6 * (g - 0.8) ** 2) + np.exp(-2 * (g + 0.5) ** 2)
        if test == "curve1":
            h = 1.0 / N
            return (h * np.sqrt(h)) * (np.arange(1, N + 1) - 0.5)
        if test == "curve2":
            h = 1.0 / N
            i = np.arange(N)
            return (1 / np.sqrt(h)) * (np.exp((i + 1) * h) - np.exp(i * h))
        if test == "curve3":
            h = 1.0 / N
            sqhi = 1 / np.sqrt(h)
            x = np.zeros(N)
            half = int(N / 2 + 1)
            i = np.arange(half)
            x[:half] = sqhi * (((i + 1) * h) ** 2 - (i * h) ** 2) / 2
            i = np.arange(half, N)
            x[half:] = sqhi * (h - (((i + 1) * h) ** 2 - (i * h) ** 2) / 2)
            return x
        raise ValueError(f"unknown test signal {test!r}")

    def gen_data(self, x, **kwargs):
        """Anti-inverse-crime data (Deblurring1D.py:104-142): blur on a
        zero-padded 2N grid, then crop."""
        if "parameter" in kwargs:
            self.parameter = kwargs["parameter"]
        if "boundary_condition" in kwargs:
            self.boundary_condition = kwargs["boundary_condition"]
        if self.parameter is None:
            self.parameter = 0.3
        if self.boundary_condition is None:
            self.boundary_condition = "reflect"
        n = self.grid_points
        x = np.asarray(x).reshape(-1)
        psf, _ = gauss_psf_1d(n, self.parameter)
        if not self.CommitCrime:
            pad = np.zeros(2 * n)
            put = n // 2
            pad[put : put + n] = x
            bfull = convolve1d(pad, psf, mode=self.boundary_condition)
            return bfull[put : put + n].reshape(-1, 1)
        return convolve1d(x, psf, mode=self.boundary_condition).reshape(-1, 1)

    def add_noise(self, b_true, opt, noise_level):
        """Gaussian/Poisson/Laplace noise (Deblurring1D.py:199-217).

        Deviation: the reference's Laplace branch draws a single scalar
        (``np.random.laplace(self.grid_points)``); a proper vector is drawn.
        """
        b_true = np.asarray(b_true).reshape(-1, 1)
        n = b_true.shape[0]
        if opt == "Gaussian":
            e = np.random.randn(n, 1)
            sig = noise_level * np.linalg.norm(b_true) / np.linalg.norm(e)
            return b_true + sig * e, sla.norm(sig * e)
        if opt == "Poisson":
            return np.random.poisson(lam=b_true + 1).astype(float), 0
        if opt == "Laplace":
            e = np.random.laplace(size=(n, 1))
            sig = noise_level * np.linalg.norm(b_true) / np.linalg.norm(e)
            return b_true + sig * e, sla.norm(sig * e)
        raise ValueError(f"unknown noise type {opt!r}")


class Deblurring2D:
    """Reference: Deblurring2D (Deblurring2D.py:41-207)."""

    def __init__(self, **kwargs):
        self.seed = kwargs.pop("seed", 2022)
        self.device = resolve(kwargs.pop("device", DEFAULT))
        self.dtype = kwargs.pop("dtype", torch.float32)
        self.nx = None
        self.ny = None
        self.CommitCrime = kwargs.get("CommitCrime", False)

    def Gauss(self, PSFdim, PSFspread):
        self.dim = PSFdim
        self.spread = PSFspread
        return gauss_psf_2d(PSFdim, PSFspread)

    def forward_Op(self, dim, spread, nx, ny):
        self.nx, self.ny = nx, ny
        psf, _ = self.Gauss(dim, spread)
        self.op = Blur2D(dim, spread, nx, ny, psf=psf, dtype=self.dtype,
                         device=self.device)
        return self.op

    def gen_true(self, im, **kwargs):
        if self.nx is None or self.ny is None:
            if "nx" in kwargs and "ny" in kwargs:
                self.nx, self.ny = kwargs["nx"], kwargs["ny"]
            else:
                raise TypeError(
                    "The dimension of the image is not specified. Pass nx/ny "
                    "or define the forward operator first."
                )
        if im == "h_im":
            # synthetic 'H' image (reference build_x_true, io.py:35-50)
            X = build_x_true(size=max(self.nx, self.ny)).reshape(
                max(self.nx, self.ny), -1
            )
            if X.shape != (self.nx, self.ny):
                X = image_to_new_size(X, (self.nx, self.ny))
                X[np.isnan(X)] = 0
            return X
        X = load_image_mat(im)
        if X.shape != (self.nx, self.ny):
            X = image_to_new_size(X, (self.nx, self.ny))
            X[np.isnan(X)] = 0
        return X

    def gen_data(self, x):
        """Anti-crime path (Deblurring2D.py:119-139): zero-pad to 2nx x 2ny,
        blur with mode='constant' (vs the solver's 'reflect'), crop."""
        nx, ny = self.nx, self.ny
        im = np.asarray(x).reshape(nx, ny)
        psf, _ = gauss_psf_2d(self.dim, self.spread)
        if not self.CommitCrime:
            pad = np.zeros((2 * nx, 2 * ny))
            px, py = nx // 2, ny // 2
            pad[px : px + nx, py : py + ny] = im
            bfull = convolve(pad, psf, mode="constant")
            return bfull[px : px + nx, py : py + ny].reshape(-1, 1)
        return convolve(im, psf, mode="reflect").reshape(-1, 1)

    def add_noise(self, b_true, opt, noise_level):
        b_true = np.asarray(b_true).reshape(-1, 1)
        n = b_true.shape[0]
        if opt == "Gaussian":
            e = np.random.randn(n, 1)
            sig = noise_level * np.linalg.norm(b_true) / np.linalg.norm(e)
            b = b_true + sig * e
            return b.reshape(self.nx, self.ny), np.linalg.norm(sig * e)
        if opt == "Poisson":
            b = np.random.poisson(lam=b_true + 1).astype(float)
            return b.reshape(self.nx, self.ny), 0
        if opt == "Laplace":
            e = np.random.laplace(size=(n, 1))
            sig = noise_level * np.linalg.norm(b_true) / np.linalg.norm(e)
            b = b_true + sig * e
            return b.reshape(self.nx, self.ny), np.linalg.norm(sig * e)
        raise ValueError(f"unknown noise type {opt!r}")

    def vec(self, image):
        return np.asarray(image).reshape(-1)

    def im(self, x, shape):
        return np.asarray(x).reshape(shape)

    def plot_rec(self, img, save_imgs=False, save_path="./saved_images"):
        import matplotlib.pyplot as plt

        if isinstance(img, torch.Tensor):
            img = img.detach().cpu().numpy()
        plt.set_cmap("inferno")
        if save_imgs and not os.path.exists(save_path):
            os.makedirs(save_path)
        plt.imshow(np.asarray(img).reshape(self.nx, self.ny))
        plt.axis("off")
        if save_imgs:
            plt.savefig(save_path + "/rec.png", bbox_inches="tight")

    plot_data = plot_rec
