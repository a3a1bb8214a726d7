"""Image utilities: the synthetic 'H' image, .mat loading, MATLAB-style
bilinear resampling (host NumPy).

Copied from ``trips_tpu/utils/images.py`` (reference:
``trips/utilities/io.py:35-50`` (build_x_true),
``trips/utilities/utils.py:141-198`` (image_to_new_size / interp2linear),
``Deblurring2D.py:75-99`` (.mat image loading with RGB 0.4/0.4/0.1 mix)).
"""
from __future__ import annotations

import os

import numpy as np


def build_x_true(dx=10, dy=10, up_width=10, bar_width=5, size=64):
    """Synthetic 'H' image (io.py:35-50); returns (size*size, 1) vector."""
    h_im = np.zeros((size, size))
    for i in range(size):
        if i < dy or i > size - dy:
            continue
        for j in range(size):
            if j < dx or j > size - dx:
                continue
            if j < dx + up_width or j > size - dx - up_width:
                h_im[i, j] = 1
            if abs(i - size / 2) < bar_width:
                h_im[i, j] = 1
    return h_im.reshape(-1, 1)


def load_image_mat(name, data_dir="./data/image_data"):
    """Load x_true from a local .mat file; RGB mixed 0.4/0.4/0.1 as in the
    reference (Deblurring2D.py:75-87). Never downloads: raises with
    guidance if the file is absent."""
    import scipy.io as spio

    path = os.path.join(data_dir, f"{name}.mat")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"image data {path} not found. Place the reference's image .mat "
            f"files under {data_dir} (no network egress available), or use "
            f"the synthetic images ('h_im', phantom gallery)."
        )
    f = spio.loadmat(path)
    X = f["x_true"]
    if X.ndim == 3:
        X = 0.4 * X[:, :, 0] + 0.4 * X[:, :, 1] + 0.1 * X[:, :, 2]
    return np.asarray(X, dtype=float)


def interp2linear(z, xi, yi, extrapval=np.nan):
    """MATLAB interp2(..., 'linear') equivalent.

    Adapted from the public pyinterp2 implementation
    (github.com/serge-m/pyinterp2) — the same third-party origin the
    reference vendors at ``trips/utilities/utils.py:153-198``; bit-exact
    behavior is required for oracle matching of every image-resampling
    test problem."""
    x = xi.copy().astype(float)
    y = yi.copy().astype(float)
    nrows, ncols = z.shape
    if nrows < 2 or ncols < 2:
        raise ValueError("z shape is too small")
    x_bad = (x < 0) | (x > ncols - 1)
    x[x_bad] = 0
    y_bad = (y < 0) | (y > nrows - 1)
    y[y_bad] = 0
    ndx = (np.floor(y) * ncols + np.floor(x)).astype(np.int64)
    d = x == ncols - 1
    x = x - np.floor(x)
    if d.any():
        x[d] += 1
        ndx[d] -= 1
    d = y == nrows - 1
    y = y - np.floor(y)
    if d.any():
        y[d] += 1
        ndx[d] -= ncols
    zf = z.ravel()
    one_minus_t = 1 - y
    f = (zf[ndx] * one_minus_t + zf[ndx + ncols] * y) * (1 - x) + (
        zf[ndx + 1] * one_minus_t + zf[ndx + ncols + 1] * y
    ) * x
    f[x_bad] = extrapval
    f[y_bad] = extrapval
    return f


def image_to_new_size(image, n):
    """Resize via the same bilinear scheme the reference uses
    (utils.py:141-144)."""
    X, Y = np.meshgrid(
        np.linspace(1, image.shape[1], n[0]), np.linspace(1, image.shape[0], n[1])
    )
    return interp2linear(np.asarray(image, dtype=float), X, Y, extrapval=np.nan)
