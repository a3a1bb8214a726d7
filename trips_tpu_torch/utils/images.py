"""Image utilities: MATLAB-style bilinear resampling (host NumPy).

Copied from ``trips_tpu/utils/images.py`` (reference:
``trips/utilities/utils.py:141-198``, ``image_to_new_size`` and
``interp2linear``), which the dynamic loaders need; the rest of that module
waits for its first user in the port.
"""
from __future__ import annotations

import numpy as np


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
