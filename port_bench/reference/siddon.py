"""Fan-beam projector matrix, plain NumPy (the benchmark's own builder).

Geometry (pixel size 1, image centred at the origin): image column j
centre x = -nx/2 + j + 1/2, row i centre y = ny/2 - i - 1/2; source at
(so*sin(th), -so*cos(th)); detector line centred at (-od*sin(th),
od*cos(th)) along (cos(th), sin(th)) with p cells of width d; sinogram
rows angle-major (row = angle * p + detector). The weight is the exact
length of the ray inside each pixel (Siddon).

Each ray's pixels are found as an incremental traversal finds them: the
entry pixel from the entry point, then one step in x or y at each grid
line the ray crosses, in the order it crosses them. So a ray that runs a
rounding error away from a grid line, or through a grid corner, keeps to
the side it entered on until it crosses, where a pixel taken from each
segment's midpoint would round onto the line.
"""
from __future__ import annotations

import numpy as np
from scipy import sparse as sp

TINY = 1e-300  # a direction component below this runs along the grid
MIN_LEN = 1e-12  # shorter segments are not entries


def _axis(s, d, lo, n):
    """Per ray along one axis: slab entry and exit t, the step (+-1), and
    the t at which the ray crosses each inner grid line lo + k
    (k = 1..n-1; inf where it runs along the axis)."""
    flat = np.abs(d) <= TINY
    dd = np.where(flat, 1.0, d)
    t0, t1 = (lo - s) / dd, (lo + n - s) / dd
    inside = (s >= lo) & (s <= lo + n)
    tmin = np.where(flat, np.where(inside, -np.inf, np.inf),
                    np.minimum(t0, t1))
    tmax = np.where(flat, np.where(inside, np.inf, -np.inf),
                    np.maximum(t0, t1))
    k = np.arange(1, n)
    tk = (lo + k[None, :] - s[:, None]) / dd[:, None]
    tk[flat] = np.inf
    return tmin, tmax, np.where(d > 0, 1, -1), k, tk


def _intersections(S, dirs, nx, ny):
    """COO triplets (ray, pixel = row * nx + col, length) of the rays
    S + t * dirs[i] with the pixel grid."""
    p = dirs.shape[0]
    S = np.broadcast_to(np.atleast_2d(S), (p, 2)).astype(float)
    xmin, ymin = -nx / 2.0, -ny / 2.0
    with np.errstate(divide="ignore", invalid="ignore"):
        x0, x1, sx, kx, tx = _axis(S[:, 0], dirs[:, 0], xmin, nx)
        y0, y1, sy, ky, ty = _axis(S[:, 1], dirs[:, 1], ymin, ny)
    t_in, t_out = np.maximum(x0, y0), np.minimum(x1, y1)
    hit = t_out > t_in
    t_in, t_out = np.where(hit, t_in, 0.0), np.where(hit, t_out, 0.0)
    ix = np.clip(np.floor(S[:, 0] + t_in * dirs[:, 0] - xmin), 0,
                 nx - 1).astype(np.int64)
    iy = np.clip(np.floor(S[:, 1] + t_in * dirs[:, 1] - ymin), 0,
                 ny - 1).astype(np.int64)
    # the lines ahead of the entry pixel, before the exit
    ahead_x = np.where(sx[:, None] > 0, kx[None, :] > ix[:, None],
                       kx[None, :] <= ix[:, None])
    ahead_y = np.where(sy[:, None] > 0, ky[None, :] > iy[:, None],
                       ky[None, :] <= iy[:, None])
    tx = np.where(ahead_x & (tx < t_out[:, None]), tx, np.inf)
    ty = np.where(ahead_y & (ty < t_out[:, None]), ty, np.inf)
    t = np.concatenate([tx, ty], axis=1)
    is_x = np.concatenate([np.ones_like(tx, bool), np.zeros_like(ty, bool)],
                          axis=1)
    order = np.argsort(t, axis=1, kind="stable")  # x before y at a corner
    t = np.take_along_axis(t, order, axis=1)
    is_x = np.take_along_axis(is_x, order, axis=1)
    ends = np.minimum(np.concatenate([t, np.full((p, 1), np.inf)], axis=1),
                      t_out[:, None])
    starts = np.concatenate([t_in[:, None], ends[:, :-1]], axis=1)
    lengths = (ends - starts) * np.linalg.norm(dirs, axis=1)[:, None]
    # the pixel of each segment: the entry pixel stepped once per line
    # crossed before it
    nx_before = np.concatenate([np.zeros((p, 1), np.int64),
                                np.cumsum(is_x & np.isfinite(t), axis=1)],
                               axis=1)
    ny_before = np.concatenate([np.zeros((p, 1), np.int64),
                                np.cumsum(~is_x & np.isfinite(t), axis=1)],
                               axis=1)
    col = ix[:, None] + sx[:, None] * nx_before
    rowy = iy[:, None] + sy[:, None] * ny_before
    valid = (hit[:, None] & (lengths > MIN_LEN) & (col >= 0) & (col < nx)
             & (rowy >= 0) & (rowy < ny))
    pix = (ny - 1 - rowy) * nx + col
    ray = np.broadcast_to(np.arange(p)[:, None], pix.shape)
    return ray[valid], pix[valid], lengths[valid]


def fan_beam_matrix(nx, angles, det_count, det_width, source_origin,
                    origin_det):
    """The (len(angles) * det_count, nx * nx) float64 CSR matrix."""
    angles = np.asarray(angles, dtype=float)
    p, so, od, d = det_count, source_origin, origin_det, det_width
    offs = (np.arange(p) - (p - 1) / 2) * d
    rows, cols, vals = [], [], []
    for ai, th in enumerate(angles):
        S = np.array([so * np.sin(th), -so * np.cos(th)])
        D0 = np.array([-od * np.sin(th), od * np.cos(th)])
        u = np.array([np.cos(th), np.sin(th)])
        dirs = D0[None, :] + offs[:, None] * u[None, :] - S[None, :]
        r, c, v = _intersections(S, dirs, nx, nx)
        rows.append(r + ai * p)
        cols.append(c)
        vals.append(v)
    A = sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(len(angles) * p, nx * nx))
    A.sum_duplicates()
    return A
