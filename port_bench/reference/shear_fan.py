"""The shear-rotate fan-beam operator as an explicit float64 matrix, plain
NumPy and SciPy (the benchmark's own, from the geometry's equations).

The geometry is the reference fan geometry (pixel size 1, image centred at
the origin, ``det_count`` detectors of width ``det_spacing``, the source
``source_origin`` from the centre and the detector line ``origin_det``
beyond it). The operator is a discretization of the fan-beam transform by
rotation: each view's image is turned into one canonical frame, where every
view sees the same rays. Per view at angle ``th``, as a product of sparse
factors, right to left:

1. Embedding: the (nx, nx) image in the middle of a zero (C, C) canvas,
   offset ``(C - nx) // 2``; C is the side that holds the image disc under
   every shear below (``canvas_side``).
2. An exact quarter turn: ``k = round(th / (pi / 2))`` (to even at a tie)
   clockwise turns of the canvas, k = 0, 1 or 2 for ``th`` in [0, pi).
3. The residual angle ``phi = th - k pi / 2`` in [-pi/4, pi/4] as three
   shears (row shear, column shear, row shear), each in pull-back form
   with 2-tap linear interpolation and circular wrap:
   ``out(c) = (1 - f) in((c + s0) mod C) + f in((c + s0 + 1) mod C)`` with
   ``s0 = floor(s)``, ``f = s - s0``, the shift ``s = tan(-phi / 2) y_i``
   for row i (y_i = cc - i) in the row shears and ``s = -sin(phi) x_j``
   for column j (x_j = j - cc) in the column shear, cc = (C - 1) / 2.
4. The fan contraction G^T: in the canonical frame the source sits at
   y = -source_origin on the axis and detector d at x = u_d, y =
   origin_det, u_d = (d - (p - 1) / 2) det_spacing. Ray d crosses row y_i
   at x = u_d (y_i + so) / (so + od), canvas column q = x + cc; its weight
   there is the hat (2-tap linear) interpolation at q times the ray's step
   length per row, sqrt(1 + (u_d / (so + od))^2), on the live rows |y_i|
   <= nx / sqrt(2) + 1.5 (those the image disc can reach).

Sinogram rows are angle-major (row = view * p + detector), image columns
row-major with row 0 at the top.
"""
from __future__ import annotations

import math

import numpy as np
from scipy import sparse as sp


def canvas_side(nx):
    """C: twice the largest excursion of the image disc (radius nx/sqrt(2))
    under the three shears of a turn of at most 45 degrees, with 3 pixels
    of margin, plus 2, rounded up to a multiple of 16."""
    bulge = nx / math.sqrt(2.0) * math.sqrt(1.0 + math.tan(math.pi / 8) ** 2)
    side = math.ceil(2 * (bulge + 3.0)) + 2
    return -(-side // 16) * 16


def det_count(nx):
    """The reference geometry's detector count, int(sqrt(2) nx): the
    diagonal of the image."""
    return int(np.sqrt(2) * nx)


def canvas_views(n, m):
    """(nx, C, views) of an operator of m rows and n columns in the
    reference geometry (``det_count(nx)`` detectors a view); None where m
    is not a whole number of views."""
    nx = math.isqrt(n)
    p = det_count(nx)
    if nx * nx != n or p < 1 or m % p:
        return None
    return nx, canvas_side(nx), m // p


def _embed(nx, C):
    """(C*C, nx*nx): the image into the middle of the canvas."""
    off = (C - nx) // 2
    i, j = np.divmod(np.arange(nx * nx), nx)
    rows = (i + off) * C + (j + off)
    return sp.csr_matrix((np.ones(nx * nx), (rows, np.arange(nx * nx))),
                         shape=(C * C, nx * nx))


def _quarter(C, k):
    """(C*C, C*C): k clockwise quarter turns, out[i, j] = in[src(i, j)]."""
    i, j = np.divmod(np.arange(C * C), C)
    if k == 0:
        si, sj = i, j
    elif k == 1:
        si, sj = C - 1 - j, i
    elif k == 2:
        si, sj = C - 1 - i, C - 1 - j
    else:
        raise ValueError(f"quarter turns in [0, pi) are 0, 1 or 2, got {k}")
    return sp.csr_matrix((np.ones(C * C), (np.arange(C * C), si * C + sj)),
                         shape=(C * C, C * C))


def _shear(C, shift, along_rows):
    """(C*C, C*C): the pull-back shear with one shift per row
    (``along_rows``: out[i, j] reads row i at columns j + s) or per column
    (out[i, j] reads column j at rows i + s), 2 taps, mod C."""
    s0 = np.floor(shift)
    f = shift - s0
    s0 = s0.astype(np.int64)
    i, j = np.divmod(np.arange(C * C), C)
    out = np.arange(C * C)
    if along_rows:
        k, w = s0[i], f[i]
        src0, src1 = i * C + (j + k) % C, i * C + (j + k + 1) % C
    else:
        k, w = s0[j], f[j]
        src0, src1 = ((i + k) % C) * C + j, ((i + k + 1) % C) * C + j
    return sp.csr_matrix(
        (np.concatenate([1.0 - w, w]),
         (np.concatenate([out, out]), np.concatenate([src0, src1]))),
        shape=(C * C, C * C))


def g_matrix(nx, det_count, det_spacing, source_origin, origin_det):
    """G^T (p, C*C): the fan contraction of the canonical frame, its zero
    weights left out."""
    C, p = canvas_side(nx), int(det_count)
    so, od, dw = float(source_origin), float(origin_det), float(det_spacing)
    cc = (C - 1) / 2.0
    u = (np.arange(p) - (p - 1) / 2.0) * dw
    y = cc - np.arange(C)
    live = np.abs(y) <= nx / np.sqrt(2.0) + 1.5
    q = u[None, :] * (y[:, None] + so) / (so + od) + cc             # (C, p)
    step = np.sqrt(1.0 + (u / (so + od)) ** 2)
    c0 = np.floor(q)
    f = q - c0
    row = np.broadcast_to(np.arange(C)[:, None], q.shape)
    det = np.broadcast_to(np.arange(p)[None, :], q.shape)
    rows, cols, vals = [], [], []
    for col, w in ((c0, 1.0 - f), (c0 + 1.0, f)):
        keep = live[:, None] & (col >= 0) & (col < C)
        rows.append(det[keep])
        cols.append(row[keep] * C + col[keep].astype(np.int64))
        vals.append((w * step[None, :])[keep])
    G = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(p, C * C))
    G.eliminate_zeros()
    return G


def g_nonzeros(nx, det_count, det_spacing, source_origin, origin_det):
    """G's nonzero weights."""
    return g_matrix(nx, det_count, det_spacing, source_origin,
                    origin_det).nnz


def shear_fan_matrix(nx, angles, det_count, det_spacing, source_origin,
                     origin_det):
    """The (len(angles) * det_count, nx * nx) float64 CSR matrix."""
    C = canvas_side(nx)
    Gt = g_matrix(nx, det_count, det_spacing, source_origin, origin_det)
    E = _embed(nx, C)
    cc = (C - 1) / 2.0
    y, x = cc - np.arange(C), np.arange(C) - cc
    blocks = []
    for th in np.asarray(angles, dtype=float):
        k = int(np.round(th / (np.pi / 2)))
        phi = th - k * (np.pi / 2)
        rows_shear = _shear(C, np.tan(-phi / 2.0) * y, True)
        M = Gt @ rows_shear
        M = M @ _shear(C, -np.sin(phi) * x, False)
        M = M @ rows_shear
        blocks.append(M @ (_quarter(C, k) @ E))
    A = sp.vstack(blocks, format="csr")
    A.sum_duplicates()
    return A
