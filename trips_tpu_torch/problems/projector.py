"""Fan- and parallel-beam projector matrices (host; ASTRA
'line_fanflat' / 'parallel' replacement), and the closed-form sinogram of
ellipses that holds them.

A copy of ``trips_tpu/problems/projector.py``. As there, the Siddon
matrices come from the C++ builder (``trips_tpu_torch.native``) unless
``TRIPS_TPU_NO_NATIVE=1`` selects the NumPy path; each path gives the same
CSR matrix as the JAX package's path of the same name (the C++ libraries
to roundoff, 1e-12 relative). The two paths differ by roundoff, and in
which of the two squares beside a grid line they put the chord of a ray
that runs along the line.

Geometry conventions (pixel size 1, image centred at the origin):
- image column j centre x = -nx/2 + j + 1/2, row i centre y = ny/2 - i - 1/2
  (row 0 at the top, ASTRA's volume layout);
- projection angle theta: source at S = (so*sin(theta), -so*cos(theta)),
  detector line centred at D0 = (-od*sin(theta), od*cos(theta)) with unit
  axis u = (cos(theta), sin(theta)) and cell centres
  D_j = D0 + (j - (p-1)/2) * d * u;
- sinogram rows are angle-major: row = angle_index * p + detector_index.

The weight is the exact length of the ray inside each pixel (Siddon).
"""
from __future__ import annotations

import numpy as np
from scipy import sparse as sp


def _line_grid_intersections(S, dirs, nx, ny):
    """Intersection lengths of rays (S + t*dirs[i]) with the pixel grid.

    S: (2,) or (p, 2) ray origins; dirs: (p, 2). Returns COO triplets
    (ray_idx, pixel_idx, length) with pixel_idx = row*nx + col.
    """
    p = dirs.shape[0]
    S = np.broadcast_to(np.atleast_2d(S), (p, 2)).astype(float)
    xmin, xmax = -nx / 2.0, nx / 2.0
    ymin, ymax = -ny / 2.0, ny / 2.0

    with np.errstate(divide="ignore", invalid="ignore"):
        xs = xmin + np.arange(nx + 1)
        ys = ymin + np.arange(ny + 1)
        tx = (xs[None, :] - S[:, 0:1]) / dirs[:, 0:1]  # (p, nx+1)
        ty = (ys[None, :] - S[:, 1:2]) / dirs[:, 1:2]  # (p, ny+1)

        # slab entry/exit
        def slab(lo, hi, s, d):
            t0 = (lo - s) / d
            t1 = (hi - s) / d
            tmin = np.minimum(t0, t1)
            tmax = np.maximum(t0, t1)
            # parallel to slab: inside -> (-inf, inf); outside -> empty
            inside = (s >= lo) & (s <= hi)
            par = np.abs(d) < 1e-300
            tmin = np.where(par, np.where(inside, -np.inf, np.inf), tmin)
            tmax = np.where(par, np.where(inside, np.inf, -np.inf), tmax)
            return tmin, tmax

        tx0, tx1 = slab(xmin, xmax, S[:, 0], dirs[:, 0])
        ty0, ty1 = slab(ymin, ymax, S[:, 1], dirs[:, 1])
    t_enter = np.maximum(tx0, ty0)
    t_exit = np.minimum(tx1, ty1)

    t_all = np.concatenate([tx, ty], axis=1)  # (p, nx+ny+2)
    t_all = np.where(np.isfinite(t_all), t_all, np.inf)
    # clip crossings into [t_enter, t_exit]; out-of-range -> t_exit (zero seg)
    t_all = np.clip(t_all, t_enter[:, None], t_exit[:, None])
    t_all = np.where(np.isnan(t_all), t_exit[:, None], t_all)
    t_all = np.sort(t_all, axis=1)

    seg = np.diff(t_all, axis=1)  # (p, nx+ny+1)
    t_mid = 0.5 * (t_all[:, :-1] + t_all[:, 1:])
    norm = np.linalg.norm(dirs, axis=1)[:, None]
    lengths = seg * norm

    pos_x = S[:, 0:1] + t_mid * dirs[:, 0:1]
    pos_y = S[:, 1:2] + t_mid * dirs[:, 1:2]
    col = np.floor(pos_x - xmin).astype(np.int64)
    rowy = np.floor(pos_y - ymin).astype(np.int64)
    valid = (
        (lengths > 1e-12)
        & (col >= 0)
        & (col < nx)
        & (rowy >= 0)
        & (rowy < ny)
        & np.isfinite(lengths)
        & (t_exit[:, None] > t_enter[:, None])
    )
    row_img = ny - 1 - rowy  # row 0 at top
    pix = row_img * nx + col
    ray_idx = np.broadcast_to(np.arange(p)[:, None], pix.shape)
    return ray_idx[valid], pix[valid], lengths[valid]


def fan_beam_matrix(nx, ny=None, angles=None, det_count=None, det_width=None,
                    source_origin=None, origin_det=None, views=None):
    """'line_fanflat' projector matrix with the reference's default geometry
    (Tomography.py:49-60): p = int(sqrt(2)*nx) detectors, theta in [0, pi),
    so = 3*nx, od = nx, det width (so+od)/so."""
    ny = ny or nx
    if angles is None:
        angles = np.linspace(0, np.pi, views, endpoint=False)
    angles = np.asarray(angles, dtype=float)
    p = det_count if det_count is not None else int(np.sqrt(2) * nx)
    so = source_origin if source_origin is not None else 3 * nx
    od = origin_det if origin_det is not None else nx
    d = det_width if det_width is not None else (so + od) / so

    from ..native import fan_beam_csr_native

    A_native = fan_beam_csr_native(nx, ny, angles, p, d, so, od)
    if A_native is not None:
        A_native.sum_duplicates()
        return A_native

    rows, cols, vals = [], [], []
    offs = (np.arange(p) - (p - 1) / 2) * d
    for ai, th in enumerate(angles):
        S = np.array([so * np.sin(th), -so * np.cos(th)])
        D0 = np.array([-od * np.sin(th), od * np.cos(th)])
        u = np.array([np.cos(th), np.sin(th)])
        dets = D0[None, :] + offs[:, None] * u[None, :]
        dirs = dets - S[None, :]
        r, c, v = _line_grid_intersections(S, dirs, nx, ny)
        rows.append(r + ai * p)
        cols.append(c)
        vals.append(v)
    A = sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(len(angles) * p, nx * ny),
    )
    A.sum_duplicates()
    return A


def parallel_beam_matrix(nx, angles, det_count=None, det_width=1.0,
                         model="line", ny=None):
    """Parallel-beam projector ('parallel' geometry).

    model='line': Siddon exact intersection lengths.
    model='linear': Joseph linear interpolation (the reference's STEMPO
    simulation projector, io.py:391-420).
    """
    ny = ny or nx
    angles = np.asarray(angles, dtype=float)
    p = det_count if det_count is not None else nx
    if model == "line":
        from ..native import parallel_beam_csr_native

        A_native = parallel_beam_csr_native(nx, ny, angles, p, det_width)
        if A_native is not None:
            A_native.sum_duplicates()
            return A_native
    offs = (np.arange(p) - (p - 1) / 2) * det_width
    far = 2.0 * (nx + ny)

    rows, cols, vals = [], [], []
    for ai, th in enumerate(angles):
        u = np.array([np.cos(th), np.sin(th)])  # detector axis
        d = np.array([np.sin(th), -np.cos(th)])  # ray direction
        origins = -far * d[None, :] + offs[:, None] * u[None, :]
        if model == "line":
            dirs = np.broadcast_to(d * (2 * far), origins.shape)
            r, c, v = _line_grid_intersections(origins, dirs.copy(), nx, ny)
        elif model == "linear":
            r, c, v = _joseph_parallel(th, offs, nx, ny)
        else:
            raise ValueError(f"unknown model {model!r}")
        rows.append(r + ai * p)
        cols.append(c)
        vals.append(v)
    A = sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(len(angles) * p, nx * ny),
    )
    A.sum_duplicates()
    return A


def _joseph_parallel(th, offs, nx, ny):
    """Joseph (linear-interpolation) weights for one parallel-beam angle."""
    u = np.array([np.cos(th), np.sin(th)])
    d = np.array([np.sin(th), -np.cos(th)])
    p = len(offs)
    rows_out, cols_out, vals_out = [], [], []
    if abs(d[1]) >= abs(d[0]):
        # drive along y (image rows); step through each row center
        yc = (ny / 2.0 - 0.5) - np.arange(ny)  # row i center y
        # ray: point = offs*u + t*d ; solve for x at y = yc
        t = (yc[None, :] - offs[:, None] * u[1]) / d[1]  # (p, ny)
        x = offs[:, None] * u[0] + t * d[0]
        step = 1.0 / abs(d[1])
        xi = x - (-nx / 2.0) - 0.5  # continuous column coordinate
        j0 = np.floor(xi).astype(np.int64)
        frac = xi - j0
        for jj, w in ((j0, 1.0 - frac), (j0 + 1, frac)):
            valid = (jj >= 0) & (jj < nx) & (w > 1e-12)
            ridx, iidx = np.nonzero(valid)
            rows_out.append(ridx)
            cols_out.append(iidx * nx + jj[valid])
            vals_out.append(w[valid] * step)
    else:
        xc = (-nx / 2.0 + 0.5) + np.arange(nx)  # column j center x
        t = (xc[None, :] - offs[:, None] * u[0]) / d[0]
        y = offs[:, None] * u[1] + t * d[1]
        step = 1.0 / abs(d[0])
        yi = (ny / 2.0 - 0.5) - y  # continuous row coordinate
        i0 = np.floor(yi).astype(np.int64)
        frac = yi - i0
        for ii, w in ((i0, 1.0 - frac), (i0 + 1, frac)):
            valid = (ii >= 0) & (ii < ny) & (w > 1e-12)
            ridx, jidx = np.nonzero(valid)
            rows_out.append(ridx)
            cols_out.append(ii[valid] * nx + jidx)
            vals_out.append(w[valid] * step)
    return (
        np.concatenate(rows_out),
        np.concatenate(cols_out),
        np.concatenate(vals_out),
    )


def analytic_sinogram(ellipses, nx, geometry="fan", angles=None,
                      views=None, det_count=None, det_width=None,
                      source_origin=None, origin_det=None, ny=None):
    """Closed-form sinogram of a sum of constant-density ellipses: an
    oracle for the discrete projectors that shares no code with them.

    ``ellipses``: iterable of (rho, a, b, cx, cy, phi_rad) in PIXEL units
    with the module's image coordinates (origin at the image center,
    x right / y up). For each ray the integral of the indicator of an
    ellipse is the chord length: map the ray into the ellipse's unit-disk
    frame, solve the quadratic |O' + t v'|^2 = 1, and scale the t-interval
    back by |v|. Rays are constructed with EXACTLY the same geometry
    parametrization as ``fan_beam_matrix`` / ``parallel_beam_matrix``
    ('line' model; Tomography.py:49-60 conventions), so a discrete
    ``A @ x`` with x the pixel-center rasterization must converge to this
    under grid refinement.

    Returns an (n_angles, p) float64 array.
    """
    ny = ny or nx
    if angles is None:
        angles = np.linspace(0, np.pi, views, endpoint=False)
    angles = np.asarray(angles, dtype=float)
    if geometry == "fan":
        p = det_count if det_count is not None else int(np.sqrt(2) * nx)
        so = source_origin if source_origin is not None else 3 * nx
        od = origin_det if origin_det is not None else nx
        d = det_width if det_width is not None else (so + od) / so
    else:
        p = det_count if det_count is not None else nx
        d = det_width if det_width is not None else 1.0
    offs = (np.arange(p) - (p - 1) / 2) * d

    out = np.zeros((len(angles), p))
    for ai, th in enumerate(angles):
        if geometry == "fan":
            S = np.array([so * np.sin(th), -so * np.cos(th)])
            D0 = np.array([-od * np.sin(th), od * np.cos(th)])
            u = np.array([np.cos(th), np.sin(th)])
            O = np.broadcast_to(S, (p, 2))
            V = D0[None, :] + offs[:, None] * u[None, :] - S[None, :]
        else:
            u = np.array([np.cos(th), np.sin(th)])
            dvec = np.array([np.sin(th), -np.cos(th)])
            far = 2.0 * (nx + ny)
            O = -far * dvec[None, :] + offs[:, None] * u[None, :]
            V = np.broadcast_to(dvec, (p, 2))
        vnorm = np.linalg.norm(V, axis=1)
        for rho, a, b, cx, cy, phi in ellipses:
            c, s = np.cos(phi), np.sin(phi)
            R = np.array([[c, s], [-s, c]])  # world -> ellipse frame
            M = np.diag([1.0 / a, 1.0 / b]) @ R
            Op = (O - np.array([cx, cy])[None, :]) @ M.T
            Vp = V @ M.T
            A2 = np.einsum("ij,ij->i", Vp, Vp)
            B2 = 2.0 * np.einsum("ij,ij->i", Op, Vp)
            C2 = np.einsum("ij,ij->i", Op, Op) - 1.0
            disc = B2 * B2 - 4.0 * A2 * C2
            hit = disc > 0
            dt = np.zeros(p)
            dt[hit] = np.sqrt(disc[hit]) / A2[hit]
            out[ai] += rho * dt * vnorm
    return out
