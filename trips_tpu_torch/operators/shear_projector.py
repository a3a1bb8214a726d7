"""Shear-stack parallel-beam projector (counterpart of
``trips_tpu/operators/shear_projector.py``), in plain PyTorch.

The Joseph crossing position of detector ``d`` on driving line ``i`` is
separable, ``pos(i, d) = u_i + v_d``, so projection factors into three dense
stages per view:

  A. **Row shear**: resample image line ``i`` at positions ``u_i + c'``: an
     integer per-row shift plus a 2-tap fractional blend.
  B. **Stack**: sum the sheared lines over ``i`` (scaled by the ray step).
  C. **Detector resample**: evaluate the stacked profile at ``v_d``, a
     small dense (p x W) hat-weight product.

The adjoint runs the exact transpose of each stage, so ``<Ax, y> ==
<x, A'y>`` to roundoff. Composing the two linear interpolations makes the
pixel footprint the quadratic B-spline ``hat * hat`` (a slightly smoother
discretization than Joseph's single hat); ``shear_stack_matrix`` is the
operator's explicit CSR.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.linop import LinearOperator
from .projector_op import _angle_params


def _round_up(x, m):
    return ((x + m - 1) // m) * m


class ShearStackParallelProjector(LinearOperator):
    """Parallel-beam shear-stack projector (quadratic B-spline footprint).

    Rows are angle-major (``angle * det_count + detector``), the image is
    (ny, nx) row-major with ny == nx, matching ``parallel_beam_matrix`` /
    ``OnTheFlyParallelProjector``.
    """

    def __init__(self, nx, angles, det_count=None, det_width=1.0, ny=None,
                 dtype=torch.float32, device="cpu"):
        ny = ny or nx
        if ny != nx:
            raise NotImplementedError("square grids only")
        self.nx, self.ny = nx, ny
        self.det_count = p = int(det_count) if det_count is not None else nx
        self.det_width = float(det_width)
        self.angles = np.asarray(angles, dtype=float)
        self.n_angles = na = len(self.angles)
        self.shape = (na * p, nx * ny)
        self.dtype, self.device = dtype, torch.device(device)

        params = [_angle_params(th, nx, ny, p, self.det_width)
                  for th in self.angles]
        drive, P0, Pi, Pd, step = (np.asarray([pr[k] for pr in params])
                                   for k in range(5))

        # c' grid per angle: covers every detector sample v_d = Pd*d +-1 tap
        vmin = np.minimum(0.0, Pd * (p - 1))
        C0 = np.floor(vmin) - 1.0  # c' = C0 + j
        W = int(np.ceil(np.max(np.abs(Pd)) * (p - 1))) + 4

        # per-(angle, line) shear: u_i = P0 + Pi*i = bi + g, g in [0, 1)
        u = P0[:, None] + Pi[:, None] * np.arange(nx)[None, :]  # (na, nx)
        bi = np.floor(u)
        g = u - bi
        s_raw = (bi + C0[:, None]).astype(np.int64)  # source offset per line
        OFF = int(max(1, 1 - s_raw.min()))  # buffer column of image col 0
        s = s_raw + OFF  # left-shift amounts, all >= 1
        WB = _round_up(max(W + int(s.max()) + 2, OFF + nx + 1), 128)
        self._W, self._WB, self._OFF = W, WB, OFF

        def t(v, dt):
            return torch.as_tensor(v, device=self.device).to(dt)

        self.drive_is_y = tuple(bool(v) for v in drive)
        self.Pd, self.step, self.C0 = (t(v, dtype) for v in (Pd, step, C0))
        self.shifts = t(s, torch.int64)  # (na, nx)
        self.frac = t(g, dtype)          # (na, nx)

    def _shift_rows(self, buf, a, sign):
        """Row i of ``buf`` rolled left (sign -1) or right (+1) by
        ``shifts[a, i]`` columns."""
        cols = torch.arange(self._WB, device=buf.device)
        idx = (cols[None, :] - sign * self.shifts[a][:, None]) % self._WB
        return torch.gather(buf, 1, idx)

    def _det_weights(self, a):
        """Stage C weights (p, W): hat(v_d - C0 - j)."""
        kw = dict(dtype=self.dtype, device=self.device)
        d_idx = torch.arange(self.det_count, **kw)
        j_idx = torch.arange(self._W, **kw)
        diff = (self.Pd[a] * d_idx)[:, None] - self.C0[a] - j_idx[None, :]
        return torch.clamp(1.0 - diff.abs(), min=0.0)

    def matvec(self, x):
        X = x.reshape(self.ny, self.nx)
        nx, W, OFF = self.nx, self._W, self._OFF
        y = []
        for a in range(self.n_angles):
            Xd = X if self.drive_is_y[a] else X.T
            buf = torch.zeros((nx, self._WB), dtype=X.dtype, device=X.device)
            buf[:, OFF:OFF + nx] = Xd
            R = self._shift_rows(buf, a, -1)
            gg = self.frac[a][:, None]
            Zr = (1.0 - gg) * R[:, :W] + gg * R[:, 1:W + 1]
            Zc = self.step[a] * Zr.sum(dim=0)  # (W,)
            y.append(self._det_weights(a) @ Zc)
        return torch.stack(y).reshape(-1)

    def rmatvec(self, y):
        Y = y.reshape(self.n_angles, self.det_count)
        nx, W, OFF = self.nx, self._W, self._OFF
        out = torch.zeros((self.ny, self.nx), dtype=Y.dtype, device=Y.device)
        for a in range(self.n_angles):
            Zc = self._det_weights(a).T @ Y[a]  # (W,)
            buf = torch.zeros((nx, self._WB), dtype=Y.dtype, device=Y.device)
            buf[:, :W] = self.step[a] * Zc[None, :]
            R = self._shift_rows(buf, a, +1)
            gg = self.frac[a][:, None]
            Xd = ((1.0 - gg) * R[:, OFF:OFF + nx]
                  + gg * R[:, OFF - 1:OFF + nx - 1])
            out += Xd if self.drive_is_y[a] else Xd.T
        return out.reshape(-1)


def shear_stack_matrix(nx, angles, det_count=None, det_width=1.0, ny=None):
    """Explicit scipy CSR of the shear-stack projector (host oracle).

    Entry [(a, d), (i, c)] = step * sum_t hat(v_d - C0 - j_t) * blend(i, t)
    expanded over the 3-tap composite footprint (identical to applying the
    operator to the identity, but built directly with NumPy index
    arithmetic).
    """
    from scipy import sparse as sp

    op = ShearStackParallelProjector(nx, angles, det_count, det_width, ny,
                                     dtype=torch.float64)
    p = op.det_count
    C0, Pd, step = (v.numpy() for v in (op.C0, op.Pd, op.step))
    s = op.shifts.numpy() - op._OFF  # bi + C0
    g = op.frac.numpy()

    rows, cols, vals = [], [], []
    d_idx = np.arange(p)
    for a in range(op.n_angles):
        v = Pd[a] * d_idx  # (p,)
        j0 = np.floor(v - C0[a]).astype(np.int64)
        fv = (v - C0[a]) - j0
        # composite taps over c = (bi + C0) + j + {0, 1} for j in {j0, j0+1}
        #   weight(c offset t) relative to base = s[a,i] + j0(d):
        #   t=0: (1-fv)(1-g); t=1: (1-fv)g + fv(1-g); t=2: fv*g
        base = s[a][None, :] + j0[:, None]  # (p, nx): column for t=0
        w0 = (1 - fv)[:, None] * (1 - g[a])[None, :]
        w1 = ((1 - fv)[:, None] * g[a][None, :]
              + fv[:, None] * (1 - g[a])[None, :])
        w2 = fv[:, None] * g[a][None, :]
        for t, w in ((0, w0), (1, w1), (2, w2)):
            c = base + t
            valid = (c >= 0) & (c < nx) & (w > 1e-14)
            dd, ii = np.nonzero(valid)
            cc = c[valid]
            if op.drive_is_y[a]:
                pix = ii * nx + cc  # row i, column c
            else:
                pix = cc * nx + ii  # drive over columns: c is the row index
            rows.append(a * p + dd)
            cols.append(pix)
            vals.append(w[valid] * step[a])
    A = sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=op.shape,
    )
    A.sum_duplicates()
    return A
