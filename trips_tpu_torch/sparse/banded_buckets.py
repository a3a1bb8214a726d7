"""Ta-bucketed banded projector on torch tensors.

Counterpart of ``trips_tpu/sparse/banded_buckets.py``: each drive group's
angles are split into ``n_buckets`` buckets sorted by tap width ``T_a``, each
stacked at its own ``T``. ``matvec`` (K2), ``rmatvec`` (K3) and the fused
``normal_matvec`` (K1) each launch their kernel once over all buckets
(``banded_kernels``); K2 writes and K3 reads each angle's sinogram row
through the buckets' angle ids. ``matmat``, ``rmatmat`` and
``normal_matmat`` apply the columns as the frames of one launch, every
frame on the one pack. Storage classes: float32 (the exact
matrix), bfloat16, and int8 with per-angle absmax/127 scales. Applies
compute in float32 on the dequantized weights whatever the input dtype, and
return the input's dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import DEFAULT, resolve
from ..core.linop import LinearOperator
from .pack import _pack_groups, _stack_packs, dequant_slab
from .banded_kernels import (banded_adj_buckets, banded_ata_buckets,
                             banded_fwd_buckets)


def _storage(dtype):
    """'float32' | 'bfloat16' | 'int8' from the accepted dtype spellings."""
    if dtype is None:
        return "float32"
    if isinstance(dtype, str):
        name = dtype
    elif isinstance(dtype, torch.dtype):
        name = str(dtype).removeprefix("torch.")
    else:
        name = np.dtype(dtype).name
    if name not in ("float32", "bfloat16", "int8"):
        raise ValueError(f"storage dtype {dtype!r}: use float32, bfloat16 "
                         f"or int8")
    return name


def _to_torch(a, device):
    """NumPy array -> tensor; ml_dtypes bfloat16 arrays keep their bits."""
    a = np.array(a, order="C")  # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def drive_images(x, nx, n_pad):
    """``(..., nx*nx)`` vectors -> the ``(..., n_pad, n_pad)`` float32
    roll-space images and their contiguous transposes (for the buckets
    driven along columns)."""
    lead = tuple(x.shape[:-1])
    X = torch.zeros(lead + (n_pad, n_pad), dtype=torch.float32,
                    device=x.device)
    X[..., :nx, :nx] = x.reshape(lead + (nx, nx))
    return X, X.transpose(-1, -2).contiguous()


class BucketedBandedProjector(LinearOperator):
    """Exact banded repack with per-bucket tap widths.

    ``stacks``: one ``(W, S, Pm)`` or ``(W, S, Pm, scales)`` tensor tuple per
    bucket, ``Pm`` reduced mod ``n_pad``; ``aidxs``/``is_cols``: each bucket's
    global angle ids and drive flag (``is_cols``: the bucket runs on the
    transposed image). ``device``: the CUDA card unless "cpu" is asked
    for.
    """

    _fwd = staticmethod(banded_fwd_buckets)
    _adj = staticmethod(banded_adj_buckets)
    _ata = staticmethod(banded_ata_buckets)

    capturable = True  # K1-K3 on the current stream, plans kept

    def __init__(self, stacks, aidxs, is_cols, shape, nx, p, n_groups, nnz,
                 n_pad, device=DEFAULT):
        self.device = resolve(device)
        self.stacks = tuple(tuple(t.to(self.device) for t in st)
                            for st in stacks)
        self.aidxs = tuple(tuple(int(a) for a in ai) for ai in aidxs)
        self.is_cols = tuple(bool(f) for f in is_cols)
        self.shape = tuple(shape)
        self.dtype = torch.float32
        self.nx = nx
        self.n_pad = n_pad
        self.det_count = p
        self.n_groups = n_groups
        self.nnz = nnz
        na_tot = self.shape[0] // p
        if sorted(a for ai in self.aidxs for a in ai) != list(range(na_tot)):
            raise ValueError("the buckets' angle ids must hold each of "
                             "[0, n_angles) once: padded buckets (ap > 1) "
                             "are not supported")
        # per bucket that holds angles: (W, S, P, scales, is_cols) and its
        # int32 angle ids
        held = [k for k, ai in enumerate(self.aidxs) if ai]
        self._bks = tuple((*self._parts(self.stacks[k]), self.is_cols[k])
                          for k in held)
        self._aidx = tuple(torch.tensor(self.aidxs[k], dtype=torch.int32,
                                        device=self.device) for k in held)

    @classmethod
    def from_scipy_fan(cls, A, nx, views, angles=None, n_groups=64,
                       dtype=None, lane_pad=128, n_buckets=4, device=DEFAULT):
        """Pack an angle-major fan/parallel CSR matrix (rows = a*p + d).
        ``dtype``: None/float32 (exact), bfloat16, or "int8"."""
        device = resolve(device)  # before the host work of packing
        kind = _storage(dtype)
        packs, idx, angles, p, n_pad = _pack_groups(A, nx, views, angles,
                                                    n_groups)
        p_pad = -(-p // lane_pad) * lane_pad
        stacks, aidxs, is_cols = [], [], []
        for dr in (True, False):
            group, ids = packs[dr], idx[dr]
            if not group:
                continue
            Ta = np.array([T_a for _, T_a, _, _ in group])
            order = np.argsort(Ta, kind="stable")
            for part in np.array_split(order, min(n_buckets, len(order))):
                if not len(part):
                    continue
                W, S, P = _stack_packs([group[k] for k in part], n_pad, p,
                                       p_pad)
                st = [torch.from_numpy(W), torch.from_numpy(S),
                      torch.from_numpy(np.mod(P, n_pad))]
                if kind == "int8":
                    sc = np.maximum(
                        np.abs(W).max(axis=(1, 2, 3)), 1e-30) / 127.0
                    st[0] = torch.from_numpy(np.rint(
                        W / sc[:, None, None, None]).astype(np.int8))
                    st.append(torch.from_numpy(sc.astype(np.float32)))
                elif kind == "bfloat16":
                    # round to nearest even, as a bfloat16 array fill does
                    st[0] = st[0].to(torch.bfloat16)
                stacks.append(st)
                aidxs.append([ids[k] for k in part])
                is_cols.append(not dr)
        return cls(stacks, aidxs, is_cols, A.shape, nx, p, n_groups, A.nnz,
                   n_pad, device=device)

    @classmethod
    def from_numpy_stacks(cls, stacks, aidxs, is_cols, shape, nx, p,
                          n_groups, nnz, n_pad, device=DEFAULT):
        """Build from NumPy copies of another pack's stacks (for instance
        ``trips_tpu``'s, with bfloat16 as ml_dtypes arrays): same bytes."""
        device = resolve(device)
        return cls([[_to_torch(a, device) for a in st] for st in stacks],
                   aidxs, is_cols, shape, nx, p, n_groups, nnz, n_pad,
                   device=device)

    @property
    def stored_bytes(self):
        return sum(st[0].numel() * st[0].element_size()
                   + st[1].numel() * 4 + st[2].numel() * 4
                   + (st[3].numel() * 4 if len(st) > 3 else 0)
                   for st in self.stacks)

    @staticmethod
    def _parts(stack):
        W, S, P = stack[:3]
        sc = stack[3] if len(stack) > 3 else None
        return W, S, P, sc

    def to_scipy(self):
        """Exact reconstruction of the (dequantized) packed matrix."""
        from scipy import sparse as sp

        nx, p = self.nx, self.det_count
        gsize = self.n_pad // self.n_groups
        rows, cols, vals = [], [], []
        for stack, aidx, isc in zip(self.stacks, self.aidxs, self.is_cols):
            W, S, P, sc = self._parts(stack)
            W, S, P = (t.cpu().numpy() for t in (dequant_slab(W, sc), S, P))
            for k, a in enumerate(aidx):
                tt, ii, dd = np.nonzero(W[k])
                cc = np.mod(S[k][ii] + P[k][ii // gsize, dd] + tt,
                            self.n_pad)
                ok = (cc < nx) & (dd < p) & (ii < nx)
                ii, tt, dd, cc = ii[ok], tt[ok], dd[ok], cc[ok]
                pix = cc * nx + ii if isc else ii * nx + cc
                rows.append(a * p + dd)
                cols.append(pix)
                vals.append(W[k][tt, ii, dd])
        M = sp.csr_matrix(
            (np.concatenate(vals).astype(np.float64),
             (np.concatenate(rows), np.concatenate(cols))),
            shape=self.shape)
        M.sum_duplicates()
        return M

    def _fwd_frames(self, x):
        """``(..., nx*nx)`` -> ``(..., m)`` float32: one K2 launch over all
        buckets and frames."""
        X, XT = drive_images(x, self.nx, self.n_pad)
        y = self._fwd(X, XT, self._bks, self._aidx, self.det_count,
                      self.n_groups)
        return y.reshape(tuple(x.shape[:-1]) + (-1,))

    def _adj_frames(self, y):
        """``(..., m)`` -> ``(..., nx*nx)`` float32: one K3 launch."""
        n, lead = self.nx, tuple(y.shape[:-1])
        Y = y.reshape(lead + (-1, self.det_count)).to(torch.float32)
        img = self._adj(Y.contiguous(), self._bks, self._aidx, self.n_groups)
        return img[..., :n, :n].reshape(lead + (-1,))

    def _ata_frames(self, x):
        """``(..., nx*nx)`` -> ``(..., nx*nx)`` float32: one K1 launch."""
        n = self.nx
        X, XT = drive_images(x, n, self.n_pad)
        img = self._ata(X, XT, self._bks, self.n_groups)
        return img[..., :n, :n].reshape(x.shape)

    def matvec(self, x):
        """One K2 launch over all buckets, each angle's row written in
        place."""
        return self._fwd_frames(x).to(x.dtype)

    def rmatvec(self, yv):
        """One K3 launch over all buckets, each reading its angles' rows."""
        return self._adj_frames(yv).to(yv.dtype)

    def normal_matvec(self, x):
        """Fused A^T A: one K1 launch over all buckets."""
        return self._ata_frames(x).to(x.dtype)

    def matmat(self, X):
        """``(n, k)`` -> ``(m, k)``: the k columns as the frames of one K2
        launch."""
        return self._fwd_frames(X.T).T.to(X.dtype)

    def rmatmat(self, Y):
        """``(m, k)`` -> ``(n, k)``: one K3 launch over k frames."""
        return self._adj_frames(Y.T).T.to(Y.dtype)

    def normal_matmat(self, X):
        """``(n, k)`` -> ``A^T A X``: one K1 launch over k frames."""
        return self._ata_frames(X.T).T.to(X.dtype)
