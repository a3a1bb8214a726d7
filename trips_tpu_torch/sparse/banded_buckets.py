"""Ta-bucketed banded projector on torch tensors.

Counterpart of ``trips_tpu/sparse/banded_buckets.py``: each drive group's
angles are split into ``n_buckets`` buckets sorted by tap width ``T_a``, each
stacked at its own ``T``. ``matvec`` (K2), ``rmatvec`` (K3) and the fused
``normal_matvec`` (K1) each launch their kernel once over all buckets
(``banded_kernels``); K2 writes and K3 reads each angle's sinogram row
through the buckets' angle ids. Storage classes: float32 (the exact
matrix), bfloat16, and int8 with per-angle absmax/127 scales. Applies
compute in float32 on the dequantized weights whatever the input dtype, and
return the input's dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import DEFAULT, resolve
from ..core.linop import LinearOperator
from .banded import _pack_groups, _stack_packs, dequant_slab
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
        # per bucket: (W, S, P, scales, is_cols) and its int32 angle ids
        self._bks = tuple((*self._parts(st), isc)
                          for st, isc in zip(self.stacks, self.is_cols))
        self._aidx = tuple(torch.tensor(ai, dtype=torch.int32,
                                        device=self.device)
                           for ai in self.aidxs)

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

    def _drive_images(self, x):
        """(nx*nx,) vector -> the (n_pad, n_pad) float32 roll-space image
        and its contiguous transpose (for the ``is_cols`` buckets)."""
        n, npd = self.nx, self.n_pad
        X = torch.zeros((npd, npd), dtype=torch.float32, device=x.device)
        X[:n, :n] = x.reshape(n, n)
        return X, X.T.contiguous()

    def matvec(self, x):
        """One K2 launch over all buckets, each angle's row written in
        place."""
        X, XT = self._drive_images(x)
        y = self._fwd(X, XT, self._bks, self._aidx, self.det_count,
                      self.n_groups)
        return y.reshape(-1).to(x.dtype)

    def rmatvec(self, yv):
        """One K3 launch over all buckets, each reading its angles' rows."""
        n = self.nx
        Y = yv.reshape(-1, self.det_count).to(torch.float32).contiguous()
        img = self._adj(Y, self._bks, self._aidx, self.n_groups)
        return img[:n, :n].reshape(-1).to(yv.dtype)

    def normal_matvec(self, x):
        """Fused A^T A: one K1 launch over all buckets."""
        n = self.nx
        X, XT = self._drive_images(x)
        img = self._ata(X, XT, self._bks, self.n_groups)
        return img[:n, :n].reshape(-1).to(x.dtype)
