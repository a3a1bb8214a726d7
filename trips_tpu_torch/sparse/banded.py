"""The flat shear-packed banded projector on torch tensors.

Counterpart of ``trips_tpu/sparse/banded.py``'s ``BandedProjector``: one
stack per drive orientation at the group-wide tap width, ``W_rows (na_r,
T_rows, n_pad, p_pad)`` for the angles driven along image rows and
``W_cols`` for those driven along columns (on the transposed image), with
their raw shears ``shift_*`` and predictors ``P_*`` and the global angle
ids ``_angles_*``. The two stacks are two buckets of one kernel launch
(``banded_kernels``): ``matvec`` (K2), ``rmatvec`` (K3) and the fused
``normal_matvec`` (K1) each launch once, as ``BucketedBandedProjector``
does. On CPU tensors the wrappers take the plain versions, which play the
part of the JAX package's ``matvec_xla`` and ``rmatvec_xla``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import DEFAULT, resolve
from .banded_buckets import BucketedBandedProjector, _storage, _to_torch
from .pack import _pack_groups, _stack_packs


class BandedProjector(BucketedBandedProjector):
    """Exact banded repack of an angle-major projector matrix; storage
    float32 (exact) or bfloat16."""

    def __init__(self, W_rows, shift_rows, P_rows, angles_rows, W_cols,
                 shift_cols, P_cols, angles_cols, shape, nx, p, n_groups,
                 nnz, n_pad=None, device=DEFAULT):
        if torch.as_tensor(W_rows).dtype == torch.int8:
            raise ValueError("the flat pack stores float32 or bfloat16; "
                             "int8 needs BucketedBandedProjector's scales")
        super().__init__([(W_rows, shift_rows, P_rows),
                          (W_cols, shift_cols, P_cols)],
                         [angles_rows, angles_cols], [False, True], shape,
                         nx, p, n_groups, nnz,
                         nx if n_pad is None else n_pad, device=device)
        (self.W_rows, self.shift_rows, self.P_rows), \
            (self.W_cols, self.shift_cols, self.P_cols) = self.stacks
        self._angles_rows, self._angles_cols = self.aidxs

    @classmethod
    def from_scipy_fan(cls, A, nx, views, angles=None, n_groups=64,
                       dtype=None, lane_pad=128, device=DEFAULT):
        """Pack an angle-major fan/parallel CSR matrix (rows = a*p + d).
        ``dtype``: None/float32 (exact) or bfloat16."""
        device = resolve(device)
        kind = _storage(dtype)
        if kind == "int8":
            raise ValueError("the flat pack stores float32 or bfloat16")
        packs, idx, angles, p, n_pad = _pack_groups(A, nx, views, angles,
                                                    n_groups)
        p_pad = -(-p // lane_pad) * lane_pad
        groups = []
        for dr in (True, False):
            if packs[dr]:
                W, S, P = _stack_packs(packs[dr], n_pad, p, p_pad)
            else:
                W = np.zeros((0, 1, n_pad, p_pad), np.float32)
                S = np.zeros((0, n_pad), np.int32)
                P = np.zeros((0, n_groups, p_pad), np.int32)
            W = torch.from_numpy(W)
            if kind == "bfloat16":
                W = W.to(torch.bfloat16)  # round to nearest even
            groups += [W, torch.from_numpy(S), torch.from_numpy(P),
                       idx[dr]]
        return cls(*groups, A.shape, nx, p, n_groups, A.nnz, n_pad=n_pad,
                   device=device)

    @classmethod
    def from_numpy_stacks(cls, W_rows, shift_rows, P_rows, angles_rows,
                          W_cols, shift_cols, P_cols, angles_cols, shape, nx,
                          p, n_groups, nnz, n_pad=None, device=DEFAULT):
        """Build from NumPy copies of another pack's arrays (for instance
        ``trips_tpu``'s, bfloat16 as ml_dtypes arrays): the same bytes."""
        device = resolve(device)
        t = [_to_torch(a, device) for a in (W_rows, shift_rows, P_rows,
                                              W_cols, shift_cols, P_cols)]
        return cls(*t[:3], angles_rows, *t[3:], angles_cols, shape, nx, p,
                   n_groups, nnz, n_pad=n_pad, device=device)

    @property
    def T_rows(self):
        return self.W_rows.shape[1] if self.W_rows.numel() else 0

    @property
    def T_cols(self):
        return self.W_cols.shape[1] if self.W_cols.numel() else 0
