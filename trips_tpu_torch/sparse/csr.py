"""Compressed sparse row operator on torch tensors.

The port's general sparse operator, where the JAX package takes ELL
(``trips_tpu/sparse/ell.py``) or BSR (``sparse/bsr.py``): padded ELL and
block-sparse rows are layouts for the TPU's static shapes, computed there
in plain XLA with no kernel of their own. On the card a CSR tensor is the
natural layout and its product is cuSPARSE's (``BsrOperator`` applies its
stored blocks so). As the ELL operator does, it keeps the transpose as a
matrix of its own, so ``rmatvec`` is a row-major product too (a product
with the transposed CSR tensor is much slower on the card).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import DEFAULT, resolve
from ..core.linop import LinearOperator


def _csr_tensor(M, dtype, device):
    """scipy CSR -> torch CSR tensor of ``dtype`` on ``device``, int32
    indices where they fit."""
    idx = torch.int32 if max(M.nnz, *M.shape) < 2**31 else torch.int64
    return torch.sparse_csr_tensor(
        torch.from_numpy(M.indptr.astype(np.int64)).to(idx),
        torch.from_numpy(M.indices.astype(np.int64)).to(idx),
        torch.from_numpy(np.ascontiguousarray(M.data)).to(dtype),
        size=M.shape, device=device, check_invariants=False)


def _torch_dtype(dtype):
    """A torch dtype from a torch or NumPy dtype, a NumPy scalar type or a
    name ("bfloat16", "int8", ...)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        return getattr(torch, dtype)
    return getattr(torch, np.dtype(dtype).name)


class CsrOperator(LinearOperator):
    """``A`` as a CSR tensor and ``Aᵀ`` as another. Products run in the
    operator's dtype and return the promoted dtype of the operator and the
    input."""

    def __init__(self, A, AT, shape, nnz):
        self.A = A
        self.AT = AT
        self.shape = tuple(shape)
        self.nnz = nnz
        self.dtype = A.dtype
        self.device = A.device

    @classmethod
    def from_scipy(cls, A, dtype=None, device=DEFAULT):
        """A scipy sparse matrix (any format); ``dtype`` None keeps its
        dtype. ``device``: the CUDA card unless "cpu" is asked for."""
        from scipy import sparse as sp

        device = resolve(device)
        A = sp.csr_matrix(A)
        A.sum_duplicates()
        dt = _torch_dtype(A.dtype if dtype is None else dtype)
        return cls(_csr_tensor(A, dt, device),
                   _csr_tensor(A.T.tocsr(), dt, device), A.shape, A.nnz)

    @classmethod
    def from_dense(cls, M, dtype=None, device=DEFAULT):
        from scipy import sparse as sp

        return cls.from_scipy(sp.csr_matrix(np.asarray(M)), dtype=dtype,
                              device=device)

    def to_scipy(self):
        from scipy import sparse as sp

        return sp.csr_matrix(
            (self.A.values().cpu().numpy(),
             self.A.col_indices().cpu().numpy(),
             self.A.crow_indices().cpu().numpy()), shape=self.shape)

    def _apply(self, M, v):
        out = torch.promote_types(self.dtype, v.dtype)
        return (M @ v.to(self.dtype)).to(out)

    def matvec(self, x):
        return self._apply(self.A, x)

    def rmatvec(self, y):
        return self._apply(self.AT, y)

    def matmat(self, X):
        return self._apply(self.A, X)

    def rmatmat(self, Y):
        return self._apply(self.AT, Y)
