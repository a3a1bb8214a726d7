"""Padded ELL sparse operator on torch tensors.

Counterpart of ``trips_tpu/sparse/ell.py``: rows padded to a common
nonzeros-per-row width, the transpose table materialized beside
(``parallel/batched.py`` stacks the tables of frames, the sharded ELL
operators of ``parallel/sharding.py`` split them). The applies are the
JAX package's XLA gathers, not Pallas kernels, so plain torch is their
port: ``matvec`` is
``(vals * x[cols]).sum(1)`` (``_ell_matvec``), ``matmat`` sums the slots
in chunks of 8 in the order of ``_ell_matmat``'s scan. ``sparse/csr.py``
stays the port's general sparse operator.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import round_up
from ..core.device import DEFAULT, resolve
from ..core.linop import LinearOperator


def _csr_to_ell(A, width_multiple: int = 1):
    """Convert scipy CSR to padded (vals, cols) ELL tables (numpy)."""
    A = A.tocsr()
    A.sum_duplicates()
    m, _ = A.shape
    counts = np.diff(A.indptr)
    w = int(counts.max()) if m else 0
    w = max(round_up(max(w, 1), width_multiple), 1)
    vals = np.zeros((m, w), dtype=A.dtype)
    cols = np.zeros((m, w), dtype=np.int32)
    # vectorized fill: position of each nnz within its row
    ptr = A.indptr
    idx = np.arange(A.nnz) - np.repeat(ptr[:-1], counts)
    rows = np.repeat(np.arange(m), counts)
    vals[rows, idx] = A.data
    cols[rows, idx] = A.indices
    return vals, cols


class EllOperator(LinearOperator):
    """Sparse operator in padded ELL form with a materialized transpose:
    ``vals``/``cols`` ``(m, w)``, ``vals_t``/``cols_t`` ``(n, w_t)``
    tensors on one device (int32 or int64 columns)."""

    capturable = True  # gathers and sums

    def __init__(self, vals, cols, vals_t, cols_t, shape, nnz=None):
        self.vals, self.cols = vals, cols
        self.vals_t, self.cols_t = vals_t, cols_t
        self.shape = tuple(shape)
        self.dtype = vals.dtype
        self.device = vals.device
        self.nnz = (nnz if nnz is not None
                    else int(torch.count_nonzero(vals)))

    @classmethod
    def from_scipy(cls, A, dtype=None, device=DEFAULT):
        """A scipy sparse matrix (any format); ``dtype`` None keeps its
        dtype. ``device``: the CUDA card unless "cpu" is asked for."""
        from scipy import sparse as sp

        device = resolve(device)
        A = sp.csr_matrix(A)
        if dtype is not None:
            A = A.astype(dtype)
        tabs = _csr_to_ell(A) + _csr_to_ell(A.T.tocsr())
        return cls(*(torch.from_numpy(t).to(device) for t in tabs), A.shape,
                   nnz=A.nnz)

    @classmethod
    def from_dense(cls, M, dtype=None, device=DEFAULT):
        from scipy import sparse as sp

        return cls.from_scipy(sp.csr_matrix(np.asarray(M)), dtype=dtype,
                              device=device)

    def to_scipy(self):
        """The stored entries as a scipy CSR matrix (padding dropped)."""
        from scipy import sparse as sp

        m, n = self.shape
        vals = self.vals.cpu().numpy().ravel()
        cols = self.cols.cpu().numpy().ravel()
        rows = np.repeat(np.arange(m), self.vals.shape[1])
        keep = vals != 0
        return sp.csr_matrix((vals[keep], (rows[keep], cols[keep])),
                             shape=(m, n))

    def matvec(self, x):
        return _ell_matvec(self.vals, self.cols, x)

    def rmatvec(self, y):
        return _ell_matvec(self.vals_t, self.cols_t, y)

    def matmat(self, X):
        return _ell_matmat(self.vals, self.cols, X)

    def rmatmat(self, Y):
        return _ell_matmat(self.vals_t, self.cols_t, Y)


def _ell_matvec(vals, cols, x):
    # (m, w) gather of x, then the row sums
    return (vals * x[cols.long()]).sum(1)


def _ell_matmat(vals, cols, X, slot_chunk: int = 8):
    """y = A @ X for tall-skinny X without materializing (m, w, k): the
    slots in chunks of ``slot_chunk``, each a (m, c, k) gather and
    contraction added to the sum in turn."""
    m, w = vals.shape
    y = X.new_zeros((m, X.shape[1]),
                    dtype=torch.promote_types(vals.dtype, X.dtype))
    for s in range(0, round_up(w, slot_chunk), slot_chunk):
        v, c = vals[:, s:s + slot_chunk], cols[:, s:s + slot_chunk].long()
        y = y + torch.einsum("mw,mwk->mk", v, X[c])
    return y
