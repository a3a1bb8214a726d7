"""A host CSR matrix's products on the device, plain torch."""
from __future__ import annotations

import warnings

import numpy as np
import torch


def to_device(M, dev):
    """A host scipy matrix as a float64 torch sparse CSR tensor."""
    M = M.tocsr()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # CSR "beta" notice
        return torch.sparse_csr_tensor(
            torch.from_numpy(M.indptr.astype(np.int64)),
            torch.from_numpy(M.indices.astype(np.int64)),
            torch.from_numpy(M.data.astype(np.float64)),
            size=M.shape, device=dev, check_invariants=True)


class SparseOp:
    """Products by M and M^T, for vectors or blocks of columns."""

    def __init__(self, M, dev):
        self.M = to_device(M, dev)
        self.Mt = to_device(M.T, dev)
        self.shape = M.shape

    def matvec(self, x):
        return self.M @ x

    def rmatvec(self, y):
        return self.Mt @ y
