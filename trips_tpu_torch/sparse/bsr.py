"""Block-sparse (BSR) operator, held as CSR.

Counterpart of ``trips_tpu/sparse/bsr.py``. JAX tiles the matrix into
``(br, bc)`` blocks, stores the nonzero ones and applies them with
``einsum`` and segment sums in XLA (no Pallas kernel). On the card the
natural layout of the same stored values is CSR, and their product is
cuSPARSE's (``sparse/csr.py``). The block choice and the stored-block
reckoning are JAX's, so ``stored_bytes`` and ``stored_density`` equal its.
The values are the stored ones: ``block_dtype=bfloat16`` rounds them to
nearest even, ``int8`` quantizes each block to ``rint(v / s)`` with its
absmax scale ``s = absmax / 127`` and holds ``q * s``. Blocks of a
floating dtype are applied in that dtype; bfloat16 and int8 blocks in
float32, the operator's dtype in JAX too. (JAX's int8 apply also rounds
the input to bfloat16 before its product; this one applies the
dequantized matrix to the input as it is.)

The helpers ``_count_blocks``, ``_values`` and ``_itemsize`` serve the
sharded block operators of ``parallel/sharded_bsr.py`` as well.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import DEFAULT, resolve
from ..core.linop import LinearOperator
from .csr import CsrOperator, _csr_tensor, _torch_dtype


def _block_ids(A, br, bc):
    """Each stored entry's block id (row-major over the block grid)."""
    coo = A.tocoo()
    nbk = -(-A.shape[1] // bc)
    return (coo.row // br).astype(np.int64) * nbk + coo.col // bc


def _count_blocks(A, br, bc):
    """Nonzero-block count without materializing the blocks (cheap)."""
    return len(np.unique(_block_ids(A, br, bc)))


def _values(A, block_dtype, dtype=np.float32):
    """``A`` as CSR of ``dtype``, its values rounded to ``block_dtype``
    (None or float32: unchanged; bfloat16: to nearest even) and kept in
    ``dtype``."""
    from scipy import sparse as sp

    A = sp.csr_matrix(A).astype(dtype)
    A.sum_duplicates()
    if block_dtype is not None:
        A.data = torch.from_numpy(A.data).to(_torch_dtype(block_dtype)).to(
            _torch_dtype(dtype)).numpy()
    return A


def _itemsize(block_dtype):
    return _torch_dtype(block_dtype or np.float32).itemsize


def _quantized(A, br, bc):
    """``A``'s values quantized per ``(br, bc)`` block as JAX quantizes
    them, and dequantized: (float32 CSR of ``q * scale``, the block
    scales)."""
    ids = _block_ids(A, br, bc)  # CSR order: the order of A.data
    uniq, local = np.unique(ids, return_inverse=True)
    absmax = np.zeros(len(uniq), A.dtype)
    np.maximum.at(absmax, local, np.abs(A.data))
    scale = (absmax / 127.0).astype(np.float32)
    safe = np.where(scale > 0, scale, np.float32(1.0))
    q = np.rint(A.data / safe[local]).astype(np.int8)
    A = A.astype(np.float32)
    A.data = q.astype(np.float32) * scale[local]
    return A, scale


class BsrOperator(CsrOperator):
    """The stored values of ``A``'s nonzero ``block_shape`` blocks as a
    CSR tensor and its transpose (``CsrOperator``), with JAX's block
    reckoning: ``n_blocks`` blocks of ``block_dtype`` storage."""

    def __init__(self, A, AT, shape, nnz, block_shape, n_blocks,
                 block_dtype):
        super().__init__(A, AT, shape, nnz)
        self.block_shape = tuple(block_shape)
        self.n_blocks = n_blocks
        self.block_dtype = block_dtype

    # JAX's: the dense matrix (through ``todense``), not the stored CSR
    to_scipy = LinearOperator.to_scipy

    @classmethod
    def from_scipy(cls, A, bs: int = None, dtype=None, block_dtype=None,
                   block_shape=None, device=DEFAULT):
        """``A`` (any scipy format) in ``(16, 128)`` blocks, ``(bs, bs)``
        with ``bs``, or ``block_shape``; ``dtype`` casts the values first
        (None keeps ``A``'s); ``block_dtype`` None, bfloat16 or int8.
        ``device``: the card unless "cpu" is asked for."""
        from scipy import sparse as sp

        device = resolve(device)
        if block_shape is not None:
            br, bc = block_shape
        elif bs is not None:
            br, bc = bs, bs
        else:
            br, bc = 16, 128
        A = sp.csr_matrix(A)
        dt = np.dtype(A.dtype if dtype is None else dtype)
        stored = _torch_dtype(dt if block_dtype is None else block_dtype)
        if stored == torch.int8:
            M, _ = _quantized(_values(A, None, dt), br, bc)
        else:
            M = _values(A, block_dtype, dt)
        # bfloat16 and int8 blocks compute in float32, as in JAX
        compute = (stored if stored in (torch.float32, torch.float64)
                   else torch.float32)
        return cls(_csr_tensor(M, compute, device),
                   _csr_tensor(M.T.tocsr(), compute, device), M.shape, M.nnz,
                   (br, bc), _count_blocks(M, br, bc), stored)

    @property
    def stored_density(self):
        """nnz / stored block capacity: the share of the stored stream
        that is matrix entries."""
        br, bc = self.block_shape
        return self.nnz / max(self.n_blocks * br * bc, 1)

    @property
    def stored_bytes(self):
        """Bytes of JAX's stored stream: the blocks, and an int8 pack's
        per-block float32 scales."""
        br, bc = self.block_shape
        nbytes = self.n_blocks * br * bc * self.block_dtype.itemsize
        if self.block_dtype == torch.int8:
            nbytes += self.n_blocks * 4
        return nbytes
