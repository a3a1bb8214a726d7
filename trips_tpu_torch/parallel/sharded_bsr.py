"""Row-sharded block-sparse operators, held as CSR.

Counterpart of ``trips_tpu/parallel/sharded_bsr.py``. JAX stores the
nonzero ``(br, bc)`` blocks and applies them with ``einsum`` and a segment
sum (no Pallas kernel); on the card the natural layout of the same entries
is CSR, whose product is cuSPARSE's (``sparse/csr.py``). The partitions
are JAX's: the padded problem ``(m_pad, n_pad)`` (multiples of the axis
times the block shape) is split into contiguous ranges, a rank's rows for
``matvec`` and its columns (held transposed) for ``rmatvec``; each apply
writes the rank's part into a zeroed full vector and ends in one
all_reduce (``parallel.sharding``). ``block_dtype=bfloat16`` rounds the
stored values to bfloat16 and keeps them as float32, the values JAX's
bfloat16 blocks hold. The stored-size guard counts the blocks JAX would
store and refuses the same matrices.
"""
from __future__ import annotations

import torch

from ..config import round_up
from ..core.device import DEFAULT, resolve
from ..core.linop import LinearOperator
from ..sparse.bsr import _count_blocks, _itemsize, _values
from ..sparse.csr import CsrOperator
from .sharding import all_reduce, share


def _check_stored_budget(n_blocks, br, bc, itemsize, nnz, max_stored_gb,
                         what):
    """Refuse a matrix whose two block partitions would store more than
    ``max_stored_gb`` (too diffuse for block storage), as JAX does."""
    stored = 2 * n_blocks * br * bc * itemsize  # forward + transpose
    if stored > max_stored_gb * 1e9:
        dens = nnz / max(n_blocks * br * bc, 1)
        raise ValueError(
            f"{what}: BSR ({br},{bc}) would store {stored/1e9:.1f} GB "
            f"across both partitions at {100*dens:.2f}% density "
            f"(limit {max_stored_gb} GB). This matrix is too diffuse for "
            f"block storage — use the banded pack "
            f"(sparse.BandedProjector) or ELL "
            f"(parallel.ShardedDynamicOperator), or raise max_stored_gb.")


def _part(M, rows, shape, device):
    """Rows ``rows`` of scipy CSR ``M`` as a ``CsrOperator`` of ``shape``
    (None when the range is empty)."""
    from scipy import sparse as sp

    if rows[1] <= rows[0]:
        return None
    P = M[rows[0]:rows[1]]
    return CsrOperator.from_scipy(
        sp.csr_matrix((P.data, P.indices, P.indptr), shape=shape),
        dtype=torch.float32, device=device)


def _csr_bytes(op):
    if op is None:
        return 0
    return sum(t.numel() * t.element_size() for M in (op.A, op.AT)
               for t in (M.values(), M.col_indices(), M.crow_indices()))


class ShardedBsrOperator(LinearOperator):
    """Block-sparse operator row-sharded over a mesh axis (default
    'rows'). ``fwd``/``adj``: this rank's rows ``rows`` of ``A`` and of
    ``Aᵀ`` (its columns ``cols_range``), ``CsrOperator``s of width
    ``n_pad`` and ``m_pad`` (None where the range is empty); ``shape`` the
    padded ``(m_pad, n_pad)``."""

    # an all_reduce per apply (gloo stages it through the host; NCCL is
    # not checked under capture): the loops over it step eagerly
    capturable = False

    def __init__(self, fwd, adj, rows, cols_range, shape, block_shape, nnz,
                 mesh, axis, device):
        self.fwd, self.adj = fwd, adj
        self.rows, self.cols_range = rows, cols_range
        self.shape = tuple(shape)
        self.block_shape = tuple(block_shape)
        self.nnz = nnz
        self.mesh, self.axis = mesh, axis
        self.dtype = torch.float32
        self.device = device

    @classmethod
    def from_scipy(cls, A, mesh, axis="rows", block_shape=(32, 128),
                   block_dtype=None, max_stored_gb=16.0, device=DEFAULT):
        """Shard a scipy matrix; ``device``: the card unless "cpu" is
        asked for."""
        device = resolve(device)
        A = _values(A, block_dtype)
        br, bc = block_shape
        _check_stored_budget(_count_blocks(A, br, bc), br, bc,
                             _itemsize(block_dtype), A.nnz, max_stored_gb,
                             "ShardedBsrOperator")
        s, i = mesh.shape[axis], mesh.coord(axis)
        m, n = A.shape
        m_pad, n_pad = round_up(m, s * br), round_up(n, s * bc)
        rows = tuple(min(a, m) for a in share(m_pad, s, i))
        cols = tuple(min(a, n) for a in share(n_pad, s, i))
        return cls(_part(A, rows, (rows[1] - rows[0], n_pad), device),
                   _part(A.T.tocsr(), cols, (cols[1] - cols[0], m_pad),
                         device), rows, cols, (m_pad, n_pad), block_shape,
                   A.nnz, mesh, axis, device)

    @property
    def stored_bytes(self):
        """Bytes of this rank's two CSR partitions."""
        return _csr_bytes(self.fwd) + _csr_bytes(self.adj)

    def _assemble(self, op, rng, size, v, apply):
        out = v.new_zeros((size,) + tuple(v.shape[1:]),
                          dtype=torch.promote_types(torch.float32, v.dtype))
        if op is not None:
            out[rng[0]:rng[1]] = getattr(op, apply)(v)
        return all_reduce(out, self.mesh, self.axis).to(v.dtype)

    def matvec(self, x):
        return self._assemble(self.fwd, self.rows, self.shape[0],
                              x.reshape(-1), "matvec")

    def rmatvec(self, y):
        return self._assemble(self.adj, self.cols_range, self.shape[1],
                              y.reshape(-1), "matvec")

    def matmat(self, X):
        """``(n_pad, k)`` -> ``(m_pad, k)`` with one all_reduce."""
        return self._assemble(self.fwd, self.rows, self.shape[0], X,
                              "matmat")

    def rmatmat(self, Y):
        return self._assemble(self.adj, self.cols_range, self.shape[1], Y,
                              "matmat")


class ShardedDynamicBsrOperator(LinearOperator):
    """Block diagonal over time of per-frame block-sparse matrices on a
    ('time', 'rows') mesh: frames over 'time', each frame's rows (and
    columns, for ``rmatvec``) over 'rows'. This rank holds frames
    ``frames`` and, of each, rows ``rows`` and columns ``cols_range``, as
    one block-diagonal CSR of its frames each (``fwd``, ``adj``: None
    where empty). ``x`` is frame-major ``(nt * n,)``; ``shape`` the true
    ``(nt * m, nt * n)``, ``frame_shape`` the padded ``(m_pad, n_pad)``."""

    # an all_reduce per apply (gloo stages it through the host; NCCL is
    # not checked under capture): the loops over it step eagerly
    capturable = False

    def __init__(self, fwd, adj, frames, rows, cols_range, shape,
                 frame_shape, block_shape, nnz, nt, mesh, device):
        self.fwd, self.adj = fwd, adj
        self.frames, self.rows, self.cols_range = frames, rows, cols_range
        self.shape = tuple(shape)
        self.frame_shape = tuple(frame_shape)
        self.block_shape = tuple(block_shape)
        self.nnz, self.nt = nnz, nt
        self.mesh = mesh
        self.dtype = torch.float32
        self.device = device

    @classmethod
    def from_blocks(cls, frames, mesh, block_shape=(8, 128),
                    block_dtype=None, max_stored_gb=16.0, device=DEFAULT):
        """``frames``: the per-frame scipy matrices (one shape)."""
        from scipy import sparse as sp

        device = resolve(device)
        Fs = [_values(F, block_dtype) for F in frames]
        br, bc = block_shape
        _check_stored_budget(sum(_count_blocks(F, br, bc) for F in Fs), br,
                             bc, _itemsize(block_dtype),
                             sum(F.nnz for F in Fs), max_stored_gb,
                             "ShardedDynamicBsrOperator")
        t_sh, r_sh = mesh.shape["time"], mesh.shape["rows"]
        nt = len(Fs)
        if nt % t_sh:
            raise ValueError(f"nt={nt} must divide over time axis {t_sh}")
        m0, n0 = Fs[0].shape
        m_pad, n_pad = round_up(m0, r_sh * br), round_up(n0, r_sh * bc)
        ri = mesh.coord("rows")
        t0, t1 = share(nt, t_sh, mesh.coord("time"))
        rows = tuple(min(a, m0) for a in share(m_pad, r_sh, ri))
        cols = tuple(min(a, n0) for a in share(n_pad, r_sh, ri))

        def diag(mats, rng):
            if rng[1] <= rng[0] or t1 <= t0:
                return None
            return CsrOperator.from_scipy(
                sp.block_diag([M[rng[0]:rng[1]] for M in mats],
                              format="csr"), dtype=torch.float32,
                device=device)

        return cls(diag(Fs[t0:t1], rows),
                   diag([F.T.tocsr() for F in Fs[t0:t1]], cols), (t0, t1),
                   rows, cols, (nt * m0, nt * n0), (m_pad, n_pad),
                   block_shape, sum(F.nnz for F in Fs), nt, mesh, device)

    @property
    def stored_bytes(self):
        """Bytes of this rank's two CSR partitions."""
        return _csr_bytes(self.fwd) + _csr_bytes(self.adj)

    def _assemble(self, op, rng, size_out, v, size_in):
        t0, t1 = self.frames
        out = v.new_zeros((self.nt, size_out),
                          dtype=torch.promote_types(torch.float32, v.dtype))
        if op is not None:
            V = v.reshape(self.nt, size_in)[t0:t1].reshape(-1)
            out[t0:t1, rng[0]:rng[1]] = op.matvec(V).view(t1 - t0, -1)
        return all_reduce(out, self.mesh).reshape(-1).to(v.dtype)

    def matvec(self, x):
        m0, n0 = self.shape[0] // self.nt, self.shape[1] // self.nt
        return self._assemble(self.fwd, self.rows, m0, x, n0)

    def rmatvec(self, y):
        m0, n0 = self.shape[0] // self.nt, self.shape[1] // self.nt
        return self._assemble(self.adj, self.cols_range, n0, y, m0)
