"""Linear-operator protocol on torch tensors.

Counterpart of ``trips_tpu/core/linop.py``: ``matvec`` maps ``(n,) ->
(m,)``, ``rmatvec`` ``(m,) -> (n,)``, ``matmat``/``rmatmat`` the same on
``(n, k)``/``(m, k)`` columns; ``op @ x`` dispatches on ``x.dim()`` and
``op.T`` is the adjoint (real operators), ``A @ B`` of two operators
their ``CompositeOperator``. The base ``matmat`` and
``rmatmat`` loop over columns; an operator that can apply ``(n, k)`` at once
overrides them. An operator may add ``normal_matvec`` (``x -> A^T A x``)
when it has a fused normal apply. Operators hold their tensors on one
``device``.
"""
from __future__ import annotations

import torch

from .device import DEFAULT, resolve


class LinearOperator:
    """Abstract base; subclasses set ``shape``, ``dtype`` and ``device`` and
    implement ``matvec``/``rmatvec``."""

    shape: tuple
    device: torch.device = torch.device("cpu")

    @property
    def dtype(self) -> torch.dtype:
        """The dtype the operator computes in (a storage class such as
        int8 weights computes in float32); float32 unless set."""
        return self.__dict__.get("_dtype", torch.float32)

    @dtype.setter
    def dtype(self, value):
        self._dtype = value

    def matvec(self, x):
        raise NotImplementedError

    def rmatvec(self, y):
        raise NotImplementedError

    def matmat(self, X):
        return torch.stack([self.matvec(c) for c in X.T], dim=1)

    def rmatmat(self, Y):
        return torch.stack([self.rmatvec(c) for c in Y.T], dim=1)

    def __matmul__(self, x):
        if isinstance(x, LinearOperator):
            return CompositeOperator(self, x)
        x = torch.as_tensor(x, device=self.device)
        if x.dim() == 1:
            return self.matvec(x)
        if x.dim() == 2 and x.shape[1] == 1:
            return self.matvec(x[:, 0])[:, None]
        return self.matmat(x)

    def __mul__(self, x):
        if isinstance(x, (int, float)):
            return ScaledOperator(float(x), self)
        return self.__matmul__(x)

    def __rmul__(self, alpha):
        if isinstance(alpha, (int, float)):
            return ScaledOperator(float(alpha), self)
        return NotImplemented

    @property
    def T(self):
        return AdjointOperator(self)

    def todense(self):
        """The operator as a dense ``(m, n)`` tensor (small operators
        only)."""
        n = self.shape[1]
        return self.matmat(torch.eye(n, dtype=self.dtype, device=self.device))

    def to_scipy(self):
        """The operator as a dense NumPy matrix, through ``todense`` (for
        oracle tests; small operators only)."""
        return self.todense().cpu().numpy()


class AdjointOperator(LinearOperator):
    def __init__(self, op):
        self.op = op
        self.shape = (op.shape[1], op.shape[0])
        self.dtype = op.dtype
        self.device = op.device

    def matvec(self, x):
        return self.op.rmatvec(x)

    def rmatvec(self, y):
        return self.op.matvec(y)

    def matmat(self, X):
        return self.op.rmatmat(X)

    def rmatmat(self, Y):
        return self.op.matmat(Y)

    @property
    def T(self):
        return self.op


class DenseOperator(LinearOperator):
    """Dense matrix operator (projected small systems, tests)."""

    def __init__(self, mat, device=None):
        self.mat = torch.as_tensor(mat, device=device)
        self.shape = tuple(self.mat.shape)
        self.dtype = self.mat.dtype
        self.device = self.mat.device

    def matvec(self, x):
        return self.mat @ x

    def rmatvec(self, y):
        return self.mat.T @ y

    def matmat(self, X):
        return self.mat @ X

    def rmatmat(self, Y):
        return self.mat.T @ Y

    def todense(self):
        return self.mat


class IdentityOperator(LinearOperator):
    """``I_n``; ``todense`` in ``dtype`` (float32 unless given) on
    ``device`` (the card unless "cpu" is asked for)."""

    def __init__(self, n, dtype=None, device=DEFAULT):
        self.shape = (n, n)
        self.dtype = dtype or torch.float32
        self.device = resolve(device)

    def matvec(self, x):
        return x

    rmatvec = matvec

    def matmat(self, X):
        return X

    rmatmat = matmat

    def todense(self):
        return torch.eye(self.shape[0], dtype=self.dtype, device=self.device)


class ScaledOperator(LinearOperator):
    """``alpha * op``."""

    def __init__(self, alpha, op):
        self.alpha = alpha
        self.op = op
        self.shape = op.shape
        self.dtype = op.dtype
        self.device = op.device

    def matvec(self, x):
        return self.alpha * self.op.matvec(x)

    def rmatvec(self, y):
        return self.alpha * self.op.rmatvec(y)

    def matmat(self, X):
        return self.alpha * self.op.matmat(X)

    def rmatmat(self, Y):
        return self.alpha * self.op.rmatmat(Y)


class BatchedBlockDiagOperator(LinearOperator):
    """``diag(B, B, ..., B)`` with ``nt`` repeats of one shared operator
    ``B``: the frames of a dynamic problem, applied as the columns of one
    ``B.matmat`` (the JAX package vmaps ``B`` over them). Over a banded
    operator that is one kernel launch over all frames on its one pack,
    the normal apply too (``B.normal_matmat``)."""

    def __init__(self, op, nt):
        self.op = op
        self.nt = nt
        self.shape = (op.shape[0] * nt, op.shape[1] * nt)
        self.dtype = op.dtype
        self.device = op.device

    def matvec(self, x):
        X = x.reshape(self.nt, self.op.shape[1])
        return self.op.matmat(X.T).T.reshape(-1)

    def rmatvec(self, y):
        Y = y.reshape(self.nt, self.op.shape[0])
        return self.op.rmatmat(Y.T).T.reshape(-1)

    def normal_matvec(self, x):
        """Per-frame ``B^T B``, through ``B``'s fused normal apply where it
        has one (over all frames at once where it has ``normal_matmat``)."""
        X = x.reshape(self.nt, self.op.shape[1])
        if hasattr(self.op, "normal_matmat"):
            return self.op.normal_matmat(X.T).T.reshape(-1)
        fn = getattr(self.op, "normal_matvec",
                     lambda v: self.op.rmatvec(self.op.matvec(v)))
        return torch.stack([fn(f) for f in X]).reshape(-1)

    def _frames(self, M, rows, fn):
        """``fn`` on the frames of ``M (nt * rows, k)`` as the columns of
        one ``(rows, nt * k)`` block -> ``(nt * out_rows, k)``."""
        k = M.shape[1]
        cols = M.reshape(self.nt, rows, k).permute(1, 0, 2).reshape(rows, -1)
        out = fn(cols)
        return out.reshape(-1, self.nt, k).permute(1, 0, 2).reshape(-1, k)

    def matmat(self, M):
        return self._frames(M, self.op.shape[1], self.op.matmat)

    def rmatmat(self, M):
        return self._frames(M, self.op.shape[0], self.op.rmatmat)


def _common(ops):
    """(dtype, device) of the operators ``ops``, which must share a device
    type: a combinator moves no tensor between devices."""
    types = {torch.device(o.device).type for o in ops}
    if len(types) != 1:
        raise ValueError(f"operators on different devices: {sorted(types)}")
    return ops[0].dtype, ops[0].device


class CompositeOperator(LinearOperator):
    """``A @ B``."""

    def __init__(self, A, B):
        if A.shape[1] != B.shape[0]:
            raise ValueError(f"shape mismatch {A.shape} @ {B.shape}")
        self.A, self.B = A, B
        self.shape = (A.shape[0], B.shape[1])
        self.dtype, self.device = _common((A, B))

    def matvec(self, x):
        return self.A.matvec(self.B.matvec(x))

    def rmatvec(self, y):
        return self.B.rmatvec(self.A.rmatvec(y))

    def matmat(self, X):
        return self.A.matmat(self.B.matmat(X))

    def rmatmat(self, Y):
        return self.B.rmatmat(self.A.rmatmat(Y))


class VStackOperator(LinearOperator):
    """Vertical stack ``[op1; op2; ...]``: regularization stacks.

    Reference analog: ``pylops``/``scipy.sparse.vstack`` use in
    ``trips/utilities/operators.py:30-45``. The adjoint sums the blocks'
    adjoints in order."""

    def __init__(self, ops):
        ops = tuple(ops)
        n = ops[0].shape[1]
        for o in ops:
            if o.shape[1] != n:
                raise ValueError("inconsistent column counts in VStack")
        self.ops = ops
        self.shape = (sum(o.shape[0] for o in ops), n)
        self.dtype, self.device = _common(ops)

    def _radd(self, Y, apply):
        out, i = None, 0
        for o in self.ops:
            m = o.shape[0]
            part = apply(o, Y[i : i + m])
            out = part if out is None else out + part
            i += m
        return out

    def matvec(self, x):
        return torch.cat([o.matvec(x) for o in self.ops])

    def rmatvec(self, y):
        return self._radd(y, lambda o, part: o.rmatvec(part))

    def matmat(self, X):
        return torch.cat([o.matmat(X) for o in self.ops], dim=0)

    def rmatmat(self, Y):
        return self._radd(Y, lambda o, part: o.rmatmat(part))


class BlockDiagOperator(LinearOperator):
    """Block-diagonal ``diag(op_1, ..., op_T)``, one apply per block (the
    reference's ``pylops.BlockDiag``, ``trips/utilities/io.py:156-158``,
    ``:420``). When every block is one shared operator,
    ``BatchedBlockDiagOperator`` applies them all at once."""

    def __init__(self, ops):
        self.ops = tuple(ops)
        self.shape = (sum(o.shape[0] for o in self.ops),
                      sum(o.shape[1] for o in self.ops))
        self.dtype, self.device = _common(self.ops)

    def _blocks(self, X, side, apply):
        outs, j = [], 0
        for o in self.ops:
            outs.append(apply(o, X[j : j + o.shape[side]]))
            j += o.shape[side]
        return torch.cat(outs, dim=0)

    def matvec(self, x):
        return self._blocks(x, 1, lambda o, part: o.matvec(part))

    def rmatvec(self, y):
        return self._blocks(y, 0, lambda o, part: o.rmatvec(part))

    def matmat(self, X):
        return self._blocks(X, 1, lambda o, part: o.matmat(part))

    def rmatmat(self, Y):
        return self._blocks(Y, 0, lambda o, part: o.rmatmat(part))


class FunctionOperator(LinearOperator):
    """User-supplied forward/adjoint callables on tensors (API parity with
    ``pylops.FunctionOperator``, used throughout the reference test
    problems); ``todense`` applies them to the identity in ``dtype`` on
    ``device`` (the card unless "cpu" is asked for)."""

    def __init__(self, f, fadj, m, n=None, dtype=torch.float32,
                 device=DEFAULT):
        self.f = f
        self.fadj = fadj
        self.shape = (m, n if n is not None else m)
        self.dtype = dtype
        self.device = resolve(device)

    def matvec(self, x):
        return torch.reshape(self.f(x), (self.shape[0],))

    def rmatvec(self, y):
        return torch.reshape(self.fadj(y), (self.shape[1],))


def aslinearoperator(A, device=DEFAULT) -> LinearOperator:
    """An operator as it is; a scipy sparse matrix as a ``CsrOperator`` in
    its dtype on ``device`` (where the JAX package makes an
    ``EllOperator``); anything else as a ``DenseOperator``."""
    if isinstance(A, LinearOperator):
        return A
    if hasattr(A, "toarray"):  # scipy sparse
        from ..sparse.csr import CsrOperator

        return CsrOperator.from_scipy(A, device=device)
    return DenseOperator(A)
