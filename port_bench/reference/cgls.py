"""CG on the normal equations, plain PyTorch: the reference of the
``cgls_normal`` entry.

``x_k`` from ``x_0 = 0`` by the textbook recurrence on A^T A x = A^T b,
one product by A and one by A^T per step, in float64, for a block of
sinograms ``b`` (m, c) solved together, column by column.
"""
from __future__ import annotations


def cgls_normal(A, b, iters):
    """(n, c) iterates after ``iters`` steps; ``A`` has ``matvec`` and
    ``rmatvec`` (``reference.sparse.SparseOp``)."""
    x = b.new_zeros((A.shape[1], b.shape[1]))
    t = A.rmatvec(b)
    p = t.clone()
    gamma = (t * t).sum(0)
    for _ in range(iters):
        q = A.rmatvec(A.matvec(p))
        beta = gamma / (p * q).sum(0)
        x = x + beta * p
        t = t - beta * q
        gamma_new = (t * t).sum(0)
        p = t + (gamma_new / gamma) * p
        gamma = gamma_new
    return x
