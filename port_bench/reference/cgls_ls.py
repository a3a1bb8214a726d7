"""CGLS, plain PyTorch: the reference of the ``cgls`` entry.

``x_k`` from ``x_0 = 0`` by the textbook CGLS recurrence for
min ||A x - b|| (Hestenes and Stiefel, 1952): the residual r = b - A x
carried, one product by A and one by A^T per step, in float64, for a
block of sinograms ``b`` (m, c) solved together, column by column.
"""
from __future__ import annotations


def cgls(A, b, iters):
    """(n, c) iterates after ``iters`` steps; ``A`` has ``matvec`` and
    ``rmatvec`` (``reference.sparse.SparseOp``)."""
    x = b.new_zeros((A.shape[1], b.shape[1]))
    r = b.clone()
    s = A.rmatvec(r)
    p = s.clone()
    gamma = (s * s).sum(0)
    for _ in range(iters):
        q = A.matvec(p)
        alpha = gamma / (q * q).sum(0)
        x = x + alpha * p
        r = r - alpha * q
        s = A.rmatvec(r)
        gamma_new = (s * s).sum(0)
        p = s + (gamma_new / gamma) * p
        gamma = gamma_new
    return x
