"""Arnoldi factorization (modified Gram-Schmidt), eager torch loop.

Counterpart of ``trips_tpu/krylov/arnoldi.py`` (reference:
``trips/utilities/decompositions.py:20-116`` and ``:207-228``), with its
deliberate deviation: the batch form orthogonalizes against every column
``0..k`` as the reference's incremental ``arnoldi_update`` does (the
reference batch form skips column ``k``). The inner loop runs over
``j <= k`` only; the JAX loop's masked terms for ``j > k`` are exact zeros,
so the arithmetic is the same. Bases are preallocated and filled in place,
each column contiguous; no value is read back on the host.
"""
from __future__ import annotations

import torch

from .golub_kahan import _basis


def arnoldi_init(A, b, n_iter: int):
    """Preallocated Arnoldi state for ``arnoldi_extend``: Q (n, n_iter+1)
    with Q[:, 0] = b/||b||, H (n_iter+1, n_iter) zero."""
    if A.shape[0] != A.shape[1]:
        raise ValueError("Arnoldi can not be used. The operator is not square")
    n = A.shape[0]
    b = b.reshape(-1)
    Q = _basis(n, n_iter + 1, b)
    Q[:, 0] = b / torch.linalg.norm(b)
    return Q, b.new_zeros((n_iter + 1, n_iter))


def arnoldi_extend(A, Q, H, k0, n_steps, reorth: bool = False):
    """Run the Arnoldi recurrence from step ``k0`` for ``n_steps`` steps,
    writing Q's and H's columns in place; returns (Q, H). ``reorth=True``
    adds a second full Gram-Schmidt pass per step over the zero-padded
    basis."""
    for k in range(k0, k0 + n_steps):
        w = A.matvec(Q[:, k])
        h = H.new_zeros(H.shape[0])
        for j in range(k + 1):
            q_j = Q[:, j]
            hj = torch.dot(q_j, w)
            w = w - hj * q_j
            h[j] = hj
        if reorth:
            corr = Q.T @ w
            w = w - Q @ corr
            h = h + corr
        nrm = torch.linalg.norm(w)
        h[k + 1] = nrm
        Q[:, k + 1] = w / torch.where(nrm == 0, torch.ones_like(nrm), nrm)
        H[:, k] = h
    return Q, H


def arnoldi(A, b, n_iter: int, reorth: bool = False):
    """Returns Q (n, k+1), H (k+1, k) upper-Hessenberg, with Q[:,0] = b/||b||.
    ``reorth=True`` adds a second full Gram-Schmidt pass per step (not in
    the reference)."""
    return arnoldi_extend(A, *arnoldi_init(A, b, n_iter), 0, n_iter,
                          reorth=reorth)
