"""Golub-Kahan bidiagonalization, eager torch loop.

Counterpart of ``trips_tpu/krylov/golub_kahan.py`` (reference:
``trips/utilities/decompositions.py:118-205`` and ``:230-255``). The bases
are preallocated at ``n_iter`` width, ``U (m, n_iter+1)`` and
``V (n, n_iter)``, each column contiguous, and filled in place: per step one
``A^T u`` and one ``A v`` plus two norms. alpha and beta stay on the device,
so the loop never waits on the host.

Returns the same (U, S, V) triplet: U (m, k+1), S (k+1, k) lower-bidiagonal,
V (n, k).
"""
from __future__ import annotations

import torch


def _basis(rows, cols, like):
    """A zero ``(rows, cols)`` basis whose columns are contiguous."""
    return like.new_zeros((cols, rows)).T


def gk_init(A, b, n_iter: int):
    """Preallocated GK state for ``golub_kahan_extend``: zero (U, V, alphas,
    betas) with only U[:, 0] = b/||b|| filled."""
    m, n = A.shape
    b = b.reshape(-1)
    U = _basis(m, n_iter + 1, b)
    U[:, 0] = b / torch.linalg.norm(b)
    V = _basis(n, n_iter, b)
    return U, V, b.new_zeros(n_iter), b.new_zeros(n_iter)


def golub_kahan_extend(A, U, V, alphas, betas, k0, n_steps,
                       reorth: bool = False):
    """Run the GK recurrence from step ``k0`` for ``n_steps`` steps,
    writing the columns of ``U``, ``V`` and the entries of ``alphas``,
    ``betas`` in place; returns them. ``reorth=True`` adds one full
    classical Gram-Schmidt pass per vector against the whole zero-padded
    basis (unused columns are zero and contribute nothing)."""
    for k in range(k0, k0 + n_steps):
        u_k = U[:, k]
        v = A.rmatvec(u_k)
        if k > 0:
            v = v - betas[k - 1] * V[:, k - 1]
        if reorth:
            v = v - V @ (V.T @ v)
        alpha = torch.linalg.norm(v)
        v = v / alpha

        u = A.matvec(v) - alpha * u_k
        if reorth:
            u = u - U @ (U.T @ u)
        beta = torch.linalg.norm(u)
        u = u / beta

        U[:, k + 1] = u
        V[:, k] = v
        alphas[k] = alpha
        betas[k] = beta
    return U, V, alphas, betas


def bidiagonal(alphas, betas):
    """(k+1, k) lower-bidiagonal S from its diagonal and subdiagonal."""
    k = alphas.shape[0]
    S = alphas.new_zeros((k + 1, k))
    ar = torch.arange(k, device=alphas.device)
    S[ar, ar] = alphas
    S[ar + 1, ar] = betas
    return S


def golub_kahan(A, b, n_iter: int, reorth: bool = False):
    """``n_iter`` GK steps from ``b``: (U, S, V). ``reorth=True`` adds one
    full Gram-Schmidt reorthogonalization per vector (not in the reference,
    whose GK loses orthogonality once Ritz values converge)."""
    U, V, alphas, betas = golub_kahan_extend(A, *gk_init(A, b, n_iter), 0,
                                             n_iter, reorth=reorth)
    return U, bidiagonal(alphas, betas), V
