"""Generalized SVD via QR + cosine-sine decomposition.

Counterpart of ``trips_tpu/utils/gsvd.py`` (reference:
``trips/utilities/decompositions.py:257-334``): the GSVD of (A, B) as the QR
of the stacked [R_A; R_B] followed by a CSD, here the direct Van Loan
construction (SVD of Q1 with ascending cosines; the sine block's columns
are orthogonal since S^T S = I - C^2), with the reference's convention:

  A = U @ C @ X.T,   B = V @ S @ X.T,   C^T C + S^T S = I,
  diag(C) ascending.

``csd`` and ``gsvd`` are host NumPy (float64 LAPACK), the JAX package's
code as it is; they serve the TGSVD solver and the 'tgsvd' parameter
rules. ``gsvd_device`` is the device twin (the JAX package's ``gsvd_jit``)
on torch tensors (the SVD with ``core.device.svd``'s driver on the
card): cuSOLVER may pick other signs than LAPACK, so compare the
reconstructions and cosines, never the factors.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import svd


def csd(Q1, Q2, tol=1e-12):
    """CS decomposition of a column-orthonormal stacked pair.

    Q1 (m, p), Q2 (n, p) with Q1^T Q1 + Q2^T Q2 = I_p.
    Returns U (m, m), V (n, n), Z (p, p), C (m, p), S (n, p) with
    Q1 = U C Z^T, Q2 = V S Z^T, cosines ascending.
    """
    m, p = Q1.shape
    n = Q2.shape[0]
    U, c, Zt = np.linalg.svd(Q1)
    # ascending cosines to match the reference's flipped ordering
    q = min(m, p)
    U[:, :q] = U[:, q - 1 :: -1]
    c = c[::-1]
    Z = Zt.T
    Z[:, :q] = Z[:, q - 1 :: -1]

    c_full = np.zeros(p)
    c_full[:q] = np.clip(c, 0.0, 1.0)
    Sblock = Q2 @ Z  # columns orthogonal, norms s_i = sqrt(1 - c_i^2)
    s = np.sqrt(np.clip(1.0 - c_full**2, 0.0, None))

    V = np.zeros((n, n))
    cols = []
    for i in range(min(n, p)):
        if s[i] > tol:
            cols.append(Sblock[:, i] / s[i])
    k = len(cols)
    if k:
        V[:, :k] = np.column_stack(cols)
    # complete V to an orthonormal basis
    if k < n:
        Qc, _ = np.linalg.qr(np.random.default_rng(0).standard_normal((n, n)))
        basis = V[:, :k]
        for v in Qc.T:
            if basis.shape[1] >= n:
                break
            w = v - basis @ (basis.T @ v)
            nw = np.linalg.norm(w)
            if nw > 1e-8:
                basis = np.column_stack([basis, w / nw])
        V = basis

    C = np.zeros((m, p))
    C[np.arange(q), np.arange(q)] = c_full[:q]
    S = np.zeros((n, p))
    qs = min(n, p)
    S[np.arange(qs), np.arange(qs)] = s[:qs]
    return U, V, Z, C, S


def _check_shapes(A, B):
    m1, p = A.shape
    m2, p2 = B.shape
    if p != p2 or not (m1 >= m2 >= p):
        raise ValueError(
            "Invalid input dimensions. A should be of size mxp, and B should "
            "be of size nxp with m >= n >= p."
        )
    return p


def gsvd(A, B):
    """GSVD of (A (m,p), B (n,p)), m >= n >= p.

    Returns (U, V, X, C, S) with A = U C X^T, B = V S X^T
    (reference convention, ``decompositions.py:257-271``).
    """
    A = np.asarray(A, dtype=float)
    B = np.asarray(B, dtype=float)
    p = _check_shapes(A, B)
    QA, RA = np.linalg.qr(A, mode="reduced")
    QB, RB = np.linalg.qr(B, mode="reduced")
    Q, R = np.linalg.qr(np.concatenate([RA, RB], axis=0), mode="reduced")
    U, V, Z, C, S = csd(Q[:p, :], Q[p:, :])
    X = R.T @ Z
    return QA @ U, QB @ V, X, C, S


def gsvd_device(A, B, tol=1e-12):
    """:func:`gsvd` of two tensors on their device and in their dtype (the
    JAX package's ``gsvd_jit``): the same construction with
    ``torch.linalg.qr`` and ``svd``.

    Returns (U, V, X, C, S) with A = U C X^T, B = V S X^T, cosines
    ascending; C is (p, p). V's null-sine columns (s_i <= tol) are
    completed by a Householder QR of the masked sine block beside the
    identity, not by the host's Gram-Schmidt sweep: V stays orthonormal
    and V S Z^T == Q2 still holds for every live column.

    Deviation: the sines are the column norms of the sine block Q2 Z, not
    sqrt(1 - c^2) as in ``gsvd_jit``. A zero sine (a rank-deficient B)
    computes there as ~1.5e-8, the square root of the cosine's rounding,
    above ``tol``, and its column of V divides rounding by it, so that
    B = V S X^T holds only to ~5e-8; the column norm is accurate to its
    own size, ~1e-16 there.
    """
    p = _check_shapes(A, B)
    QA, RA = torch.linalg.qr(A, mode="reduced")
    QB, RB = torch.linalg.qr(B, mode="reduced")
    Q, R = torch.linalg.qr(torch.cat([RA, RB], dim=0), mode="reduced")
    Q1, Q2 = Q[:p, :], Q[p:, :]

    n = Q2.shape[0]
    U, c, Zt = svd(Q1)
    q = min(p, Q1.shape[0])
    # ascending cosines (the reference's flipped ordering)
    U = torch.cat([U[:, :q].flip(1), U[:, q:]], dim=1)
    c = torch.clamp(c.flip(0), 0.0, 1.0)
    Z = Zt.T
    Z = torch.cat([Z[:, :q].flip(1), Z[:, q:]], dim=1)

    c_full = A.new_zeros(p)
    c_full[:q] = c
    Sblock = Q2 @ Z
    s = torch.linalg.vector_norm(Sblock, dim=0)
    qs = min(n, p)
    live = s[:qs] > tol
    V0 = torch.where(live[None, :],
                     Sblock[:, :qs] / torch.clamp(s[:qs], min=tol)[None, :],
                     0.0)
    # orthonormal completion: QR of [V0 | I] keeps the live columns (already
    # orthonormal) and fills the rest
    Vq, _ = torch.linalg.qr(
        torch.cat([V0, torch.eye(n, dtype=A.dtype, device=A.device)], dim=1),
        mode="reduced")
    # Householder QR may flip signs of the live columns; restore them
    sign = torch.sign(torch.sum(Vq[:, :qs] * V0, dim=0))
    sign = torch.where(sign == 0, 1.0, sign)
    V = Vq[:, :n].clone()
    V[:, :qs] *= sign[None, :]

    C = torch.diag(c_full)  # Q1 is (p, p): q == p
    S = A.new_zeros(n, p)
    S[:qs, :qs] = torch.diag(s[:qs])
    X = R.T @ Z
    return QA @ U, QB @ V, X, C, S
