"""Discrepancy principle: pick lam so ||A x_lam - b|| = eta * delta.

Semantics mirror ``trips/utilities/reg_param/discrepancy_principle.py:19-130``:

- ``dptype='tikhonov'``: project b (b <- Q^T b), transform general L to
  standard form via the A-weighted pseudoinverse of L (SVD/QR construction,
  ``:38-61``), then Newton-iterate on beta = 1/lam in filtered-SVD
  coordinates (init beta=1e-8, <=30 iterations extended to 100 while
  |alpha| < 1e-16, relative tol 1e-12; ``:76-99``). If the DP is already
  satisfied at lam -> infinity ("testzero" >= 0), returns alpha = 0.
- ``dptype='tsvd'`` / ``'tgsvd'``: discrete truncation-index search
  (``:100-128``).

A host NumPy/SciPy copy of ``trips_tpu/regparam/dp.py``.
"""
from __future__ import annotations

import numpy as np
import scipy.linalg as sla

from .utils import dense_or_identity, is_identity_matrix


def _standard_form(A, L, b):
    """Transform min ||Ax-b||^2 + lam ||Lx||^2 to standard form (L=I).

    Returns (Anew, bnew) following discrepancy_principle.py:33-61.
    """
    if is_identity_matrix(L):
        return A, b
    L = dense_or_identity(L)
    UL, SL, VLt = sla.svd(L)
    if L.shape[0] >= L.shape[1] and SL[-1] != 0:
        Anew = A @ (VLt.T @ np.diag(SL ** (-1.0)))
        return Anew, b
    # L has a nontrivial null space: split it off with the A-weighted
    # pseudoinverse  L_A^+ = (I - W (R_AW)^{-1} Q_AW^T A) Q_LT R_LT^{-T}
    if L.shape[0] >= L.shape[1]:
        zeroind = np.where(SL == 0)[0]
        W = VLt[zeroind, :].reshape(-1, 1)
    else:
        W = VLt[L.shape[0] - L.shape[1] :, :].T
    AW = A @ W
    Q_AW, R_AW = np.linalg.qr(AW, mode="reduced")
    Q_LT, R_LT = np.linalg.qr(L.T, mode="reduced")
    LAwpinv = (
        np.eye(L.shape[1]) - W @ np.linalg.inv(R_AW) @ Q_AW.T @ A
    ) @ Q_LT @ np.linalg.inv(R_LT.T)
    Anew = A @ LAwpinv
    xnull = W @ np.linalg.inv(R_AW) @ Q_AW.T @ b
    bnew = b - A @ xnull
    return Anew, bnew


def dp_tikhonov_projected(R_A, R_L, bproj, out_norm2, delta, eta=1.01,
                          explicit_proj=False):
    """DP Newton iteration given projected quantities (basis stays on device)."""
    thresh = (eta * delta) ** 2
    A = dense_or_identity(R_A)
    bproj = np.asarray(bproj, dtype=float).reshape(-1, 1)
    Anew, bnew = _standard_form(A, R_L, bproj)
    return _dp_newton(Anew, bnew, out_norm2, thresh, explicit_proj)


def _dp_newton(Anew, bnew, out_norm2, thresh, explicit_proj):
    U, S, _ = sla.svd(Anew)
    sv2 = S**2
    bhat = (U.T @ bnew).reshape(-1)
    mA, nA = Anew.shape
    if mA > nA:
        sv2 = np.concatenate([sv2, np.zeros(mA - nA)])
        tail2 = float(np.linalg.norm(bhat[nA - mA :]) ** 2)
        testzero = tail2 + (out_norm2 if explicit_proj else 0.0) - thresh
    else:
        testzero = out_norm2 - thresh

    if testzero >= 0:
        return 0

    beta = 1e-8
    alpha = None
    iterations = 0
    while (iterations < 30) or (
        iterations <= 100 and alpha is not None and abs(alpha) < 1e-16
    ):
        filt = 1.0 / (sv2 * beta + 1.0)
        zbeta = filt * bhat
        f = float(np.sum(zbeta**2)) - thresh
        if explicit_proj:
            f += out_norm2
        wbeta = filt * zbeta
        f_prime = 2.0 / beta * float(zbeta @ (wbeta - zbeta))
        beta_new = beta - f / f_prime
        if abs(beta_new - beta) < 1e-12 * beta:
            beta = beta_new
            alpha = 1.0 / beta_new
            break
        beta = beta_new
        alpha = 1.0 / beta_new
        iterations += 1
    return float(alpha)


def discrepancy_principle(Q, A, L, b, delta=None, eta=1.01, **kwargs):
    if not isinstance(delta, (int, float)):
        raise Exception(
            "A value for the noise level delta was not provided and the "
            "discrepancy principle cannot be applied. Please supply delta, "
            "or choose the regularization parameter by gcv."
        )
    dptype = kwargs.get("dptype", "tikhonov")
    explicit_proj = kwargs.get("explicitProj", False)
    b = np.asarray(b, dtype=float).reshape(-1, 1)
    thresh = (eta * delta) ** 2

    if dptype == "tikhonov":
        A = dense_or_identity(A)
        if is_identity_matrix(Q, b.shape[0]):
            # identity Q short-circuit: avoids materializing an m x m eye
            # when called on the full (unprojected) system (direct Tikhonov)
            bproj = b
            out_norm2 = 0.0
        else:
            Q = dense_or_identity(Q)
            bproj = Q.T @ b
            out_norm2 = float(np.linalg.norm(b - Q @ bproj) ** 2)

        Anew, bnew = _standard_form(A, L, bproj)
        return _dp_newton(Anew, bnew, out_norm2, thresh, explicit_proj)

    Q = np.asarray(dense_or_identity(Q), dtype=float)
    bhat = (Q.T @ b).reshape(-1)
    n = dense_or_identity(L).shape[1]

    if dptype == "tsvd":
        # walk k = n-1 .. 0 while the truncated residual stays below eta*delta
        # (discrepancy_principle.py:100-114)
        tail = float(np.sum(bhat[n:] ** 2))
        alpha = n
        for i in range(n):
            k = n - (i + 1)
            dp_val = float(np.sum(bhat[k:n] ** 2)) + tail - thresh
            if dp_val < 0:
                alpha = k
            else:
                break
        return alpha

    if dptype == "tgsvd":
        # progressive zeroing (discrepancy_principle.py:115-128)
        coeff = bhat**2
        running = float(np.sum(coeff))
        alpha = n
        for i in range(n):
            running -= float(coeff[n - (i + 1)])
            if running - thresh >= 0:
                alpha = i
            else:
                break
        return alpha

    raise ValueError(f"unknown dptype {dptype!r}")
