"""Fixed-projection solvers: Arnoldi-Tikhonov, Golub-Kahan-Tikhonov, GMRES.

Counterpart of ``trips_tpu/solvers/projection.py``, with its semantics and
deviations from the reference:
- Arnoldi-Tikhonov: ``trips/solvers/A_Tikhonov.py:23-97`` — Arnoldi to a
  fixed dimension, then Tikhonov on the projected (H, Q^T b) with lam from
  GCV (projected SVD) / DP / scalar.
- Golub-Kahan-Tikhonov: ``trips/solvers/GK_Tikhonov.py:23-77`` — GK
  bidiagonalization, modified-GCV (fullsize = m) or DP, stacked lstsq;
  ``n_iter`` is honored (the reference hard-codes 3 at :59; the default
  reproduces it).
- GMRES: ``trips/solvers/GMRES.py:19-53`` as textbook GMRES,
  y = argmin ||H y - Q^T b||, x = Q_k y, honoring ``n_iter`` (the
  reference ignores it and solves ``lstsq(H.T, H.T @ bhat)``).

The Krylov factorizations run on the operator's device; projected solves on
the host.
"""
from __future__ import annotations

import numpy as np
import scipy.linalg as sla
import torch

from ..krylov import arnoldi, golub_kahan
from ..regparam.dp import dp_tikhonov_projected
from ..regparam.gcv import gcv_tikhonov_projected
from ._common import as_op, host, like, stacked_lstsq, vec


def _out_norm2(b, Q, bproj):
    return float(torch.linalg.norm(b - Q @ bproj) ** 2)


def Arnoldi_Tikhonov(A, b, n_iter=3, regparam="gcv", **kwargs):
    """Returns (x, lam)."""
    A = as_op(A)
    if A.shape[0] != A.shape[1]:
        raise ValueError("The observation matrix A must be square for this method.")
    b = vec(b, A.device)
    Q, H = arnoldi(A, b, n_iter)
    Hh = host(H)
    bhat = host(Q.T @ b)  # (k+1,)
    k = Hh.shape[1]

    if regparam == "gcv":
        U, s, _ = sla.svd(Hh, full_matrices=False)
        # gcv on the projected pencil (diag(s), I); data is bhat
        lam = gcv_tikhonov_projected(np.diag(s), np.eye(k), U.T @ bhat,
                                     out_norm2=float(np.linalg.norm(bhat - U @ (U.T @ bhat)) ** 2))
        y = sla.solve(Hh.T @ Hh + lam * np.eye(k), Hh.T @ bhat)
    elif regparam == "dp":
        lam = dp_tikhonov_projected(
            Hh, np.eye(k), bhat, _out_norm2(b, Q, like(bhat, b)),
            delta=kwargs["delta"], eta=kwargs.get("eta", 1.01),
            explicit_proj=kwargs.get("explicitProj", False),
        )
        y = stacked_lstsq(Hh, lam, np.eye(k), bhat)
    else:
        lam = float(regparam)
        y = sla.solve(Hh.T @ Hh + lam * np.eye(k), Hh.T @ bhat)
    x = Q[:, :-1] @ like(y, b)
    return x[:, None], lam


def Golub_Kahan_Tikhonov(A, b, n_iter=3, regparam="gcv", **kwargs):
    """Returns (x, lam)."""
    A = as_op(A)
    b = vec(b, A.device)
    delta = kwargs.get("delta", None)
    if regparam == "dp" and delta is None:
        raise Exception(
            "A value for the noise level delta was not provided and the "
            "discrepancy principle cannot be applied. Please supply delta, "
            "or choose the regularization parameter according to gcv."
        )
    U, B, V = golub_kahan(A, b, n_iter)
    Bh = host(B)
    bhat = host(U.T @ b)
    k = Bh.shape[1]

    if regparam == "gcv":
        Us, s, _ = sla.svd(Bh, full_matrices=False)
        lam = gcv_tikhonov_projected(
            np.diag(s), np.eye(k), Us.T @ bhat,
            out_norm2=float(np.linalg.norm(bhat - Us @ (Us.T @ bhat)) ** 2),
            t_term=float(A.shape[0]), variant="modified",
        )
    elif regparam == "dp":
        lam = dp_tikhonov_projected(
            Bh, np.eye(k), bhat, _out_norm2(b, U, like(bhat, b)),
            delta=delta, eta=kwargs.get("eta", 1.01),
            explicit_proj=kwargs.get("explicitProj", False),
        )
    else:
        lam = float(regparam)
    y = stacked_lstsq(Bh, lam, np.eye(k), bhat)
    x = V @ like(y, b)
    return x[:, None], lam


def GMRES(A, b, n_iter=3, dp_stop=0, **kwargs):
    """Textbook GMRES on the projected system; returns x."""
    A = as_op(A)
    if A.shape[0] != A.shape[1]:
        raise ValueError("Arnoldi can not be used. The operator is not square")
    b = vec(b, A.device)
    Q, H = arnoldi(A, b, n_iter)
    bhat = host(Q.T @ b)
    y, *_ = np.linalg.lstsq(host(H), bhat, rcond=None)
    x = Q[:, :-1] @ like(y, b)
    return x[:, None]
