"""GKS — generalized Krylov subspace method for ||Ax-b||^2 + lam ||Lx||^2.

Counterpart of ``trips_tpu/solvers/gks.py`` (reference:
``trips/solvers/GKS.py:27-105``). Per iteration: QR (or SVD when L == I) of
the projected panels AV and LV, lam selection on the projected pencil,
stacked least squares, then expansion of V with the normalized, (3x)
reorthogonalized residual of the normal equations
r = A^T(A V y - b) + lam L^T L V y.

Device/host split: V, AV, LV live on the operator's device and grow by one
column per iteration, with one apply of A and one of A^T (incremental QR
columns, a full Householder refactorization every 25 columns); lam
selection and the k x k least squares run on the host, which reads the
projected factors back once per iteration, as the JAX package does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import svd
from ..core.linop import IdentityOperator
from ..krylov import golub_kahan
from ..regparam.dp import dp_tikhonov_projected
from ..regparam.gcv import gcv_tikhonov_projected
from ..regparam.lcurve import l_curve
from ..regparam.utils import is_identity_matrix
from ._common import as_op, build_info, host, like, stacked_lstsq, vec


def _qr_append(Q, R, a):
    """Append column a to the QR factorization (two-pass MGS for
    stability)."""
    r1 = Q.T @ a
    q = a - Q @ r1
    r2 = Q.T @ q
    q = q - Q @ r2
    r = r1 + r2
    rho = torch.linalg.norm(q)
    q = q / rho
    k = R.shape[1]
    R = torch.nn.functional.pad(R, (0, 1, 0, 1))
    R[: k + 1, k] = torch.cat([r, rho[None]])
    return torch.cat([Q, q[:, None]], dim=1), R


def _qr_panel(P):
    return torch.linalg.qr(P, mode="reduced")


def _is_identity_op(L):
    if isinstance(L, IdentityOperator):
        return True
    if L.shape[0] == L.shape[1] and L.shape[0] <= 4096:
        try:
            dense = L.todense()
        except NotImplementedError:
            return False
        return is_identity_matrix(host(dense))
    return False


def _select_lambda(regparam, R_A, R_L, bproj, out_norm2, delta, eta, kwargs):
    if regparam == "gcv":
        return gcv_tikhonov_projected(
            R_A, R_L, bproj,
            out_norm2=out_norm2,
            t_term=float(kwargs["fullsize"]) if kwargs.get("variant") == "modified" else None,
            variant=kwargs.get("variant", "standard"),
        )
    if regparam == "dp":
        return dp_tikhonov_projected(R_A, R_L, bproj, out_norm2, delta=delta, eta=eta)
    if regparam == "l_curve":
        return l_curve(R_A, R_L, np.asarray(bproj).reshape(-1, 1))
    return float(regparam)


def GKS(A, b, L, projection_dim=3, n_iter=50, regparam="gcv", x_true=None, **kwargs):
    """Returns (x, info).

    kwargs['strict_reference']=True reproduces the reference's identity-L
    behavior literally, including its missing right-rotation
    (GKS.py:46-52,74-76 drop the SVD's W factor and apply x = V z in the
    rotated coordinates). The default applies the fix (y = W z), as the
    JAX package does (pinned by its tests/test_deviations.py).
    """
    A = as_op(A)
    L = as_op(L)
    b = vec(b, A.device)
    delta = kwargs.get("delta", None)
    eta = kwargs.get("eta", 1.01)
    dp_stop = kwargs.get("dp_stop", False)
    if (regparam == "dp" or dp_stop) and delta is None:
        raise Exception(
            "A value for the noise level delta was not provided and the "
            "discrepancy principle cannot be applied. Please supply delta, "
            "or choose the regularization parameter according to gcv or a "
            "different stopping criterion."
        )

    callback = kwargs.get("callback", None)
    L_is_identity = _is_identity_op(L)
    _, _, V = golub_kahan(A, b, projection_dim)
    AV = A.matmat(V)
    LV = L.matmat(V)
    QA = RAj = QL = RLj = None

    x = None
    lam = None
    x_history, lambda_history, residual_history = [], [], []
    its = 0
    for ii in range(n_iter):
        its = ii
        k = V.shape[1]
        Wrot = None
        if L_is_identity:
            # SVD of AV = Qa diag(s) W^T. The reference (GKS.py:46-52,74-76)
            # drops W and applies x = V z in the rotated coordinates; the
            # fix rotates back (y = W z)
            Qa, s, Wt = svd(AV, full_matrices=False)
            R_A = np.diag(host(s))
            R_L = np.eye(k)
            QA = Qa
            if not kwargs.get("strict_reference", False):
                Wrot = Wt.T
        else:
            # incremental column appends are O(mk); a full Householder
            # re-factorization every 25 columns arrests the slow loss of
            # orthogonality MGS appends accumulate on ill-posed panels
            if QA is None or (ii % 25 == 0 and ii > 0):
                QA, RAj = _qr_panel(AV)
                QL, RLj = _qr_panel(LV)
            else:
                QA, RAj = _qr_append(QA, RAj, AV[:, -1])
                QL, RLj = _qr_append(QL, RLj, LV[:, -1])
            R_A, R_L = host(RAj), host(RLj)

        bproj_dev = QA.T @ b
        bproj = host(bproj_dev)
        out_norm2 = float(torch.linalg.norm(b - QA @ bproj_dev) ** 2)
        lam = _select_lambda(regparam, R_A, R_L, bproj, out_norm2, delta, eta, kwargs)
        lambda_history.append(lam)

        y = like(stacked_lstsq(R_A, lam, R_L, bproj), b)
        if Wrot is not None:
            y = Wrot @ y
        x = V @ y
        x_history.append(x)

        # residual of the normal equations + 3x reorthogonalization
        ra = A.rmatvec(AV @ y - b)
        rb = L.rmatvec(LV @ y)
        r = ra + lam * rb
        for _ in range(3):
            r = r - V @ (V.T @ r)
        residual_history.append(float(torch.linalg.norm(r)))
        if callback is not None:
            callback(ii, x=host(x), lam=lam, residual=residual_history[-1])
        vn = r / torch.linalg.norm(r)
        V = torch.cat([V, vn[:, None]], dim=1)
        AV = torch.cat([AV, A.matvec(vn)[:, None]], dim=1)
        LV = torch.cat([LV, L.matvec(vn)[:, None]], dim=1)

    info = build_info(x_history, lambda_history, residual_history, its, x_true=x_true)
    return x[:, None], info
