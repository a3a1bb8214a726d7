"""MMGKS — majorization-minimization GKS for ||Ax-b||_p^p + lam ||Lx||_q^q.

Counterpart of ``trips_tpu/solvers/mmgks.py`` (reference:
``trips/solvers/MMGKS.py:28-137``). Per iteration: fidelity weights
wf = (v^2 + eps^2)^(p/2-1) with v = A x - b; regularization weights wr by
mode — smoothed-Holder (default), isotropic TV ('isoTV') or group sparsity
('GS') for dynamic (nx, ny, nt) problems; QR of the weighted panels
(wf * AV), (wr * LV); lam selection; stacked least squares; basis
expansion with the reweighted normal-equations residual (2x reorth).

The m/n-sized work (weights, panels, QR, residual) runs on the operator's
device, lam selection and the k x k solve on the host. In 'GS' mode the
regularizer is replaced by kron(I_nt, D_2d), as the reference does
(MMGKS.py:44-50).
"""
from __future__ import annotations

import torch

from ..core.linop import BatchedBlockDiagOperator
from ..krylov import golub_kahan
from ..operators.derivatives import FirstDerivative2D
from ..operators.weights import (gs_weights, iso_tv_weights,
                                 smoothed_holder_weights)
from ..utils import telemetry
from ._common import as_op, build_info, host, like, stacked_lstsq, vec
from .gks import _select_lambda


@telemetry.request("solve.mmgks")
def MMGKS(A, b, L, pnorm=2, qnorm=1, projection_dim=3, n_iter=5,
          regparam="gcv", x_true=None, **kwargs):
    """Returns (x, info)."""
    A = as_op(A)
    b = vec(b, A.device)
    delta = kwargs.get("delta", None)
    eta = kwargs.get("eta", 1.01)
    epsilon = kwargs.get("epsilon", 0.1)
    iso_tv = kwargs.get("isoTV", False)
    gs = kwargs.get("GS", False)
    prob_dims = kwargs.get("prob_dims", False)
    if (regparam == "dp") and delta is None:
        raise Exception(
            "A value for the noise level delta was not provided and the "
            "discrepancy principle cannot be applied. Please supply delta, "
            "or choose the regularization parameter according to gcv."
        )

    callback = kwargs.get("callback", None)
    iso_tv_on = iso_tv in ("isoTV", "ISOTV", "IsoTV")
    gs_on = gs in ("GS", "gs", "Gs")
    if (iso_tv_on or gs_on) and prob_dims is False:
        raise TypeError(
            "For isotropic TV / group sparsity you must enter the dimensions "
            "of the dynamic problem, e.g. prob_dims=(nx, ny, nt)."
        )
    if iso_tv_on or gs_on:
        nx, ny, nt = prob_dims

    if gs_on:
        # reference rebuilds L = kron(I_nt, D_2d) in GS mode (MMGKS.py:44-50)
        L = BatchedBlockDiagOperator(FirstDerivative2D(nx, ny, device=b.device),
                                     nt)
    else:
        L = as_op(L)

    _, _, V = golub_kahan(A, b, projection_dim)
    x = A.rmatvec(b)
    AV = A.matmat(V)
    LV = L.matmat(V)

    lam = None
    x_history, lambda_history, residual_history = [], [], []
    its = 0
    for ii in range(n_iter):
        its = ii
        v = A.matvec(x) - b
        # the reference multiplies rows of AV by wf = (v^2+eps^2)^(p/2-1)
        # directly (MMGKS.py:56-58): weighted panel diag(wf) AV, data wf*b
        wf = smoothed_holder_weights(v, epsilon, pnorm)
        u = L.matvec(x)
        if iso_tv_on:
            wr = iso_tv_weights(x, u, nx, ny, nt, epsilon, qnorm)
        elif gs_on:
            wr = gs_weights(x, L.op.matmat, nx, ny, nt, qnorm)
        else:
            wr = smoothed_holder_weights(u, epsilon, qnorm)

        QA, RAj = torch.linalg.qr(AV * wf[:, None], mode="reduced")
        QL, RLj = torch.linalg.qr(LV * wr[:, None], mode="reduced")
        R_A, R_L = host(RAj), host(RLj)

        wb = wf * b
        bproj_dev = QA.T @ wb
        bproj = host(bproj_dev)
        out_norm2 = float(torch.linalg.norm(wb - QA @ bproj_dev) ** 2)
        # the reference solves the projected system against Q_A^T b
        # (MMGKS.py:106); gcv and dp choose lam on the weighted data
        bsolve = host(QA.T @ b)
        with telemetry.span("mmgks.lambda"):  # lam and y on the host
            lam = _select_lambda(
                regparam, R_A, R_L,
                bproj if regparam in ("gcv", "dp") else bsolve, out_norm2,
                delta, eta, kwargs)
            lambda_history.append(lam)
            y = like(stacked_lstsq(R_A, lam, R_L, bsolve), b)
        x = V @ y
        x_history.append(x)

        # reweighted normal-equations residual (MMGKS.py:114-118)
        ra = A.rmatvec(wf * (AV @ y - b))
        rb = L.rmatvec(wr * (LV @ y))
        r = ra + lam * rb
        for _ in range(2):
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
