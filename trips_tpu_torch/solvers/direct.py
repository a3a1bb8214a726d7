"""Direct regularization solvers: Tikhonov, TSVD, TGSVD.

Counterpart of ``trips_tpu/solvers/direct.py`` (reference semantics):
- Tikhonov: ``trips/solvers/Tikhonov.py:19-29`` — lam by GCV/DP/scalar, then
  the normal-equations solve (A^T A + lam L^T L) x = A^T b.
- TSVD: ``trips/solvers/tSVD.py:19-38`` — full SVD, truncation index k by
  GCV('tsvd')/DP('tsvd')/user, x = V_k S_k^{-1} U_k^T b.
- TGSVD: ``trips/solvers/tGSVD.py:20-39`` — GSVD of (A, L), truncation by
  GCV('tgsvd')/DP('tgsvd'), x = X^{-T} C_trunc U^T b.

For small/medium dense systems: the decompositions and the choice of lam or
k run on the host in float64 LAPACK, as in the JAX package; the
reconstruction runs on ``device`` (the CUDA card unless "cpu" is asked
for) in ``dtype``, by default A's own (a float32 operator or array gives a
float32 x, as the JAX package's float32 run does).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import DEFAULT, resolve
from ..core.linop import IdentityOperator, LinearOperator
from ..regparam.dp import discrepancy_principle
from ..regparam.gcv import generalized_crossvalidation
from ..utils.gsvd import gsvd
from ._common import host

_GCV_NAMES = ("gcv", "GCV", "Gcv")
_DP_NAMES = ("DP", "dp", "Dp", "Discrepancy Principle", "Discrepancy principle",
             "discrepancy principle")


# Direct solvers densify A (and run LAPACK SVD/GSVD on it): O(m*n) memory
# and O(m*n^2) work. Beyond this element count the dense route is unusable
# (a 21720x65536 tomography operator would be 11 GB dense) — use the
# hybrid/fused iterative solvers instead. Override via dense_max= kwarg.
DENSE_MAX_ELEMENTS = 25_000_000  # ~5000 x 5000 f64 (0.2 GB)


def _guard_dense(shape, dense_max, who):
    m, n = shape
    if m * n > dense_max:
        raise ValueError(
            f"{who}: operator is {m}x{n} = {m * n:,} elements dense, above "
            f"the direct-solver limit of {dense_max:,} "
            "(densification + LAPACK decomposition would need "
            f"{m * n * 8 / 1e9:.1f} GB). Use an iterative solver "
            "(hybrid_lsqr / fused_hybrid_lsqr, gks, mmgks) for operators "
            "of this size, or pass dense_max= to override.")


def _densify(M):
    """A port operator, tensor, scipy sparse or NumPy matrix as a float64
    host array."""
    if isinstance(M, IdentityOperator):
        return np.eye(M.shape[0])
    if isinstance(M, LinearOperator):
        return np.asarray(host(M.todense()), dtype=float)
    if hasattr(M, "toarray"):
        return M.toarray()
    return np.asarray(host(M), dtype=float)


def _dtype(A, dtype):
    """The reconstruction's dtype: ``dtype`` if given, else A's."""
    if dtype is not None:
        return dtype
    if isinstance(A, (LinearOperator, torch.Tensor)):
        return A.dtype
    if np.asarray(A).dtype == np.float32:
        return torch.float32
    return torch.float64


def _require_delta(regparam, kwargs):
    if regparam == "dp" and kwargs.get("delta", None) is None:
        raise Exception(
            "A value for the noise level delta was not provided and the "
            "discrepancy principle cannot be applied. Please supply delta, "
            "or choose the regularization parameter according to gcv."
        )


def Tikhonov(A, b, L, x_true=None, regparam="gcv", device=DEFAULT,
             dtype=None, **kwargs):
    """Returns (x, lam), x an ``(n, 1)`` tensor on ``device``."""
    dev = resolve(device)
    dense_max = kwargs.pop("dense_max", DENSE_MAX_ELEMENTS)
    _guard_dense(A.shape, dense_max, "Tikhonov")
    dt = _dtype(A, dtype)
    A = _densify(A)
    L = _densify(L)
    b = np.asarray(host(b), dtype=float).reshape(-1, 1)
    # IdentityOperator stands in for the reference's np.eye(m) Q argument
    # (trips/solvers/Tikhonov.py:22-27) without the O(m^2) materialization;
    # both gcv and dp short-circuit identity Q.
    eye_q = IdentityOperator(A.shape[0], device="cpu")
    if regparam in _GCV_NAMES:
        lam = generalized_crossvalidation(eye_q, A, L, b)
    elif regparam in _DP_NAMES:
        lam = discrepancy_principle(eye_q, A, L, b, **kwargs)
    else:
        lam = regparam
    At, Lt, bt = (torch.tensor(M, dtype=dt, device=dev) for M in (A, L, b))
    x = torch.linalg.solve(At.T @ At + lam * (Lt.T @ Lt), At.T @ bt)
    return x, lam


def tSVD_sol(A, b, regparam="gcv", device=DEFAULT, dtype=None, **kwargs):
    """Returns (x, k), x an ``(n, 1)`` tensor on ``device``."""
    dev = resolve(device)
    _guard_dense(A.shape, kwargs.pop("dense_max", DENSE_MAX_ELEMENTS),
                 "tSVD_sol")
    _require_delta(regparam, kwargs)
    dt = _dtype(A, dtype)
    b = np.asarray(host(b), dtype=float).reshape(-1, 1)
    A = _densify(A)
    U, S, VT = np.linalg.svd(A)
    if regparam == "gcv":
        k = generalized_crossvalidation(U, S, VT, b, gcvtype="tsvd")
    elif regparam == "dp":
        k = discrepancy_principle(U, S, VT, b, dptype="tsvd", **kwargs)
    else:
        k = int(regparam)
    coef = (U[:, :k].T @ b) / S[:k].reshape(-1, 1)
    x = (torch.tensor(VT[:k, :].T, dtype=dt, device=dev)
         @ torch.tensor(coef, dtype=dt, device=dev))
    return x, k


def tGSVD_sol(A, L, b, regparam="gcv", device=DEFAULT, dtype=None, **kwargs):
    """Returns (x, k), x an ``(n, 1)`` tensor on ``device``."""
    dev = resolve(device)
    _guard_dense(A.shape, kwargs.pop("dense_max", DENSE_MAX_ELEMENTS),
                 "tGSVD_sol")
    _require_delta(regparam, kwargs)
    dt = _dtype(A, dtype)
    b = np.asarray(host(b), dtype=float).reshape(-1, 1)
    A = _densify(A)
    L = _densify(L)
    U, _, X, C, S = gsvd(A, L)
    if regparam == "gcv":
        k = generalized_crossvalidation(U, S, X, b, gcvtype="tgsvd")
    elif regparam == "dp":
        k = discrepancy_principle(U, C, X, b, dptype="tgsvd", **kwargs)
    else:
        k = int(regparam)
    Y = np.linalg.inv(X.T)
    Ck = C.copy()
    Ck[:k, :k] = 0

    def t(M):
        return torch.tensor(M, dtype=dt, device=dev)

    x = t(Y) @ t(Ck) @ (t(U.T) @ t(b))
    return x, k
