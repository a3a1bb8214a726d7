"""Generalized cross-validation for the projected Tikhonov problem.

Semantics mirror ``trips/utilities/reg_param/gcv.py:25-124``:

- ``gcvtype='tikhonov'``: minimize ``N(lam)/D(lam)`` over lam in [1e-9, 1e2]
  with scipy's bounded Brent (xtol=1e-12, maxfun=1000), where for the
  projected pencil (R_A, R_L) and data b:
    z(lam) solves (R_A^T R_A + lam R_L^T R_L) z = R_A^T Q_A^T b
    N(lam) = ||R_A z - Q_A^T b||^2            (+ ||b - Q_A Q_A^T b||^2 when
                                               variant='modified')
    D(lam) = (t - tr(R_A (R_A^T R_A + lam R_L^T R_L)^{-1} R_A^T))^2
  with t = rows(R_A) for the standard variant and t = ``fullsize`` (the full
  problem row count) for the modified (hybrid-solver) variant.
- ``gcvtype='tsvd'`` / ``'tgsvd'``: discrete search returning a truncation
  index (``gcv.py:96-122``).

These run on host over the tiny projected systems (k x k); the large-system
work stays on device. A host NumPy/SciPy copy of
``trips_tpu/regparam/gcv.py``.
"""
from __future__ import annotations

import numpy as np
import scipy.linalg as sla
from scipy import optimize as sop

from .utils import dense_or_identity, is_identity_matrix


def _gcv_terms(lam, R_A, R_L, bproj):
    G = R_A.T @ R_A + lam * (R_L.T @ R_L)
    z = sla.solve(G, R_A.T @ bproj)
    resid = R_A @ z - bproj
    num = float(np.linalg.norm(resid) ** 2)
    inverted = sla.solve(G, R_A.T)
    trace = float(np.trace(R_A @ inverted))
    return num, trace


def gcv_tikhonov_projected(R_A, R_L, bproj, out_norm2=0.0, t_term=None,
                           variant="standard"):
    """GCV minimization given already-projected quantities.

    Solvers call this directly so the (m, k) basis Q_A never leaves the
    device — only R_A, R_L (k x k) and bproj (k,) come to host.

    ``variant='standard-cols'`` uses cols(R_A) instead of rows(R_A) in the
    trace term — the reference ships this as the (unused) ``gcv_new.py``
    variant (``gcv_new.py:76`` vs ``gcv.py:76``); exposed here for parity.
    """
    R_A = dense_or_identity(R_A)
    R_L = dense_or_identity(R_L)
    bproj = np.asarray(bproj, dtype=float).reshape(-1, 1)
    if variant == "standard-cols":
        t_term = float(R_A.shape[1])
        variant = "standard"
    if t_term is None:
        t_term = float(R_A.shape[0])

    def gcv_func(lam):
        num, trace = _gcv_terms(lam, R_A, R_L, bproj)
        if variant == "modified":
            num = num + out_norm2
        return num / (t_term - trace) ** 2

    return float(sop.fminbound(gcv_func, 1e-9, 1e2, xtol=1e-12, maxfun=1000, disp=0))


def generalized_crossvalidation(Q_A, R_A, R_L, b, **kwargs):
    """Returns lam (float) for 'tikhonov', or a truncation index (int)."""
    gcvtype = kwargs.get("gcvtype", "tikhonov")
    variant = kwargs.get("variant", "standard")

    b = np.asarray(b, dtype=float).reshape(-1, 1)

    if gcvtype == "tikhonov":
        R_A = dense_or_identity(R_A)
        R_L = dense_or_identity(R_L)
        if is_identity_matrix(Q_A, b.shape[0]):
            bproj = b
            out_norm2 = 0.0
        else:
            Q_A = np.asarray(Q_A, dtype=float)
            bproj = Q_A.T @ b
            out_norm2 = float(np.linalg.norm(b - Q_A @ bproj) ** 2)

        t_term = float(kwargs["fullsize"]) if variant == "modified" else float(R_A.shape[0])
        return gcv_tikhonov_projected(R_A, R_L, bproj, out_norm2, t_term, variant)

    Q_A = np.asarray(Q_A, dtype=float)
    bhat = (Q_A.T @ b).reshape(-1)
    m = Q_A.shape[0]
    n = np.asarray(R_L).shape[1]

    if gcvtype == "tsvd":
        # k = n-(i+1); residual energy = sum of |bhat_j|^2 for j >= k plus the
        # out-of-column-space tail j >= n  (gcv.py:96-109)
        tail = float(np.sum(bhat[n:] ** 2))
        vals = []
        for i in range(n):
            k = n - (i + 1)
            num = float(np.sum(bhat[k:n] ** 2)) + tail
            den = (m - k) ** 2
            vals.append(num / den)
        return n - (int(np.argmin(vals)) + 1)

    if gcvtype == "tgsvd":
        # progressive zeroing of |bhat|^2 from index n-1 downward
        # (gcv.py:110-122); returns the loop index i directly
        p = np.asarray(R_L).shape[0]
        coeff = bhat**2
        total = float(np.sum(coeff))
        vals = []
        running = total
        for i in range(n):
            running -= float(coeff[n - (i + 1)])
            den = (n - (i + 1) - (n - p)) ** 2
            # den can hit 0 at the last index (reference divides by zero and
            # gets inf through numpy); keep that semantics explicitly
            vals.append(running / den if den != 0 else np.inf)
        return int(np.argmin(vals))

    raise ValueError(f"unknown gcvtype {gcvtype!r}")
