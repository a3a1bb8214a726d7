"""L-curve criterion: lam maximizing the curvature of
(log ||A x_lam - b||^2, log ||L x_lam - d||^2)... in the reference's
parametrization, the *plain* (not log) curvature of
(f(lam), g(lam)) = (||A x_lam - b||^2, ||L x_lam - d||^2).

Semantics mirror ``trips/utilities/reg_param/l_curve.py:23-203``: analytic
first/second derivatives of f and g via repeated solves with
C + lam*D (C = A^T A, D = L^T L), curvature

  kappa(lam) = (-g' f'' + f' g'') / (g'^2 + f'^2)^{3/2}

maximized with bounded Brent on [1e-9, 2] (xtol=1e-12, maxfun=1000). Called
on projected small systems (R_A, R_L, Q_A^T b).

A host NumPy/SciPy copy of ``trips_tpu/regparam/lcurve.py``.
"""
from __future__ import annotations

import numpy as np
from scipy import optimize as sop

from .utils import dense_or_identity


def _lstsq(M, rhs):
    return np.linalg.lstsq(M, rhs, rcond=None)[0]


def _derivatives(lam, A, L, b, d):
    """x_lam and its first/second lam-derivatives (l_curve.py:23-88)."""
    C = A.T @ A
    D = L.T @ L
    lhs = C + lam * D
    rhs = A.T @ b + lam * (L.T @ d)
    x = _lstsq(lhs, rhs)
    dx = -_lstsq(lhs, D @ x - L.T @ d)
    inv4 = _lstsq(lhs, D @ x)
    d2x = 2.0 * _lstsq(lhs, D @ dx - D @ inv4)
    return x, dx, d2x


def _term_derivs(M, c, x, dx, d2x):
    """(d/dlam, d2/dlam2) of ||M x_lam - c||^2."""
    r = M @ x - c
    Mdx = M @ dx
    first = 2.0 * float(np.vdot(r, Mdx))
    second = 2.0 * (float(np.vdot(Mdx, Mdx)) + float(np.vdot(r, M @ d2x)))
    return first, second


def curvature(lam, A, L, b, d=None):
    A = dense_or_identity(A)
    L = dense_or_identity(L)
    b = np.asarray(b, dtype=float).reshape(-1, 1)
    if d is None:
        d = np.zeros((L.shape[0], 1))
    x, dx, d2x = _derivatives(lam, A, L, b, d)
    f1, f2 = _term_derivs(A, b, x, dx, d2x)
    g1, g2 = _term_derivs(L, d, x, dx, d2x)
    num = -g1 * f2 + f1 * g2
    den = (g1**2 + f1**2) ** 1.5
    return num / den


def l_curve(A, L, b, d=None):
    """Returns lam maximizing the curvature (l_curve.py:190-203)."""
    neg = lambda lam: -curvature(lam, A, L, b, d)
    return float(sop.fminbound(neg, 1e-9, 2.0, xtol=1e-12, maxfun=1000, disp=0))
