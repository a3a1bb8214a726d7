"""Generalized Krylov solvers with the regularization parameter by GCV,
plain PyTorch and SciPy: the references of the ``gks`` and ``mmgks``
entries.

The upstream TRIPs-Py algorithms (GKS.py, MMGKS.py), written out again:
``projection_dim`` Golub-Kahan steps from b give the first basis V; each
iteration factors the projected panels, takes lambda minimizing the GCV
function of the projected Tikhonov problem (bounded Brent on [1e-9, 1e2],
xtol 1e-12), solves the stacked least squares, and appends the normalized,
reorthogonalized residual of the normal equations to V. MMGKS reweights
the panels each iteration: fidelity weights (v^2 + eps^2)^(p/2 - 1) of
v = A x - b, and isotropic-TV weights that couple each pixel's two spatial
derivatives in its own frame, the time derivative keeping the smoothed
Holder weight. Everything runs in the dtype of ``A`` (float64 for the
comparison); lambda is chosen on the host.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
from scipy import optimize



def first_difference(n):
    """(n-1, n): row i is e_i - e_{i+1}."""
    return sp.diags([np.ones(n - 1), -np.ones(n - 1)], [0, 1],
                    shape=(n - 1, n))


def centered_difference(n):
    """(n, n): row i (0 < i < n-1) is (e_{i+1} - e_{i-1}) / 2, rows 0 and
    n-1 zero."""
    D = sp.diags([-0.5 * np.ones(n - 1), 0.5 * np.ones(n - 1)], [-1, 1],
                 shape=(n, n)).tolil()
    D[0, :] = 0
    D[n - 1, :] = 0
    return D.tocsr()


def derivative_2d(nx, ny):
    """Forward differences within each row, then across rows."""
    return sp.vstack([sp.kron(sp.identity(nx), first_difference(ny)),
                      sp.kron(first_difference(nx), sp.identity(ny))]).tocsr()


def centered_2d(nx, ny):
    return sp.vstack([sp.kron(sp.identity(nx), centered_difference(ny)),
                      sp.kron(centered_difference(nx), sp.identity(ny))])


def centered_space_time(nx, ny, nt):
    """Per frame (frame-major) the centered derivatives within rows and
    across rows, then the centered time derivative."""
    return sp.vstack([sp.kron(sp.identity(nt), centered_2d(nx, ny)),
                      sp.kron(centered_difference(nt),
                              sp.identity(nx * ny))]).tocsr()


def golub_kahan_basis(A, b, k):
    """V (n, k) of k Golub-Kahan steps from b (no reorthogonalization)."""
    u = b / b.norm()
    vs, beta = [], None
    for _ in range(k):
        v = A.rmatvec(u)
        if vs:
            v = v - beta * vs[-1]
        alpha = v.norm()
        v = v / alpha
        u = A.matvec(v) - alpha * u
        beta = u.norm()
        u = u / beta
        vs.append(v)
    return torch.stack(vs, dim=1)


def gcv_lambda(R_A, R_L, bproj):
    """lambda minimizing ||R_A z - bproj||^2 / (k - tr(R_A G^-1 R_A^T))^2,
    G = R_A^T R_A + lambda R_L^T R_L (host, float64)."""
    R_A, R_L = (np.asarray(M.cpu(), dtype=np.float64) for M in (R_A, R_L))
    bproj = np.asarray(bproj.cpu(), dtype=np.float64)
    k = R_A.shape[0]

    def gcv(lam):
        G = R_A.T @ R_A + lam * (R_L.T @ R_L)
        z = np.linalg.solve(G, R_A.T @ bproj)
        trace = np.trace(R_A @ np.linalg.solve(G, R_A.T))
        return float(np.sum((R_A @ z - bproj) ** 2)) / (k - trace) ** 2

    return float(optimize.fminbound(gcv, 1e-9, 1e2, xtol=1e-12, maxfun=1000,
                                    disp=0))


def stacked_solve(R_A, R_L, lam, rhs):
    """argmin_y ||[R_A; sqrt(lam) R_L] y - [rhs; 0]||."""
    top = torch.cat([R_A, np.sqrt(lam) * R_L])
    full = torch.cat([rhs, rhs.new_zeros(R_L.shape[0])])
    return torch.linalg.lstsq(top.cpu(), full.cpu()[:, None],
                              driver="gelsd").solution[:, 0].to(rhs.device)


def _expand(A, L, V, AV, LV, r, passes):
    for _ in range(passes):
        r = r - V @ (V.T @ r)
    v = r / r.norm()
    return (torch.cat([V, v[:, None]], 1),
            torch.cat([AV, A.matvec(v)[:, None]], 1),
            torch.cat([LV, L.matvec(v)[:, None]], 1))


def gks(A, L, b, projection_dim, n_iter):
    """(x, lambda) after ``n_iter`` GKS iterations with GCV."""
    V = golub_kahan_basis(A, b, projection_dim)
    AV, LV = A.matvec(V), L.matvec(V)
    for _ in range(n_iter):
        QA, R_A = torch.linalg.qr(AV)
        R_L = torch.linalg.qr(LV, mode="r")[1]
        bproj = QA.T @ b
        lam = gcv_lambda(R_A, R_L, bproj)
        y = stacked_solve(R_A, R_L, lam, bproj)
        x = V @ y
        r = A.rmatvec(AV @ y - b) + lam * L.rmatvec(LV @ y)
        V, AV, LV = _expand(A, L, V, AV, LV, r, 3)
    return x, lam


def iso_tv_weights(x, u, spatial, nx, ny, nt, epsilon, qnorm):
    """Each pixel's two spatial derivatives in its own frame coupled
    isotropically; the time derivatives' smoothed Holder weights."""
    p = nx * ny
    D = spatial.matvec(x.reshape(nt, p).T)  # (2p, nt)
    wx = (D[:p] ** 2 + D[p:] ** 2 + epsilon ** 2) ** ((qnorm - 2) / 4)
    wt = (u[2 * p * nt:] ** 2 + epsilon ** 2) ** ((qnorm - 2) / 4)
    return torch.cat([torch.cat([wx.T, wx.T], 1).reshape(-1), wt])


def mmgks_isotv(A, L, spatial, b, dims, projection_dim, n_iter, pnorm,
                qnorm, epsilon):
    """(x, lambda) after ``n_iter`` MMGKS iterations, isotropic TV, GCV on
    the weighted data."""
    nx, ny, nt = dims
    V = golub_kahan_basis(A, b, projection_dim)
    x = A.rmatvec(b)
    AV, LV = A.matvec(V), L.matvec(V)
    for _ in range(n_iter):
        wf = ((A.matvec(x) - b) ** 2 + epsilon ** 2) ** (pnorm / 2 - 1)
        wr = iso_tv_weights(x, L.matvec(x), spatial, nx, ny, nt, epsilon,
                            qnorm)
        QA, R_A = torch.linalg.qr(AV * wf[:, None])
        R_L = torch.linalg.qr(LV * wr[:, None], mode="r")[1]
        lam = gcv_lambda(R_A, R_L, QA.T @ (wf * b))
        y = stacked_solve(R_A, R_L, lam, QA.T @ b)
        x = V @ y
        r = (A.rmatvec(wf * (AV @ y - b))
             + lam * L.rmatvec(wr * (LV @ y)))
        V, AV, LV = _expand(A, L, V, AV, LV, r, 2)
    return x, lam
