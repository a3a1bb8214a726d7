"""1D deblurring demo, the twin of ``demos/demo_1d_deblurring.py`` (which
mirrors the reference's demo_1D_deblurring.ipynb): Gaussian PSF blur, 2%
noise, TSVD, TGSVD and Tikhonov with the discrepancy principle, Hybrid
GMRES and Hybrid LSQR (DP on the total discrepancy, reorthogonalized) and
GKS with ``FirstDerivative1D``, in float32. No banded kernel lies on this
path: ``Blur1D`` is a dense product (cuBLAS on the card), the direct
solvers' factorizations run on the host in float64.

Run: python3 -m trips_tpu_torch.demos.demo_1d_deblurring [--n 200]
[--parameter 10] [--iters 30] [--plot] [--device cuda]
"""
import argparse

import numpy as np
import torch

from ..operators import FirstDerivative1D, first_derivative_matrix
from ..problems import Deblurring1D
from ..solvers import (GKS, Hybrid_GMRES, Hybrid_LSQR, Tikhonov, tGSVD_sol,
                       tSVD_sol)
from ..solvers._common import host


def relerr(x, xt):
    x = host(x).reshape(-1)
    return np.linalg.norm(x - xt) / np.linalg.norm(xt)


def problem(n, parameter, device, dtype):
    """The demo's inputs after ``np.random.seed(0)``: (A, A_dense, b,
    delta, delta_total, x_true), ``A`` the ``Blur1D`` operator of
    ``dtype`` on ``device``, ``A_dense`` its host matrix, ``b`` the noisy
    data (NumPy float64), ``delta_total`` the total discrepancy."""
    np.random.seed(0)
    prob = Deblurring1D(device=device, dtype=dtype)
    A = prob.forward_Op_1D(parameter=parameter, nx=n)
    x_true = prob.gen_xtrue(n, "curve0")
    b_true = prob.gen_data(x_true, parameter=parameter)
    b, delta = prob.add_noise(b_true, "Gaussian", 0.02)
    A_dense = A.mat.cpu().numpy()
    b = np.asarray(b).reshape(-1)
    # anti-inverse-crime data carries model error beyond the additive noise;
    # DP needs the total discrepancy or it is unattainable (lam -> 0)
    delta_total = float(np.linalg.norm(
        b - A_dense @ np.asarray(x_true).reshape(-1)))
    return A, A_dense, b, float(delta), delta_total, x_true


def solves(A, A_dense, b, delta, delta_total, n_iter):
    """The demo's solves, in its order: {name: solve}, each solve a
    function of no arguments returning (x, its second result); a name with
    ``{}`` takes that result (k, lam). The direct solvers factor
    ``A_dense`` on the host in float64, x in ``A``'s dtype on its
    device."""
    dev, dt, n = A.device, A.dtype, A.shape[1]
    bt = torch.tensor(b, dtype=dt, device=dev)
    L_sq = np.vstack([first_derivative_matrix(n).toarray(), np.zeros((1, n))])
    L = FirstDerivative1D(n, device=dev)
    return {
        "TSVD (dp, k={})": lambda: tSVD_sol(
            A_dense, b, regparam="dp", delta=delta, device=dev, dtype=dt),
        "TGSVD (dp, k={})": lambda: tGSVD_sol(
            A_dense, L_sq, b, regparam="dp", delta=delta, device=dev,
            dtype=dt),
        "Tikhonov (dp, lam={:.2e})": lambda: Tikhonov(
            A_dense, b, np.eye(n), regparam="dp", delta=delta, device=dev,
            dtype=dt),
        "Hybrid GMRES (dp)": lambda: Hybrid_GMRES(
            A, bt, n_iter=n_iter, regparam="dp", delta=delta_total,
            reorth=True),
        "Hybrid LSQR (dp)": lambda: Hybrid_LSQR(
            A, bt, n_iter=n_iter, regparam="dp", delta=delta_total,
            reorth=True),
        "GKS (dp)": lambda: GKS(A, bt, L, projection_dim=3, n_iter=n_iter,
                                regparam="dp", delta=delta),
    }


def main(argv=None):
    """Run the demo and print its lines; returns {name: relError}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--parameter", type=float, default=10.0)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    A, A_dense, b, delta, delta_total, x_true = problem(
        args.n, args.parameter, args.device, torch.float32)
    results = {}
    for name, solve in solves(A, A_dense, b, delta, delta_total,
                              args.iters).items():
        x, info = solve()
        results[name.format(info)] = relerr(x, x_true)

    for name, err in results.items():
        print(f"{name:35s} relative error = {err:.4f}")

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.plot(x_true, label="x_true")
        plt.plot(host(x).reshape(-1), label="GKS")
        plt.legend()
        plt.savefig("demo_1d_deblurring.png", bbox_inches="tight")
        print("saved demo_1d_deblurring.png")
    return results


if __name__ == "__main__":
    main()
