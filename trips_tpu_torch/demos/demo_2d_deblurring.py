"""2D deblurring demo, the twin of ``demos/demo_2d_deblurring.py`` (which
mirrors the reference's demo_2D_Deblurring_small_scale / _large_scale):
Gaussian PSF, 1% noise, Arnoldi-Tikhonov with the discrepancy principle,
Hybrid GMRES, Hybrid LSQR, GKS and MMGKS with the derivative and with the
framelet regularizer, all with GCV, in float32. No banded kernel lies on
this path: ``Blur2D`` is a ``conv2d`` (cuDNN on the card).

Run: python3 -m trips_tpu_torch.demos.demo_2d_deblurring [--n 50]
[--large] [--iters 30] [--device cuda]
"""
import argparse

import numpy as np
import torch

from ..operators import FirstDerivative2D, FrameletOperator
from ..problems import Deblurring2D
from ..solvers import GKS, MMGKS, Arnoldi_Tikhonov, Hybrid_GMRES, Hybrid_LSQR
from ..solvers._common import host


def relerr(x, xt):
    x, xt = host(x).reshape(-1), np.asarray(xt).reshape(-1)
    return np.linalg.norm(x - xt) / np.linalg.norm(xt)


def problem(n, large, device, dtype):
    """The demo's inputs after ``np.random.seed(0)``: (A, b, delta,
    x_true), ``A`` the ``Blur2D`` operator of ``dtype`` on ``device``
    (``large``: the (9, 9) PSF of spread (3, 3), else (3, 3) of spread
    (1, 1)), ``b`` the noisy data (NumPy float64)."""
    np.random.seed(0)
    dim, spread = ([9, 9], (3, 3)) if large else ([3, 3], (1, 1))
    prob = Deblurring2D(device=device, dtype=dtype)
    A = prob.forward_Op(dim, spread, n, n)
    x_true = prob.gen_true("h_im", nx=n, ny=n)
    b_true = prob.gen_data(np.asarray(x_true).reshape(-1, 1))
    b, delta = prob.add_noise(b_true, "Gaussian", 0.01)
    return A, np.asarray(b).reshape(-1), float(delta), x_true


def solves(A, b, delta, n, n_iter):
    """The demo's solves, in its order: {name: solve}, each solve a
    function of no arguments returning (x, its second result), in ``A``'s
    dtype on its device."""
    dev, dt = A.device, A.dtype
    bv = torch.tensor(b, dtype=dt, device=dev)
    L = FirstDerivative2D(n, n, device=dev)
    W = FrameletOperator(n, n, 2, dtype=dt, device=dev)
    return {
        "Arnoldi-Tikhonov (dp)": lambda: Arnoldi_Tikhonov(
            A, bv, n_iter=8, regparam="dp", delta=delta),
        "Hybrid GMRES (gcv)": lambda: Hybrid_GMRES(A, bv, n_iter=n_iter,
                                                   regparam="gcv"),
        "Hybrid LSQR (gcv)": lambda: Hybrid_LSQR(A, bv, n_iter=n_iter,
                                                 regparam="gcv"),
        "GKS (gcv, derivative L)": lambda: GKS(
            A, bv, L, projection_dim=3, n_iter=n_iter, regparam="gcv"),
        "MMGKS p2 q1 (derivative L)": lambda: MMGKS(
            A, bv, L, pnorm=2, qnorm=1, projection_dim=3, n_iter=n_iter,
            regparam="gcv"),
        "MMGKS p2 q1 (framelet W)": lambda: MMGKS(
            A, bv, W, pnorm=2, qnorm=1, projection_dim=3,
            n_iter=min(n_iter, 15), regparam="gcv"),
    }


def main(argv=None):
    """Run the demo and print its lines; returns {name: relError}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=50)
    ap.add_argument("--large", action="store_true",
                    help="128x128 with (9,9)/(3,3) PSF (paper Code 2 config)")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    n = 128 if args.large else args.n
    A, b, delta, x_true = problem(n, args.large, args.device, torch.float32)
    results = {}
    for name, solve in solves(A, b, delta, n, args.iters).items():
        x, _ = solve()
        results[name] = relerr(x, x_true)

    for name, err in results.items():
        print(f"{name:35s} relative error = {err:.4f}")
    return results


if __name__ == "__main__":
    main()
