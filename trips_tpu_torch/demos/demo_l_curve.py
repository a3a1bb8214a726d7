"""L-curve demo, the twin of ``demos/demo_l_curve.py`` (which mirrors the
reference's demo_l_curve.ipynb): GKS and MMGKS with regparam 'l_curve'
and 'dp', Hybrid LSQR with 'gcv' and 'l_curve', on a small tomography
problem whose operator is ``Tomography``'s (the bucketed banded pack,
float32: kernels K2 and K3 on the card).

Run: python3 -m trips_tpu_torch.demos.demo_l_curve [--n 64 --views 30
--iters 20 --device cuda]
"""
import argparse

import numpy as np
import torch

from ..operators import FirstDerivative2D
from ..problems import Tomography
from ..solvers import GKS, MMGKS, Hybrid_LSQR
from ..solvers._common import host


def relerr(x, xt):
    x, xt = host(x).reshape(-1), np.asarray(xt).reshape(-1)
    return np.linalg.norm(x - xt) / np.linalg.norm(xt)


def problem(n, views, device):
    """The demo's inputs: (OP, b, L, delta, x_true, A) with ``OP`` and
    ``L`` on ``device``, ``b`` the noisy data (NumPy float64) and ``A`` the
    host matrix."""
    np.random.seed(0)
    tomo = Tomography(CommitCrime=False, device=device)
    x_true, nx, ny = tomo.gen_true("tectonic", nx=n, ny=n)
    OP, b, p, q, A = tomo.gen_data(x_true, nx, ny, views)
    b_noisy, delta = tomo.add_noise(b, "Gaussian", 0.01)
    return (OP, b_noisy.reshape(-1), FirstDerivative2D(nx, ny, device=device),
            float(delta), x_true, A)


def solves(OP, bv, L, delta, n_iter):
    """The demo's six solves, in its order: {name: (solve, its info)}
    where each solve is a function of no arguments returning (x, info)."""
    runs = {}
    for rp in ["l_curve", "dp"]:
        runs[f"GKS ({rp})"] = lambda rp=rp: GKS(
            OP, bv, L, projection_dim=3, n_iter=n_iter, regparam=rp,
            delta=delta)
        runs[f"MMGKS ({rp})"] = lambda rp=rp: MMGKS(
            OP, bv, L, pnorm=2, qnorm=1, projection_dim=3, n_iter=n_iter,
            regparam=rp, delta=delta)
    for rp in ["gcv", "l_curve"]:
        runs[f"Hybrid LSQR ({rp})"] = lambda rp=rp: Hybrid_LSQR(
            OP, bv, n_iter=n_iter, regparam=rp, delta=delta)
    return runs


def main(argv=None):
    """Run the demo and print its lines; returns {name: (relError,
    lambda, the solver's info)}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--views", type=int, default=30)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    OP, b, L, delta, x_true, _ = problem(args.n, args.views, args.device)
    bv = torch.tensor(b, dtype=torch.float32, device=OP.device)
    results = {}
    for name, solve in solves(OP, bv, L, delta, args.iters).items():
        x, info = solve()
        results[name] = (float(relerr(x, x_true)), float(info["regParam"]),
                         info)
    for name, (err, lam, _) in results.items():
        print(f"{name:25s} relative error = {err:.4f}  (lam = {lam:.3e})")
    return results


if __name__ == "__main__":
    main()
