"""Tomography demo, the twin of ``demos/demo_tomography.py`` (which mirrors
the reference's demo_Tomo_small_scale / _large_scale): the fan-beam
projector, tectonic or grains phantom, TSVD (n <= 64), GKS, Hybrid LSQR
and MMGKS, each with the discrepancy principle, on ``Tomography``'s
operator (the bucketed banded pack, float32: kernels K2 and K3 on the
card).

Run: python3 -m trips_tpu_torch.demos.demo_tomography [--n 32 --views 30]
[--large] [--iters 30] [--device cuda]
"""
import argparse

import numpy as np
import torch

from ..operators import FirstDerivative2D
from ..problems import Tomography
from ..solvers import GKS, MMGKS, Hybrid_LSQR, tSVD_sol
from ..solvers._common import host


def relerr(x, xt):
    x, xt = host(x).reshape(-1), np.asarray(xt).reshape(-1)
    return np.linalg.norm(x - xt) / np.linalg.norm(xt)


def problem(n, views, phantom, noise, device):
    """The demo's inputs after ``np.random.seed(0)``: (OP, b, delta,
    x_true, A) with ``OP`` on ``device`` (float32), ``b`` the noisy data
    (NumPy float64) and ``A`` the host matrix."""
    np.random.seed(0)
    tomo = Tomography(CommitCrime=False, device=device)
    x_true, nx, ny = tomo.gen_true(phantom, nx=n, ny=n, phantom_seed=0)
    OP, b, p, q, A = tomo.gen_data(x_true, nx, ny, views)
    b_noisy, delta = tomo.add_noise(b, "Gaussian", noise)
    return OP, b_noisy.reshape(-1), float(delta), x_true, A


def solves(OP, bv, A, b, delta, n, n_iter, dtype, x_true=None):
    """The demo's solves, in its order: {name: solve}, each solve a
    function of no arguments returning (x, its second result); a name with
    ``{}`` takes that result (TSVD's k). ``bv`` is the data as a tensor of
    ``OP``'s dtype, ``b`` the same on the host for the SVD; GKS records
    its relError history against ``x_true``."""
    dev = bv.device
    L = FirstDerivative2D(n, n, device=dev)
    runs = {}
    if n <= 64:
        # the SVD on the host in float64, x in ``dtype`` (the JAX demo's
        # on its float32 device)
        runs["TSVD (dp, k={})"] = lambda: tSVD_sol(
            A.toarray(), b, regparam="dp", delta=delta, device=dev,
            dtype=dtype)
    runs["GKS (dp)"] = lambda: GKS(OP, bv, L, projection_dim=3,
                                   n_iter=n_iter, regparam="dp", delta=delta,
                                   x_true=x_true)
    runs["Hybrid LSQR (dp)"] = lambda: Hybrid_LSQR(
        OP, bv, n_iter=n_iter, regparam="dp", delta=delta, reorth=True)
    runs["MMGKS p2 q1 (dp)"] = lambda: MMGKS(
        OP, bv, L, pnorm=2, qnorm=1, projection_dim=3, n_iter=n_iter,
        regparam="dp", delta=delta)
    return runs


def main(argv=None):
    """Run the demo and print its lines; returns {name: relError}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--views", type=int, default=30)
    ap.add_argument("--large", action="store_true",
                    help="256x256, 60 views, grains, 0.1% noise (demo config)")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.large:
        n, views, phantom_name, noise = 256, 60, "grains", 0.001
    else:
        n, views, phantom_name, noise = args.n, args.views, "tectonic", 0.01
    OP, b, delta, x_true, A = problem(n, views, phantom_name, noise,
                                      args.device)
    bv = torch.tensor(b, dtype=torch.float32, device=OP.device)
    results = {}
    for name, solve in solves(OP, bv, A, b, delta, n, args.iters,
                              torch.float32, x_true).items():
        x, info = solve()
        results[name.format(info)] = relerr(x, x_true)

    for name, err in results.items():
        print(f"{name:30s} relative error = {err:.4f}")
    return results


if __name__ == "__main__":
    main()
