"""Tomography on saved data, the twin of ``demos/demo_saved_data.py``
(which mirrors the reference's demo_Tomo_saved_data): a pre-saved matrix
and sinogram bundle (``head`` with ``CT200``, or ``60``/``90`` with
``CT60``/``CT90``) from ``./data/image_data``, GKS with lam = 1 and MMGKS
p=2 q=1 with lam = 1e-3 on the matrix as an ``EllOperator``, in float32.
The bundles are read from ``./data`` only, never downloaded; without them
the demo prints where to put them and returns.

Run: python3 -m trips_tpu_torch.demos.demo_saved_data [--dataset head]
[--iters 30] [--device cuda]
"""
import argparse

import numpy as np
import torch

from ..operators import FirstDerivative2D
from ..problems import Tomography
from ..solvers import GKS, MMGKS
from ..solvers._common import host
from ..sparse import EllOperator


def relerr(x, xt):
    x, xt = host(x).reshape(-1), np.asarray(xt).reshape(-1)
    return np.linalg.norm(x - xt) / np.linalg.norm(xt)


def problem(dataset, device, dtype):
    """(op, b, x_true, n): the bundle's matrix as an ``EllOperator`` of
    ``dtype`` on ``device``, its sinogram (NumPy), the true image and the
    image side; FileNotFoundError without the bundle."""
    tomo = Tomography(device=device)
    A, x_true, b = tomo.gen_saved_data(
        dataset if dataset == "head" else int(dataset))
    n = int(np.sqrt(A.shape[1]))
    op = EllOperator.from_scipy(
        A, dtype=torch.empty(0, dtype=dtype).numpy().dtype, device=device)
    return op, np.asarray(b).reshape(-1), x_true, n


def solves(op, b, n, n_iter):
    """The demo's solves, in its order: {name: solve}, each a function of
    no arguments returning (x, info), in ``op``'s dtype on its device."""
    bv = torch.tensor(b, dtype=op.dtype, device=op.device)
    L = FirstDerivative2D(n, n, device=op.device)
    return {
        "GKS (lam=1)": lambda: GKS(op, bv, L, projection_dim=3,
                                   n_iter=n_iter, regparam=1.0),
        "MMGKS (lam=1e-3)": lambda: MMGKS(op, bv, L, pnorm=2, qnorm=1,
                                          projection_dim=3, n_iter=n_iter,
                                          regparam=0.001)}


def main(argv=None):
    """Run the demo and print its lines; returns {name: relError}, or None
    without the bundles."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="head")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    try:
        op, b, x_true, n = problem(args.dataset, args.device, torch.float32)
    except FileNotFoundError as e:
        print(f"saved-data bundles unavailable: {e}")
        print("place SL60/SL90/head + CT60/CT90/CT200 .mat files under "
              "./data/image_data to run this demo.")
        return None
    results = {}
    for name, solve in solves(op, b, n, args.iters).items():
        x, _ = solve()
        results[name] = relerr(x, x_true)
    for name, err in results.items():
        print(f"{name:20s} relative error = {err:.4f}")
    return results


if __name__ == "__main__":
    main()
