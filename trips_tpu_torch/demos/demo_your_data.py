"""Deblurring of a user's image, the twin of ``demos/demo_your_data.py``
(which mirrors the reference's demo_2D_Deblurring_your_data): the image
converted to the framework's ``.mat`` format, blurred by a (5, 5)
Gaussian PSF of spread (1.5, 1.5), 1% Gaussian noise, GKS with GCV and the
derivative regularizer, in float32. Without ``--image`` it runs offline
on the synthetic 'H' image. No banded kernel lies on this path:
``Blur2D`` is a ``conv2d`` (cuDNN on the card); GCV's Brent search runs
on the host, as in ``solvers.GKS``.

Run: python3 -m trips_tpu_torch.demos.demo_your_data [--image path.jpg]
[--n 64] [--iters 25] [--device cuda]
"""
import argparse

import numpy as np
import torch

from ..operators import FirstDerivative2D
from ..problems import Deblurring2D
from ..solvers import GKS
from ..solvers._common import host


def relerr(x, xt):
    x, xt = host(x).reshape(-1), np.asarray(xt).reshape(-1)
    return np.linalg.norm(x - xt) / np.linalg.norm(xt)


def problem(n, image, device, dtype):
    """The demo's inputs after ``np.random.seed(0)``: (A, b, delta,
    x_true), ``A`` the ``Blur2D`` operator of ``dtype`` on ``device``,
    ``b`` the noisy data (NumPy float64); ``image`` a path (converted
    into ``./data/image_data/mydata.mat``) or None for the 'H' image."""
    np.random.seed(0)
    prob = Deblurring2D(device=device, dtype=dtype)
    A = prob.forward_Op([5, 5], (1.5, 1.5), n, n)
    if image:
        from ..utils.helpers import convert_image_for_trips

        x_true, path = convert_image_for_trips(image, dataset="mydata",
                                               size=(n, n))
        prob.nx = prob.ny = n
        print(f"converted {image} -> {path}")
    else:
        x_true = prob.gen_true("h_im", nx=n, ny=n)
        print("no --image given; using the synthetic 'H' image")
    b_true = prob.gen_data(np.asarray(x_true).reshape(-1, 1))
    b, delta = prob.add_noise(b_true, "Gaussian", 0.01)
    return A, np.asarray(b).reshape(-1), float(delta), x_true


def solves(A, b, n, n_iter):
    """The demo's one solve: {name: solve}, the solve a function of no
    arguments returning (x, info), in ``A``'s dtype on its device."""
    bv = torch.tensor(b, dtype=A.dtype, device=A.device)
    L = FirstDerivative2D(n, n, device=A.device)
    return {"GKS (gcv)": lambda: GKS(A, bv, L, projection_dim=3,
                                     n_iter=n_iter, regparam="gcv")}


def main(argv=None):
    """Run the demo and print its line; returns {name: relError}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--image", default=None)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--iters", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    A, b, _, x_true = problem(args.n, args.image, args.device,
                              torch.float32)
    results = {}
    for name, solve in solves(A, b, args.n, args.iters).items():
        x, _ = solve()
        results[name] = relerr(x, x_true)
        print(f"{name} relative error = {results[name]:.4f}")
    return results


if __name__ == "__main__":
    main()
