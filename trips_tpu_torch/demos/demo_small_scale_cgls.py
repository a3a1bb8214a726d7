"""Small-scale CGLS demo, the twin of ``demos/demo_small_scale_cgls.py``
(which mirrors the reference's ``demos/demo_small_scale_CGLS.ipynb``): a
50x50 deblurring problem whose regularized system is solved by stacking A
and sqrt(lam)*L into one least-squares problem and running plain CGLS on
it,

    min_x || [A; sqrt(lam) L] x - [b; 0] ||_2,

with x0 = A^T b, lam = 0.01, 50 iterations, tol 1e-3 (notebook cells
3-8). ``VStackOperator`` concatenates the forward blur and the scaled 2D
first-derivative operator, both matrix-free on ``--device``.

Run: python3 -m trips_tpu_torch.demos.demo_small_scale_cgls [--n 50]
[--iters 50] [--device cuda]
"""
import argparse

import numpy as np
import torch

from ..core.linop import ScaledOperator, VStackOperator
from ..operators import FirstDerivative2D
from ..problems import Deblurring2D
from ..solvers import CGLS
from ..solvers._common import as_op, host


def relerr(x, xt):
    x, xt = host(x).reshape(-1), np.asarray(xt).reshape(-1)
    return np.linalg.norm(x - xt) / np.linalg.norm(xt)


def problem(n, regparam, device, dtype=torch.float32):
    """The demo's stacked system: (Ahat, bhat, x0, x_true) on ``device``
    in ``dtype``."""
    np.random.seed(0)
    prob = Deblurring2D(device=device, dtype=dtype)
    A = as_op(prob.forward_Op([3, 3], (1, 1), n, n))
    # the notebook uses 'satellite'; its .mat is data the repository does
    # not hold: the synthetic 'h_im' keeps the demo self-contained
    x_true = prob.gen_true("h_im", nx=n, ny=n)
    b_true = prob.gen_data(np.asarray(x_true).reshape(-1, 1))
    b, delta = prob.add_noise(b_true, "Gaussian", 0.01)
    bv = torch.as_tensor(np.asarray(b).reshape(-1), dtype=dtype,
                         device=A.device)
    L = FirstDerivative2D(n, n, device=A.device)
    Ahat = VStackOperator([A, ScaledOperator(np.sqrt(regparam), as_op(L))])
    bhat = torch.cat([bv, bv.new_zeros(L.shape[0])])
    return Ahat, bhat, A.rmatvec(bv), np.asarray(x_true).reshape(-1)


def main(argv=None):
    """Run the demo and print its lines; returns (x, info)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=50)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--regparam", type=float, default=0.01)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    n = args.n
    Ahat, bhat, x0, x_true = problem(n, args.regparam, args.device)
    x, info = CGLS(Ahat, bhat, x0, max_iter=args.iters, tol=1e-3,
                   x_true=x_true)
    print(f"CGLS on stacked [A; sqrt({args.regparam}) L] "
          f"({n}x{n} h_im, 1% noise):")
    print(f"  iterations: {info['its']}")
    if info.get("relError"):
        print(f"  final relative error: {info['relError'][-1]:.4f}")
    print(f"  relative error vs x_true: {relerr(x, x_true):.4f}")
    return x, info


if __name__ == "__main__":
    main()
