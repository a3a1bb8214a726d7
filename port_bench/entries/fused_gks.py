"""``solvers.fused.fused_gks`` with ``FirstDerivative2D`` and GCV, as the
fused demo calls it: every iteration on the device, lambda by Brent's
search replayed as a CUDA graph. Compared with the float64 reference
GKS's last iterate and lambda, each number the largest over the sample:
``x_gap`` and ``fit_gap`` as in ``cgls_normal``, and ``lam_gap``,
``|lam - lam_ref| / lam_ref``, read but held to no limit: GCV is flat
where it settles, so float32 moves lambda by factors where x moves by
1e-5 or less.
"""
from __future__ import annotations

import torch

from ..reference import regularized as ref
from ..reference.sparse import SparseOp
from .cgls_normal import gaps


def program(op, dims, params):
    from trips_tpu_torch.operators import FirstDerivative2D
    from trips_tpu_torch.solvers.fused import fused_gks

    L = FirstDerivative2D(dims[0], dims[1], device=op.device)

    def solve(b):
        x, lams, _ = fused_gks(op, b, L,
                               projection_dim=params["projection_dim"],
                               n_iter=params["n_iter"], regparam_mode="gcv",
                               device=op.device)
        return {"x": x, "lam": lams[-1]}

    return solve


def check(A, bs, outs, dims, params):
    dev = bs.device
    A = SparseOp(A, dev)
    L = SparseOp(ref.derivative_2d(dims[0], dims[1]), dev)
    xr, lams = [], []
    for j in range(bs.shape[1]):
        x, lam = ref.gks(A, L, bs[:, j], params["projection_dim"],
                         params["n_iter"])
        xr.append(x)
        lams.append(lam)
    return gaps(A, outs, torch.stack(xr, 1), lams)
