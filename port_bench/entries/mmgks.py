"""``solvers.MMGKS`` with isotropic space-time TV and GCV, as the dynamic
demo calls it: host-driven, the panels and their Householder QRs on the
device, lambda on the host each iteration. Compared with the float64
reference MMGKS's last iterate and lambda, each number the largest over
the sample: ``x_gap`` and ``fit_gap`` as in ``cgls_normal``, and
``lam_gap``, ``|lam - lam_ref| / lam_ref``, read but held to no limit:
GCV is flat where it settles, so float32 moves lambda by factors where x
moves by 1e-5 or less.
"""
from __future__ import annotations

import torch

from ..reference import regularized as ref
from ..reference.sparse import SparseOp
from .cgls_normal import gaps


def program(op, dims, params):
    from trips_tpu_torch.operators import CenteredSpaceTimeDerivative
    from trips_tpu_torch.solvers import MMGKS

    L = CenteredSpaceTimeDerivative(*dims, device=op.device)

    def solve(b):
        x, info = MMGKS(op, b, L, pnorm=params["pnorm"],
                        qnorm=params["qnorm"],
                        projection_dim=params["projection_dim"],
                        n_iter=params["n_iter"], regparam="gcv",
                        isoTV="isoTV", prob_dims=dims,
                        epsilon=params["epsilon"])
        return {"x": x.reshape(-1),
                "lam": torch.tensor(info["regParam"], dtype=torch.float64)}

    return solve


def check(A, bs, outs, dims, params):
    dev = bs.device
    A, L = SparseOp(A, dev), SparseOp(ref.centered_space_time(*dims), dev)
    spatial = SparseOp(ref.centered_2d(dims[0], dims[1]), dev)
    xr, lams = [], []
    for j in range(bs.shape[1]):
        x, lam = ref.mmgks_isotv(A, L, spatial, bs[:, j], dims,
                                 params["projection_dim"], params["n_iter"],
                                 params["pnorm"], params["qnorm"],
                                 params["epsilon"])
        xr.append(x)
        lams.append(lam)
    return gaps(A, outs, torch.stack(xr, 1), lams)
