"""``krylov.cgls_normal``: CG on the normal equations from x0 = 0, a fixed
number of steps (tol 0), replayed on the card as one captured CUDA graph
of a step. Compared with the float64 reference's iterate x_ref after the
same number of steps, each number the largest over the sample:

- ``x_gap``: ``||x - x_ref|| / ||x_ref||``;
- ``fit_gap``: ``||A (x - x_ref)|| / ||A x_ref||``, the gap in the data
  space, with the reference's A.

A cell holds the numbers its ``limits/<cell>.json`` names.
"""
from __future__ import annotations

import torch

from ..reference.cgls import cgls_normal as reference_cgls
from ..reference.sparse import SparseOp


def program(op, dims, params):
    from trips_tpu_torch.krylov import cgls_normal

    x0 = torch.zeros(op.shape[1], dtype=torch.float32, device=op.device)

    def solve(b):
        x, _ = cgls_normal(op, b, x0, params["max_iter"], params["tol"])
        return {"x": x}

    return solve


def check(A, bs, outs, dims, params):
    A = SparseOp(A, bs.device)
    return gaps(A, outs, reference_cgls(A, bs, params["max_iter"]))


def gaps(A, outs, xr, lams=None):
    """x_gap and fit_gap of the outputs' x against the columns of ``xr``,
    and with the reference's ``lams`` lam_gap, each the largest over the
    sample."""
    x = torch.stack([o["x"] for o in outs], dim=1)
    d = x - xr
    out = {"x_gap": float((d.norm(dim=0) / xr.norm(dim=0)).max()),
           "fit_gap": float((A.matvec(d).norm(dim=0)
                             / A.matvec(xr).norm(dim=0)).max())}
    if lams is not None:
        out["lam_gap"] = max(abs(float(o["lam"]) - lam) / lam
                             for o, lam in zip(outs, lams))
    return out
