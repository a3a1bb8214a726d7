"""``krylov.cgls``: CGLS with one product by A (K2) and one by A^T (K3)
each step, from x0 = 0, a fixed number of steps (tol 0), replayed on the
card as one captured CUDA graph of a step. Compared with the float64
reference CGLS's iterate after the same number of steps: ``x_gap`` and
``fit_gap`` as in ``cgls_normal``, each the largest over the sample."""
from __future__ import annotations

import torch

from ..reference.cgls_ls import cgls as reference_cgls
from ..reference.sparse import SparseOp
from .cgls_normal import gaps


def program(op, dims, params):
    from trips_tpu_torch.krylov import cgls

    x0 = torch.zeros(op.shape[1], dtype=torch.float32, device=op.device)

    def solve(b):
        x, _ = cgls(op, b, x0, params["max_iter"], params["tol"])
        return {"x": x}

    return solve


def check(A, bs, outs, dims, params):
    A = SparseOp(A, bs.device)
    return gaps(A, outs, reference_cgls(A, bs, params["max_iter"]))
