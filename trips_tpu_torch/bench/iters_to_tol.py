"""Iterations-to-tolerance comparison against the reference algorithm.

Counterpart of ``trips_tpu/bench/iters_to_tol.py``: the port's CGLS
(``krylov.cgls``, on the matrix's ``EllOperator``) must take the same
number of iterations to a tolerance as the reference's NumPy CGLS
(``trips/solvers/CGLS.py``): the same recurrence and stopping rule, on the
same configurations. Run as ``python3 -m trips_tpu_torch.bench.iters_to_tol
[--device cpu]`` to print the table.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..core.device import DEFAULT


def cgls_reference(A, b, x0, max_iter, tol):
    """NumPy mirror of the reference CGLS loop (CGLS.py:16-86)."""
    b = np.asarray(b).reshape(-1)
    x = np.asarray(x0).reshape(-1).copy()
    r = b - A @ x
    t = A.T @ r
    p = t.copy()
    norms_t0 = np.linalg.norm(t)
    gamma = norms_t0**2
    k = 0
    while k < max_iter:
        k += 1
        w = A @ p
        delta = np.linalg.norm(w) ** 2 or np.finfo(float).eps
        beta = gamma / delta
        x = x + beta * p
        r = r - beta * w
        t = A.T @ r
        gamma_new = np.linalg.norm(t) ** 2
        p = t + (gamma_new / gamma) * p
        gamma = gamma_new
        if np.sqrt(gamma_new) <= norms_t0 * tol or np.linalg.norm(x) * tol >= 1:
            break
    return x, k


def compare(configs=None, device=DEFAULT, dtype=None):
    """Rows ``(name, reference iterations, port iterations)`` for the
    configurations ``(name, nx, views, phantom, tol)`` (JAX's two by
    default). The port runs on ``device`` (the card unless "cpu" is asked
    for) in ``dtype`` (None: the matrix's, float64)."""
    import torch

    from ..krylov import cgls
    from ..problems.phantoms import shepp_logan, tectonic
    from ..problems.projector import fan_beam_matrix
    from ..sparse import EllOperator

    if configs is None:
        configs = [
            ("tomo32x30", 32, 30, tectonic, 1e-4),
            ("tomo64x40", 64, 40, shepp_logan, 1e-4),
        ]
    rows = []
    for name, nx, views, phantom, tol in configs:
        A = fan_beam_matrix(nx, views=views)
        x_true = phantom(nx).reshape(-1)
        b = A @ x_true
        _, k_ref = cgls_reference(A, b, np.zeros(A.shape[1]), 500, tol)
        op = EllOperator.from_scipy(A, dtype=dtype, device=device)
        _, k_dev = cgls(op, torch.as_tensor(b, dtype=op.dtype,
                                            device=op.device),
                        torch.zeros(A.shape[1], dtype=op.dtype,
                                    device=op.device), 500, tol)
        rows.append((name, k_ref, int(k_dev)))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=DEFAULT)
    args = ap.parse_args(argv)
    for name, k_ref, k_dev in compare(device=args.device):
        print(f"{name}: reference CGLS iters={k_ref}, trips-tpu iters={k_dev}")


if __name__ == "__main__":
    main()
