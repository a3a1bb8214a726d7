"""Shared helpers for the solver layer (counterpart of
``trips_tpu/solvers/_common.py``).

The large-system work (applies, basis updates, QR of tall panels) runs on
the operator's device in the working dtype, which follows ``b``; the tiny
projected systems (k x k) and the scalar parameter searches run on the
host in float64 NumPy/SciPy, as in the JAX package. The projected
quantities crossing the boundary are O(k^2) scalars per iteration.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.linop import LinearOperator, aslinearoperator


def as_op(A) -> LinearOperator:
    return aslinearoperator(A)


def vec(b, device=None):
    """Flatten to a 1-D tensor on ``device`` (NumPy input keeps its dtype)."""
    return torch.as_tensor(b, device=device).reshape(-1)


def host(x):
    """Tensor (any device) or array -> NumPy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def like(y, b):
    """Host coefficients ``y`` as a tensor in ``b``'s dtype on its device."""
    return torch.as_tensor(np.asarray(y), dtype=b.dtype, device=b.device)


def stacked_lstsq(R_A, lam, R_L, bproj):
    """y = argmin ||[R_A; sqrt(lam) R_L] y - [bproj; 0]|| (host, tiny).

    The reference solves this exact stacked system per iteration (e.g.
    Hybrid_LSQR.py:104, GKS.py:74).
    """
    R_A = np.asarray(R_A, dtype=float)
    R_L = np.asarray(R_L, dtype=float)
    bproj = np.asarray(bproj, dtype=float).reshape(-1)
    top = np.concatenate([R_A, np.sqrt(lam) * R_L], axis=0)
    rhs = np.concatenate([bproj, np.zeros(R_L.shape[0])])
    y, *_ = np.linalg.lstsq(top, rhs, rcond=None)
    return y


def rel_error_history(x_history, x_true):
    x_true = host(x_true).reshape(-1)
    nrm = np.linalg.norm(x_true)
    return [float(np.linalg.norm(host(x).reshape(-1) - x_true) / nrm)
            for x in x_history]


def build_info(x_history, lambda_history, residual_history, its, x_true=None,
               residual_key="Residual"):
    info = {
        "xHistory": x_history,
        "regParam": lambda_history[-1] if lambda_history else None,
        "regParam_history": lambda_history,
        residual_key: residual_history,
        "its": its,
    }
    if x_true is not None:
        info["relError"] = rel_error_history(x_history, x_true)
    return info
