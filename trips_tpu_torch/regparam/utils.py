"""Small host-side helpers shared by the parameter-selection rules (a copy
of ``trips_tpu/regparam/utils.py`` on the port's operators; tensors on any
device come to the host as NumPy)."""
from __future__ import annotations

import numpy as np
import torch


def _host(M):
    if isinstance(M, torch.Tensor):
        return M.detach().cpu().numpy()
    return M


def dense_or_identity(M):
    """Accept NumPy arrays, tensors, our IdentityOperator, or scipy sparse."""
    from ..core.linop import IdentityOperator, LinearOperator

    if isinstance(M, IdentityOperator):
        return np.eye(M.shape[0])
    if isinstance(M, LinearOperator):
        return np.asarray(_host(M.todense()), dtype=float)
    if hasattr(M, "toarray"):
        return np.asarray(M.toarray(), dtype=float)
    M = np.asarray(_host(M), dtype=float)
    if M.ndim == 1:  # vector of singular values
        return np.diag(M)
    return M


def is_identity_matrix(M, n=None):
    """True when M acts as the identity (reference: trips/utilities/utils.py:47-62)."""
    from ..core.linop import IdentityOperator, LinearOperator

    if isinstance(M, IdentityOperator):
        return True
    if isinstance(M, LinearOperator):
        return False
    if hasattr(M, "toarray"):
        M = M.toarray()
    M = np.asarray(_host(M))
    if M.ndim != 2 or M.shape[0] != M.shape[1]:
        return False
    return bool(np.allclose(M, np.eye(M.shape[0])))


def poisson_delta(b_meas):
    """Estimated noise norm for Poisson-distributed measurements.

    The reference's Poisson ``add_noise`` returns ``delta=0``
    (``trips/test_problems/Tomography.py:214-217``), leaving the
    discrepancy principle unusable for counting noise. This estimator
    closes that gap (beyond reference): for ``b ~ Poisson(lam = b_true+1)``
    the noise ``e = b - (b_true+1)`` has ``E||e||^2 = sum(lam)``, and
    ``E b = lam``, so ``sqrt(sum(b_meas))`` is an unbiased plug-in for
    ``||e||`` in expectation. Use as the ``delta`` argument of any
    DP-driven solver on Poisson data.
    """
    b = np.asarray(_host(b_meas), dtype=float)
    return float(np.sqrt(max(b.sum(), 0.0)))
