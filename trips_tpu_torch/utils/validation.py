"""Input validation helpers.

Counterpart of ``trips_tpu/utils/validation.py`` (API parity with
``trips/utilities/utils.py:28-110``: soft_thresh, is_identity,
check_noise_type, check_noise_level, check_Regparam, check_operator_type),
host NumPy; a port operator or a tensor on any device densifies to a host
array.
"""
from __future__ import annotations

import numpy as np

from ..regparam.utils import _host
from ..regparam.utils import is_identity_matrix as is_identity  # noqa: F401


def soft_thresh(x, mu):
    """Soft thresholding (utils.py:28-33)."""
    x = np.asarray(_host(x))
    y = np.abs(x) - mu
    y[y < 0] = 0
    return y * np.sign(x)


def check_noise_type(noise_type):
    if noise_type not in (
        "g", "p", "l", "gaussian", "Gaussian", "Poisson", "poisson",
        "Laplace", "laplace",
    ):
        raise TypeError(
            "You must enter a valid name for the noise. For Gaussian noise "
            "input g or Gaussian or gaussian. For Poisson noise input p or "
            "Poisson or poisson. For Laplace noise input l or laplace."
        )


def check_noise_level(noise_level):
    if not isinstance(noise_level, (int, float)) or noise_level < 0:
        raise TypeError(
            "You must enter a valid noise level! Choose 0 for 0 %, 1 for 1%, "
            "or other valid values accordingly."
        )


def check_Regparam(Regparam=1):
    if isinstance(Regparam, (int, float)):
        if Regparam <= 0:
            raise TypeError(
                "You must specify a valid regularization parameter. Input a "
                "positive number!"
            )
        return
    if Regparam not in (
        "gcv", "GCV", "Gcv", "DP", "dp", "Dp", "Discrepancy Principle",
        "Discrepancy principle", "discrepancy principle", "l_curve",
    ):
        raise TypeError(
            "You must specify a valid regularization parameter. For "
            "Generalized Cross Validation type 'gcv'. For Discrepancy "
            "Principle type 'dp'."
        )


def check_operator_type(A):
    """Densify non-array operators (utils.py:103-110) to a host array."""
    if hasattr(A, "todense"):
        return np.asarray(_host(A.todense()))
    if hasattr(A, "toarray"):
        return A.toarray()
    return np.asarray(_host(A))


def operator_qr(A):
    """QR of a (densified) operator (reference operators.py:119-127)."""
    import scipy.linalg as sla

    return sla.qr(check_operator_type(A), mode="economic")


def operator_svd(A):
    """SVD of a (densified) operator (reference operators.py:130-140)."""
    import scipy.linalg as sla

    return sla.svd(check_operator_type(A), full_matrices=False)
