"""trips_tpu_torch.regparam against trips_tpu.regparam.

The port's GCV, DP and L-curve are host NumPy/SciPy copies of the JAX
package's, so on the same random projected systems they return the same
values: held to 1e-12 relative. The port's own part is the input
handling: tensors (and its ``IdentityOperator``) where the JAX package
takes arrays.
"""
import numpy as np
import pytest
import torch

import trips_tpu.regparam as jr
import trips_tpu_torch.regparam as tr
from trips_tpu.regparam.dp import dp_tikhonov_projected as jdp
from trips_tpu.regparam.gcv import gcv_tikhonov_projected as jgcv
from trips_tpu.regparam.utils import dense_or_identity as jdense
from trips_tpu_torch.core import DenseOperator, IdentityOperator
from trips_tpu_torch.operators import FirstDerivative1D
from trips_tpu_torch.regparam.dp import dp_tikhonov_projected as tdp
from trips_tpu_torch.regparam.gcv import gcv_tikhonov_projected as tgcv
from trips_tpu_torch.regparam.utils import (dense_or_identity,
                                            is_identity_matrix)

from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-12


def _system(seed, m=30, k=8, noise=0.01):
    """tests/test_regparam.py's projected system: an ill-posed A, noisy
    data, a random k-dimensional subspace, and its projection."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, m)) @ np.diag(np.logspace(0, -4, m))
    b = A @ np.linspace(0, 1, m)
    e = noise * np.linalg.norm(b) / np.sqrt(m) * rng.standard_normal(m)
    V = np.linalg.qr(rng.standard_normal((m, k)))[0]
    Q_A, R_A = np.linalg.qr(A @ V)
    L = (np.eye(k) - np.diag(np.ones(k - 1), 1))[:-1, :]
    return dict(A=A, b=(b + e).reshape(-1, 1), Q=Q_A, R=R_A, L=L,
                delta=float(np.linalg.norm(e)))


SEEDS = [0, 1, 2]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kw", [{}, {"variant": "modified", "fullsize": 30},
                                {"gcvtype": "tsvd"}, {"gcvtype": "tgsvd"}])
def test_generalized_crossvalidation(seed, kw):
    s = _system(seed)
    got = tr.generalized_crossvalidation(s["Q"], s["R"], np.eye(8), s["b"],
                                         **kw)
    ref = jr.generalized_crossvalidation(s["Q"], s["R"], np.eye(8), s["b"],
                                         **kw)
    assert type(got) is type(ref)
    assert got == pytest.approx(ref, rel=RTOL)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("variant", ["standard", "modified",
                                     "standard-cols"])
def test_gcv_projected_general_L(seed, variant):
    s = _system(seed)
    bproj = s["Q"].T @ s["b"]
    kw = dict(out_norm2=0.3, variant=variant,
              t_term=30.0 if variant == "modified" else None)
    got = tgcv(torch.from_numpy(s["R"]), s["L"], bproj, **kw)
    assert got == pytest.approx(jgcv(s["R"], s["L"], bproj, **kw), rel=RTOL)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kw", [{}, {"explicitProj": True},
                                {"dptype": "tsvd"}, {"dptype": "tgsvd"}])
def test_discrepancy_principle(seed, kw):
    s = _system(seed)
    args = (s["Q"], s["R"], np.eye(8), s["b"])
    got = tr.discrepancy_principle(*args, delta=s["delta"], **kw)
    ref = jr.discrepancy_principle(*args, delta=s["delta"], **kw)
    assert got == pytest.approx(ref, rel=RTOL)


@pytest.mark.parametrize("seed", SEEDS)
def test_dp_projected_general_L(seed):
    """A rank-deficient (k-1, k) L: the A-weighted pseudoinverse path."""
    s = _system(seed)
    bproj = s["Q"].T @ s["b"]
    out2 = float(np.linalg.norm(s["b"] - s["Q"] @ bproj) ** 2)
    got = tdp(s["R"], torch.from_numpy(s["L"]), bproj, out2, s["delta"])
    ref = jdp(s["R"], s["L"], bproj, out2, s["delta"])
    assert got > 0 and got == pytest.approx(ref, rel=RTOL)


def test_dp_saturated_returns_zero():
    """A tall A whose range misses b by more than eta * delta: the DP holds
    at lam -> infinity already, and both packages return 0."""
    A = np.random.default_rng(0).standard_normal((20, 5))
    b = np.ones((20, 1))
    args = (np.eye(20), A, np.eye(5), b)
    assert tr.discrepancy_principle(*args, delta=1e-6) == 0
    assert jr.discrepancy_principle(*args, delta=1e-6) == 0
    with pytest.raises(Exception, match="noise level delta"):
        tr.discrepancy_principle(*args)


@pytest.mark.parametrize("seed", SEEDS)
def test_l_curve_and_curvature(seed):
    s = _system(seed)
    bproj = s["Q"].T @ s["b"]
    got = tr.l_curve(s["R"], IdentityOperator(8, device="cpu"), bproj)
    ref = jr.l_curve(s["R"], np.eye(8), bproj)
    assert got == pytest.approx(ref, rel=RTOL)
    for lam in (1e-4, 1e-2):
        assert tr.curvature(lam, s["R"], s["L"], bproj) == pytest.approx(
            jr.curvature(lam, s["R"], s["L"], bproj), rel=RTOL)


def test_poisson_delta():
    counts = np.random.default_rng(3).poisson(50.0, 200).astype(float)
    got = tr.poisson_delta(torch.from_numpy(counts))
    assert got == jr.poisson_delta(counts) == np.sqrt(counts.sum())


def test_dense_or_identity_takes_tensors_and_operators():
    M = np.random.default_rng(0).standard_normal((5, 4))
    s = np.array([3.0, 2.0, 1.0])
    for got, ref in ((dense_or_identity(torch.from_numpy(M)), M),
                     (dense_or_identity(DenseOperator(torch.from_numpy(M))),
                      M),
                     (dense_or_identity(IdentityOperator(4, device="cpu")),
                      np.eye(4)),
                     (dense_or_identity(torch.from_numpy(s)), jdense(s)),
                     (dense_or_identity(FirstDerivative1D(5, device="cpu")),
                      (np.eye(5) - np.eye(5, k=1))[:-1])):
        assert got.dtype == np.float64 and np.array_equal(got, ref)


def test_is_identity_matrix():
    assert is_identity_matrix(IdentityOperator(3, device="cpu"))
    assert is_identity_matrix(torch.eye(3, dtype=torch.float64))
    assert is_identity_matrix(np.eye(4))
    assert not is_identity_matrix(DenseOperator(torch.eye(3)))
    assert not is_identity_matrix(2 * np.eye(3))
    assert not is_identity_matrix(np.ones((2, 3)))
