"""CsrOperator against scipy and trips_tpu's EllOperator on the CPU, and
the two places where the JAX package wraps a scipy matrix and the port now
does too: ``aslinearoperator`` and ``device_sparse_operator``'s fallback.

In float64 the CSR products agree with scipy's to 1e-12 of the norm and
with the JAX ELL operator's to the same (the sums run in another order);
in float32 to 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import sparse as sp

import trips_tpu.problems as jp
from trips_tpu.core.linop import aslinearoperator as jax_aslinearoperator
from trips_tpu.sparse import EllOperator
from trips_tpu_torch.core import DenseOperator, aslinearoperator
from trips_tpu_torch.problems import device_sparse_operator
from trips_tpu_torch.sparse import BucketedBandedProjector, CsrOperator

from torch_threads import one_torch_thread  # noqa: F401


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    a, b = a.astype(np.float64).reshape(-1), np.asarray(b).reshape(-1)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture
def matrix(rng):
    M = sp.random(70, 50, density=0.15, format="csr", random_state=3)
    M.data = rng.standard_normal(M.nnz)
    return M


@pytest.mark.parametrize("dtype,tol", [(None, 1e-12), (torch.float32, 1e-6)])
def test_products_match_scipy_and_ell(matrix, rng, dtype, tol):
    op = CsrOperator.from_scipy(matrix, dtype=dtype, device="cpu")
    ell = EllOperator.from_scipy(matrix)
    assert op.dtype == (dtype or torch.float64)
    assert op.shape == matrix.shape and op.nnz == matrix.nnz
    x = rng.standard_normal(50)
    y = rng.standard_normal(70)
    X = rng.standard_normal((50, 3))
    Y = rng.standard_normal((70, 3))
    for fn, v, ref in (("matvec", x, matrix @ x),
                       ("rmatvec", y, matrix.T @ y),
                       ("matmat", X, matrix @ X),
                       ("rmatmat", Y, matrix.T @ Y)):
        v = torch.from_numpy(v).to(op.dtype)
        got = getattr(op, fn)(v)
        assert got.dtype == op.dtype and tuple(got.shape) == ref.shape
        assert _rel(got, ref) <= tol, fn
        assert _rel(got, np.asarray(getattr(ell, fn)(jnp.asarray(
            v.double().numpy())))) <= tol, fn


def test_round_trip_and_from_dense(matrix):
    op = CsrOperator.from_scipy(matrix, device="cpu")
    assert (op.to_scipy() != matrix).nnz == 0
    dense = CsrOperator.from_dense(matrix.toarray(), dtype=np.float32,
                                   device="cpu")
    assert dense.dtype == torch.float32
    assert (dense.to_scipy() != matrix.astype(np.float32)).nnz == 0


def test_promotes_like_jax(matrix, rng):
    """A float32 vector on a float64 matrix gives float64, as JAX's
    promotion does."""
    op = CsrOperator.from_scipy(matrix, device="cpu")
    x = rng.standard_normal(50).astype(np.float32)
    got = op.matvec(torch.from_numpy(x))
    assert got.dtype == torch.float64
    assert _rel(got, matrix @ x.astype(np.float64)) <= 1e-12


def test_aslinearoperator_wraps_scipy(matrix, rng):
    """Failed before: the port raised where JAX makes an ELL operator."""
    op = aslinearoperator(matrix, device="cpu")
    jop = jax_aslinearoperator(matrix)
    assert isinstance(op, CsrOperator) and isinstance(jop, EllOperator)
    x = rng.standard_normal(50)
    assert _rel(op.matvec(torch.from_numpy(x)),
                np.asarray(jop.matvec(jnp.asarray(x)))) <= 1e-12
    assert isinstance(aslinearoperator(matrix.toarray()), DenseOperator)
    assert aslinearoperator(op) is op


@pytest.fixture
def tomo_matrix(monkeypatch):
    monkeypatch.setenv("TRIPS_TPU_NO_NATIVE", "1")
    return jp.fan_beam_matrix(32, views=12)


@pytest.mark.parametrize("case", ["no geometry", "not square", "refused"])
def test_device_sparse_operator_falls_back_to_csr(tomo_matrix, case, rng):
    """Failed before: the port raised where JAX falls back to ELL/BSR
    (``trips_tpu/problems/tomography.py:43-67``): no ``nx``/``angles``, a
    matrix that is not (m, nx*nx), or a geometry the pack refuses (here 7
    angles for a matrix of 12 views' rows, which do not split evenly)."""
    A = tomo_matrix
    theta = np.linspace(0, np.pi, 12, endpoint=False)
    kw = {"no geometry": dict(nx=None, angles=theta),
          "not square": dict(nx=16, angles=theta),
          "refused": dict(nx=32, angles=theta[:7])}[case]
    op = device_sparse_operator(A, device="cpu", **kw)
    assert isinstance(op, CsrOperator) and op.dtype == torch.float32
    x = rng.standard_normal(A.shape[1])
    assert _rel(op.matvec(torch.from_numpy(x)), A @ x) <= 1e-6
    # the geometry the pack takes still gets the banded operator
    assert isinstance(device_sparse_operator(A, nx=32, angles=theta,
                                             device="cpu"),
                      BucketedBandedProjector)
