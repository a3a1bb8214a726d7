"""trips_tpu_torch.solvers.direct and utils.gsvd against trips_tpu on the CPU.

- ``csd`` and ``gsvd`` are the JAX package's host NumPy code: bitwise equal.
- ``gsvd_device`` (torch QR/SVD, the twin of ``gsvd_jit``): A = U C X^T and
  B = V S X^T to 1e-10, C^T C + S^T S = I, V orthonormal, and every
  sign-free quantity (the cosines, the reconstructions, |X| column norms)
  within 1e-8 of ``gsvd_jit``'s; the factors themselves may differ in sign.
- ``Tikhonov``, ``tSVD_sol``, ``tGSVD_sol`` on ``tests/test_solvers.py``'s
  ``deblur1d`` problem (n = 100) in float64: the decompositions and the
  rules run on the host in both packages (float64 LAPACK), the
  reconstruction on the device: x within 1e-8 relative, lam within 1e-8
  relative, k equal, for GCV, DP and a given lam or k, with identity and
  general L; the dense-size guard and DP without delta raise as in JAX.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trips_tpu.solvers as js
import trips_tpu_torch.solvers as ts
from trips_tpu.operators import Blur1D
from trips_tpu_torch.operators import FirstDerivative1D, first_derivative_matrix

from torch_threads import one_torch_thread  # noqa: F401

# the modules (the packages re-export their function under the same name)
jgsvd_mod = importlib.import_module("trips_tpu.utils.gsvd")
tgsvd_mod = importlib.import_module("trips_tpu_torch.utils.gsvd")

CPU = {"device": "cpu"}
X_RTOL, LAM_RTOL = 1e-8, 1e-8


def _rel(a, b):
    a = np.asarray(a, dtype=float).reshape(-1)
    b = np.asarray(b, dtype=float).reshape(-1)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def deblur1d():
    """tests/test_solvers.py's problem: Blur1D(100, 5.0), curve0, 2%
    noise from default_rng(42)."""
    n = 100
    rng = np.random.default_rng(42)
    A = np.asarray(Blur1D(n, 5.0).mat)
    h = np.pi / n
    g = -np.pi / 2 + np.arange(0.5, n, 1) * h
    x_true = 2 * np.exp(-6 * (g - 0.8) ** 2) + np.exp(-2 * (g + 0.5) ** 2)
    b_true = A @ x_true
    e = rng.standard_normal(n)
    sig = 0.02 * np.linalg.norm(b_true) / np.linalg.norm(e)
    return dict(A=A, x_true=x_true, b=b_true + sig * e,
                delta=float(np.linalg.norm(sig * e)), n=n)


@pytest.mark.parametrize("m, n, p", [(20, 12, 10), (16, 16, 16), (30, 12, 8),
                                     (12, 10, 10)])
def test_gsvd_host_bitwise(rng, m, n, p):
    A = rng.standard_normal((m, p))
    B = rng.standard_normal((n, p))
    if p == 10 and n == 10:  # a rank-deficient B: V completed from rng(0)
        B[-3:] = 0.0
    for got, ref in zip(tgsvd_mod.gsvd(A, B), jgsvd_mod.gsvd(A, B)):
        assert np.array_equal(got, ref)
    Q, _ = np.linalg.qr(np.vstack([A, B]))
    for got, ref in zip(tgsvd_mod.csd(Q[:m], Q[m:]),
                        jgsvd_mod.csd(Q[:m], Q[m:])):
        assert np.array_equal(got, ref)
    for bad in ((A[:, :p - 1], B), (A[:p - 1], B[:p - 1, :p - 2])):
        with pytest.raises(ValueError, match="Invalid input dimensions"):
            tgsvd_mod.gsvd(*bad)
        with pytest.raises(ValueError, match="Invalid input dimensions"):
            tgsvd_mod.gsvd_device(*(torch.from_numpy(M) for M in bad))


@pytest.mark.parametrize("m, n, p", [(20, 15, 12), (16, 16, 16), (30, 12, 8),
                                     (14, 10, 10)])
def test_gsvd_device_matches_jit(rng, m, n, p):
    """Full-rank pencils: a zero sine computes as ~sqrt(eps), above ``tol``,
    in both device twins alike (the host twin's case)."""
    A = rng.standard_normal((m, p))
    B = rng.standard_normal((n, p))
    U, V, X, C, S = (t.numpy() for t in tgsvd_mod.gsvd_device(
        torch.from_numpy(A), torch.from_numpy(B)))
    np.testing.assert_allclose(U @ C @ X.T, A, atol=1e-10)
    np.testing.assert_allclose(V @ S @ X.T, B, atol=1e-10)
    np.testing.assert_allclose(C.T @ C + S.T @ S, np.eye(p), atol=1e-10)
    assert V.shape == (n, p) and S.shape == C.shape == (p, p)
    np.testing.assert_allclose(V.T @ V, np.eye(p), atol=1e-10)
    c = np.diag(C)
    assert np.all(np.diff(c) >= -1e-12)  # ascending cosines
    Uj, Vj, Xj, Cj, Sj = (np.asarray(t) for t in jax.jit(jgsvd_mod.gsvd_jit)(
        jnp.asarray(A), jnp.asarray(B)))
    np.testing.assert_allclose(c, np.diag(Cj), atol=1e-8)
    np.testing.assert_allclose(np.diag(S[:p]), np.diag(Sj[:p]), atol=1e-8)
    np.testing.assert_allclose(np.linalg.norm(X, axis=0),
                               np.linalg.norm(Xj, axis=0), rtol=1e-8)
    np.testing.assert_allclose(np.abs(U), np.abs(Uj), atol=1e-6)
    # the host construction's generalized spectrum
    np.testing.assert_allclose(c, np.diag(tgsvd_mod.gsvd(A, B)[3])[:p],
                               atol=1e-8)


@pytest.mark.parametrize("m, n, p, dead", [(14, 10, 10, 3), (20, 15, 12, 1)])
def test_gsvd_device_rank_deficient(rng, m, n, p, dead):
    """A rank-deficient B: its zero sines are ~1e-16 (the sine block's
    column norms), so B = V S X^T holds to 1e-12 and V stays orthonormal,
    where ``gsvd_jit``'s sqrt(1 - c^2) sines leave 5e-8; the cosines and
    A = U C X^T within 1e-8 of ``gsvd_jit``'s."""
    A = rng.standard_normal((m, p))
    B = rng.standard_normal((n, p)) @ np.diag(
        np.r_[np.ones(p - dead), np.zeros(dead)])
    U, V, X, C, S = (t.numpy() for t in tgsvd_mod.gsvd_device(
        torch.from_numpy(A), torch.from_numpy(B)))
    np.testing.assert_allclose(U @ C @ X.T, A, atol=1e-12)
    np.testing.assert_allclose(V @ S @ X.T, B, atol=1e-12)
    np.testing.assert_allclose(V.T @ V, np.eye(V.shape[1]), atol=1e-12)
    np.testing.assert_allclose(C.T @ C + S.T @ S, np.eye(p), atol=1e-12)
    s = np.diag(S[:p])  # descending: the zero sines last
    assert np.all(s[p - dead:] <= 1e-14) and np.all(s[:p - dead] > 1e-3)
    Uj, Vj, Xj, Cj, Sj = (np.asarray(t) for t in jax.jit(jgsvd_mod.gsvd_jit)(
        jnp.asarray(A), jnp.asarray(B)))
    np.testing.assert_allclose(np.diag(C), np.diag(Cj), atol=1e-8)
    np.testing.assert_allclose(U @ C @ X.T, Uj @ Cj @ Xj.T, atol=1e-12)
    assert np.abs(Vj @ Sj @ Xj.T - B).max() > 1e-9  # the twin's fault


def _same_x(tx, jx):
    assert isinstance(tx, torch.Tensor) and tx.dtype == torch.float64
    assert tuple(tx.shape) == tuple(np.asarray(jx).shape)
    assert _rel(tx.numpy(), jx) <= X_RTOL


@pytest.mark.parametrize("regparam", ["gcv", "dp", 0.03])
@pytest.mark.parametrize("general_L", [False, True])
def test_tikhonov_matches_jax(deblur1d, regparam, general_L):
    d = deblur1d
    L = (first_derivative_matrix(d["n"]).toarray() if general_L
         else np.eye(d["n"]))
    kw = dict(regparam=regparam, delta=d["delta"])
    tx, tlam = ts.Tikhonov(d["A"], d["b"], L, **kw, **CPU)
    jx, jlam = js.Tikhonov(d["A"], d["b"], L, **kw)
    _same_x(tx, jx)
    assert tlam == pytest.approx(float(jlam), rel=LAM_RTOL)
    assert tlam > 0


def test_tikhonov_takes_port_operators(deblur1d):
    """A port operator and L as operators densify through todense()."""
    from trips_tpu_torch.core import DenseOperator

    d = deblur1d
    A = DenseOperator(torch.tensor(d["A"]))
    tx, tlam = ts.Tikhonov(A, d["b"], FirstDerivative1D(d["n"], **CPU),
                           regparam="gcv", **CPU)
    jx, jlam = js.Tikhonov(d["A"], d["b"],
                           first_derivative_matrix(d["n"]).toarray())
    _same_x(tx, jx)
    assert tlam == pytest.approx(float(jlam), rel=LAM_RTOL)
    x32, _ = ts.Tikhonov(d["A"].astype(np.float32), d["b"], np.eye(d["n"]),
                         regparam=0.03, **CPU)
    assert x32.dtype == torch.float32  # A's dtype


@pytest.mark.parametrize("regparam", ["gcv", "dp", 17])
def test_tsvd_matches_jax(deblur1d, regparam):
    d = deblur1d
    tx, tk = ts.tSVD_sol(d["A"], d["b"], regparam=regparam, delta=d["delta"],
                         **CPU)
    jx, jk = js.tSVD_sol(d["A"], d["b"], regparam=regparam, delta=d["delta"])
    assert tk == jk and 0 < tk < d["n"]
    _same_x(tx, jx)


@pytest.mark.parametrize("regparam", ["gcv", "dp", 60])
def test_tgsvd_matches_jax(deblur1d, regparam):
    d = deblur1d
    n = d["n"]
    L = np.vstack([first_derivative_matrix(n).toarray(), np.zeros((1, n))])
    tx, tk = ts.tGSVD_sol(d["A"], L, d["b"], regparam=regparam,
                          delta=d["delta"], **CPU)
    jx, jk = js.tGSVD_sol(d["A"], L, d["b"], regparam=regparam,
                          delta=d["delta"])
    assert tk == jk
    _same_x(tx, jx)


def test_direct_guards(deblur1d):
    from trips_tpu_torch.solvers.direct import DENSE_MAX_ELEMENTS

    d = deblur1d

    class FakeBig:
        shape = (30_000, 30_000)

    eye = np.eye(d["n"])
    for call in (lambda: ts.Tikhonov(FakeBig(), d["b"], eye, **CPU),
                 lambda: ts.tSVD_sol(FakeBig(), d["b"], **CPU),
                 lambda: ts.tGSVD_sol(FakeBig(), eye, d["b"], **CPU),
                 lambda: ts.Tikhonov(d["A"], d["b"], eye, dense_max=10,
                                     **CPU)):
        with pytest.raises(ValueError, match="direct-solver limit"):
            call()
    x, lam = ts.Tikhonov(d["A"], d["b"], eye, dense_max=DENSE_MAX_ELEMENTS,
                         **CPU)
    assert lam > 0
    for call in (lambda: ts.tSVD_sol(d["A"], d["b"], regparam="dp", **CPU),
                 lambda: ts.tGSVD_sol(d["A"], eye, d["b"], regparam="dp",
                                      **CPU),
                 lambda: ts.Tikhonov(d["A"], d["b"], eye, regparam="dp",
                                     **CPU)):
        with pytest.raises(Exception, match="noise level delta"):
            call()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ts.tSVD_sol(d["A"], d["b"])
