"""trips_tpu_torch.krylov Golub-Kahan and Arnoldi against trips_tpu.krylov.

Float64 on dense operators (60x40 for Golub-Kahan, 50x50 for Arnoldi, each
with and without reorthogonalization): the same recurrence in the same
precision, the products in another BLAS, so the factors agree to 1e-10
relative. The chunked ``*_extend`` forms run the one-shot loop's very
operations, so they give its factors to the bit.

Float32 on the bucketed banded operator (nx = 32, 12 views, the same packed
bytes in both packages): the applies sum in another order, so alpha and
beta agree to 1e-4 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trips_tpu.krylov as jk
import trips_tpu.problems as jp
import trips_tpu_torch.krylov as tk
from trips_tpu.core import DenseOperator as JaxDense
from trips_tpu.sparse.banded_buckets import \
    BucketedBandedProjector as JaxBucketed
from trips_tpu_torch.core import DenseOperator
from trips_tpu_torch.sparse import BucketedBandedProjector

from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-10


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    a, b = a.astype(np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _problem(rng, m, n):
    """Singular values from 1 to 0.1: far enough from convergence over 12
    steps that Golub-Kahan without reorthogonalization keeps its basis
    (with values down to 1e-6 it loses it and amplifies the products' last
    bits to 4e-2 between the two packages)."""
    U, _ = np.linalg.qr(rng.standard_normal((m, n)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = U @ np.diag(np.logspace(0, -1, n)) @ V.T
    return A, rng.standard_normal(m)


@pytest.fixture(scope="module")
def rect():
    return _problem(np.random.default_rng(3), 60, 40)


@pytest.fixture(scope="module")
def square():
    return _problem(np.random.default_rng(4), 50, 50)


def _ops(A):
    return JaxDense(jnp.asarray(A)), DenseOperator(torch.from_numpy(A))


@pytest.mark.parametrize("reorth", [False, True])
def test_golub_kahan_matches_jax(rect, reorth):
    A, b = rect
    jA, tA = _ops(A)
    got = tk.golub_kahan(tA, torch.from_numpy(b), 12, reorth=reorth)
    ref = jk.golub_kahan(jA, jnp.asarray(b), 12, reorth=reorth)
    for g, r, shape in zip(got, ref, [(60, 13), (13, 12), (40, 12)]):
        assert tuple(g.shape) == shape and g.dtype == torch.float64
        assert _rel(g, r) <= RTOL
    U, S, V = (t.numpy() for t in got)
    np.testing.assert_allclose(A @ V, U @ S, atol=1e-12)  # A V = U S
    if reorth:
        np.testing.assert_allclose(V.T @ V, np.eye(12), atol=1e-12)


@pytest.mark.parametrize("reorth", [False, True])
def test_arnoldi_matches_jax(square, reorth):
    A, b = square
    jA, tA = _ops(A)
    got = tk.arnoldi(tA, torch.from_numpy(b), 12, reorth=reorth)
    ref = jk.arnoldi(jA, jnp.asarray(b), 12, reorth=reorth)
    for g, r, shape in zip(got, ref, [(50, 13), (13, 12)]):
        assert tuple(g.shape) == shape and g.dtype == torch.float64
        assert _rel(g, r) <= RTOL
    Q, H = (t.numpy() for t in got)
    np.testing.assert_allclose(A @ Q[:, :-1], Q @ H, atol=1e-12)
    assert np.allclose(np.tril(H, -2), 0)  # upper Hessenberg


def test_arnoldi_refuses_non_square(rect):
    with pytest.raises(ValueError, match="not square"):
        tk.arnoldi(_ops(rect[0])[1], torch.from_numpy(rect[1]), 3)


@pytest.mark.parametrize("reorth", [False, True])
def test_golub_kahan_extend_in_chunks(rect, reorth):
    A, b = rect
    jA, tA = _ops(A)
    bt = torch.from_numpy(b)
    U, S, V = tk.golub_kahan(tA, bt, 12, reorth=reorth)
    state = tk.gk_init(tA, bt, 12)
    k = 0
    for n in (3, 1, 5, 3):
        state = tk.golub_kahan_extend(tA, *state, k, n, reorth=reorth)
        k += n
    Uc, Vc, alphas, betas = state
    assert torch.equal(Uc, U) and torch.equal(Vc, V)
    assert torch.equal(torch.diagonal(S), alphas)
    assert torch.equal(torch.diagonal(S, -1), betas)
    # and the JAX chunked form
    js = jk.gk_init(jA, jnp.asarray(b), 12)
    js = jk.golub_kahan_extend(jA, *js, 0, 7, reorth=reorth)
    js = jk.golub_kahan_extend(jA, *js, 7, 5, reorth=reorth)
    for g, r in zip(state, js):
        assert _rel(g, r) <= RTOL


@pytest.mark.parametrize("reorth", [False, True])
def test_arnoldi_extend_in_chunks(square, reorth):
    A, b = square
    jA, tA = _ops(A)
    bt = torch.from_numpy(b)
    Q, H = tk.arnoldi(tA, bt, 12, reorth=reorth)
    state = tk.arnoldi_init(tA, bt, 12)
    k = 0
    for n in (4, 4, 2, 2):
        state = tk.arnoldi_extend(tA, *state, k, n, reorth=reorth)
        k += n
    assert torch.equal(state[0], Q) and torch.equal(state[1], H)
    js = jk.arnoldi_init(jA, jnp.asarray(b), 12)
    js = jk.arnoldi_extend(jA, *js, 0, 5, reorth=reorth)
    js = jk.arnoldi_extend(jA, *js, 5, 7, reorth=reorth)
    for g, r in zip(state, js):
        assert _rel(g, r) <= RTOL


def test_arnoldi_breakdown_guard():
    """b an eigenvector: the next vector is exactly zero, and nrm = 0 stores
    a zero column instead of dividing by zero, as in JAX."""
    A = np.diag([2.0, 3.0, 4.0, 5.0])
    b = np.array([1.0, 0.0, 0.0, 0.0])
    Q, H = tk.arnoldi(DenseOperator(torch.from_numpy(A)),
                      torch.from_numpy(b), 3)
    jQ, jH = jk.arnoldi(JaxDense(jnp.asarray(A)), jnp.asarray(b), 3)
    assert float(H[0, 0]) == 2.0 and int((H != 0).sum()) == 1
    assert torch.equal(Q[:, 1:], torch.zeros(4, 3, dtype=torch.float64))
    assert np.array_equal(H.numpy(), np.asarray(jH))
    assert np.array_equal(Q.numpy(), np.asarray(jQ))


@pytest.fixture(scope="module")
def banded(request):
    mp = pytest.MonkeyPatch()
    mp.setenv("TRIPS_TPU_NO_NATIVE", "1")
    request.addfinalizer(mp.undo)
    A = jp.fan_beam_matrix(32, views=12).astype(np.float32)
    jop = JaxBucketed.from_scipy_fan(A, 32, 12, n_groups=8, n_buckets=2)
    top = BucketedBandedProjector.from_numpy_stacks(
        [[np.asarray(a) for a in st] for st in jop.stacks], jop.aidxs,
        jop.is_cols, jop.shape, jop.nx, jop.det_count, jop.n_groups,
        jop.nnz, jop.n_pad, device="cpu")
    rng = np.random.default_rng(11)
    b = (A @ rng.random(A.shape[1])).astype(np.float32)
    return jop, top, b


@pytest.mark.parametrize("reorth,steps", [(False, 5), (True, 10)])
def test_golub_kahan_banded_f32_matches_jax(banded, reorth, steps):
    """Without reorthogonalization float32 GK loses its basis from step 6
    on here and amplifies the sum order (8e-3 apart at step 8), so it is
    held over 5 steps."""
    jop, top, b = banded
    _, S, V = tk.golub_kahan(top, torch.from_numpy(b), steps, reorth=reorth)
    _, jS, _ = jk.golub_kahan(jop, jnp.asarray(b), steps, reorth=reorth)
    assert S.dtype == torch.float32 and V.shape == (top.shape[1], steps)
    jS = np.asarray(jS)
    for off in (0, -1):  # alpha, beta
        np.testing.assert_allclose(torch.diagonal(S, off).numpy(),
                                   np.diagonal(jS, off), rtol=1e-4)
