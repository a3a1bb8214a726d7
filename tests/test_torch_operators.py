"""trips_tpu_torch derivative and weight operators and the linear-operator
combinators against trips_tpu, on the CPU in float64.

Each apply is the JAX package's shifts, subtractions and slice adds in the
same order, so results agree to 1e-14 relative (``RTOL``; the products of
the combinators run in another BLAS). Grids have nx != ny. The derivative
operators are also held against the reference's scipy matrices
(``*_matrix``, built here), their ``todense`` equal to them, and their
adjoints to ``<Ax, y> = <x, A^T y>``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trips_tpu.core as jc
import trips_tpu.operators as jo
import trips_tpu_torch.core as tc
import trips_tpu_torch.operators as to

from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-14
NX, NY, NT = 5, 7, 3


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


# (name, constructor arguments, the scipy matrix or None)
DERIVATIVES = [
    ("FirstDerivative1D", (9,), lambda: to.first_derivative_matrix(9)),
    ("FirstDerivative2D", (NX, NY),
     lambda: to.first_derivative_2d_matrix(NX, NY)),
    ("SpaceTimeDerivative", (NX, NY, NT),
     lambda: to.spacetime_derivative_matrix(NX, NY, NT)),
    ("CenteredSpaceTimeDerivative", (NX, NY, NT), None),
    ("CenteredDerivative2D", (NX, NY), None),
]


@pytest.mark.parametrize("name,args,matrix", DERIVATIVES)
def test_derivative_matches_jax(name, args, matrix, rng):
    top = getattr(to, name)(*args, device="cpu")
    jop = getattr(jo, name)(*args)
    assert top.shape == jop.shape and top.device == torch.device("cpu")
    m, n = top.shape
    x, y = rng.standard_normal(n), rng.standard_normal(m)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    Ax, Aty = top.matvec(tx), top.rmatvec(ty)
    assert Ax.dtype == torch.float64 and Ax.shape == (m,)
    assert _rel(Ax, jop.matvec(jnp.asarray(x))) <= RTOL
    assert _rel(Aty, jop.rmatvec(jnp.asarray(y))) <= RTOL
    assert abs(float(Ax @ ty) - float(tx @ Aty)) <= 1e-12 * float(
        Ax.norm() * ty.norm())
    if matrix is not None:
        M = matrix()
        assert _rel(Ax, M @ x) <= RTOL and _rel(Aty, M.T @ y) <= RTOL
        dense = top.todense()
        assert dense.shape == (m, n) and np.array_equal(dense.numpy(),
                                                        M.toarray())


@pytest.mark.parametrize("name,args,matrix", DERIVATIVES)
def test_derivative_matmat(name, args, matrix, rng):
    """``(n, k)`` columns at once (the solvers' ``L.matmat(V)``) give the
    columns' applies."""
    top = getattr(to, name)(*args, device="cpu")
    m, n = top.shape
    X = torch.from_numpy(rng.standard_normal((n, 3)))
    Y = torch.from_numpy(rng.standard_normal((m, 3)))
    for fn, vfn, M in (("matmat", "matvec", X), ("rmatmat", "rmatvec", Y)):
        got = getattr(top, fn)(M)
        ref = torch.stack([getattr(top, vfn)(c) for c in M.T], dim=1)
        assert got.shape == ref.shape and _rel(got, ref) <= RTOL


def test_derivative_entry_points_default_to_the_card():
    """Without a card the default device raises before any tensor is made
    (the port's rule for entry points)."""
    if torch.cuda.is_available():
        assert to.FirstDerivative2D(4, 4).device.type == "cuda"
        return
    for make in (lambda: to.FirstDerivative1D(4),
                 lambda: to.FirstDerivative2D(4, 5),
                 lambda: to.CenteredDerivative2D(4, 5),
                 lambda: tc.IdentityOperator(4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


@pytest.mark.parametrize("p", [1.0, 2.0, 0.5])
def test_smoothed_holder_weights(p, rng):
    x = rng.standard_normal(50)
    got = to.smoothed_holder_weights(torch.from_numpy(x), 0.1, p)
    ref = jo.smoothed_holder_weights(jnp.asarray(x), 0.1, p)
    assert _rel(got, ref) <= RTOL


def test_iso_tv_weights(rng):
    n = NX * NY * NT
    x = rng.standard_normal(n)
    L = jo.CenteredSpaceTimeDerivative(NX, NY, NT)
    u = np.array(L.matvec(jnp.asarray(x)))
    got = to.iso_tv_weights(torch.from_numpy(x), torch.from_numpy(u), NX,
                            NY, NT, 0.1, 1.0)
    ref = jo.iso_tv_weights(jnp.asarray(x), jnp.asarray(u), NX, NY, NT, 0.1,
                            1.0)
    assert got.shape == (L.shape[0],) and _rel(got, ref) <= RTOL


def test_gs_weights(rng):
    """The reference's np.exp(2) inside the power is kept."""
    x = rng.standard_normal(NX * NY * NT)
    tD, jD = (to.FirstDerivative2D(NX, NY, device="cpu"),
              jo.FirstDerivative2D(NX, NY))
    got = to.gs_weights(torch.from_numpy(x), tD.matmat, NX, NY, NT, 1.0)
    ref = jo.gs_weights(jnp.asarray(x), jD.matmat, NX, NY, NT, 1.0)
    assert got.shape == (NT * tD.shape[0],) and _rel(got, ref) <= RTOL
    X = x.reshape(NT, -1).T
    D = to.first_derivative_2d_matrix(NX, NY) @ X
    wr = ((D**2).sum(axis=1) + np.exp(2)) ** -0.5
    assert _rel(got, np.tile(wr, NT)) <= RTOL


def test_batched_block_diag_matches_jax(rng):
    """diag(B, ..., B) over NT frames of FirstDerivative2D, as MMGKS's GS
    mode builds it; and of a dense B without a column-wise apply."""
    for tB, jB in ((to.FirstDerivative2D(NX, NY, device="cpu"),
                    jo.FirstDerivative2D(NX, NY)),
                   (tc.DenseOperator(torch.from_numpy(
                       rng.standard_normal((6, NX * NY)))), None)):
        if jB is None:
            jB = jc.DenseOperator(jnp.asarray(tB.mat.numpy()))
        top, jop = (tc.BatchedBlockDiagOperator(tB, NT),
                    jc.BatchedBlockDiagOperator(jB, NT))
        assert top.shape == jop.shape
        m, n = top.shape
        x, y = rng.standard_normal(n), rng.standard_normal(m)
        X, Y = rng.standard_normal((n, 2)), rng.standard_normal((m, 2))
        for fn, v in (("matvec", x), ("rmatvec", y), ("normal_matvec", x),
                      ("matmat", X), ("rmatmat", Y)):
            got = getattr(top, fn)(torch.from_numpy(v))
            assert _rel(got, getattr(jop, fn)(jnp.asarray(v))) <= 1e-13, fn


def test_identity_and_scaled_operators(rng):
    x = torch.from_numpy(rng.standard_normal(6))
    X = torch.from_numpy(rng.standard_normal((6, 2)))
    eye = tc.IdentityOperator(6, device="cpu")
    assert eye.matvec(x) is x and eye.rmatmat(X) is X
    assert torch.equal(eye.todense(), torch.eye(6))
    assert tc.IdentityOperator(6, dtype=torch.float64,
                               device="cpu").todense().dtype == torch.float64
    D = to.FirstDerivative1D(6, device="cpu")
    for S in (tc.ScaledOperator(2.5, D), 2.5 * D, D * 2.5):
        assert isinstance(S, tc.ScaledOperator) and S.shape == (5, 6)
        assert torch.equal(S.matvec(x), 2.5 * D.matvec(x))
        assert torch.equal(S.matmat(X), 2.5 * D.matmat(X))
        y = D.matvec(x)
        assert torch.equal(S.rmatvec(y), 2.5 * D.rmatvec(y))
        assert torch.equal(S.rmatmat(D.matmat(X)), 2.5 * D.rmatmat(
            D.matmat(X)))


def test_base_matmat_rmatmat_todense_and_adjoint(rng):
    """The base class's column loops and ``todense`` on an operator that
    has only matvec/rmatvec; the adjoint swaps them."""
    M = torch.from_numpy(rng.standard_normal((4, 3)))

    class Plain(tc.LinearOperator):
        shape, dtype, device = (4, 3), torch.float64, torch.device("cpu")

        def matvec(self, x):
            return M @ x

        def rmatvec(self, y):
            return M.T @ y

    op = Plain()
    X = torch.from_numpy(rng.standard_normal((3, 2)))
    Y = torch.from_numpy(rng.standard_normal((4, 2)))
    assert _rel(op.matmat(X), M @ X) <= RTOL
    assert _rel(op.rmatmat(Y), M.T @ Y) <= RTOL
    assert _rel(op.todense(), M) <= RTOL
    assert _rel(op.T.matmat(Y), M.T @ Y) <= RTOL
    assert _rel(op.T.rmatmat(X), M @ X) <= RTOL
    assert _rel(op.T.todense(), M.T) <= RTOL
    dense = tc.DenseOperator(M)
    assert dense.todense() is M and _rel(dense.rmatmat(Y), M.T @ Y) <= RTOL
