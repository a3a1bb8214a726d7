"""trips_tpu_torch.core's operator combinators and utils.validation against
trips_tpu on the CPU.

``CompositeOperator``, ``VStackOperator``, ``BlockDiagOperator`` and
``FunctionOperator`` over dense float64 blocks: every apply and column
apply within 1e-12 relative of the JAX twin's, and exact adjointness
<Ax, y> = <x, A^T y> to 1e-12 where the blocks are exact. A combinator
takes its dtype and device from its operands and refuses operands on two
device types. The validation helpers are host NumPy: the same results and
the same errors as JAX's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trips_tpu.core as jc
import trips_tpu.utils as ju
import trips_tpu_torch.core as tc
import trips_tpu_torch.utils as tu
from trips_tpu_torch.operators import FirstDerivative2D

from torch_threads import one_torch_thread  # noqa: F401

CPU = {"device": "cpu"}


def _rel(a, b):
    a = np.asarray(a, dtype=float).reshape(-1)
    b = np.asarray(b, dtype=float).reshape(-1)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _pair(M):
    return tc.DenseOperator(torch.tensor(M)), jc.DenseOperator(jnp.asarray(M))


def _ops(rng):
    """name -> (port operator, JAX operator)."""
    mats = [rng.standard_normal(s) for s in ((7, 5), (5, 6), (4, 6), (3, 6),
                                             (2, 3))]
    p = [_pair(M) for M in mats]
    f = lambda x: 2.0 * x - x.sum()  # noqa: E731  (symmetric)
    return {
        "composite": (tc.CompositeOperator(p[0][0], p[1][0]),
                      jc.CompositeOperator(p[0][1], p[1][1])),
        "matmul": (p[0][0] @ p[1][0], p[0][1] @ p[1][1]),
        "vstack": (tc.VStackOperator([p[1][0], p[2][0], p[3][0]]),
                   jc.VStackOperator([p[1][1], p[2][1], p[3][1]])),
        "blockdiag": (tc.BlockDiagOperator([p[0][0], p[4][0], p[1][0]]),
                      jc.BlockDiagOperator([p[0][1], p[4][1], p[1][1]])),
        "function": (tc.FunctionOperator(f, f, 6, **CPU),
                     jc.FunctionOperator(f, f, 6)),
        "nested": (tc.VStackOperator([p[0][0] @ p[1][0], 3.0 * p[2][0]]).T,
                   jc.VStackOperator([p[0][1] @ p[1][1], 3.0 * p[2][1]]).T),
    }


NAMES = ["composite", "matmul", "vstack", "blockdiag", "function", "nested"]


@pytest.mark.parametrize("name", NAMES)
def test_combinator_matches_jax(rng, name):
    t, j = _ops(rng)[name]
    assert tuple(t.shape) == tuple(j.shape)
    m, n = t.shape
    x, y = rng.standard_normal(n), rng.standard_normal(m)
    X, Y = rng.standard_normal((n, 3)), rng.standard_normal((m, 3))
    for meth, arg in (("matvec", x), ("rmatvec", y), ("matmat", X),
                      ("rmatmat", Y)):
        got = getattr(t, meth)(torch.from_numpy(arg))
        ref = np.asarray(getattr(j, meth)(jnp.asarray(arg)))
        assert got.shape == ref.shape and _rel(got, ref) <= 1e-12, meth
    assert _rel(t.todense(), np.asarray(j.todense())) <= 1e-12
    lhs = float(t.matvec(torch.from_numpy(x)) @ torch.from_numpy(y))
    rhs = float(torch.from_numpy(x) @ t.rmatvec(torch.from_numpy(y)))
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)
    assert t.dtype == torch.float64 or name == "function"
    assert t.device == torch.device("cpu")


def test_combinator_checks():
    a = tc.DenseOperator(torch.zeros(3, 4))
    with pytest.raises(ValueError, match="shape mismatch"):
        tc.CompositeOperator(a, a)
    with pytest.raises(ValueError, match="inconsistent column counts"):
        tc.VStackOperator([a, tc.DenseOperator(torch.zeros(3, 5))])

    class OnCard(tc.DenseOperator):
        device = torch.device("cuda")

    card = object.__new__(OnCard)
    card.shape, card.dtype = (4, 4), torch.float32
    for make in (lambda: tc.CompositeOperator(a, card),
                 lambda: tc.VStackOperator([a, card]),
                 lambda: tc.BlockDiagOperator([a, card])):
        with pytest.raises(ValueError, match="different devices"):
            make()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tc.FunctionOperator(lambda v: v, lambda v: v, 3)


def test_regularizer_stack_in_a_solver(rng):
    """A stacked regularizer [D; 0.5 I] through the port's GKS, against the
    JAX GKS on the same stack (float64, deblurring data)."""
    import trips_tpu.operators as jo
    import trips_tpu.solvers as js
    import trips_tpu_torch.operators as to
    import trips_tpu_torch.solvers as ts

    n = 12
    tA = to.Blur2D((3, 3), 1.0, n, n, dtype=torch.float64, **CPU)
    jA = jo.Blur2D((3, 3), 1.0, n, n)
    x = rng.standard_normal(n * n)
    b = np.asarray(jA.matvec(jnp.asarray(x))) + 0.01 * rng.standard_normal(
        n * n)
    tL = tc.VStackOperator([FirstDerivative2D(n, n, **CPU),
                            0.5 * tc.IdentityOperator(n * n, torch.float64,
                                                      **CPU)])
    jL = jc.VStackOperator([jo.FirstDerivative2D(n, n),
                            0.5 * jc.IdentityOperator(n * n)])
    tx, ti = ts.GKS(tA, torch.from_numpy(b), tL, projection_dim=2, n_iter=6,
                    regparam=0.05)
    jx, ji = js.GKS(jA, jnp.asarray(b), jL, projection_dim=2, n_iter=6,
                    regparam=0.05)
    assert _rel(tx.numpy(), np.asarray(jx)) <= 1e-8


def test_validation_matches_jax(rng):
    x = rng.standard_normal(20)
    assert np.array_equal(tu.soft_thresh(x, 0.3), ju.soft_thresh(x, 0.3))
    assert np.array_equal(tu.soft_thresh(torch.from_numpy(x), 0.3),
                          ju.soft_thresh(x, 0.3))
    for fn, good, bad in (
            ("check_noise_type", ["g", "Gaussian", "laplace", "poisson"],
             ["speckle", 1]),
            ("check_noise_level", [0, 0.01, 2], [-1, "1%"]),
            ("check_Regparam", [1, 0.5, "gcv", "dp", "l_curve"],
             [0, -1.0, "lcurve"])):
        for v in good:
            assert getattr(tu, fn)(v) is None
        for v in bad:
            with pytest.raises(TypeError):
                getattr(ju, fn)(v)
            with pytest.raises(TypeError):
                getattr(tu, fn)(v)
    M = rng.standard_normal((9, 5))
    t, j = _pair(M)
    assert np.array_equal(tu.check_operator_type(t), M)
    assert np.array_equal(tu.check_operator_type(M), M)
    for a, b in zip(tu.operator_qr(t), ju.operator_qr(j)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    for a, b in zip(tu.operator_svd(t), ju.operator_svd(j)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    assert tu.is_identity(np.eye(4)) and not tu.is_identity(M)
    assert tu.is_identity(tc.IdentityOperator(5, **CPU))
    assert ju.is_identity(np.eye(4)) == tu.is_identity(np.eye(4))
