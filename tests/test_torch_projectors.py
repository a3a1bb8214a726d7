"""The plain-PyTorch projectors against trips_tpu on the same inputs
(nx <= 24).

- ``parallel_beam_matrix``: the same CSR matrix, entry for entry ('line'
  and 'linear'; the JAX package with its NumPy builder,
  ``TRIPS_TPU_NO_NATIVE=1``, since the port carries only that one).
- ``OnTheFlyParallelProjector``, ``OnTheFlyFanProjector``,
  ``ShearStackParallelProjector``: applies within 1e-12 relative of the JAX
  operators in float64 (the same arithmetic; sums in another order),
  adjointness to 1e-12, and the matrices they stand for to 1e-11
  absolute: the Joseph parallel matrix, the Siddon fan matrix (the
  on-the-fly fan operator's docstring pins ~1e-12 in float64) and
  ``shear_stack_matrix``. In float32 the applies are within 1e-5 of the
  float64 matrix.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trips_tpu.operators as jo
import trips_tpu_torch.operators as to
from trips_tpu.operators.shear_projector import \
    shear_stack_matrix as jax_shear_stack_matrix
from trips_tpu.problems.projector import \
    parallel_beam_matrix as jax_parallel_beam_matrix
from trips_tpu_torch.problems import fan_beam_matrix, parallel_beam_matrix

from torch_threads import one_torch_thread  # noqa: F401

NX = 24
ANGLES = np.linspace(0, np.pi, 10, endpoint=False) + 0.0123
OPS = {
    "parallel": ("OnTheFlyParallelProjector", (NX, ANGLES), {}),
    "fan": ("OnTheFlyFanProjector", (NX,), {"angles": ANGLES}),
    "shear_stack": ("ShearStackParallelProjector", (NX, ANGLES), {}),
}


@pytest.fixture(autouse=True)
def _numpy_builder(monkeypatch):
    monkeypatch.setenv("TRIPS_TPU_NO_NATIVE", "1")


def _matrix(kind):
    if kind == "parallel":
        return parallel_beam_matrix(NX, ANGLES, model="linear")
    if kind == "fan":
        return fan_beam_matrix(NX, angles=ANGLES)
    return to.shear_stack_matrix(NX, ANGLES)


@pytest.fixture(scope="module")
def pairs():
    """kind -> (JAX operator, port operator), float64."""
    out = {}
    for kind, (name, args, kw) in OPS.items():
        out[kind] = (getattr(jo, name)(*args, dtype=jnp.float64, **kw),
                     getattr(to, name)(*args, dtype=torch.float64,
                                       device="cpu", **kw))
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("model", ["line", "linear"])
@pytest.mark.parametrize("nx,na,p,dw", [(24, 10, None, 1.0),
                                        (17, 7, 30, 0.9)])
def test_parallel_beam_matrix_identical(model, nx, na, p, dw):
    angles = np.linspace(0, np.pi, na, endpoint=False) + 0.0123
    Aj = jax_parallel_beam_matrix(nx, angles, p, dw, model=model)
    At = parallel_beam_matrix(nx, angles, p, dw, model=model)
    assert Aj.shape == At.shape and Aj.nnz == At.nnz
    assert (Aj != At).nnz == 0


def test_shear_stack_matrix_matches_jax():
    Aj = jax_shear_stack_matrix(NX, ANGLES)
    At = to.shear_stack_matrix(NX, ANGLES)
    assert Aj.shape == At.shape
    assert np.array_equal(Aj.indptr, At.indptr)
    assert np.array_equal(Aj.indices, At.indices)
    np.testing.assert_allclose(At.data, Aj.data, rtol=1e-14, atol=0)


@pytest.mark.parametrize("kind", list(OPS))
def test_operator_matches_jax(pairs, kind, rng):
    jop, top = pairs[kind]
    assert top.shape == jop.shape
    x = rng.standard_normal(top.shape[1])
    y = rng.standard_normal(top.shape[0])
    Ax = top.matvec(torch.from_numpy(x))
    Aty = top.rmatvec(torch.from_numpy(y))
    assert _rel(Ax, jop.matvec(jnp.asarray(x))) <= 1e-12
    assert _rel(Aty, jop.rmatvec(jnp.asarray(y))) <= 1e-12
    np.testing.assert_allclose(float(Ax @ torch.from_numpy(y)),
                               float(torch.from_numpy(x) @ Aty), rtol=1e-12)


@pytest.mark.parametrize("kind", list(OPS))
def test_operator_matches_matrix(pairs, kind, rng):
    top = pairs[kind][1]
    A = _matrix(kind)
    x = rng.standard_normal(top.shape[1])
    y = rng.standard_normal(top.shape[0])
    np.testing.assert_allclose(top.matvec(torch.from_numpy(x)).numpy(),
                               A @ x, atol=1e-11)
    np.testing.assert_allclose(top.rmatvec(torch.from_numpy(y)).numpy(),
                               A.T @ y, atol=1e-11)


@pytest.mark.parametrize("kind", list(OPS))
def test_float32(kind, rng):
    name, args, kw = OPS[kind]
    op = getattr(to, name)(*args, dtype=torch.float32, device="cpu", **kw)
    A = _matrix(kind)
    x = rng.standard_normal(op.shape[1])
    y = rng.standard_normal(op.shape[0])
    Ax = op.matvec(torch.from_numpy(x.astype(np.float32)))
    Aty = op.rmatvec(torch.from_numpy(y.astype(np.float32)))
    assert Ax.dtype == Aty.dtype == torch.float32
    assert _rel(Ax, A @ x) <= 1e-5
    assert _rel(Aty, A.T @ y) <= 1e-5


def test_fan_axis_aligned_angles(rng):
    """Exactly axis-aligned fans (0, pi/2) take the degenerate-slope
    branches; boundary rays may break ties differently from the matrix
    builder, so a smooth comparison as in the JAX package's test."""
    nx = 16
    angles = np.array([0.0, np.pi / 2, np.pi / 4])
    A = fan_beam_matrix(nx, angles=angles)
    op = to.OnTheFlyFanProjector(nx, angles=angles, dtype=torch.float64,
                                 device="cpu")
    x = rng.standard_normal(nx * nx)
    assert _rel(op.matvec(torch.from_numpy(x)), A @ x) < 1e-6
