"""The per-frame batched solve: trips_tpu_torch against trips_tpu on the
CPU.

At ``tests/test_parallel.py``'s batched shapes (16x16, 4 frames, 10 views,
1% noise), in float64 on the same NumPy matrices:

- ``stack_ell_tables`` gives JAX's tables bit for bit (values, int32
  columns, the transposes', shape and nnz);
- ``EllOperator`` on a frame's tables applies that frame's matrix as scipy
  does (float64, to 1e-13 of the norm: the row sums run in another order);
- ``batched_frame_solve`` agrees with JAX's ``vmap``ped solve frame by
  frame, fused MMGKS with GCV and fused GKS with DP at ``delta / nt``, to
  ``tests/test_torch_fused.py``'s 1e-7 on the final iterate (the same
  masked recurrences, the products and factorizations in another
  BLAS/LAPACK order);
- each frame's result is the port's own fused solve of that frame alone,
  bit for bit: the loop over frames is ``vmap``'s meaning.

The matrices come from the NumPy builder (``TRIPS_TPU_NO_NATIVE=1``).
"""
import os

import numpy as np
import pytest
import torch

import trips_tpu.parallel as jpar
import trips_tpu.problems as jp
from trips_tpu.operators import FirstDerivative2D as JaxD2
from trips_tpu_torch.operators import FirstDerivative2D
from trips_tpu_torch.parallel import batched_frame_solve, stack_ell_tables
from trips_tpu_torch.solvers.fused import fused_gks, fused_mmgks
from trips_tpu_torch.sparse import EllOperator

from torch_threads import one_torch_thread  # noqa: F401

X_RTOL = 1e-7
SOLVES = {"mmgks gcv": dict(solver="mmgks"),
          "gks dp": dict(solver="gks", regparam_mode="dp")}


@pytest.fixture(scope="module")
def problem():
    old = os.environ.get("TRIPS_TPU_NO_NATIVE")
    os.environ["TRIPS_TPU_NO_NATIVE"] = "1"
    try:
        return jp.generate_synthetic_dynamic(nx=16, nt=4, views=10,
                                             noise_level=0.01)
    finally:
        if old is None:
            os.environ.pop("TRIPS_TPU_NO_NATIVE")
        else:
            os.environ["TRIPS_TPU_NO_NATIVE"] = old


def _kw(problem, name):
    kw = dict(SOLVES[name])
    if kw.get("regparam_mode") == "dp":
        kw["delta"] = problem[7] / problem[6]
    return kw


@pytest.fixture(scope="module")
def solved(problem):
    """{solve: (JAX's X, the port's X)}, each package's batched solve run
    once."""
    A, b, AA, B, nx, ny, nt, delta, x_true = problem
    out = {}
    for name in SOLVES:
        kw = _kw(problem, name)
        xj = np.asarray(jpar.batched_frame_solve(AA, B, JaxD2(nx, ny), **kw))
        xt = batched_frame_solve(AA, B, FirstDerivative2D(nx, ny,
                                                          device="cpu"),
                                 device="cpu", **kw)
        out[name] = (xj, xt)
    return out


def test_stack_ell_tables_bitwise(problem):
    AA = problem[2]
    j = jpar.stack_ell_tables(AA)
    t = stack_ell_tables(AA, device="cpu")
    for a, b in zip(j[:4], t[:4]):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert t[4:] == j[4:] and t[5] == sum(m.nnz for m in AA)


def test_ell_operator_matches_scipy(problem, rng):
    AA = problem[2]
    vals, cols, vals_t, cols_t, shape, _ = stack_ell_tables(AA, device="cpu")
    for f, M in enumerate(AA):
        op = EllOperator(vals[f], cols[f], vals_t[f], cols_t[f], shape)
        assert op.nnz == M.nnz and op.dtype == torch.float64
        x = rng.standard_normal(shape[1])
        y = rng.standard_normal(shape[0])
        X = rng.standard_normal((shape[1], 3))
        Y = rng.standard_normal((shape[0], 3))
        for got, ref in ((op.matvec(torch.from_numpy(x)), M @ x),
                         (op.rmatvec(torch.from_numpy(y)), M.T @ y),
                         (op.matmat(torch.from_numpy(X)), M @ X),
                         (op.rmatmat(torch.from_numpy(Y)), M.T @ Y)):
            assert got.shape == ref.shape
            assert (np.linalg.norm(got.numpy() - ref)
                    <= 1e-13 * np.linalg.norm(ref))


@pytest.mark.parametrize("name", list(SOLVES))
def test_batched_frame_solve_matches_jax(problem, solved, name):
    nt, n = problem[6], problem[4] * problem[5]
    xj, xt = solved[name]
    assert xt.shape == (nt, n) and xt.dtype == torch.float64
    for f in range(nt):
        err = np.linalg.norm(xt[f].numpy() - xj[f]) / np.linalg.norm(xj[f])
        assert err <= X_RTOL, (f, err)


@pytest.mark.parametrize("name", list(SOLVES))
def test_batched_is_each_frame_alone(problem, solved, name):
    A, b, AA, B, nx, ny, nt, delta, x_true = problem
    kw = _kw(problem, name)
    solve = fused_mmgks if kw.pop("solver") == "mmgks" else fused_gks
    L = FirstDerivative2D(nx, ny, device="cpu")
    for f in (0, nt - 1):
        # the frame's own tables, at its own widths
        tabs = stack_ell_tables([AA[f]], device="cpu")
        op = EllOperator(*(t[0] for t in tabs[:4]), tabs[4])
        x, _, _ = solve(op, torch.from_numpy(np.asarray(B[f])), L,
                        projection_dim=3, n_iter=10, device="cpu", **kw)
        assert torch.equal(x, solved[name][1][f])
