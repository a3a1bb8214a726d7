"""trips_tpu_torch.krylov.lsqr against trips_tpu.krylov.lsqr on the CPU.

Float64 on ``tests/test_krylov.py``'s dense ill-posed systems (60 x 40,
condition 1e2, a smooth solution): the same recurrence, undamped and
damped, with the stopping tests firing before the cap and with the cap
reached. The products run in another BLAS order, and on these systems
LSQR (no reorthogonalization) amplifies that exponentially after ~12
steps: the port against itself with another product order parts by
5.5e-12 at step 12 and 2.7e-6 at step 16, and JAX's runs the same way.
So the stops compared fall within the first 12 steps (tolerances 0.1 to
0.01): there ``k`` equals JAX's and the iterates agree to 1e-10 (measured
at most 7.4e-12). The loop reads the stopping test once per ``chunk``
steps and drops the steps past the stop: any chunk gives the eager loop's (a
read every step) ``x`` and ``k`` to the bit, on these and on long runs to
a tight tolerance.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from trips_tpu.core import DenseOperator as JaxDense
from trips_tpu.krylov import lsqr as jax_lsqr
from trips_tpu_torch.core import DenseOperator, loop
from trips_tpu_torch.krylov import lsqr

from torch_threads import one_torch_thread  # noqa: F401

CPU = {"device": "cpu"}
# (max_iter, damp, atol=btol): tolerances reached before the cap, and the
# cap reached first (the last)
CASES = [(200, 0.0, 0.1), (200, 0.0, 0.03), (200, 0.1, 0.1),
         (200, 0.1, 0.03), (200, 0.1, 0.01), (6, 0.1, 1e-12)]
# the chunked loop: long runs to tight tolerances too
CHUNK_CASES = CASES + [(200, 0.0, 1e-10), (500, 0.1, 1e-12)]


def make_illposed(rng, m, n, cond=1e2):
    """tests/test_krylov.py's system."""
    U, _ = np.linalg.qr(rng.standard_normal((m, m)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    s = np.logspace(0, -np.log10(cond), min(m, n))
    A = U[:, : len(s)] @ np.diag(s) @ V[:, : len(s)].T
    x_true = np.sin(np.linspace(0, 3, n))
    return A, x_true, A @ x_true


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_lsqr_matches_jax(case, seed):
    max_iter, damp, tol = CASES[case]
    A, _, b = make_illposed(np.random.default_rng(seed), 60, 40)
    x_t, k_t = lsqr(DenseOperator(torch.from_numpy(A)), b, max_iter,
                    damp=damp, atol=tol, btol=tol, **CPU)
    x_j, k_j = jax_lsqr(JaxDense(jnp.asarray(A)), jnp.asarray(b), max_iter,
                        damp=damp, atol=tol, btol=tol)
    assert isinstance(k_t, int) and k_t == int(k_j)
    assert (k_t < max_iter) == (case != len(CASES) - 1) and k_t <= 12
    assert x_t.dtype == torch.float64
    x_j = np.asarray(x_j)
    assert np.linalg.norm(x_t.numpy() - x_j) / np.linalg.norm(x_j) <= 1e-10


def test_lsqr_damped_solves_tikhonov():
    """tests/test_krylov.py::test_lsqr_damped on the port."""
    A, _, b = make_illposed(np.random.default_rng(0), 50, 30)
    damp = 0.1
    x, _ = lsqr(DenseOperator(torch.from_numpy(A)), b, 500, damp=damp,
                atol=1e-12, btol=1e-12, **CPU)
    x_direct = sla.solve(A.T @ A + damp**2 * np.eye(30), A.T @ b)
    np.testing.assert_allclose(x.numpy(), x_direct, atol=1e-6)


@pytest.mark.parametrize("case", range(len(CHUNK_CASES)))
def test_lsqr_chunked_equals_eager(case, monkeypatch):
    max_iter, damp, tol = CHUNK_CASES[case]
    A, _, b = make_illposed(np.random.default_rng(case), 60, 40)
    op = DenseOperator(torch.from_numpy(A))
    module = importlib.import_module("trips_tpu_torch.krylov.lsqr")
    runs = {}
    loop.TRACE = []
    try:
        for c in (1, 3, 8, 64):
            monkeypatch.setattr(module, "CHUNK", c)
            runs[c] = lsqr(op, b, max_iter, damp=damp, atol=tol, btol=tol,
                           **CPU)
        trace = list(loop.TRACE)
    finally:
        loop.TRACE = None
    x1, k1 = runs[1]
    for c, (x, k) in runs.items():
        assert torch.equal(x, x1) and k == k1, c
    # one host read per chunk of steps
    for c, (_, reads, steps) in zip(runs, trace):
        assert int(steps) == k1
        assert reads == max(1, -(-k1 // c))
