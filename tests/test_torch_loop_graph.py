"""``core.loop.run``'s card path, emulated on the CPU, against its eager path.

On the card a loop captures one masked step ``s <- where(done(s), s,
step(s))`` with a device step counter in a CUDA graph, runs the first step
eagerly and replays the graph a chunk of times between host reads of
(done, counter). ``loop.emulated()`` runs that path on any device with the
masked step called in place of each replay. Here, in float64, it gives the
eager path's state bit for bit, the same step count and the same host
reads: on a toy loop at its edges (done at the start, a stop on a chunk's
last step, a stop by ``max_steps``), on ``cgls``, ``cgls_normal``,
``lsqr``, ``cgls_normal``'s negative-delta guard, Brent's ``fminbound``
(GCV and L-curve on a small masked pencil, the solve-based
``gcv_lambda``, a float32 search that stalls), the DP Newton search, the
fused GKS's lambda sequence, and a ``cgls_normal_checkpointed`` run
resumed from its first chunk. The existing tests hold the eager path to the JAX
package, so the card path's arithmetic is held to it too; the card tests
(``tests/test_torch_cuda.py``) hold the replayed graphs to the eager path
on the card.
"""
import numpy as np
import pytest
import torch

from trips_tpu_torch.core import DenseOperator, loop
from trips_tpu_torch.krylov import cgls, cgls_normal, lsqr
from trips_tpu_torch.krylov.cgls import (CHUNK, _cgn_init, _cgn_step, _init,
                                         _step)
from trips_tpu_torch.operators import FirstDerivative1D
from trips_tpu_torch.regparam import device as regdev
from trips_tpu_torch.solvers import fused
from trips_tpu_torch.solvers.checkpointed import cgls_normal_checkpointed

from torch_threads import one_torch_thread  # noqa: F401

CPU = {"device": "cpu"}


def _both(fn):
    """(fn() eagerly, its TRACE), (fn() emulated, its TRACE)."""
    out = []
    for ctx in (loop.eager, loop.emulated):
        loop.TRACE = []
        try:
            with ctx():
                res = fn()
            out.append((res, [(n, r, None if s is None else int(s))
                              for n, r, s in loop.TRACE]))
        finally:
            loop.TRACE = None
    return out


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


@pytest.fixture(scope="module")
def dense():
    rng = np.random.default_rng(7)
    U, _ = np.linalg.qr(rng.standard_normal((60, 40)))
    V, _ = np.linalg.qr(rng.standard_normal((40, 40)))
    A = U @ np.diag(np.logspace(0, -1, 40)) @ V.T
    b = A @ rng.standard_normal(40) + 1e-3 * rng.standard_normal(60)
    return (DenseOperator(torch.from_numpy(A)), torch.from_numpy(b),
            torch.zeros(40, dtype=torch.float64))


# ---- a toy loop at the edges ------------------------------------------------
def _toy(stop, max_steps, chunk=4):
    """x <- x / 2 + 1 from 0 (x_k = 2 - 2^(1-k)), done once k >= stop."""
    def step(s):
        return dict(x=s["x"] / 2 + 1, k=s["k"] + 1, tag=s["tag"])

    def done(s):
        return s["k"] >= stop

    s0 = dict(x=torch.zeros((), dtype=torch.float64),
              k=torch.zeros((), dtype=torch.int32), tag="kept")
    return loop.run(step, s0, done, chunk, max_steps, "toy", counter="k")


# (stop, max_steps, chunk 4): expected steps, host reads
EDGES = {"done_at_start": (0, None, 0, 1),
         "mid_chunk": (6, None, 6, 2),
         "last_step_of_a_chunk": (8, None, 8, 2),
         "first_step_of_a_chunk": (5, None, 5, 2),
         "max_steps_mid_chunk": (99, 7, 7, 2),
         "max_steps_on_a_chunk": (99, 8, 8, 2),
         "max_steps_1": (99, 1, 1, 1),
         "max_steps_0": (99, 0, 0, 0),
         "stop_before_max_steps": (3, 7, 3, 1)}


@pytest.mark.parametrize("case", list(EDGES))
def test_toy_loop_edges(case):
    stop, max_steps, steps, reads = EDGES[case]
    (ref, tr_ref), (got, tr_got) = _both(lambda: _toy(stop, max_steps))
    assert _equal(got, ref)
    assert ref[1] == steps and int(ref[0]["k"]) == steps
    assert ref[0]["tag"] == got[0]["tag"] == "kept"
    assert tr_ref == tr_got == [("toy", reads, steps)]


def test_cpu_takes_the_eager_path(dense, monkeypatch):
    """Without ``emulated()`` a CPU state never enters the card's path."""
    def refuse(*args, **kwargs):
        raise AssertionError("the card's path on the CPU")

    monkeypatch.setattr(loop, "_replayed", refuse)
    A, b, x0 = dense
    cgls(A, b, x0, 10, 0.0)
    _toy(5, None)


def test_kernel_counts_are_registered():
    from trips_tpu_torch.operators import shear_kernels
    from trips_tpu_torch.sparse import banded_kernels

    ids = [id(c) for c in loop._COUNTS]
    assert id(banded_kernels.launch_counts) in ids
    assert id(shear_kernels.launch_counts) in ids


# ---- CGLS and LSQR ----------------------------------------------------------
def _tol_firing_at(A, b, x0, name, k):
    """A tolerance at which ``name``'s rule first fires at step k: the
    ratio ||t_k|| / ||t_0|| of the recurrence, taken step by step."""
    init, step = ((_init, _step) if name == "cgls" else (_cgn_init,
                                                         _cgn_step))
    s, r = init(A, b, x0), []
    for _ in range(k):
        s = step(A, 0.0, s)
        r.append(float(torch.sqrt(s.gamma) / s.norms_t0))
    tol = r[-1] * (1 + 1e-9)
    assert min(r[:-1]) > tol
    return tol


@pytest.mark.parametrize("name", ["cgls", "cgls_normal"])
@pytest.mark.parametrize("case", ["mid_chunk", "last_step_of_a_chunk",
                                  "max_iter_13"])
def test_cgls_emulated_equals_eager(dense, name, case):
    A, b, x0 = dense
    fn = cgls if name == "cgls" else cgls_normal
    fires = {"mid_chunk": 11, "last_step_of_a_chunk": 2 * CHUNK}
    max_iter = 30 if case in fires else 13
    tol = (_tol_firing_at(A, b, x0, name, fires[case]) if case in fires
           else 0.0)
    (ref, tr_ref), (got, tr_got) = _both(lambda: fn(A, b, x0, max_iter,
                                                    tol))
    assert ref[1] == fires.get(case, max_iter)
    assert _equal(got, ref) and tr_got == tr_ref


@pytest.mark.parametrize("max_iter,damp,tol", [(200, 0.1, 0.03),
                                               (200, 0.0, 1e-10),
                                               (6, 0.1, 1e-12)])
def test_lsqr_emulated_equals_eager(dense, max_iter, damp, tol):
    A, b, _ = dense
    (ref, tr_ref), (got, tr_got) = _both(
        lambda: lsqr(A, b, max_iter, damp=damp, atol=tol, btol=tol, **CPU))
    assert _equal(got, ref) and tr_got == tr_ref
    assert tr_ref[0][2] == ref[1]


class _NegativeAfter(DenseOperator):
    """A^T A for the first ``good`` normal applies, then -I: the negative
    delta guard of ``cgls_normal`` fires mid-chunk."""

    def __init__(self, mat, good):
        super().__init__(mat)
        self.left = good

    def normal_matvec(self, x):
        self.left -= 1
        return -x if self.left < 0 else self.mat.T @ (self.mat @ x)


def test_negative_delta_guard_emulated_equals_eager(dense):
    A, b, x0 = dense
    (ref, tr_ref), (got, tr_got) = _both(lambda: cgls_normal(
        _NegativeAfter(A.mat, 4), b, x0, 20))
    assert ref[1] == 4 and _equal(got, ref) and tr_got == tr_ref


# ---- the lambda searches ----------------------------------------------------
@pytest.fixture(scope="module")
def pencil():
    """A masked projected pencil: 6 live columns of 9, R_A and R_L upper
    triangular, their inactive columns zero (the fused GKS's at k = 6)."""
    rng = np.random.default_rng(3)
    K, k = 9, 6
    R_A = np.triu(rng.standard_normal((K, K))) * np.logspace(0, -3, K)
    R_L = np.triu(rng.standard_normal((K, K))) + 2 * np.eye(K)
    active = np.arange(K) < k
    R_A[:, ~active] = 0
    R_L[:, ~active] = 0
    bproj = rng.standard_normal(K) * active
    t = [torch.from_numpy(v) for v in (R_A, R_L, bproj)]
    return (*t, torch.from_numpy(active))


SEARCHES = {
    "gcv_masked": lambda R_A, R_L, bp, act: fused._gcv_lambda_masked(
        R_A, R_L, bp, 6.0, act),
    "lcurve_masked": lambda R_A, R_L, bp, act: fused._lcurve_lambda_masked(
        R_A, R_L, bp, act),
    "dp_newton_masked": lambda R_A, R_L, bp, act: fused._dp_lambda_masked(
        R_A, R_L, bp, torch.tensor(1e-4, dtype=torch.float64), 0.05, 1.01,
        act),
    "gcv_lambda_solves": lambda R_A, R_L, bp, act: regdev.gcv_lambda(
        R_A[:6, :6], R_L[:6, :6], bp[:6], **CPU),
    "dp_lambda": lambda R_A, R_L, bp, act: regdev.dp_lambda(
        R_A[:, :6], bp, 0.05, **CPU),
    # float32 cannot resolve the stopping interval: the search stops at the
    # first step that moves no entry of its state (Brent's ``moved``)
    "fminbound_f32_stall": lambda R_A, R_L, bp, act: regdev.fminbound(
        lambda x: (x - 0.337) ** 2 + 0.01 * torch.sin(50 * x), 1e-9, 2.0,
        dtype=torch.float32, **CPU),
}


@pytest.mark.parametrize("name", list(SEARCHES))
def test_search_emulated_equals_eager(pencil, name):
    (ref, tr_ref), (got, tr_got) = _both(lambda: SEARCHES[name](*pencil))
    assert _equal(got, ref) and tr_got == tr_ref
    assert len(tr_ref) == 1 and tr_ref[0][2] > 1  # the search took steps


@pytest.mark.parametrize("mode", ["gcv", "dp", "l_curve"])
def test_fused_gks_lambda_sequence_emulated_equals_eager(dense, mode):
    A, b, _ = dense
    L = FirstDerivative1D(40, **CPU)
    (ref, tr_ref), (got, tr_got) = _both(lambda: fused.fused_gks(
        A, b, L, projection_dim=3, n_iter=5, regparam_mode=mode,
        delta=float(1e-3 * np.sqrt(60)), **CPU))
    assert _equal(got, ref) and tr_got == tr_ref  # x, lambdas, residuals
    assert len(tr_ref) == 5


def test_cgls_normal_checkpointed_resume_emulated(dense):
    """Killed after its first chunk and resumed from the state the
    callback saw: the uninterrupted run's iterate and k, bitwise, and
    both equal to the eager run's."""
    A, b, x0 = dense
    saved = {}

    def keep_first(it, **state):
        saved.setdefault("state", state)

    with loop.emulated():
        full = cgls_normal_checkpointed(A, b, x0, 20, chunk=6,
                                        callback=keep_first, **CPU)
        resumed = cgls_normal_checkpointed(A, b, x0, 20, chunk=6,
                                           resume_state=saved["state"],
                                           **CPU)
    with loop.eager():
        eager = cgls_normal_checkpointed(A, b, x0, 20, chunk=6, **CPU)
    assert int(saved["state"]["k"]) == 6
    assert _equal(resumed, full) and _equal(full, eager)
    assert full[1] == 20
