"""trips_tpu_torch.krylov CGLS variants against trips_tpu.krylov.

Float64 on a dense operator: the same recurrence in the same precision, so
iterates agree to 1e-10 with the same iteration count ``k``. Float32 on the
bucketed banded operator (the same packed bytes in both packages): the
applies sum in another order, and float32 CG amplifies that: the iterates
agree to 1e-3 after 20 iterations. The chunked loops (a host read of the
stopping test once per ``CHUNK`` steps) against loops that test it every
step, in float64: the same iterate to the bit and the same ``k``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trips_tpu.krylov as jk
import trips_tpu_torch.krylov as tk
from trips_tpu.core.linop import DenseOperator as JaxDense
from trips_tpu.sparse.banded_buckets import \
    BucketedBandedProjector as JaxBucketed
from trips_tpu_torch.core import DenseOperator
from trips_tpu_torch.krylov.cgls import (CHUNK, _cgn_init, _cgn_step, _init,
                                         _step)
from trips_tpu_torch.problems.projector import fan_beam_matrix
from trips_tpu_torch.sparse import BucketedBandedProjector

from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def dense():
    rng = np.random.default_rng(7)
    U, _ = np.linalg.qr(rng.standard_normal((60, 40)))
    V, _ = np.linalg.qr(rng.standard_normal((40, 40)))
    A = U @ np.diag(np.logspace(0, -1, 40)) @ V.T
    b = A @ rng.standard_normal(40) + 1e-3 * rng.standard_normal(60)
    return A, b


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# (name, args after (A, b, x0)). tol 2e-2 fires at k = 11 of 30, before
# the iterates reach the noise floor: past it, CG amplifies roundoff and
# two correct implementations drift apart.
CASES = [("cgls", (30, 2e-2)), ("cgls", (8, 0.0)),
         ("cgls_normal", (30, 2e-2)), ("cgls_normal", (8, 0.0)),
         ("cgls_fixed", (10,)), ("cgls_normal_fixed", (10,)),
         ("cgls_history", (30, 2e-2))]


@pytest.mark.parametrize("name,args", CASES)
def test_dense_f64_matches_jax(dense, name, args):
    A, b = dense
    x0 = np.zeros(A.shape[1])
    jout = getattr(jk, name)(JaxDense(A), jnp.asarray(b), jnp.asarray(x0),
                             *args)
    tout = getattr(tk, name)(DenseOperator(torch.from_numpy(A)),
                             torch.from_numpy(b), torch.from_numpy(x0), *args)
    assert tout[0].dtype == torch.float64
    assert int(tout[1]) == int(jout[1])
    assert _rel(tout[0].numpy(), jout[0]) <= 1e-10
    if name == "cgls_history":
        k = int(jout[1])
        assert k < args[0]  # the rule fired: later entries are frozen
        assert _rel(tout[2].numpy(), jout[2]) <= 1e-10
        np.testing.assert_allclose(tout[3].numpy()[:k],
                                   np.asarray(jout[3])[:k], rtol=1e-8)


@pytest.fixture(scope="module")
def banded():
    A = fan_beam_matrix(32, views=12).astype(np.float32)
    jop = JaxBucketed.from_scipy_fan(A, 32, 12, n_groups=8, n_buckets=2)
    top = BucketedBandedProjector.from_scipy_fan(A, 32, 12, n_groups=8,
                                                 n_buckets=2, device="cpu")
    rng = np.random.default_rng(11)
    b = (A @ rng.random(A.shape[1])).astype(np.float32)
    return jop, top, b


@pytest.mark.parametrize("name", ["cgls", "cgls_normal"])
def test_banded_f32_matches_jax(banded, name):
    """Each float32 apply is as close to the float64 matrix in both packages
    (~5e-8 relative) but sums in another order. Float32 CG amplifies such
    differences: by iteration 10 either run is ~1e-2 from the float64
    iterate, and the two runs are 1e-4..6e-4 apart at iteration 20
    (measured on this problem with several right-hand sides). So ``x`` is
    held to 1e-3."""
    jop, top, b = banded
    x0 = np.zeros(top.shape[1], np.float32)
    jx, jkk = getattr(jk, name)(jop, jnp.asarray(b), jnp.asarray(x0), 20,
                                0.0)
    tx, tkk = getattr(tk, name)(top, torch.from_numpy(b),
                                torch.from_numpy(x0), 20, 0.0)
    assert tx.dtype == torch.float32 and tkk == int(jkk) == 20
    assert _rel(tx.numpy(), jx) <= 1e-3


class _NegativeNormal(DenseOperator):
    """A^T A replaced by -I: p.(A^T A p) < 0 from the first step."""

    def normal_matvec(self, x):
        return -x


def test_negative_delta_guard(dense):
    A, b = dense
    op = _NegativeNormal(torch.from_numpy(A))
    x0 = torch.zeros(A.shape[1], dtype=torch.float64)
    s = _cgn_step(op, 0.0, _cgn_init(op, torch.from_numpy(b), x0))
    assert bool(s.done) and s.k == 1
    assert torch.equal(s.x, x0)  # beta = 0: no step against the descent
    x, k = tk.cgls_normal(op, torch.from_numpy(b), x0, 10)
    assert k == 1 and torch.equal(x, x0)


# ---- the chunked loop -------------------------------------------------------
# ``cgls`` and ``cgls_normal`` run CHUNK steps between host reads of the
# stopping test and return the first state at which it fired. The loops
# below test the rule after every step (the eager loops the chunked ones
# replace): in float64 both must give the same iterate to the bit and the
# same k.
def _eager(init, step, max_iter):
    s = init()
    while s.k < max_iter and not bool(s.done):
        s = step(s)
    return s.x, s.k


def _eager_cgls(A, b, x0, max_iter, tol):
    return _eager(lambda: _init(A, b, x0), lambda s: _step(A, tol, s),
                  max_iter)


def _eager_cgls_normal(A, b, x0, max_iter, tol=0.0):
    return _eager(lambda: _cgn_init(A, b, x0), lambda s: _cgn_step(A, tol, s),
                  max_iter)


EAGER = {"cgls": _eager_cgls, "cgls_normal": _eager_cgls_normal}


def _ratios(name, A, b, n):
    """||t_k|| / ||t_0|| of the first n steps (the stopping test's
    quantity) in the eager recurrence."""
    init, step = ((_init, _step) if name == "cgls" else (_cgn_init, _cgn_step))
    s = init(A, b, torch.zeros(A.shape[1], dtype=torch.float64))
    out = []
    for _ in range(n):
        s = step(A, 0.0, s)
        out.append(float(torch.sqrt(s.gamma) / s.norms_t0))
    return out


def _tol_firing_at(name, A, b, k):
    """A tolerance at which the rule first fires at step k."""
    r = _ratios(name, A, b, k)
    tol = r[-1] * (1 + 1e-9)
    assert min(r[:-1]) > tol
    return tol


@pytest.mark.parametrize("name", ["cgls", "cgls_normal"])
@pytest.mark.parametrize("case", ["mid_chunk", "chunk_boundary",
                                  "second_boundary", "max_iter_13",
                                  "max_iter_5"])
def test_chunked_loop_bit_equal_to_eager(dense, name, case):
    A, b = dense
    op = DenseOperator(torch.from_numpy(A))
    bt, x0 = torch.from_numpy(b), torch.zeros(A.shape[1],
                                             dtype=torch.float64)
    fires = {"mid_chunk": 11, "chunk_boundary": CHUNK,
             "second_boundary": 2 * CHUNK}
    if case in fires:
        max_iter, tol = 30, _tol_firing_at(name, op, bt, fires[case])
    else:  # the rule never fires: max_iter, not a multiple of CHUNK, ends it
        max_iter, tol = int(case.rsplit("_", 1)[1]), 0.0
    x, k = getattr(tk, name)(op, bt, x0, max_iter, tol)
    xe, ke = EAGER[name](op, bt, x0, max_iter, tol)
    assert k == ke == fires.get(case, max_iter)
    assert torch.equal(x, xe)


class _NegativeAfter(DenseOperator):
    """A^T A for the first ``good`` normal applies, then -I: the guard of
    ``cgls_normal`` must fire at step good + 1 (set-up's apply included),
    mid-chunk, and stop the iterate there."""

    def __init__(self, mat, good):
        super().__init__(mat)
        self.left = good

    def normal_matvec(self, x):
        self.left -= 1
        if self.left < 0:
            return -x
        return self.mat.T @ (self.mat @ x)


def test_chunked_negative_delta_guard_fires_mid_chunk(dense):
    A, b = dense
    bt, x0 = torch.from_numpy(b), torch.zeros(A.shape[1],
                                             dtype=torch.float64)
    x, k = tk.cgls_normal(_NegativeAfter(torch.from_numpy(A), 4), bt, x0, 20)
    xe, ke = _eager_cgls_normal(_NegativeAfter(torch.from_numpy(A), 4), bt,
                                x0, 20)
    assert k == ke == 4 and torch.equal(x, xe)


@pytest.mark.parametrize("name", ["cgls", "cgls_normal"])
@pytest.mark.parametrize("max_iter,tol", [(30, 0.0), (30, 2e-2), (8, 0.0),
                                          (1, 0.0)])
def test_chunked_loop_reads_back_once_per_chunk(dense, monkeypatch, name,
                                                max_iter, tol):
    """Every host read of a tensor (bool, int, float, item) during a solve
    is counted: at most one per chunk plus the final read of k."""
    A, b = dense
    op = DenseOperator(torch.from_numpy(A))
    bt, x0 = torch.from_numpy(b), torch.zeros(A.shape[1],
                                             dtype=torch.float64)
    reads = []
    for attr in ("__bool__", "__int__", "__float__", "item"):
        orig = getattr(torch.Tensor, attr)
        monkeypatch.setattr(torch.Tensor, attr,
                            (lambda f, a: lambda self: reads.append(a)
                             or f(self))(orig, attr))
    _, k = getattr(tk, name)(op, bt, x0, max_iter, tol)
    monkeypatch.undo()
    assert 1 <= len(reads) <= math.ceil(max_iter / CHUNK) + 1, reads
    assert k == (11 if tol else max_iter)
