"""The GCV search's factored evaluation (``regparam/gcv.py``) against the
two ``scipy.linalg.solve`` calls of ``_gcv_terms``, bit for bit.

``gcv_tikhonov_projected`` factors each lam's G = R_A^T R_A + lam R_L^T R_L
once (``dpotrf``) and solves both right-hand sides on that factor
(``dpotrs``) wherever ``solve`` itself takes Cholesky; every other G goes
through ``_gcv_terms``. Held here, on the CPU and with NumPy and SciPy only:

- on dense pencils of sizes 1 to 23, well and ill conditioned, every lam
  of a grid over [1e-9, 1e2] gives the terms of ``_gcv_terms`` exactly, and
  every G of size 2 or more takes the factored path;
- the search returns the lam of ``fminbound`` over ``_gcv_terms``, rebuilt
  here, exactly, in the three variants;
- the hybrid solvers' diagonal pencil (diag(s), I), k = 1 and G that fail
  ``potrf`` go through ``_gcv_terms``, with its result or its error;
- a small isotropic-TV MMGKS puts ``gcv_evals`` and ``gcv_factored`` on
  each ``mmgks.lambda`` span, every evaluation factored, and its iterates
  and lambdas are those of the unfactored search.

If a SciPy release changes what ``solve`` picks for these matrices, these
tests fail here first.
"""
import warnings

import numpy as np
import pytest
import scipy.linalg as sla
import torch
from scipy import optimize as sop
from scipy.linalg import lapack

from trips_tpu_torch.core import DenseOperator
from trips_tpu_torch.operators import CenteredSpaceTimeDerivative
from trips_tpu_torch.regparam import gcv
from trips_tpu_torch.solvers import MMGKS
from trips_tpu_torch.utils import telemetry

pytestmark = pytest.mark.filterwarnings("ignore::scipy.linalg.LinAlgWarning")

SIZES = [1, 4, 12, 23]
CONDITION = {"well": 1e-1, "ill": 1e-6}  # R_A's smallest singular value
GRID = np.logspace(-9, 2, 45)


def _pencil(k, cond, seed=0):
    """R_A (k x k, upper triangular, singular values 1 .. cond), R_L the R
    factor of a Gaussian 3k x k panel, bproj (k,)."""
    rng = np.random.default_rng(seed + 100 * k)
    U = np.linalg.qr(rng.standard_normal((k, k)))[0]
    V = np.linalg.qr(rng.standard_normal((k, k)))[0]
    R_A = np.linalg.qr((U * np.logspace(0, np.log10(cond), k)) @ V.T)[1]
    R_L = np.linalg.qr(rng.standard_normal((3 * k, k)))[1]
    return R_A, R_L, rng.standard_normal(k)


def _old_search(R_A, R_L, bproj, out_norm2=0.0, t_term=None,
                variant="standard"):
    """The search as it was: Brent over ``_gcv_terms``."""
    bproj = np.asarray(bproj, dtype=float).reshape(-1, 1)
    if variant == "standard-cols":
        t_term, variant = float(R_A.shape[1]), "standard"
    if t_term is None:
        t_term = float(R_A.shape[0])

    def f(lam):
        num, trace = gcv._gcv_terms(lam, R_A, R_L, bproj)
        if variant == "modified":
            num = num + out_norm2
        return num / (t_term - trace) ** 2

    return float(sop.fminbound(f, 1e-9, 1e2, xtol=1e-12, maxfun=1000,
                               disp=0))


def _counted(fn):
    """fn()'s result and the (evals, factored) it added to ``gcv.counts``."""
    before = dict(gcv.counts)
    out = fn()
    return out, (gcv.counts["evals"] - before["evals"],
                 gcv.counts["factored"] - before["factored"])


@pytest.mark.parametrize("cond", list(CONDITION))
@pytest.mark.parametrize("k", SIZES)
def test_factored_terms_are_gcv_terms_bit_for_bit(k, cond):
    R_A, R_L, b = _pencil(k, CONDITION[cond])
    bproj = b.reshape(-1, 1)
    terms = gcv._gcv_terms_factored(R_A, R_L, bproj)
    got, (evals, factored) = _counted(lambda: [terms(lam) for lam in GRID])
    assert got == [gcv._gcv_terms(lam, R_A, R_L, bproj) for lam in GRID]
    assert evals == len(GRID)
    assert factored == (len(GRID) if k >= 2 else 0)  # 1 x 1: diagonal


@pytest.mark.parametrize("variant", ["standard", "modified", "standard-cols"])
@pytest.mark.parametrize("cond", list(CONDITION))
@pytest.mark.parametrize("k", SIZES)
def test_search_lambda_is_the_old_searchs(k, cond, variant):
    R_A, R_L, b = _pencil(k, CONDITION[cond], seed=1)
    kw = dict(variant=variant)
    if variant == "modified":
        kw.update(out_norm2=0.3, t_term=float(3 * k + 5))
    lam, (evals, factored) = _counted(
        lambda: gcv.gcv_tikhonov_projected(R_A, R_L, b, **kw))
    assert lam == _old_search(R_A, R_L, b, **kw)
    assert evals >= 1 and factored == (evals if k >= 2 else 0)


@pytest.mark.parametrize("variant", ["standard", "modified"])
@pytest.mark.parametrize("k", [1, 4, 12])
def test_hybrid_diagonal_pencil_falls_back(k, variant):
    """The hybrid and projection solvers' (diag(s), I): solve() treats G
    as diagonal, so no evaluation is factored."""
    rng = np.random.default_rng(7 + k)
    H = rng.standard_normal((k + 1, k)) @ np.diag(np.logspace(0, -3, k))
    bhat = rng.standard_normal(k + 1)
    U, s, _ = sla.svd(H, full_matrices=False)
    out_norm2 = float(np.linalg.norm(bhat - U @ (U.T @ bhat)) ** 2)
    kw = dict(out_norm2=out_norm2, variant=variant)
    if variant == "modified":
        kw["t_term"] = float(4 * k)
    args = (np.diag(s), np.eye(k), U.T @ bhat)
    lam, (evals, factored) = _counted(
        lambda: gcv.gcv_tikhonov_projected(*args, **kw))
    assert lam == _old_search(*args, **kw)
    assert evals >= 1 and factored == 0


def test_g_that_fails_potrf_falls_back():
    """R_A and R_L with a shared null vector: G is singular but for
    rounding, and ``potrf`` fails at some lam; there the terms are
    ``_gcv_terms``' (LU's, through solve) and nothing is counted as
    factored."""
    rng = np.random.default_rng(11)
    k = 4
    v = rng.standard_normal(k)
    P = np.eye(k) - np.outer(v, v) / (v @ v)
    R_A = np.linalg.qr(rng.standard_normal((k, k)) @ P)[1]
    R_L = np.linalg.qr(rng.standard_normal((2 * k, k)) @ P)[1]
    b = rng.standard_normal(k)
    bproj = b.reshape(-1, 1)
    terms = gcv._gcv_terms_factored(R_A, R_L, bproj)
    failing = [lam for lam in GRID
               if lapack.dpotrf(R_A.T @ R_A + lam * (R_L.T @ R_L),
                                lower=0)[1] > 0]
    assert failing
    got, (evals, factored) = _counted(lambda: [terms(lam) for lam in failing])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = [gcv._gcv_terms(lam, R_A, R_L, bproj) for lam in failing]
    np.testing.assert_array_equal(got, ref)  # NaN where solve gives NaN
    assert evals == len(failing) and factored == 0
    lam, (evals, factored) = _counted(
        lambda: gcv.gcv_tikhonov_projected(R_A, R_L, b))
    old = _old_search(R_A, R_L, b)
    assert lam == old or (np.isnan(lam) and np.isnan(old))
    assert factored < evals


def test_singular_g_raises_as_before():
    """A zero column in both factors: every G fails ``potrf`` and solve()
    refuses it; the search raises solve()'s error, as it did."""
    rng = np.random.default_rng(12)
    R_A, R_L = np.triu(rng.standard_normal((2, 3, 3)))
    R_A[:, 1] = R_L[:, 1] = 0.0
    b = rng.standard_normal(3)
    with pytest.raises(np.linalg.LinAlgError) as old:
        _old_search(R_A, R_L, b)
    before = dict(gcv.counts)
    with pytest.raises(np.linalg.LinAlgError) as new:
        gcv.gcv_tikhonov_projected(R_A, R_L, b)
    assert str(new.value) == str(old.value)
    assert gcv.counts["factored"] == before["factored"]


@pytest.fixture(scope="module")
def dynamic():
    """Three frames of an 8x8 image, each blurred by one random block with
    decaying singular values, 1% noise (float64)."""
    nx = ny = 8
    nt = 3
    rng = np.random.default_rng(5)
    U, _ = np.linalg.qr(rng.standard_normal((48, 48)))
    V, _ = np.linalg.qr(rng.standard_normal((64, 48)))
    B = U @ np.diag(np.logspace(0, -2, 48)) @ V.T
    A = np.kron(np.eye(nt), B)
    g = np.linspace(-1, 1, nx)
    x_true = np.concatenate([
        np.exp(-4 * ((g[:, None] - 0.2 * t) ** 2 + g[None, :] ** 2)).ravel()
        for t in range(nt)])
    b = A @ x_true
    e = rng.standard_normal(b.size)
    b = b + 0.01 * np.linalg.norm(b) / np.linalg.norm(e) * e
    return (DenseOperator(torch.from_numpy(A)), torch.from_numpy(b),
            CenteredSpaceTimeDerivative(nx, ny, nt, device="cpu"),
            (nx, ny, nt))


def _mmgks(dynamic):
    A, b, L, dims = dynamic
    return MMGKS(A, b, L, pnorm=2, qnorm=1, projection_dim=3, n_iter=8,
                 regparam="gcv", isoTV="isoTV", prob_dims=dims)


def test_mmgks_spans_count_every_evaluation_factored(dynamic, monkeypatch):
    with telemetry.tracing() as t:
        x, info = _mmgks(dynamic)
    lam = [s for s in t.spans if s.name == "mmgks.lambda"]
    assert len(lam) == 8
    for s in lam:
        assert s.attrs["gcv_evals"] >= 1
        assert s.attrs["gcv_factored"] == s.attrs["gcv_evals"]
    # the same solve through the unfactored search: the same bits
    monkeypatch.setattr(
        gcv, "_gcv_terms_factored",
        lambda R_A, R_L, bproj: (
            lambda lam: gcv._gcv_terms(lam, R_A, R_L, bproj)))
    x_old, info_old = _mmgks(dynamic)
    assert torch.equal(x, x_old)
    assert info["regParam"] == info_old["regParam"]
