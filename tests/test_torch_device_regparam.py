"""trips_tpu_torch.regparam.device against trips_tpu.regparam.device.

Both run Brent's bounded search and the discrepancy principle's Newton on
the same tensors step for step: the port as a loop with one host read per
chunk of steps, JAX as a ``lax.while_loop``. In float64 on the same
inputs:

- ``fminbound`` on ``tests/test_device_regparam.py``'s four functions
  agrees with JAX's and scipy's to 1e-6 relative (scipy's tolerance in
  that file), and takes as many evaluations as JAX's loop (counted on
  JAX's side with ``jax.debug.callback``);
- ``gcv_lambda`` (both variants) agrees with JAX's to 1e-5 (the
  tolerance that file holds JAX's against the host rule), ``lcurve_lambda``
  to 1e-6 and ``dp_lambda`` to 1e-10, on that file's random projected
  systems. The k x k solves run in another LAPACK order, so the function
  values differ in the last bits, and Brent stops anywhere within
  sqrt(eps) |lam| of the minimum: measured 1.1e-6 for the modified GCV
  (its curve is flat: 500 rows against 10 columns), 3.5e-8 for the
  L-curve. An unattainable DP gives 0 in both;
- the four tsvd/tgsvd walks give JAX's integer on every seed and at the
  saturation edges.

The golden-section constant is computed in the working dtype: in float32
it is one ulp below the rounded float64 constant, as JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize as sop
import torch

import trips_tpu.regparam.device as jd
import trips_tpu_torch.regparam.device as td
from trips_tpu.utils.gsvd import gsvd
from trips_tpu_torch.core import loop

from torch_threads import one_torch_thread  # noqa: F401

CPU = {"device": "cpu"}
FUNCS = [
    (lambda x, m: (x - 0.337) ** 2, 0.0, 2.0),
    (lambda x, m: m.sin(x) + 0.1 * x, 1e-9, 6.0),
    (lambda x, m: m.log(x) + 1.0 / x, 1e-3, 50.0),
    (lambda x, m: (x - 1e-6) ** 2 / (x + 1e-9), 1e-9, 1e2),
]


def _jax_evaluations(func, lo, hi):
    """JAX's minimizer and how many times its loop evaluated ``func``."""
    calls = []

    def counted(x):
        jax.debug.callback(lambda: calls.append(1))
        return func(x, jnp)

    x = float(jd.fminbound(counted, lo, hi, xtol=1e-12, maxfun=1000))
    return x, len(calls)


@pytest.mark.parametrize("case", range(len(FUNCS)))
def test_fminbound_matches_jax_and_scipy(case):
    func, lo, hi = FUNCS[case]
    loop.TRACE = []
    try:
        x_t = td.fminbound(lambda x: func(x, torch), lo, hi, xtol=1e-12,
                           maxfun=1000, **CPU)
        (_, reads, steps), = loop.TRACE
    finally:
        loop.TRACE = None
    x_j, evals = _jax_evaluations(func, lo, hi)
    x_sp = float(sop.fminbound(lambda x: func(x, np), lo, hi, xtol=1e-12,
                               maxfun=1000, disp=0))
    assert x_t.dtype == torch.float64 and x_t.dim() == 0
    assert float(x_t) == pytest.approx(x_j, rel=1e-6, abs=1e-9)
    assert float(x_t) == pytest.approx(x_sp, rel=1e-6, abs=1e-9)
    assert int(steps) == evals  # the first evaluation and one per step
    # one read per chunk of steps
    assert reads == max(1, -(-(int(steps) - 1) // td.BRENT_CHUNK))


def test_fminbound_chunk_does_not_change_the_result(monkeypatch):
    func, lo, hi = FUNCS[3]
    out = []
    for chunk in (1, 5, td.BRENT_CHUNK):
        monkeypatch.setattr(td, "BRENT_CHUNK", chunk)
        out.append(td.fminbound(lambda x: func(x, torch), lo, hi, **CPU))
    assert all(torch.equal(o, out[0]) for o in out)


@pytest.mark.parametrize("case", [0, 2, 3, 4])
def test_fminbound_f32_equals_jax_with_x64_off(case):
    """In float32 the port's search is JAX's with x64 off (a TPU's), to the
    bit: the same golden-mean ulp, the same steps. Case 4 stalls after 18
    steps (float32 cannot resolve the stopping interval): JAX's loop then
    repeats the unchanged state up to maxfun, the port stops, and both
    return the same minimizer. Case 1 is left out: there XLA's and torch's
    float32 ``sin`` differ in the last ulp, and the searches part."""
    func, lo, hi = (FUNCS + [(lambda x, m: (x - 0.337) ** 2
                              + 0.01 * m.sin(50 * x), 1e-9, 2.0)])[case]
    with jax.enable_x64(False):
        x_j = jd.fminbound(lambda x: func(x, jnp), lo, hi)
        assert x_j.dtype == jnp.float32
    x_t = td.fminbound(lambda x: func(x, torch), lo, hi,
                       dtype=torch.float32, **CPU)
    assert x_t.dtype == torch.float32
    assert float(x_t) == float(x_j)


def test_golden_mean_in_the_working_dtype():
    g32 = td._golden_mean(torch.float32, "cpu")
    f32 = np.float32
    assert g32.dtype == torch.float32
    assert float(g32) == f32(0.5) * (f32(3) - np.sqrt(f32(5)))
    rounded = f32(0.5 * (3 - np.sqrt(5.0)))
    assert float(g32) == np.nextafter(rounded, f32(0))  # one ulp below
    assert float(td._golden_mean(torch.float64, "cpu")) == pytest.approx(
        0.5 * (3 - np.sqrt(5.0)), rel=1e-16)


def projected(rng, k=10):
    """tests/test_device_regparam.py's projected system."""
    R_A = np.triu(rng.standard_normal((k, k))) + np.diag(np.logspace(0, -4,
                                                                     k))
    return R_A, np.eye(k), rng.standard_normal(k)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("variant", ["standard", "modified"])
def test_gcv_lambda_matches_jax(seed, variant):
    R_A, R_L, bproj = projected(np.random.default_rng(seed))
    kw = (dict(out_norm2=3.0, t_term=500.0, variant="modified")
          if variant == "modified" else {})
    lam_t = td.gcv_lambda(R_A, R_L, bproj, **kw, **CPU)
    lam_j = float(jd.gcv_lambda(jnp.asarray(R_A), jnp.asarray(R_L),
                                jnp.asarray(bproj), **kw))
    assert lam_t.dtype == torch.float64
    assert float(lam_t) == pytest.approx(lam_j, rel=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lcurve_lambda_matches_jax(seed):
    R_A, R_L, bproj = projected(np.random.default_rng(seed))
    lam_t = td.lcurve_lambda(R_A, R_L, bproj, **CPU)
    lam_j = float(jd.lcurve_lambda(jnp.asarray(R_A), jnp.asarray(R_L),
                                   jnp.asarray(bproj)))
    assert float(lam_t) == pytest.approx(lam_j, rel=1e-6)


@pytest.mark.parametrize("level", [0.1, 0.2, 0.3])
def test_dp_lambda_matches_jax(level):
    """tests/test_device_regparam.py's bidiagonal DP system, at three noise
    levels."""
    rng = np.random.default_rng(0)
    k = 12
    B = np.zeros((k + 1, k))
    B[np.arange(k), np.arange(k)] = np.logspace(0, -2, k)
    B[np.arange(1, k + 1), np.arange(k)] = 0.3
    bproj = rng.standard_normal(k + 1)
    delta = level * np.linalg.norm(bproj)
    lam_t = td.dp_lambda(B, bproj, delta, **CPU)
    lam_j = float(jd.dp_lambda(jnp.asarray(B), jnp.asarray(bproj), delta))
    assert lam_j > 0
    assert float(lam_t) == pytest.approx(lam_j, rel=1e-10)


def test_dp_lambda_unattainable():
    """Irreducible residual above eta*delta: lam = 0 in both."""
    k = 6
    B = np.eye(k + 1)[:, :k]
    bproj = np.ones(k + 1)
    lam_t = td.dp_lambda(B, bproj, 1e-6, **CPU)
    lam_j = float(jd.dp_lambda(jnp.asarray(B), jnp.asarray(bproj), 1e-6))
    assert float(lam_t) == lam_j == 0.0


def _spectra(seed):
    """tests/test_device_regparam.py's ill-posed systems: bhat of the SVD
    and of the GSVD with a square first-difference L."""
    r = np.random.default_rng(seed)
    m, n = 24, 18
    U0, _ = np.linalg.qr(r.standard_normal((m, m)))
    V0, _ = np.linalg.qr(r.standard_normal((n, n)))
    A = U0[:, :n] * np.geomspace(1, 1e-6, n) @ V0.T
    b = (A @ r.standard_normal(n) + 1e-3 * r.standard_normal(m))
    U, _, _ = np.linalg.svd(A)
    L = np.eye(n) - np.diag(np.ones(n - 1), 1)
    Ug, _, X, _, _ = gsvd(A, L)
    return (U.T @ b, (Ug.T @ b).reshape(-1), n, X.shape[1], L.shape[0],
            1e-3 * np.sqrt(m))


@pytest.mark.parametrize("seed", range(4))
def test_truncation_walks_equal_jax(seed):
    bhat, bh_g, n, ng, p, delta = _spectra(seed)
    for d in (delta, 1e9, 0.0):
        assert int(td.dp_tsvd_k(bhat, n, d, **CPU)) == int(
            jd.dp_tsvd_k(jnp.asarray(bhat), n, d))
        assert int(td.dp_tgsvd_k(bh_g, ng, d, **CPU)) == int(
            jd.dp_tgsvd_k(jnp.asarray(bh_g), ng, d))
    assert int(td.gcv_tsvd_k(bhat, n, **CPU)) == int(
        jd.gcv_tsvd_k(jnp.asarray(bhat), n))
    assert int(td.gcv_tgsvd_k(bh_g, ng, p, **CPU)) == int(
        jd.gcv_tgsvd_k(jnp.asarray(bh_g), ng, p))
    # the zero-denominator edge of the TGSVD GCV (p - i - 1 = 0 inside)
    assert int(td.gcv_tgsvd_k(bh_g, ng, ng - 3, **CPU)) == int(
        jd.gcv_tgsvd_k(jnp.asarray(bh_g), ng, ng - 3))
