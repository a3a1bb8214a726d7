"""trips_tpu_torch.solvers against trips_tpu.solvers on the CPU.

Float64 on dense operators: the ``deblur1d`` problem of
``tests/test_solvers.py`` and a small dynamic problem (three frames of a
6x6 image under one random blur-like block). Both packages run the same
recurrences in float64 and the same host NumPy/SciPy code on the projected
systems, with the same ``its`` and ``matvec_count``. The large products run
in another BLAS (torch's against XLA's), so the Krylov bases and projected
factors differ in the last bits (4e-15 relative for the bidiagonal), and
the projected solves amplify that:

- every entry of ``xHistory`` agrees to 1e-6 relative (``X_RTOL``; measured
  at most 1.8e-7, in the GS case, and 6.5e-8 for GKS with DP);
- lam from the discrepancy principle agrees to 1e-8 (measured 1.0e-9), from
  the L-curve to 1e-6 (measured 3.1e-7), a scalar exactly;
- lam from GCV agrees to 1e-6 relative wherever it is at least 1e-4
  (``LAM_FLAT``; measured at most 5.8e-7). Below that, Brent's method stops
  anywhere in the flat bottom of the GCV curve: lam is too small to move
  the filter factors, and two runs on bidiagonals 4e-15 apart choose lam
  up to 1.5x apart (1e-9..1e-5) while their iterates agree to 1e-7. There
  only the iterates are held.

The tomography demo's solvers in float32 on the banded operator are in
``tests/test_torch_demo_solvers.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trips_tpu.operators as jo
import trips_tpu.solvers as js
import trips_tpu_torch.operators as to
import trips_tpu_torch.solvers as ts
from trips_tpu.core import DenseOperator as JaxDense
from trips_tpu.core import IdentityOperator as JaxIdentity
from trips_tpu_torch.core import DenseOperator, IdentityOperator

from torch_threads import one_torch_thread  # noqa: F401

X_RTOL = 1e-6
LAM_RTOL = {"dp": 1e-8, "l_curve": 1e-6, "gcv": 1e-6}
LAM_FLAT = 1e-4
REGPARAMS = ["gcv", "dp", "l_curve", 0.01]


def curve0(n):
    """Reference gen_xtrue 'curve0' (Deblurring1D.py:158-165)."""
    h = np.pi / n
    grid = -np.pi / 2 + np.arange(0.5, n, 1) * h
    return 2 * np.exp(-6 * (grid - 0.8) ** 2) + np.exp(-2 * (grid + 0.5) ** 2)


@pytest.fixture(scope="module")
def deblur1d():
    """tests/test_solvers.py's problem: Blur1D(100, 5.0), 2% noise."""
    n = 100
    rng = np.random.default_rng(42)
    A = np.asarray(jo.Blur1D(n, 5.0).mat)
    x_true = curve0(n)
    b_true = A @ x_true
    e = rng.standard_normal(n)
    sig = 0.02 * np.linalg.norm(b_true) / np.linalg.norm(e)
    return dict(A=A, jA=JaxDense(jnp.asarray(A)),
                tA=DenseOperator(torch.from_numpy(A.copy())), x_true=x_true,
                b=b_true + sig * e, delta=float(np.linalg.norm(sig * e)), n=n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _rel(a, b):
    a, b = _np(a).reshape(-1), _np(b).reshape(-1)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _same_lam(tlam, jlam, regparam):
    tlam, jlam = np.asarray(tlam, float), np.asarray(jlam, float)
    assert tlam.shape == jlam.shape
    if regparam not in LAM_RTOL:  # a scalar
        assert np.array_equal(tlam, jlam)
        return
    held = jlam >= LAM_FLAT if regparam == "gcv" else np.ones_like(jlam, bool)
    np.testing.assert_allclose(tlam[held], jlam[held],
                               rtol=LAM_RTOL[regparam], atol=0)


def _same(t, j, regparam):
    """(x, info) pairs: the final x, every iterate and every lam."""
    (tx, ti), (jx, ji) = t, j
    assert tx.dtype == torch.float64 and tx.shape == jx.shape
    assert _rel(tx, jx) <= X_RTOL
    assert ti["its"] == ji["its"]
    _same_lam(ti["regParam_history"], ji["regParam_history"], regparam)
    assert len(ti["xHistory"]) == len(ji["xHistory"])
    for a, b in zip(ti["xHistory"], ji["xHistory"]):
        assert _rel(a, b) <= X_RTOL
    if "matvec_count" in ji:
        assert ti["matvec_count"] == ji["matvec_count"]


@pytest.mark.parametrize("regparam", REGPARAMS)
@pytest.mark.parametrize("name", ["Hybrid_LSQR", "Hybrid_GMRES"])
def test_hybrid_matches_jax(deblur1d, name, regparam):
    d = deblur1d
    kw = dict(n_iter=12, regparam=regparam, delta=d["delta"],
              x_true=d["x_true"])
    t = getattr(ts, name)(d["tA"], d["b"], **kw)
    j = getattr(js, name)(d["jA"], d["b"], **kw)
    _same(t, j, regparam)
    np.testing.assert_allclose(t[1]["relError"], j[1]["relError"],
                               rtol=X_RTOL)


@pytest.mark.parametrize("reorth", [False, True])
@pytest.mark.parametrize("name,n_iter,count,its", [
    ("Hybrid_LSQR", 60, 2 * 8, 1), ("Hybrid_GMRES", 40, 8, 1)])
def test_hybrid_dp_stop_matches_jax(deblur1d, name, n_iter, count, its,
                                    reorth):
    """dp_stop extends the factorization in chunks of gk_chunk steps and
    stops at the first regularized DP iteration (the reference's quirk):
    one chunk of applies."""
    d = deblur1d
    kw = dict(n_iter=n_iter, regparam="dp", delta=d["delta"], dp_stop=True,
              gk_chunk=8, reorth=reorth)
    t = getattr(ts, name)(d["tA"], d["b"], **kw)
    j = getattr(js, name)(d["jA"], d["b"], **kw)
    _same(t, j, "dp")
    assert t[1]["matvec_count"] == count and t[1]["its"] == its


@pytest.mark.parametrize("regparam", REGPARAMS)
def test_gks_first_derivative_matches_jax(deblur1d, regparam):
    d = deblur1d
    kw = dict(projection_dim=3, n_iter=10, regparam=regparam,
              delta=d["delta"], x_true=d["x_true"])
    t = ts.GKS(d["tA"], d["b"], to.FirstDerivative1D(d["n"], device="cpu"),
               **kw)
    j = js.GKS(d["jA"], d["b"], jo.FirstDerivative1D(d["n"]), **kw)
    _same(t, j, regparam)
    # the normal-equations residual falls by cancellation to ~1e-4 of its
    # first value, where the last bits of the bases show: held to 1e-6 of
    # its largest entry
    res = np.asarray(j[1]["Residual"])
    np.testing.assert_allclose(t[1]["Residual"], res, rtol=0,
                               atol=X_RTOL * res.max())


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("regparam", ["gcv", "dp", 0.05])
def test_gks_identity_matches_jax(deblur1d, regparam, strict):
    """L = I takes the SVD path; ``strict_reference`` keeps the reference's
    missing rotation (the deviation tests/test_deviations.py pins)."""
    d = deblur1d
    kw = dict(projection_dim=3, n_iter=8, regparam=regparam,
              delta=d["delta"], strict_reference=strict)
    t = ts.GKS(d["tA"], d["b"], IdentityOperator(d["n"], device="cpu"), **kw)
    j = js.GKS(d["jA"], d["b"], JaxIdentity(d["n"]), **kw)
    _same(t, j, regparam)


@pytest.mark.parametrize("regparam", ["gcv", "dp", 0.05])
def test_mmgks_matches_jax(deblur1d, regparam):
    d = deblur1d
    kw = dict(pnorm=2, qnorm=1, projection_dim=3, n_iter=8,
              regparam=regparam, delta=d["delta"], x_true=d["x_true"])
    t = ts.MMGKS(d["tA"], d["b"], to.FirstDerivative1D(d["n"], device="cpu"),
                 **kw)
    j = js.MMGKS(d["jA"], d["b"], jo.FirstDerivative1D(d["n"]), **kw)
    _same(t, j, regparam)


@pytest.fixture(scope="module")
def own_blur():
    """The deblur1d problem built by each package's own Deblurring1D:
    Blur1D(100, 5.0), whose rmatvec is the reversed-PSF matrix (not
    mat.T), curve0, 2% noise after np.random.seed(42)."""
    import trips_tpu.problems as jp
    import trips_tpu_torch.problems as tp

    out = {}
    for key, pkg, kw in (("j", jp, {}), ("t", tp, dict(
            dtype=torch.float64, device="cpu"))):
        np.random.seed(42)
        prob = pkg.Deblurring1D(**kw)
        out[key + "A"] = prob.forward_Op_1D(5.0, 100)
        x_true = prob.gen_xtrue(100, "curve0")
        b, delta = prob.add_noise(prob.gen_data(x_true), "Gaussian", 0.02)
        out[key + "b"] = np.asarray(b).reshape(-1)
    assert np.array_equal(out["tb"], out["jb"])
    assert np.array_equal(out["tA"]._adj.numpy(), np.asarray(out["jA"]._adj))
    return dict(out, x_true=x_true, delta=float(delta), n=100)


@pytest.mark.parametrize("name", ["Hybrid_LSQR", "Hybrid_GMRES", "GKS",
                                  "MMGKS"])
def test_solvers_on_port_blur1d_match_jax(own_blur, name):
    """The port's own Blur1D (its reversed-PSF rmatvec included) against
    JAX's Blur1D, GCV, float64: every iterate to 1e-6 as above; lam from
    LAM_FLAT up to 1e-4 relative (measured at most 6.1e-5, GKS): with the pseudo-adjoint
    the bases lose orthogonality faster, and GCV's minimum is flat enough
    there that lam moves while the iterates agree to 1e-6."""
    d = own_blur
    kw = dict(n_iter=8, regparam="gcv", x_true=d["x_true"])
    if name in ("GKS", "MMGKS"):
        kw["projection_dim"] = 3
        targs = (to.FirstDerivative1D(d["n"], device="cpu"),)
        jargs = (jo.FirstDerivative1D(d["n"]),)
    else:
        targs = jargs = ()
    (tx, ti) = getattr(ts, name)(d["tA"], torch.from_numpy(d["tb"]), *targs,
                                 **kw)
    (jx, ji) = getattr(js, name)(d["jA"], d["jb"], *jargs, **kw)
    assert tx.dtype == torch.float64 and _rel(tx, jx) <= X_RTOL
    assert ti["its"] == ji["its"]
    for a, b in zip(ti["xHistory"], ji["xHistory"], strict=True):
        assert _rel(a, b) <= X_RTOL
    tl, jl = (np.asarray(i["regParam_history"]) for i in (ti, ji))
    held = jl >= LAM_FLAT
    np.testing.assert_allclose(tl[held], jl[held], rtol=1e-4)


@pytest.fixture(scope="module")
def dynamic():
    """Three frames of a 6x6 image, each blurred by one random block with
    decaying singular values, 1% noise."""
    nx = ny = 6
    nt = 3
    rng = np.random.default_rng(5)
    U, _ = np.linalg.qr(rng.standard_normal((30, 30)))
    V, _ = np.linalg.qr(rng.standard_normal((36, 30)))
    B = U @ np.diag(np.logspace(0, -2, 30)) @ V.T
    A = np.kron(np.eye(nt), B)
    g = np.linspace(-1, 1, nx)
    x_true = np.concatenate([
        np.exp(-4 * ((g[:, None] - 0.2 * t) ** 2 + g[None, :] ** 2)).ravel()
        for t in range(nt)])
    b_true = A @ x_true
    e = rng.standard_normal(b_true.size)
    b = b_true + 0.01 * np.linalg.norm(b_true) / np.linalg.norm(e) * e
    return dict(A=A, b=b, x_true=x_true, dims=(nx, ny, nt))


@pytest.mark.parametrize("mode", ["isoTV", "GS"])
def test_mmgks_dynamic_modes_match_jax(dynamic, mode):
    d = dynamic
    nx, ny, nt = d["dims"]
    kw = dict(pnorm=2, qnorm=1, projection_dim=3, n_iter=6, regparam="gcv",
              prob_dims=d["dims"], x_true=d["x_true"], **{mode: mode})
    tL = jL = None
    if mode == "isoTV":
        tL = to.CenteredSpaceTimeDerivative(nx, ny, nt, device="cpu")
        jL = jo.CenteredSpaceTimeDerivative(nx, ny, nt)
    t = ts.MMGKS(DenseOperator(torch.from_numpy(d["A"])), d["b"], tL, **kw)
    j = js.MMGKS(JaxDense(jnp.asarray(d["A"])), d["b"], jL, **kw)
    _same(t, j, "gcv")


@pytest.mark.parametrize("regparam", ["gcv", "dp", 0.01])
@pytest.mark.parametrize("name,n_iter", [("Arnoldi_Tikhonov", 8),
                                         ("Golub_Kahan_Tikhonov", 3)])
def test_projection_solvers_match_jax(deblur1d, name, n_iter, regparam):
    d = deblur1d
    kw = dict(n_iter=n_iter, regparam=regparam, delta=d["delta"])
    tx, tlam = getattr(ts, name)(d["tA"], d["b"], **kw)
    jx, jlam = getattr(js, name)(d["jA"], d["b"], **kw)
    assert tx.dtype == torch.float64 and tx.shape == jx.shape
    _same_lam([tlam], [jlam], regparam)
    assert _rel(tx, jx) <= X_RTOL


def test_gmres_matches_jax(deblur1d):
    d = deblur1d
    tx = ts.GMRES(d["tA"], d["b"], n_iter=5)
    jx = js.GMRES(d["jA"], d["b"], n_iter=5)
    assert tx.shape == jx.shape and _rel(tx, jx) <= X_RTOL

