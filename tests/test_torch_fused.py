"""trips_tpu_torch.solvers.fused against trips_tpu.solvers.fused on the CPU.

Float64 on ``tests/test_fused.py``'s Blur1D problem (n = 80, 2% noise),
the port's ``DenseOperator`` made from the JAX operator's matrix: every
fused solver (GKS, MMGKS, Hybrid LSQR, Hybrid GMRES) with every lam rule
(GCV, DP, L-curve, a scalar). Both packages run the same masked
recurrences; the products and the k x k factorizations run in another
BLAS/LAPACK order, so the last bits differ, and Brent stops anywhere
within sqrt(eps) |lam| of the minimum:

- the final iterate agrees to 1e-7 relative (measured at most 7.9e-9,
  Hybrid GMRES with the L-curve);
- lam from DP agrees to 1e-9 (measured 3.2e-12), from the L-curve to 1e-5
  (measured 8.1e-8), from GCV to 1e-4 wherever JAX's lam is at least
  1e-4 (measured 8.3e-6, the hybrid's modified GCV, flat at 80 rows
  against k <= 12 columns). Below 1e-4 GCV's curve has a flat bottom where
  two correct runs stop up to 1.5x apart (``tests/test_torch_solvers.py``'s
  ``LAM_FLAT``): there only the iterates are held. A scalar is exact;
- GKS's and MMGKS's residual histories (the reorthogonalized gradient
  norm, which falls 1000x in 10 iterations) agree to 1e-5 (measured
  2.2e-6, at 4e-5).

In float32 (the card's precision) every combination tracks its own
float64 run on ``tests/test_fused.py``'s Deblurring1D problem as that
file holds JAX's float32 runs: the last lam within 2x and the error
within 4x. Where either lam is 0 both must be below 1e-6: Hybrid LSQR's DP
sits at its attainability edge from iteration 11 on, where rounding
decides the sign of the test (JAX's own float64 run alternates between 0
and ~1e-7 there, its float32 run too) and a lam that small moves no
iterate (the error check holds that). The fixed projected pencil's
float32 GCV finds the float64 interior minimizer within 10%. The JAX package's float32
runs need x64 off (with x64 on it searches a float32 pencil in float64),
so the port's float32 runs are held to its own float64 runs here.

Two deliberate departures from JAX's float32 arithmetic, the same values
in exact arithmetic (so the float64 comparisons above hold them too),
are pinned at the end: DP's out-of-subspace energy is summed as an
explicit residual, not as ||b||^2 - ||bproj||^2, and a square pencil's
filtered residual (0) is not computed from the SVD's rounding.

The dynamic MMGKS (isotropic TV and group sparsity) runs on a small
``DynamicBandedOperator`` (32x32, 4 frames, 9 views: padded angles) in
float64 against JAX's on the same matrices: iterates to 1e-5 (measured
3.2e-7: both apply the float32 pack), relError to 1e-6; GCV's lam lies on
its flat bottom (1e-9..1e-7) and is not held. In float32 with lam fixed
they are held against JAX's with x64 off. The ``*_info`` adapters
run the plain solvers' bodies: the same tensors, bitwise.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trips_tpu.solvers.fused as jf
import trips_tpu_torch.solvers.fused as tf
from trips_tpu.core import DenseOperator as JaxDense
from trips_tpu.operators import Blur1D
from trips_tpu.operators import FirstDerivative1D as JaxD1
from trips_tpu_torch.core import DenseOperator
from trips_tpu_torch.operators import CenteredSpaceTimeDerivative
from trips_tpu_torch.operators import FirstDerivative1D
from trips_tpu_torch.solvers import fused_info as ti

from torch_threads import one_torch_thread  # noqa: F401

CPU = {"device": "cpu"}
MODES = ["gcv", "dp", "l_curve", "scalar"]
SOLVERS = ["gks", "mmgks", "hlsqr", "hgmres"]
X_RTOL = 1e-7
LAM_RTOL = {"dp": 1e-9, "l_curve": 1e-6, "gcv": 1e-4, "scalar": 0.0}
LAM_FLAT = 1e-4
RES_RTOL = 1e-5


def _blur_problem():
    """tests/test_fused.py:12's problem."""
    n = 80
    rng = np.random.default_rng(7)
    A = np.asarray(Blur1D(n, 4.0).mat)
    h = np.pi / n
    g = -np.pi / 2 + np.arange(0.5, n, 1) * h
    x_true = 2 * np.exp(-6 * (g - 0.8) ** 2) + np.exp(-2 * (g + 0.5) ** 2)
    b_true = A @ x_true
    e = rng.standard_normal(n)
    b = b_true + 0.02 * np.linalg.norm(b_true) / np.linalg.norm(e) * e
    return A, x_true, b, float(np.linalg.norm(b - b_true))


@pytest.fixture(scope="module")
def blur():
    A, x_true, b, delta = _blur_problem()
    return dict(A=A, x_true=x_true, b=b, delta=delta,
                jA=JaxDense(jnp.asarray(A)),
                tA=DenseOperator(torch.from_numpy(A.copy())))


def _call(pkg, solver, A, b, L, mode, delta, n_iter=None, **extra):
    """One fused solve of ``pkg`` (``jf`` or ``tf``)."""
    kw = dict(regparam_mode=mode, delta=delta, regparam=1e-2, **extra)
    if pkg is tf:
        kw.update(CPU)
    if solver == "gks":
        return pkg.fused_gks(A, b, L, projection_dim=3, n_iter=n_iter or 10,
                             **kw)
    if solver == "mmgks":
        return pkg.fused_mmgks(A, b, L, pnorm=2.0, qnorm=1.0,
                               projection_dim=3, n_iter=n_iter or 10, **kw)
    if solver == "hlsqr":
        return pkg.fused_hybrid_lsqr(A, b, n_iter=n_iter or 12, **kw)
    return pkg.fused_hybrid_gmres(A, b, n_iter=n_iter or 12, **kw)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("solver", SOLVERS)
def test_fused_f64_matches_jax(blur, solver, mode):
    n = len(blur["b"])
    t = _call(tf, solver, blur["tA"], blur["b"], FirstDerivative1D(n, **CPU),
              mode, blur["delta"])
    j = _call(jf, solver, blur["jA"], jnp.asarray(blur["b"]), JaxD1(n), mode,
              blur["delta"])
    tx, tl = t[0], t[1]
    jx, jl = np.asarray(j[0]), np.asarray(j[1])
    assert tx.dtype == torch.float64 and tx.shape == jx.shape
    assert tl.shape == jl.shape
    assert (np.linalg.norm(tx.numpy() - jx) / np.linalg.norm(jx)) <= X_RTOL
    held = jl >= LAM_FLAT
    np.testing.assert_allclose(tl.numpy()[held], jl[held],
                               rtol=LAM_RTOL[mode], atol=0)
    if len(t) == 3:  # GKS/MMGKS: the residual histories too
        np.testing.assert_allclose(t[2].numpy(), np.asarray(j[2]),
                                   rtol=RES_RTOL)


@pytest.mark.parametrize("solver", SOLVERS)
def test_fused_on_port_blur1d_matches_jax(solver):
    """The port's own Deblurring1D and Blur1D (its reversed-PSF rmatvec,
    not mat.T) build ``_blur_problem``'s operator; held against JAX's
    Blur1D as ``test_fused_f64_matches_jax`` holds the dense one (GCV)."""
    import trips_tpu_torch.problems as tp

    A, x_true, b, delta = _blur_problem()
    tA = tp.Deblurring1D(dtype=torch.float64, **CPU).forward_Op_1D(4.0, 80)
    jA = Blur1D(80, 4.0)
    assert np.array_equal(tA.mat.numpy(), A)
    assert np.array_equal(tA._adj.numpy(), np.asarray(jA._adj))
    n = len(b)
    t = _call(tf, solver, tA, torch.from_numpy(b), FirstDerivative1D(n, **CPU),
              "gcv", delta)
    j = _call(jf, solver, jA, jnp.asarray(b), JaxD1(n), "gcv", delta)
    tx, jx = t[0].numpy(), np.asarray(j[0])
    assert np.linalg.norm(tx - jx) / np.linalg.norm(jx) <= X_RTOL
    jl = np.asarray(j[1])
    held = jl >= LAM_FLAT
    np.testing.assert_allclose(t[1].numpy()[held], jl[held],
                               rtol=LAM_RTOL["gcv"], atol=0)


@pytest.fixture(scope="module")
def deblur():
    """tests/test_fused.py:304's problem: Deblurring1D(30, 200), curve0,
    2% Gaussian noise after np.random.seed(11)."""
    from trips_tpu.problems import Deblurring1D

    np.random.seed(11)
    prob = Deblurring1D()
    A = np.asarray(prob.forward_Op_1D(30, 200).mat)
    x_true = prob.gen_xtrue(200, "curve0")
    b, delta = prob.add_noise(prob.gen_data(x_true), "Gaussian", 0.02)
    return dict(A=A, x_true=np.asarray(x_true).ravel(),
                b=np.asarray(b).reshape(-1), delta=float(delta))


def _deblur_run(d, solver, mode, dtype):
    A = DenseOperator(torch.tensor(d["A"], dtype=dtype))
    b = torch.tensor(d["b"], dtype=dtype)
    n_iter = 15 if solver in ("gks", "mmgks") else 20
    out = _call(tf, solver, A, b, FirstDerivative1D(200, **CPU), mode,
                d["delta"], n_iter=n_iter)
    x, lams = out[0], out[1]
    assert x.dtype == dtype
    assert torch.isfinite(x).all() and torch.isfinite(lams).all()
    err = float(np.linalg.norm(x.double().numpy() - d["x_true"])
                / np.linalg.norm(d["x_true"]))
    return err, float(lams[-1])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("solver", SOLVERS)
def test_fused_f32_tracks_f64(deblur, solver, mode):
    e32, l32 = _deblur_run(deblur, solver, mode, torch.float32)
    e64, l64 = _deblur_run(deblur, solver, mode, torch.float64)
    assert e32 < 4 * max(e64, 0.05), (e32, e64)
    if l64 == 0.0 or l32 == 0.0:
        assert max(l32, l64) < 1e-6, (l32, l64)
    else:
        assert 0.5 < l32 / l64 < 2.0, (l32, l64)


def test_fused_f32_gcv_fixed_pencil():
    """tests/test_fused.py:224-240: the masked GCV selector finds the same
    interior minimizer in float32 as in float64 (the solve-based form
    collapsed to the 1e-9 boundary in float32)."""
    k = 24
    rng = np.random.default_rng(3)
    s = np.logspace(0, -6, k)
    bp = s * 1.0 + 1e-3 * rng.standard_normal(k)
    lam = {}
    for dt in (torch.float64, torch.float32):
        active = torch.ones(k, dtype=torch.bool)
        lam[dt] = tf._gcv_lambda_masked(
            torch.tensor(np.diag(s), dtype=dt), torch.eye(k, dtype=dt),
            torch.tensor(bp, dtype=dt), float(k), active)
        assert lam[dt].dtype == dt
    lam64, lam32 = float(lam[torch.float64]), float(lam[torch.float32])
    assert 1e-8 < lam64 < 1e2
    np.testing.assert_allclose(lam32, lam64, rtol=0.1)


@pytest.fixture(scope="module")
def dynamic():
    import trips_tpu.problems as jp
    from trips_tpu.sparse.dynamic_banded import DynamicBandedOperator as JDyn
    from trips_tpu_torch.sparse import DynamicBandedOperator

    old = os.environ.get("TRIPS_TPU_NO_NATIVE")
    os.environ["TRIPS_TPU_NO_NATIVE"] = "1"
    try:
        A, b, AA, B, nx, ny, nt, delta, x_true, al = \
            jp.generate_synthetic_dynamic(nx=32, nt=4, views=9,
                                          noise_level=0.01,
                                          return_angles=True)
    finally:
        if old is None:
            os.environ.pop("TRIPS_TPU_NO_NATIVE")
        else:
            os.environ["TRIPS_TPU_NO_NATIVE"] = old
    return dict(b=b.astype(np.float64), x_true=x_true, dims=(nx, ny, nt),
                frames=(AA, nx, al),
                jop=JDyn.from_frames(AA, nx, al, n_groups=8),
                top=DynamicBandedOperator.from_frames(AA, nx, al, n_groups=8,
                                                      **CPU))


@pytest.mark.parametrize("weight_mode", ["isoTV", "GS"])
def test_fused_mmgks_dynamic_banded_matches_jax(dynamic, weight_mode):
    import trips_tpu.operators as jo

    nx, ny, nt = dims = dynamic["dims"]
    kw = dict(pnorm=2.0, qnorm=1.0, projection_dim=4, n_iter=8,
              regparam_mode="gcv", weight_mode=weight_mode, prob_dims=dims)
    iso = weight_mode == "isoTV"
    tx, tl, _ = tf.fused_mmgks(
        dynamic["top"], dynamic["b"],
        CenteredSpaceTimeDerivative(nx, ny, nt, **CPU) if iso else None,
        **kw, **CPU)
    jx, jl, _ = jf.fused_mmgks(
        dynamic["jop"], jnp.asarray(dynamic["b"]),
        jo.CenteredSpaceTimeDerivative(nx, ny, nt) if iso else None, **kw)
    jx = np.asarray(jx)
    assert tx.dtype == torch.float64 and tl.shape == jl.shape
    assert np.linalg.norm(tx.numpy() - jx) / np.linalg.norm(jx) <= 1e-5
    xt = dynamic["x_true"]
    err = [np.linalg.norm(x - xt) / np.linalg.norm(xt)
           for x in (tx.numpy(), jx)]
    assert abs(err[0] - err[1]) <= 1e-6 and err[0] < 0.5


@pytest.mark.parametrize("weight_mode", ["isoTV", "GS"])
def test_fused_mmgks_dynamic_float32_fixed_lambda_matches_jax(dynamic,
                                                              weight_mode):
    """The demo's float32 path with lam fixed (``regparam_mode="scalar"``,
    lam = 1, where the weights move the relError from 0.244 to 0.210-0.233)
    against JAX's with x64 off, as a TPU runs it: iterates to 1e-5
    (measured 1.0e-6), relError to 1e-6 (measured 1.1e-8)."""
    import jax

    import trips_tpu.operators as jo
    from trips_tpu.sparse.dynamic_banded import DynamicBandedOperator as JDyn

    nx, ny, nt = dims = dynamic["dims"]
    kw = dict(pnorm=2.0, qnorm=1.0, projection_dim=4, n_iter=8, regparam=1.0,
              regparam_mode="scalar", weight_mode=weight_mode,
              prob_dims=dims)
    iso = weight_mode == "isoTV"
    b32 = dynamic["b"].astype(np.float32)
    tx, tl, _ = tf.fused_mmgks(
        dynamic["top"], torch.from_numpy(b32),
        CenteredSpaceTimeDerivative(nx, ny, nt, **CPU) if iso else None,
        **kw, **CPU)
    with jax.enable_x64(False):
        jop = JDyn.from_frames(*dynamic["frames"], n_groups=8)
        jx, jl, _ = jf.fused_mmgks(
            jop, jnp.asarray(b32),
            jo.CenteredSpaceTimeDerivative(nx, ny, nt) if iso else None, **kw)
        jx, jl = np.asarray(jx), np.asarray(jl)
    assert tx.dtype == torch.float32 and jx.dtype == np.float32
    np.testing.assert_array_equal(tl.numpy(), jl)
    assert np.linalg.norm(tx.numpy() - jx) / np.linalg.norm(jx) <= 1e-5
    xt = dynamic["x_true"].reshape(-1)
    err = [np.linalg.norm(x.astype(np.float64) - xt) / np.linalg.norm(xt)
           for x in (tx.numpy(), jx)]
    assert abs(err[0] - err[1]) <= 1e-6


def test_info_adapters_match_plain(rng):
    """tests/test_fused.py's info test on the port: the adapters run the
    plain solvers' bodies, so x and the histories are the same tensors;
    the info dict carries the reference keys."""
    n = 40
    Ah = rng.standard_normal((n, n))
    x_true = np.sin(np.linspace(0, 3, n))
    b = torch.from_numpy(Ah @ x_true + 0.01 * rng.standard_normal(n))
    A = DenseOperator(torch.from_numpy(Ah))
    L = FirstDerivative1D(n, **CPU)
    xt = torch.from_numpy(x_true)
    for plain, wrapped in ((tf.fused_gks, ti.fused_gks_info),
                           (tf.fused_mmgks, ti.fused_mmgks_info)):
        x0, lam0, res0 = plain(A, b, L, n_iter=6, regparam_mode="gcv", **CPU)
        x1, info = wrapped(A, b, L, n_iter=6, regparam_mode="gcv",
                           x_true=x_true, **CPU)
        assert torch.equal(x1, x0)
        assert torch.equal(info["regParam_history"], lam0)
        assert torch.equal(info["Residual"], res0)
        assert info["xHistory"].shape == (6, n)
        assert torch.equal(info["xHistory"][-1], x0)
        assert "relResidual" not in info and info["its"] == 6
        assert float(info["relError"][-1]) == pytest.approx(
            float((x1 - xt).norm() / xt.norm()), rel=1e-12)
    for plain, wrapped, start in (
            (tf.fused_hybrid_lsqr, ti.fused_hybrid_lsqr_info, 1),
            (tf.fused_hybrid_gmres, ti.fused_hybrid_gmres_info, 0)):
        x0, lam0 = plain(A, b, n_iter=8, regparam_mode="gcv", **CPU)
        x1, info = wrapped(A, b, n_iter=8, regparam_mode="gcv", x_true=xt,
                           **CPU)
        assert torch.equal(x1, x0)
        assert torch.equal(info["regParam_history"], lam0[start:])
        assert (info["regParam_history"].shape == info["Residual"].shape
                == info["relResidual"].shape
                == (info["xHistory"].shape[0],)
                == info["relError"].shape == (8 - start,))
        assert torch.equal(info["xHistory"][-1], x0)
        # the projected residual identity: ||A x - b|| == ||B y - bhat||
        assert float(info["Residual"][-1]) == pytest.approx(
            float((A.matvec(x1) - b).norm()), rel=1e-6)


def test_info_adapters_match_jax(blur):
    """The adapters' histories against JAX's adapters (float64)."""
    from trips_tpu.solvers import fused_info as ji

    n = len(blur["b"])
    tx, tinfo = ti.fused_gks_info(blur["tA"], blur["b"],
                                  FirstDerivative1D(n, **CPU), n_iter=6,
                                  regparam_mode="dp", delta=blur["delta"],
                                  x_true=blur["x_true"], **CPU)
    jx, jinfo = ji.fused_gks_info(blur["jA"], jnp.asarray(blur["b"]),
                                  JaxD1(n), n_iter=6, regparam_mode="dp",
                                  delta=blur["delta"],
                                  x_true=jnp.asarray(blur["x_true"]))
    for key in ("xHistory", "regParam_history", "Residual", "relError"):
        np.testing.assert_allclose(tinfo[key].numpy(), np.asarray(jinfo[key]),
                                   rtol=1e-7, atol=1e-12, err_msg=key)
    assert tinfo["its"] == jinfo["its"]


def test_fused_arguments_checked():
    A = DenseOperator(torch.eye(4, dtype=torch.float64))
    b = torch.ones(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="regparam_mode"):
        tf.fused_gks(A, b, A, regparam_mode="bogus", **CPU)
    with pytest.raises(ValueError, match="weight_mode"):
        tf.fused_mmgks(A, b, A, weight_mode="bogus", **CPU)
    with pytest.raises(TypeError, match="prob_dims"):
        tf.fused_mmgks(A, b, A, weight_mode="isoTV", **CPU)
    with pytest.raises(ValueError, match="operator on"):
        tf.fused_gks(DenseOperator(torch.eye(4, device="meta")), b, A, **CPU)


def _energies(seed):
    """(truth, explicit, difference) of DP's out-of-subspace energy for a
    padded float32 panel whose QR is taken in float32, as in the solvers,
    with ||b||^2 1e6 times the residual's (tomo256x60's ratio)."""
    rng = np.random.default_rng(seed)
    m, K, k = 20000, 30, 20
    P = (rng.standard_normal((m, K)) * np.logspace(0, -3, K)).astype(
        np.float32)
    P[:, k:] = 0  # the padded panel: k active columns
    Q64 = np.linalg.qr(P[:, :k].astype(np.float64))[0]
    r = rng.standard_normal(m)
    r -= Q64 @ (Q64.T @ r)
    r *= 10.0 / np.linalg.norm(r)  # ||r||^2 = 100
    b = Q64 @ rng.standard_normal(k) * 1e4 / np.sqrt(k) + r
    truth = float(np.sum((b - Q64 @ (Q64.T @ b)) ** 2))
    QA = torch.linalg.qr(torch.from_numpy(P))[0]
    b32 = torch.tensor(b, dtype=torch.float32)
    bproj = (QA.T @ b32) * (torch.arange(K) < k)
    return (truth, float(tf._out_norm2(b32, QA, bproj)),
            float(torch.sum(b32**2) - torch.sum(bproj**2)))


def test_dp_out_of_subspace_energy_in_float32():
    """DP's attainability test compares the data energy outside the
    projected subspace with (eta delta)^2. The port sums the explicit
    residual ||b - QA bproj||^2, within 1e-4 of the float64 truth on every
    seed here; JAX's difference ||b||^2 - ||bproj||^2 cancels, and with
    QA's columns orthonormal to ~1e-6 only it is off by over 5% on some
    seeds (measured 12% to 100% off on five of six, the explicit form at
    most 6.6e-6)."""
    rows = [_energies(seed) for seed in range(6)]
    for truth, explicit, _ in rows:
        assert abs(explicit - truth) <= 1e-4 * truth
    assert max(abs(d - t) / t for t, _, d in rows) > 0.05


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_square_pencil_gcv_in_float32(seed):
    """A square pencil's filtered residual is 0: the port drops it, where
    JAX computes it and in float32 gets the SVD's rounding, which GCV
    divides by lam^2. On consistent data (GCV's minimum at small lam) the
    port's float32 lam is its float64 lam within 10% (JAX's float32 with
    x64 off: 7.8x above on seed 0, the lower bound 1e-9 in float64); a
    rectangular (hybrid) factor keeps its explicit residual."""
    k = 24
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((k, k)))[0]
    R_A = np.linalg.qr(Q @ np.diag(np.logspace(0, -3, k)))[1]
    bp = R_A @ rng.standard_normal(k)
    lam = {}
    for dt in (torch.float64, torch.float32):
        args = [torch.tensor(a, dtype=dt) for a in (R_A, np.eye(k), bp)]
        active = torch.ones(k, dtype=torch.bool)
        assert float(tf._filtered_pencil(*args, active)[2]) == 0.0
        lam[dt] = float(tf._gcv_lambda_masked(*args, float(k), active))
    np.testing.assert_allclose(lam[torch.float32], lam[torch.float64],
                               rtol=0.1)
    B = torch.tensor(np.vstack([R_A, rng.standard_normal((1, k))]))
    b = torch.tensor(rng.standard_normal(k + 1))
    rest2 = float(tf._filtered_pencil(B, torch.eye(k, dtype=B.dtype), b,
                                      torch.ones(k, dtype=torch.bool))[2])
    U = np.linalg.svd(B.numpy(), full_matrices=False)[0]
    r = b.numpy() - U @ (U.T @ b.numpy())
    assert rest2 == pytest.approx(float(r @ r), rel=1e-10)
