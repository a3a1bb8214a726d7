"""The demo twins against the JAX demos, live, in float64 on the CPU.

Each twin's own ``problem`` (or builder) makes its inputs, which must
equal the JAX demo's made the JAX demo's way (the same seed and calls;
``demos/demo_fused_tpu.py``'s builders are imported and called). Then the
twin's own ``solves`` run through ``trips_tpu_torch`` in float64 and the
JAX demo's solver calls through ``trips_tpu`` in float64 (x64 on) on the
same data, and each final iterate is held to JAX's. A banded pack stores
float32 or bfloat16 only, so where a twin runs one on the card, the
port's float64 run takes the host matrix as a ``CsrOperator`` and JAX's
its demo's sparse operator (as ``tests/test_torch_support2.py`` holds
the L-curve twin); the tomo configuration of ``demo_fused_tpu`` checks its
data and the bfloat16 pack's matrix against JAX's. The fused dynamic
twin's kill/resume must end bit for bit on its whole run, and that run
at JAX's checkpointed run's iterate.

Tolerances, relative to JAX's iterate (the products and the k x k
factorizations run in another BLAS/LAPACK order; torch on one intra-op
thread):

- ``X_RTOL`` = 1e-10 where lam is fixed by DP or a direct rule (TSVD,
  TGSVD and Tikhonov also with k and lam equal as printed; measured at
  most 3.7e-13, the 1D demo's GKS);
- ``SEARCH_RTOL`` = 1e-7 where lam comes from a GCV or L-curve search,
  which stops anywhere within sqrt(eps) |lam| of its minimum (measured at
  most 2.6e-8, the dynamic demo's static per-frame MMGKS).

The float32 runs of the twins' ``main``, against the JAX demos' float32
relErrors, are ``tests/test_torch_demos.py``.
"""
import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import torch

import trips_tpu.operators as jo
import trips_tpu.problems as jp
import trips_tpu.solvers as js
from trips_tpu_torch.demos import (demo_1d_deblurring, demo_2d_deblurring,
                                   demo_dynamic_ct, demo_fused_dynamic,
                                   demo_fused_tpu, demo_saved_data,
                                   demo_tomography, demo_your_data)
from trips_tpu_torch.sparse import CsrOperator

import torch_saved_bundles
from torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64
X_RTOL, SEARCH_RTOL = 1e-10, 1e-7


def _x(x):
    if isinstance(x, torch.Tensor):
        return x.double().numpy().reshape(-1)
    return np.asarray(x, np.float64).reshape(-1)


def _rel(a, b):
    a, b = _x(a), _x(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _searched(name):
    return "gcv" in name or "l_curve" in name


def _held(runs, jax_runs, searched=_searched):
    """Run the twin's solves and compare each with JAX's (x, second): a
    name with ``{}`` (k, lam) prints the same from both."""
    assert list(runs) == list(jax_runs)
    for name, solve in runs.items():
        x, second = solve()
        jx, jsecond = jax_runs[name]
        assert x.dtype == F64, name
        assert name.format(second) == name.format(jsecond), name
        tol = SEARCH_RTOL if searched(name) else X_RTOL
        assert _rel(x, jx) <= tol, (name, _rel(x, jx))


def _jax_demo(name):
    """A module of ``demos/`` (its ``_bootstrap`` keeps JAX on the CPU)."""
    path = os.path.join(os.path.dirname(__file__), "..", "demos",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, os.path.dirname(path))
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(os.path.dirname(path))
    return mod


def test_demo_tomography_matches_jax():
    """16x16 tectonic, 12 views, 1% noise, 8 iterations: TSVD, GKS,
    Hybrid LSQR and MMGKS with DP."""
    n, views, iters = 16, 12, 8
    OP, b, delta, x_true, A = demo_tomography.problem(n, views, "tectonic",
                                                      0.01, "cpu")
    np.random.seed(0)
    jt = jp.Tomography(CommitCrime=False)
    jx_true, nx, ny = jt.gen_true("tectonic", nx=n, ny=n, phantom_seed=0)
    jOP, jb, _, _, jA = jt.gen_data(jx_true, nx, ny, views)
    jb, jdelta = jt.add_noise(jb, "Gaussian", 0.01)
    jb = np.asarray(jb).reshape(-1)
    assert np.array_equal(x_true, jx_true) and float(jdelta) == delta
    assert np.array_equal(b, jb) and (A != jA).nnz == 0
    runs = demo_tomography.solves(
        CsrOperator.from_scipy(A, dtype=F64, device="cpu"),
        torch.from_numpy(b), A, b, delta, n, iters, F64, x_true)
    L = jo.FirstDerivative2D(nx, ny)
    jax_runs = {
        "TSVD (dp, k={})": js.tSVD_sol(jA.toarray(), jb, regparam="dp",
                                       delta=delta),
        "GKS (dp)": js.GKS(jOP, jb, L, projection_dim=3, n_iter=iters,
                           regparam="dp", delta=delta, x_true=jx_true),
        "Hybrid LSQR (dp)": js.Hybrid_LSQR(jOP, jb, n_iter=iters,
                                           regparam="dp", delta=delta,
                                           reorth=True),
        "MMGKS p2 q1 (dp)": js.MMGKS(jOP, jb, L, pnorm=2, qnorm=1,
                                     projection_dim=3, n_iter=iters,
                                     regparam="dp", delta=delta)}
    _held(runs, jax_runs)


def test_demo_1d_deblurring_matches_jax():
    """n = 200, parameter 10, 2% noise, 12 iterations: TSVD, TGSVD,
    Tikhonov with DP, Hybrid GMRES and Hybrid LSQR with DP on the total
    discrepancy, GKS with DP."""
    n, iters = 200, 12
    A, A_dense, b, delta, delta_total, x_true = demo_1d_deblurring.problem(
        n, 10.0, "cpu", F64)
    np.random.seed(0)
    prob = jp.Deblurring1D()
    jA = prob.forward_Op_1D(parameter=10.0, nx=n)
    jx_true = prob.gen_xtrue(n, "curve0")
    jb, jdelta = prob.add_noise(prob.gen_data(jx_true, parameter=10.0),
                                "Gaussian", 0.02)
    jb = np.asarray(jb).reshape(-1)
    jA_dense = np.asarray(jA.mat)
    assert np.array_equal(A_dense, jA_dense) and np.array_equal(b, jb)
    assert np.array_equal(x_true, jx_true) and float(jdelta) == delta
    assert delta_total == float(np.linalg.norm(jb - jA_dense @ jx_true))
    runs = demo_1d_deblurring.solves(A, A_dense, b, delta, delta_total,
                                     iters)
    L_sq = np.vstack([jo.first_derivative_matrix(n).toarray(),
                      np.zeros((1, n))])
    jax_runs = {
        "TSVD (dp, k={})": js.tSVD_sol(jA_dense, jb, regparam="dp",
                                       delta=delta),
        "TGSVD (dp, k={})": js.tGSVD_sol(jA_dense, L_sq, jb, regparam="dp",
                                         delta=delta),
        "Tikhonov (dp, lam={:.2e})": js.Tikhonov(
            jA_dense, jb, np.eye(n), regparam="dp", delta=delta),
        "Hybrid GMRES (dp)": js.Hybrid_GMRES(
            jA, jb, n_iter=iters, regparam="dp", delta=delta_total,
            reorth=True),
        "Hybrid LSQR (dp)": js.Hybrid_LSQR(
            jA, jb, n_iter=iters, regparam="dp", delta=delta_total,
            reorth=True),
        "GKS (dp)": js.GKS(jA, jb, jo.FirstDerivative1D(n), projection_dim=3,
                           n_iter=iters, regparam="dp", delta=delta)}
    _held(runs, jax_runs)


def test_demo_2d_deblurring_matches_jax():
    """24x24 h_im, (3, 3) PSF of spread (1, 1), 1% noise, 8 iterations:
    Arnoldi-Tikhonov with DP, Hybrid GMRES, Hybrid LSQR, GKS and MMGKS
    (derivative and framelet) with GCV."""
    n, iters = 24, 8
    A, b, delta, x_true = demo_2d_deblurring.problem(n, False, "cpu", F64)
    np.random.seed(0)
    prob = jp.Deblurring2D()
    jA = prob.forward_Op([3, 3], (1, 1), n, n)
    jx_true = prob.gen_true("h_im", nx=n, ny=n)
    jb, jdelta = prob.add_noise(prob.gen_data(jx_true.reshape(-1, 1)),
                                "Gaussian", 0.01)
    jb = np.asarray(jb).reshape(-1)
    assert np.array_equal(np.asarray(x_true), np.asarray(jx_true))
    assert np.array_equal(b, jb) and float(jdelta) == delta
    runs = demo_2d_deblurring.solves(A, b, delta, n, iters)
    L, W = jo.FirstDerivative2D(n, n), jo.FrameletOperator(n, n, 2)
    jax_runs = {
        "Arnoldi-Tikhonov (dp)": js.Arnoldi_Tikhonov(
            jA, jb, n_iter=8, regparam="dp", delta=delta),
        "Hybrid GMRES (gcv)": js.Hybrid_GMRES(jA, jb, n_iter=iters,
                                              regparam="gcv"),
        "Hybrid LSQR (gcv)": js.Hybrid_LSQR(jA, jb, n_iter=iters,
                                            regparam="gcv"),
        "GKS (gcv, derivative L)": js.GKS(jA, jb, L, projection_dim=3,
                                          n_iter=iters, regparam="gcv"),
        "MMGKS p2 q1 (derivative L)": js.MMGKS(
            jA, jb, L, pnorm=2, qnorm=1, projection_dim=3, n_iter=iters,
            regparam="gcv"),
        "MMGKS p2 q1 (framelet W)": js.MMGKS(
            jA, jb, W, pnorm=2, qnorm=1, projection_dim=3,
            n_iter=min(iters, 15), regparam="gcv")}
    _held(runs, jax_runs, searched=lambda name: "(dp)" not in name)


def test_demo_your_data_matches_jax():
    """32x32 h_im (no --image), (5, 5) PSF of spread (1.5, 1.5), 1% noise,
    GKS with GCV, 3 iterations."""
    n, iters = 32, 3
    A, b, delta, x_true = demo_your_data.problem(n, None, "cpu", F64)
    np.random.seed(0)
    prob = jp.Deblurring2D()
    jA = prob.forward_Op([5, 5], (1.5, 1.5), n, n)
    jx_true = prob.gen_true("h_im", nx=n, ny=n)
    jb, jdelta = prob.add_noise(
        prob.gen_data(np.asarray(jx_true).reshape(-1, 1)), "Gaussian", 0.01)
    jb = np.asarray(jb).reshape(-1)
    assert np.array_equal(np.asarray(x_true), np.asarray(jx_true))
    assert np.array_equal(b, jb) and float(jdelta) == delta
    runs = demo_your_data.solves(A, b, n, iters)
    jax_runs = {"GKS (gcv)": js.GKS(jA, jb, jo.FirstDerivative2D(n, n),
                                    projection_dim=3, n_iter=iters,
                                    regparam="gcv")}
    _held(runs, jax_runs)


def test_demo_saved_data_matches_jax(tmp_path, monkeypatch):
    """``tests/torch_saved_bundles.py``'s head/CT200 bundles (8x8, 72
    rays), 4 iterations: GKS with lam = 1 and MMGKS with lam = 1e-3 on the
    matrix as an ``EllOperator``."""
    from trips_tpu.sparse import EllOperator as JaxEll

    iters = 4
    torch_saved_bundles.write(tmp_path)
    monkeypatch.chdir(tmp_path)
    op, b, x_true, n = demo_saved_data.problem("head", "cpu", F64)
    jA, jx_true, jb = jp.Tomography().gen_saved_data("head")
    jb = np.asarray(jb).reshape(-1)
    assert np.array_equal(x_true, jx_true) and np.array_equal(b, jb)
    assert n == 8 and op.dtype == F64
    jop, L = JaxEll.from_scipy(jA), jo.FirstDerivative2D(n, n)
    runs = demo_saved_data.solves(op, b, n, iters)
    jax_runs = {
        "GKS (lam=1)": js.GKS(jop, jb, L, projection_dim=3, n_iter=iters,
                              regparam=1.0),
        "MMGKS (lam=1e-3)": js.MMGKS(jop, jb, L, pnorm=2, qnorm=1,
                                     projection_dim=3, n_iter=iters,
                                     regparam=0.001)}
    _held(runs, jax_runs)


def test_demo_fused_tpu_deblur1d_matches_jax():
    """The deblur1d configuration at n = 120, 8 iterations: fused GKS
    with GCV, DP and the L-curve, fused MMGKS and fused Hybrid LSQR with
    GCV, ``cgls`` and ``cgls_normal``, through the JAX demo's own
    ``build_deblur1d``."""
    from trips_tpu.krylov import cgls, cgls_normal
    from trips_tpu.solvers.fused import (fused_gks, fused_hybrid_lsqr,
                                         fused_mmgks)

    n, iters = 120, 8
    A, L, b, x_true, delta = demo_fused_tpu.build_deblur1d(n, "cpu", F64)
    jA, jL, jb, jx_true, jdelta = _jax_demo("demo_fused_tpu").build_deblur1d(
        n)
    assert np.array_equal(b, jb) and np.array_equal(x_true, jx_true)
    assert jdelta == delta
    assert np.array_equal(A.mat.numpy(), np.asarray(jA.mat))
    runs = demo_fused_tpu.solves(A, L, torch.from_numpy(b), delta, iters)
    bj = jnp.asarray(jb)
    jax_runs = {}
    for mode in ("gcv", "dp", "l_curve"):
        jax_runs[f"fused_gks[{mode}]"] = fused_gks(
            jA, bj, jL, projection_dim=3, n_iter=iters, regparam_mode=mode,
            delta=delta)[:2]
    jax_runs["fused_mmgks[gcv]"] = fused_mmgks(
        jA, bj, jL, pnorm=2.0, qnorm=1.0, projection_dim=3, n_iter=iters,
        regparam_mode="gcv")[:2]
    jax_runs["fused_hyb_lsqr[gcv]"] = fused_hybrid_lsqr(
        jA, bj, n_iter=max(iters, 20), regparam_mode="gcv")
    x0 = jnp.zeros(jA.shape[1])
    for name, fn in (("cgls", cgls), ("cgls_normal", cgls_normal)):
        jax_runs[name] = fn(jA, bj, x0, max(iters, 20), 0.0)
    _held(runs, jax_runs)


def test_demo_fused_tpu_tomo_data_matches_jax():
    """The tomo configuration's data (16x16 tectonic, 12 views) equal to
    the JAX demo's ``build_tomo``'s, and the bfloat16 pack's matrix equal
    to JAX's pack's."""
    import trips_tpu.sparse as jsp

    A, b, x_true, delta = demo_fused_tpu.tomo_data(16, 12)
    op = demo_fused_tpu.build_tomo(16, 12, "cpu")[0]
    jop, _, jb, jx_true, jdelta = _jax_demo("demo_fused_tpu").build_tomo(16,
                                                                         12)
    assert np.array_equal(b, jb) and np.array_equal(x_true, jx_true)
    assert delta == jdelta
    assert isinstance(jop, jsp.BucketedBandedProjector)
    M, jM = op.to_scipy(), jop.to_scipy()
    assert (M != jM).nnz == 0 and M.nnz > 0


def test_demo_dynamic_ct_matches_jax():
    """The synthetic problem at 16x16, 2 frames, 12 views, 4 iterations:
    static per-frame MMGKS, dynamic MMGKS with anisotropic and isotropic
    TV and group sparsity, Hybrid LSQR, all with GCV; the block system as
    a ``CsrOperator`` (the port) and an ``EllOperator`` (JAX)."""
    from trips_tpu.sparse import EllOperator

    nx, nt, iters = 16, 2, 4
    A, b, AA, B, nx, ny, nt, x_true, _ = demo_dynamic_ct.problem(
        "synthetic", nx, nt)
    np.random.seed(0)
    (jA, jb, jAA, jB, _, _, _, _, jx_true,
     _) = jp.generate_synthetic_dynamic(nx=nx, nt=nt, views=12,
                                        noise_level=0.01,
                                        return_angles=True)
    assert (A != jA).nnz == 0 and np.array_equal(b, jb)
    assert np.array_equal(x_true, jx_true)
    runs = demo_dynamic_ct.solves(
        CsrOperator.from_scipy(A, dtype=F64, device="cpu"), b, AA, B, nx,
        ny, nt, iters, F64)
    op = EllOperator.from_scipy(jA)
    dims = (nx, ny, nt)
    xs = [js.MMGKS(EllOperator.from_scipy(jAA[t]),
                   np.asarray(jB[t]).reshape(-1), jo.FirstDerivative2D(nx, ny),
                   pnorm=2, qnorm=1, projection_dim=3,
                   n_iter=max(4, iters // 4), regparam="gcv")[0]
          for t in range(nt)]
    jax_runs = {
        "static per-frame MMGKS": (np.concatenate([_x(x) for x in xs]),
                                   None),
        "dynamic MMGKS (anisoTV)": js.MMGKS(
            op, jb, jo.SpaceTimeDerivative(nx, ny, nt), pnorm=2, qnorm=1,
            projection_dim=4, n_iter=iters, regparam="gcv"),
        "dynamic MMGKS (isoTV)": js.MMGKS(
            op, jb, jo.CenteredSpaceTimeDerivative(nx, ny, nt), pnorm=2,
            qnorm=1, projection_dim=4, n_iter=iters, regparam="gcv",
            isoTV="isoTV", prob_dims=dims),
        "dynamic MMGKS (GS)": js.MMGKS(
            op, jb, None, pnorm=2, qnorm=1, projection_dim=4, n_iter=iters,
            regparam="gcv", GS="GS", prob_dims=dims),
        "Hybrid LSQR (full system)": js.Hybrid_LSQR(op, jb, n_iter=iters,
                                                    regparam="gcv")}
    # the static solves return host arrays: compare them as float64
    static = runs.pop("static per-frame MMGKS")
    x, _ = static()
    assert x.dtype == np.float64
    assert _rel(x, jax_runs.pop("static per-frame MMGKS")[0]) <= SEARCH_RTOL
    _held(runs, jax_runs, searched=lambda name: True)


def test_demo_fused_dynamic_matches_jax(tmp_path):
    """16x16, 2 frames, 9 views, 7 iterations: fused dynamic MMGKS with
    isoTV and GS weights and GCV, and the checkpointed isoTV loop killed at
    iteration 6 and resumed: bit for bit on the port's whole run, which is
    held to JAX's ``fused_mmgks_checkpointed``."""
    from trips_tpu.solvers.checkpointed import fused_mmgks_checkpointed
    from trips_tpu.solvers.fused import fused_mmgks
    from trips_tpu.sparse import EllOperator
    from trips_tpu_torch.operators import CenteredSpaceTimeDerivative

    nx, nt, views, n_iter = 16, 2, 9, 7
    (A, b, _, _, nx, ny, nt, _, x_true,
     _) = demo_fused_dynamic.generate_synthetic_dynamic(
        nx=nx, nt=nt, views=views, noise_level=0.01, return_angles=True)
    (jA, jb, _, _, _, _, _, _, jx_true,
     _) = jp.generate_synthetic_dynamic(nx=nx, nt=nt, views=views,
                                        noise_level=0.01,
                                        return_angles=True)
    assert (A != jA).nnz == 0 and np.array_equal(b, jb)
    assert np.array_equal(x_true, jx_true)
    op = CsrOperator.from_scipy(A, dtype=F64, device="cpu")
    bt = torch.from_numpy(b.astype(np.float64))
    Ltv = CenteredSpaceTimeDerivative(nx, ny, nt, device="cpu")
    dims = (nx, ny, nt)
    runs = demo_fused_dynamic.solves(op, bt, Ltv, dims, n_iter)
    jop, jbv = EllOperator.from_scipy(jA), jnp.asarray(jb)
    jL = jo.CenteredSpaceTimeDerivative(nx, ny, nt)
    jax_runs = {f"fused dynamic MMGKS ({mode})": fused_mmgks(
        jop, jbv, jL if mode == "isoTV" else None, pnorm=2.0, qnorm=1.0,
        projection_dim=3, n_iter=n_iter, regparam_mode="gcv",
        weight_mode=mode, prob_dims=dims)[:2] for mode in ("isoTV", "GS")}
    _held(runs, jax_runs, searched=lambda name: True)
    x_ref, x_res = demo_fused_dynamic.kill_and_resume(
        op, bt, Ltv, dims, n_iter, str(tmp_path / "ckpt.npz"))
    assert x_ref.dtype == F64 and torch.equal(x_res, x_ref)
    jx = fused_mmgks_checkpointed(
        jop, jbv, jL, pnorm=2.0, qnorm=1.0, projection_dim=3, n_iter=n_iter,
        regparam_mode="gcv", weight_mode="isoTV", prob_dims=dims,
        chunk=3)[0]
    assert _rel(x_ref, jx) <= SEARCH_RTOL, _rel(x_ref, jx)
