"""The port's last support modules against ``trips_tpu`` on the CPU.

- ``analytic_sinogram`` equal to JAX's to 1e-12 (fan and parallel), and
  the port's own builders converging to it under grid refinement, as
  ``tests/test_projector_oracle.py`` holds JAX's.
- ``LinearOperator.dtype`` and ``to_scipy`` on a few operators against
  JAX's ``todense``.
- ``utils.helpers``: ``convert_image_for_trips`` on a PNG made from a seed
  in a temporary directory, its array and ``.mat`` equal to JAX's; each
  plot under Agg returns a figure with JAX's number of axes, from arrays
  and from tensors.
- ``bench.iters_to_tol.compare``: JAX's configurations and reference
  counts, the port's counts within the bound JAX's own test sets.
- The demo twins at a small size (``demo_l_curve --n 32 --views 16 --iters
  8``, ``demo_small_scale_cgls --n 24 --iters 20``): the same solver calls
  through ``trips_tpu`` in float64, the iterates to 1e-8 (lambda to
  1e-6, GCV's to 1e-4), and each twin's ``main`` on the CPU printing the
  JAX demo's lines.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trips_tpu.core.linop as jl
import trips_tpu.operators as jo
import trips_tpu.problems as jp
import trips_tpu_torch.core.linop as tl
import trips_tpu_torch.operators as to
import trips_tpu_torch.problems as tp
from test_projector_oracle import _rasterize, _scaled
from torch_threads import one_torch_thread  # noqa: F401


# ---- analytic_sinogram ---------------------------------------------------
@pytest.mark.parametrize("geometry,kw", [
    ("fan", dict(views=9)),
    ("fan", dict(angles=np.array([0.0, 0.7, 2.5]), det_count=50,
                 det_width=1.2, source_origin=100.0, origin_det=40.0)),
    ("parallel", dict(views=7)),
    ("parallel", dict(angles=np.array([0.3, 1.9]), det_count=41,
                      det_width=0.8))])
def test_analytic_sinogram_matches_jax(geometry, kw):
    args = (_scaled(40), 40)
    t = tp.analytic_sinogram(*args, geometry=geometry, **kw)
    j = jp.projector.analytic_sinogram(*args, geometry=geometry, **kw)
    assert t.shape == j.shape and np.abs(t).max() > 1
    assert np.abs(t - j).max() <= 1e-12 * np.abs(j).max()


def _oracle_err(geometry, nx, model="line"):
    angles = np.linspace(0, np.pi, 14, endpoint=False) + 0.123
    if geometry == "fan":
        A, p = tp.fan_beam_matrix(nx, angles=angles), int(np.sqrt(2) * nx)
    else:
        A, p = tp.parallel_beam_matrix(nx, angles, model=model), nx
    ref = tp.analytic_sinogram(_scaled(nx), nx, geometry=geometry,
                               angles=angles, det_count=p)
    got = (A @ _rasterize(nx)).reshape(len(angles), p)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


@pytest.mark.parametrize("builder", ["cpp", "numpy"])
@pytest.mark.parametrize("geometry,model,limit", [("fan", "line", 2e-2),
                                                  ("parallel", "line", 2e-2),
                                                  ("parallel", "linear",
                                                   3e-2)])
def test_builders_converge_to_analytic(monkeypatch, builder, geometry,
                                       model, limit):
    if builder == "numpy":
        monkeypatch.setenv("TRIPS_TPU_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("TRIPS_TPU_NO_NATIVE", raising=False)
    errs = [_oracle_err(geometry, nx, model) for nx in (48, 96, 192)]
    assert errs[1] < 0.75 * errs[0], errs
    assert errs[2] < 0.75 * errs[1], errs
    assert errs[2] < limit, errs


# ---- LinearOperator.dtype and to_scipy --------------------------------------
def _operator_pairs():
    M = np.random.default_rng(1).standard_normal((7, 5))
    D = np.random.default_rng(2).standard_normal((5, 5))
    return {
        "dense": (jl.DenseOperator(jnp.asarray(M)),
                  tl.DenseOperator(torch.from_numpy(M))),
        "derivative": (jo.FirstDerivative2D(4, 3),
                       to.FirstDerivative2D(4, 3, device="cpu")),
        "stack": (jl.VStackOperator([jl.DenseOperator(jnp.asarray(M)),
                                     jl.ScaledOperator(
                                         0.5, jl.DenseOperator(
                                             jnp.asarray(D)))]),
                  tl.VStackOperator([tl.DenseOperator(torch.from_numpy(M)),
                                     tl.ScaledOperator(
                                         0.5, tl.DenseOperator(
                                             torch.from_numpy(D)))])),
    }


@pytest.mark.parametrize("name", ["dense", "derivative", "stack"])
def test_dtype_and_to_scipy_match_jax(name):
    j, t = _operator_pairs()[name]
    dense = t.to_scipy()
    assert isinstance(dense, np.ndarray) and dense.shape == t.shape
    ref = np.asarray(j.todense())
    assert dense.dtype == ref.dtype == np.dtype(j.dtype)
    assert t.dtype == getattr(torch, dense.dtype.name)
    np.testing.assert_allclose(dense, ref, rtol=1e-12, atol=1e-12)


def test_dtype_defaults_to_float32_and_is_settable():
    class Op(tl.LinearOperator):
        shape = (2, 2)

    op = Op()
    assert op.dtype == torch.float32
    op.dtype = torch.float64
    assert op.dtype == torch.float64 and Op().dtype == torch.float32


# ---- utils.helpers --------------------------------------------------------
def test_convert_image_for_trips_matches_jax(tmp_path, monkeypatch):
    import scipy.io as spio
    from PIL import Image

    import trips_tpu.utils.helpers as jh
    import trips_tpu_torch.utils.helpers as th

    img = np.random.default_rng(3).integers(0, 256, (40, 30, 3), np.uint8)
    Image.fromarray(img).save(tmp_path / "in.png")
    out = {}
    for name, mod in (("jax", jh), ("torch", th)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        X, path = mod.convert_image_for_trips(str(tmp_path / "in.png"),
                                              dataset="mine", size=(20, 16))
        out[name] = (X, path, spio.loadmat(path)["x_true"])
    (jx, jpath, jm), (tx, tpath, tm) = out["jax"], out["torch"]
    assert tpath == jpath == "./data/image_data/mine.mat"
    assert tx.dtype == jx.dtype and np.array_equal(tx, jx)
    assert np.array_equal(tm, jm) and tm.shape == (16, 20)


def test_plots_match_jax_axes(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    import trips_tpu.utils.helpers as jh
    import trips_tpu_torch.utils.helpers as th

    rng = np.random.default_rng(4)
    V, S = rng.standard_normal((12, 6)), np.sort(rng.random(9))[::-1].copy()
    x, b = rng.random(3 * 12), rng.random(4 * 5 * 3)
    calls = [("plot_singular_vectors", (V, 4, 3), {"num": 6}),
             ("plot_singular_values", (S,), {}),
             ("plot_recstructions_series", (x, (4, 3, 3)),
              {"geome_x": 1, "geome_y": 3, "save_imgs": True,
               "save_path": str(tmp_path / "rec")}),
             ("plot_sinograms", (b, 5, 3), {"geome_x": 2, "geome_y": 2})]
    for name, args, kw in calls:
        jfig = getattr(jh, name)(*args, **kw)
        for a in (args, tuple(torch.as_tensor(v) if isinstance(v, np.ndarray)
                              else v for v in args)):
            tfig = getattr(th, name)(*a, **kw)
            assert len(tfig.axes) == len(jfig.axes), name
            plt.close(tfig)
        plt.close(jfig)
    assert (tmp_path / "rec" / "series_.png").stat().st_size > 0


# ---- bench.iters_to_tol ---------------------------------------------------
def test_iters_to_tol_matches_jax(monkeypatch):
    from trips_tpu.bench import iters_to_tol as jit_
    from trips_tpu_torch.bench import iters_to_tol as tit

    monkeypatch.delenv("TRIPS_TPU_NO_NATIVE", raising=False)
    rows, jrows = tit.compare(device="cpu"), jit_.compare()
    assert [r[:2] for r in rows] == [r[:2] for r in jrows]
    assert [r[0] for r in rows] == ["tomo32x30", "tomo64x40"]
    # the bound of JAX's own test (tests/test_krylov.py): the stop at tol
    # 1e-4 sits where the residual flattens, so the sum order moves it by
    # an iteration or two (JAX's rows are 33 and 51 against 32 and 49)
    for (_, k_ref, k), (_, _, jk) in zip(rows, jrows):
        assert abs(k - k_ref) <= max(2, int(0.05 * k_ref))
        assert abs(jk - k_ref) <= max(2, int(0.05 * k_ref))
    rng = np.random.default_rng(5)
    M = rng.standard_normal((30, 12))
    b = rng.standard_normal(30)
    xt, kt = tit.cgls_reference(M, b, np.zeros(12), 50, 1e-8)
    xj, kj = jit_.cgls_reference(M, b, np.zeros(12), 50, 1e-8)
    assert kt == kj and np.array_equal(xt, xj)


# ---- the demo twins -------------------------------------------------------
def _relerr(x, xt):
    x = np.asarray(x, np.float64).reshape(-1)
    return np.linalg.norm(x - xt.reshape(-1)) / np.linalg.norm(xt)


def test_demo_l_curve_matches_jax():
    """The demo's six solves in float64 at 32x32, 16 views, 8 iterations:
    the port's over its CSR matrix, JAX's over its ELL operator, on the
    same data (each package's Tomography, the C++ builder)."""
    from trips_tpu.solvers import GKS, MMGKS, Hybrid_LSQR
    from trips_tpu_torch.demos import demo_l_curve as demo
    from trips_tpu_torch.sparse import CsrOperator

    OP, b, L, delta, x_true, A = demo.problem(32, 16, "cpu")
    np.random.seed(0)
    jt = jp.Tomography(CommitCrime=False)
    jx_true, nx, ny = jt.gen_true("tectonic", nx=32, ny=32)
    jOP, jb, *_ = jt.gen_data(jx_true, nx, ny, 16)
    jb_noisy, jdelta = jt.add_noise(jb, "Gaussian", 0.01)
    assert np.array_equal(jx_true, x_true) and float(jdelta) == delta
    assert np.array_equal(jb_noisy.reshape(-1), b)
    runs = demo.solves(CsrOperator.from_scipy(A, dtype=torch.float64,
                                              device="cpu"),
                       torch.from_numpy(b), L, delta, 8)
    jL, jbv = jo.FirstDerivative2D(nx, ny), jnp.asarray(b)
    jax_runs = {}
    for rp in ["l_curve", "dp"]:
        jax_runs[f"GKS ({rp})"] = GKS(jOP, jbv, jL, projection_dim=3,
                                      n_iter=8, regparam=rp, delta=delta)
        jax_runs[f"MMGKS ({rp})"] = MMGKS(jOP, jbv, jL, pnorm=2, qnorm=1,
                                          projection_dim=3, n_iter=8,
                                          regparam=rp, delta=delta)
    for rp in ["gcv", "l_curve"]:
        jax_runs[f"Hybrid LSQR ({rp})"] = Hybrid_LSQR(
            jOP, jbv, n_iter=8, regparam=rp, delta=delta)
    assert list(runs) == list(jax_runs)
    for name, solve in runs.items():
        x, info = solve()
        jx, jinfo = jax_runs[name]
        jx = np.asarray(jx, np.float64).reshape(-1)
        x = x.numpy().reshape(-1)
        assert np.linalg.norm(x - jx) <= 1e-8 * np.linalg.norm(jx), name
        # lambda where its rule is flat: the L-curve's corner 7e-8 apart in
        # GKS here, GCV's minimum 3e-6 apart in the hybrid (as
        # test_torch_dynamic.py's LAM_RTOL has it)
        assert float(info["regParam"]) == pytest.approx(
            float(jinfo["regParam"]),
            rel=1e-4 if name == "Hybrid LSQR (gcv)" else 1e-6), name


def test_demo_l_curve_main_prints_jax_lines(capsys):
    from trips_tpu_torch.demos import demo_l_curve as demo

    res = demo.main(["--n", "32", "--views", "16", "--iters", "8",
                     "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert list(res) == ["GKS (l_curve)", "MMGKS (l_curve)", "GKS (dp)",
                         "MMGKS (dp)", "Hybrid LSQR (gcv)",
                         "Hybrid LSQR (l_curve)"]
    assert lines == [f"{name:25s} relative error = {err:.4f}  (lam = "
                     f"{lam:.3e})" for name, (err, lam, _) in res.items()]
    assert all(0 < err < 0.5 for err, _, _ in res.values())


def test_demo_small_scale_cgls_matches_jax():
    """The stacked CGLS in float64 at 24x24, 20 iterations."""
    from trips_tpu.solvers import CGLS
    from trips_tpu.solvers._common import as_op
    from trips_tpu_torch.demos import demo_small_scale_cgls as demo
    from trips_tpu_torch.solvers import CGLS as TCGLS

    Ahat, bhat, x0, x_true = demo.problem(24, 0.01, "cpu", torch.float64)
    x, info = TCGLS(Ahat, bhat, x0, max_iter=20, tol=1e-3, x_true=x_true)
    np.random.seed(0)
    prob = jp.Deblurring2D()
    A = prob.forward_Op([3, 3], (1, 1), 24, 24)
    jx_true = prob.gen_true("h_im", nx=24, ny=24)
    b, _ = prob.add_noise(prob.gen_data(np.asarray(jx_true).reshape(-1, 1)),
                          "Gaussian", 0.01)
    bv = np.asarray(b).reshape(-1)
    L = jo.FirstDerivative2D(24, 24)
    jAhat = jl.VStackOperator([as_op(A), jl.ScaledOperator(np.sqrt(0.01),
                                                           as_op(L))])
    assert np.array_equal(np.asarray(jx_true).reshape(-1), x_true)
    np.testing.assert_array_equal(bhat.numpy()[:len(bv)], bv)
    jx, jinfo = CGLS(jAhat, np.concatenate([bv, np.zeros(L.shape[0])]),
                     np.asarray(as_op(A).rmatvec(bv)), max_iter=20,
                     tol=1e-3, x_true=x_true)
    assert info["its"] == jinfo["its"]
    jx = np.asarray(jx, np.float64).reshape(-1)
    assert np.linalg.norm(x.numpy().reshape(-1) - jx) <= (
        1e-8 * np.linalg.norm(jx))
    np.testing.assert_allclose(info["relError"], jinfo["relError"],
                               rtol=1e-8)


def test_demo_small_scale_cgls_main_prints_jax_lines(capsys):
    from trips_tpu_torch.demos import demo_small_scale_cgls as demo

    x, info = demo.main(["--n", "24", "--iters", "20", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("CGLS on stacked [A; sqrt(0.01) L] (24x24 h_im, 1% "
                      "noise):")
    assert out[1] == f"  iterations: {info['its']}"
    assert out[2] == f"  final relative error: {info['relError'][-1]:.4f}"
    assert out[3].startswith("  relative error vs x_true: ")
    assert x.dtype == torch.float32 and 0 < info["its"] <= 20
