"""The deblurring slice as a whole, 1D: the demo's solver sequence through
trips_tpu_torch and trips_tpu on the same inputs, on the CPU at small size
(the 2D sequence: ``test_torch_deblur_demos2d.py``).

- The 1D demo (``demos/demo_1d_deblurring.py`` at n = 100, parameter 10,
  ``curve0``, 2% noise after ``np.random.seed(0)``), float64: TSVD, TGSVD
  (the zero-padded ``L_sq``) and Tikhonov with DP (k equal, x within 1e-8,
  lam within 1e-8 relative); Hybrid GMRES and Hybrid LSQR with DP and
  ``reorth`` on the total discrepancy; GKS with DP and
  ``FirstDerivative1D``, 12 iterations. The hybrids' final x within 1e-6
  relative (``tests/test_torch_solvers.py``'s ``X_RTOL``: the products run
  in another BLAS and the projected solves amplify the last bits), their
  relError and lam histories within 1e-6. GKS with DP is not stable on
  this problem: DP becomes attainable at iteration 9, and from there a
  1e-15 relative change of b moves JAX's own x by 2.1e-5 at iteration 12
  and 1.6e-2 at 30 (measured; with lam fixed, 1.8e-15). So its first 8
  iterates (lam = 0) are held to 1e-12, the final x to 1e-4 (``DP_GKS``),
  and the same GKS with lam fixed at 0.5 to 1e-6.
"""
import numpy as np
import pytest
import torch

import trips_tpu.operators as jo
import trips_tpu.problems as jp
import trips_tpu.solvers as js
import trips_tpu_torch.operators as to
import trips_tpu_torch.problems as tp
import trips_tpu_torch.solvers as ts

from torch_threads import one_torch_thread  # noqa: F401

CPU = {"device": "cpu"}
X_RTOL, DIRECT_RTOL = 1e-6, 1e-8
ITERS1 = 12
DP_GKS = 1e-4


def _np(x):
    return x.double().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, dtype=float)


def _rel(a, b):
    a, b = _np(a).reshape(-1), _np(b).reshape(-1)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _problem1d(pkg, n, **kw):
    np.random.seed(0)
    prob = pkg.Deblurring1D(**kw)
    A = prob.forward_Op_1D(parameter=10.0, nx=n)
    x_true = prob.gen_xtrue(n, "curve0")
    b, delta = prob.add_noise(prob.gen_data(x_true, parameter=10.0),
                              "Gaussian", 0.02)
    return A, x_true, np.asarray(b), float(delta)


@pytest.fixture(scope="module")
def demo1d():
    n = 100
    jA, x_true, b, delta = _problem1d(jp, n)
    tA, tx, tb, tdelta = _problem1d(tp, n, dtype=torch.float64, **CPU)
    assert np.array_equal(tx, x_true) and np.array_equal(tb, b)
    assert tdelta == delta
    A_dense = tA.mat.numpy()
    assert np.array_equal(A_dense, np.asarray(jA.mat))
    delta_total = float(np.linalg.norm(b.reshape(-1) - A_dense @ x_true))
    L_sq = np.vstack([to.first_derivative_matrix(n).toarray(),
                      np.zeros((1, n))])
    return dict(n=n, jA=jA, tA=tA, A=A_dense, x_true=x_true, b=b,
                delta=delta, delta_total=delta_total, L_sq=L_sq)


def test_demo1d_direct_solvers(demo1d):
    d = demo1d
    runs = {
        "tsvd": (lambda m, **kw: m.tSVD_sol(d["A"], d["b"], regparam="dp",
                                            delta=d["delta"], **kw)),
        "tgsvd": (lambda m, **kw: m.tGSVD_sol(d["A"], d["L_sq"], d["b"],
                                              regparam="dp",
                                              delta=d["delta"], **kw)),
        "tikhonov": (lambda m, **kw: m.Tikhonov(d["A"], d["b"],
                                                np.eye(d["n"]),
                                                regparam="dp",
                                                delta=d["delta"], **kw)),
    }
    for name, run in runs.items():
        tx, tpar = run(ts, **CPU)
        jx, jpar = run(js)
        assert _rel(tx, jx) <= DIRECT_RTOL, name
        if name == "tikhonov":
            assert tpar == pytest.approx(float(jpar), rel=DIRECT_RTOL)
        else:
            assert tpar == jpar, name


def test_demo1d_iterative_solvers(demo1d):
    d = demo1d
    n, bv = d["n"], d["b"].reshape(-1)
    kw = dict(n_iter=ITERS1, regparam="dp", delta=d["delta_total"], reorth=True,
              x_true=d["x_true"])
    pairs = {
        "Hybrid GMRES": (ts.Hybrid_GMRES(d["tA"], torch.from_numpy(bv), **kw),
                         js.Hybrid_GMRES(d["jA"], d["b"], **kw)),
        "Hybrid LSQR": (ts.Hybrid_LSQR(d["tA"], torch.from_numpy(bv), **kw),
                        js.Hybrid_LSQR(d["jA"], d["b"], **kw)),
        "GKS": (ts.GKS(d["tA"], torch.from_numpy(bv),
                       to.FirstDerivative1D(n, **CPU), projection_dim=3,
                       n_iter=ITERS1, regparam="dp", delta=d["delta"],
                       x_true=d["x_true"]),
                js.GKS(d["jA"], bv, jo.FirstDerivative1D(n),
                       projection_dim=3, n_iter=ITERS1, regparam="dp",
                       delta=d["delta"], x_true=d["x_true"])),
    }
    for name, ((tx, ti), (jx, ji)) in pairs.items():
        assert tx.dtype == torch.float64
        if name == "GKS":
            assert _rel(tx, jx) <= DP_GKS
            assert ji["regParam_history"][:8] == [0] * 8
            for a, b in zip(ti["xHistory"][:8], ji["xHistory"][:8]):
                assert _rel(a, b) <= 1e-12
            continue
        assert _rel(tx, jx) <= X_RTOL, name
        np.testing.assert_allclose(ti["relError"], ji["relError"],
                                   rtol=X_RTOL, err_msg=name)
        np.testing.assert_allclose(ti["regParam_history"],
                                   ji["regParam_history"], rtol=1e-6,
                                   err_msg=name)
    tx, ti = ts.GKS(d["tA"], torch.from_numpy(bv),
                    to.FirstDerivative1D(n, **CPU), projection_dim=3,
                    n_iter=ITERS1, regparam=0.5, x_true=d["x_true"])
    jx, ji = js.GKS(d["jA"], bv, jo.FirstDerivative1D(n), projection_dim=3,
                    n_iter=ITERS1, regparam=0.5, x_true=d["x_true"])
    assert _rel(tx, jx) <= X_RTOL
