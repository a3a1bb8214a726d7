"""The deblurring slice as a whole, 2D: the demo's solver sequence through
trips_tpu_torch and trips_tpu on the same inputs, on the CPU at small size
(the 1D sequence: ``test_torch_deblur_demos.py``).

- The 2D demo's sequence (``demos/demo_2d_deblurring.py``) at 24x24 with a
  3x3 PSF (spread 1), 1% noise, 6 iterations, float64: Arnoldi-Tikhonov
  DP (8), Hybrid GMRES and Hybrid LSQR with GCV, GKS with GCV and
  ``FirstDerivative2D``, MMGKS p=2 q=1 with ``FirstDerivative2D`` and with
  ``FrameletOperator(24, 24, 2)``; x within 1e-6 relative.
- ``fused_hybrid_gmres`` with GCV and DP on the same 24x24 ``Blur2D``, its
  first square operator: x within 1e-7 relative (``test_torch_fused.py``'s
  ``X_RTOL``), lam within 1e-9 (DP) and 1e-4 (GCV).
- The 2D sequence again in float32 on the port (the card's precision),
  against JAX's float64 run: each final relError within 1e-5 (measured at
  most 3.5e-7, GKS; float32 rounds the operators at ~1e-7).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trips_tpu.operators as jo
import trips_tpu.problems as jp
import trips_tpu.solvers as js
import trips_tpu.solvers.fused as jf
import trips_tpu_torch.operators as to
import trips_tpu_torch.problems as tp
import trips_tpu_torch.solvers as ts
import trips_tpu_torch.solvers.fused as tf

from torch_threads import one_torch_thread  # noqa: F401

CPU = {"device": "cpu"}
X_RTOL, F32_GATE = 1e-6, 1e-5


def _np(x):
    return x.double().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, dtype=float)


def _rel(a, b):
    a, b = _np(a).reshape(-1), _np(b).reshape(-1)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


N2, ITERS2 = 24, 6


def _problem2d(pkg, **kw):
    np.random.seed(0)
    prob = pkg.Deblurring2D(**kw)
    A = prob.forward_Op([3, 3], (1, 1), N2, N2)
    x_true = prob.gen_true("h_im", nx=N2, ny=N2)
    b, delta = prob.add_noise(prob.gen_data(x_true.reshape(-1, 1)),
                              "Gaussian", 0.01)
    return A, x_true.reshape(-1), np.asarray(b).reshape(-1), float(delta)


def _sequence2d(pkg, ops, A, b, delta, x_true):
    """name -> final x of the 2D demo's sequence through ``pkg``'s solvers;
    ``ops`` builds its operators."""
    L = ops.FirstDerivative2D(N2, N2)
    W = ops.FrameletOperator(N2, N2, 2)
    out = {"Arnoldi-Tikhonov dp": pkg.Arnoldi_Tikhonov(
        A, b, n_iter=8, regparam="dp", delta=delta)[0]}
    out["Hybrid GMRES gcv"] = pkg.Hybrid_GMRES(A, b, n_iter=ITERS2,
                                               regparam="gcv")[0]
    out["Hybrid LSQR gcv"] = pkg.Hybrid_LSQR(A, b, n_iter=ITERS2,
                                             regparam="gcv")[0]
    out["GKS gcv"] = pkg.GKS(A, b, L, projection_dim=3, n_iter=ITERS2,
                             regparam="gcv")[0]
    kw = dict(pnorm=2, qnorm=1, projection_dim=3, n_iter=ITERS2,
              regparam="gcv")
    out["MMGKS derivative"] = pkg.MMGKS(A, b, L, **kw)[0]
    out["MMGKS framelet"] = pkg.MMGKS(A, b, W, **kw)[0]
    return out


class _TorchOps:
    def __init__(self, dtype):
        self.dtype = dtype

    def FirstDerivative2D(self, nx, ny):
        return to.FirstDerivative2D(nx, ny, **CPU)

    def FrameletOperator(self, n, m, l):  # noqa: E741
        return to.FrameletOperator(n, m, l, dtype=self.dtype, **CPU)


@pytest.fixture(scope="module")
def demo2d():
    jA, x_true, b, delta = _problem2d(jp)
    j = _sequence2d(js, jo, jA, jnp.asarray(b), delta, x_true)
    return dict(jA=jA, x_true=x_true, b=b, delta=delta,
                jax={k: np.asarray(v).reshape(-1) for k, v in j.items()})


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_demo2d_sequence(demo2d, dtype):
    d = demo2d
    tA, tx, tb, tdelta = _problem2d(tp, dtype=dtype, **CPU)
    assert np.array_equal(tx, d["x_true"]) and np.array_equal(tb, d["b"])
    got = _sequence2d(ts, _TorchOps(dtype), tA,
                      torch.tensor(tb, dtype=dtype), tdelta, tx)
    assert got.keys() == d["jax"].keys()
    for name, x in got.items():
        assert x.dtype == dtype and bool(torch.isfinite(x).all()), name
        ref = d["jax"][name]
        if dtype == torch.float64:
            assert _rel(x, ref) <= X_RTOL, name
        else:
            err, ref_err = _rel(x, tx), _rel(ref, tx)
            assert abs(err - ref_err) <= F32_GATE, (name, err, ref_err)


@pytest.mark.parametrize("mode", ["gcv", "dp"])
def test_fused_hybrid_gmres_on_blur2d(demo2d, mode):
    d = demo2d
    tA, _, tb, _ = _problem2d(tp, dtype=torch.float64, **CPU)
    kw = dict(n_iter=12, regparam_mode=mode, delta=d["delta"])
    tx, tl = tf.fused_hybrid_gmres(tA, torch.from_numpy(tb), **kw, **CPU)
    jx, jl = jf.fused_hybrid_gmres(d["jA"], jnp.asarray(d["b"]), **kw)
    assert _rel(tx, jx) <= 1e-7
    jl = np.asarray(jl)
    held = jl >= 1e-4  # GCV's flat bottom below (test_torch_fused.py)
    np.testing.assert_allclose(tl.numpy()[held], jl[held],
                               rtol=1e-9 if mode == "dp" else 1e-4)
