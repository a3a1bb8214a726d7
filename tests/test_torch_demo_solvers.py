"""The tomography demo's regularized solvers (demos/demo_tomography.py:50-61:
GKS, Hybrid LSQR with reorthogonalization and MMGKS p=2 q=1, each with the
discrepancy principle) in float32 on the bucketed banded operator,
trips_tpu_torch against trips_tpu on the CPU.

The problem is the demo's at nx = 32 and 12 views (tectonic, 1% noise after
``np.random.seed(0)``), the matrix from the JAX package's NumPy builder, and
both packages' operators hold the same float32 bytes. The applies sum in
another order and float32 rounding drives the Krylov bases apart, so only
the final relError is compared: within 1e-3 (measured 3e-8..5e-8).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trips_tpu.operators as jo
import trips_tpu.problems as jp
import trips_tpu.solvers as js
import trips_tpu_torch.operators as to
import trips_tpu_torch.solvers as ts
from trips_tpu.sparse.banded_buckets import \
    BucketedBandedProjector as JaxBucketed
from trips_tpu_torch.sparse import BucketedBandedProjector

from torch_threads import one_torch_thread  # noqa: F401


def _rel(a, b):
    a = (a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a))
    a, b = a.reshape(-1).astype(np.float64), np.asarray(b).reshape(-1)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def demo32():
    """The problem, and the two operators on the JAX pack's bytes."""
    old = os.environ.get("TRIPS_TPU_NO_NATIVE")
    os.environ["TRIPS_TPU_NO_NATIVE"] = "1"
    try:
        np.random.seed(0)
        tomo = jp.Tomography(CommitCrime=False)
        x_true, nx, ny = tomo.gen_true("tectonic", nx=32, ny=32)
        _, b, _, _, A = tomo.gen_data(x_true, nx, ny, 12)
        bn, delta = tomo.add_noise(b, "Gaussian", 0.01)
    finally:
        if old is None:
            os.environ.pop("TRIPS_TPU_NO_NATIVE")
        else:
            os.environ["TRIPS_TPU_NO_NATIVE"] = old
    jop = JaxBucketed.from_scipy_fan(A, nx, None, angles=tomo.theta,
                                     n_groups=32)
    top = BucketedBandedProjector.from_numpy_stacks(
        [[np.asarray(a) for a in st] for st in jop.stacks], jop.aidxs,
        jop.is_cols, jop.shape, jop.nx, jop.det_count, jop.n_groups,
        jop.nnz, jop.n_pad, device="cpu")
    return dict(jop=jop, top=top, b=bn.reshape(-1).astype(np.float32),
                delta=float(delta), x_true=x_true.reshape(-1), nx=nx)


DEMO = {
    "GKS": lambda s, o, b, L, kw: s.GKS(o, b, L, projection_dim=3, **kw),
    "Hybrid_LSQR": lambda s, o, b, L, kw: s.Hybrid_LSQR(o, b, reorth=True,
                                                        **kw),
    "MMGKS": lambda s, o, b, L, kw: s.MMGKS(o, b, L, pnorm=2, qnorm=1,
                                            projection_dim=3, **kw),
}


@pytest.mark.parametrize("name", list(DEMO))
def test_demo_solvers_f32_banded_match_jax(demo32, name):
    """8 iterations; the JAX side mixes its float64 host coefficients into
    the iterates under x64."""
    d = demo32
    nx = d["nx"]
    kw = dict(n_iter=8, regparam="dp", delta=d["delta"])
    tx, _ = DEMO[name](ts, d["top"], torch.from_numpy(d["b"]),
                       to.FirstDerivative2D(nx, nx, device="cpu"), kw)
    jx, _ = DEMO[name](js, d["jop"], jnp.asarray(d["b"]),
                       jo.FirstDerivative2D(nx, nx), kw)
    assert tx.dtype == torch.float32 and tx.shape == (nx * nx, 1)
    et, ej = _rel(tx, d["x_true"]), _rel(jx, d["x_true"])
    assert abs(et - ej) <= 1e-3, (et, ej)
