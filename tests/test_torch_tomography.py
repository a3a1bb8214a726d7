"""The tomography CGLS slice: trips_tpu_torch against trips_tpu end to end.

Problem generation must agree exactly (phantoms, CSR matrices, data and
noise under the same ``np.random.seed``); the CGLS relative-error history
on the banded operator must agree to 1e-3 in float32. That is the size of
float32 CG's own error: each package's float32 history is 9e-4 from the
float64 history here, and the two are 1e-4..1e-3 apart on this and
larger grids (measured), because the applies sum in different orders. The
JAX package runs with its NumPy matrix builder (``TRIPS_TPU_NO_NATIVE=1``):
the port carries only that builder, and the optional C++ one gives another
CSR matrix.
"""
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trips_tpu.problems as jp
import trips_tpu_torch.problems as tp
from trips_tpu.solvers import CGLS as JaxCGLS
from trips_tpu.sparse.banded_buckets import \
    BucketedBandedProjector as JaxBucketed
from trips_tpu_torch.solvers import CGLS
from trips_tpu_torch.sparse import BucketedBandedProjector


@pytest.fixture(autouse=True)
def _numpy_builder(monkeypatch):
    monkeypatch.setenv("TRIPS_TPU_NO_NATIVE", "1")


@pytest.mark.parametrize("name", ["grains", "smooth", "tectonic",
                                  "threephases", "ppower", "shepp_logan"])
def test_phantoms_identical(name):
    kw = dict(nx=40, ny=40, phantom_seed=3)
    xj, *_ = jp.Tomography().gen_true(name, **kw)
    xt, *_ = tp.Tomography(device="cpu").gen_true(name, **kw)
    assert xj.dtype == xt.dtype and np.array_equal(xj, xt)


def _both(nx, views, seed=0):
    out = []
    for mod in (jp, tp):
        np.random.seed(seed)
        dev = {"device": "cpu"} if mod is tp else {}
        tomo = mod.Tomography(CommitCrime=False, **dev)
        x, nx_, ny_ = tomo.gen_true("grains", nx=nx, ny=nx, phantom_seed=0)
        OP, b, p, q, A = tomo.gen_data(x, nx_, ny_, views)
        bn, delta = tomo.add_noise(b, "Gaussian", 0.01)
        out.append((tomo, x, OP, b, bn, delta, (p, q)))
    return out


@pytest.mark.parametrize("nx", [32, 40])
def test_problem_generation_identical(nx):
    (tj, xj, _, bj, bnj, dj, pqj), (tt, xt, OP, bt, bnt, dt, pqt) = \
        _both(nx, 12)
    assert np.array_equal(xj, xt)
    for M in ("A", "A_mis"):
        Mj, Mt = getattr(tj, M), getattr(tt, M)
        assert Mj.shape == Mt.shape and (Mj != Mt).nnz == 0
    assert np.array_equal(bj, bt) and np.array_equal(bnj, bnt)
    assert dj == dt and pqj == pqt
    assert isinstance(OP, BucketedBandedProjector)
    assert OP.device == torch.device("cpu") and OP.n_groups == 32
    assert len(OP.stacks) == 8  # 4 buckets per drive orientation
    assert (OP.to_scipy() != tt.A.astype(np.float32)).nnz == 0


def test_noise_from_generator():
    tomo = tp.Tomography(device="cpu")
    tomo.p, tomo.q = 3, 4
    b = np.arange(12.0)
    g1, d1 = tomo.add_noise(b, "Gaussian", 0.1,
                            rng=np.random.default_rng(5))
    e = np.random.default_rng(5).standard_normal(12)
    e = 0.1 * np.linalg.norm(b) / np.linalg.norm(e) * e
    np.testing.assert_allclose(g1.reshape(-1), b + e, rtol=1e-15)
    assert d1 == pytest.approx(np.linalg.norm(e), rel=1e-15)


def test_cgls_relerror_history_matches_jax():
    """Port CGLS on the port's operator vs JAX CGLS on the JAX bucketed
    operator of the same matrix: 20 float32 iterations."""
    (tj, xj, _, _, bnj, _, _), (_, xt, OP, _, bnt, _, _) = _both(32, 12)
    jop = JaxBucketed.from_scipy_fan(tj.A, 32, None, angles=tj.theta,
                                     n_groups=32)
    x0 = np.zeros(32 * 32, np.float32)
    b = bnj.reshape(-1).astype(np.float32)
    _, ij = JaxCGLS(jop, jnp.asarray(b), jnp.asarray(x0), 20, 1e-8,
                    x_true=xj)
    _, it = CGLS(OP, torch.from_numpy(b), torch.from_numpy(x0), 20, 1e-8,
                 x_true=xt)
    assert it["its"] == ij["its"] == 20
    assert len(it["relError"]) == 20
    np.testing.assert_allclose(it["relError"], ij["relError"], rtol=0,
                               atol=1e-3)


def test_unsupported_geometry_and_images_raise():
    A = tp.fan_beam_matrix(8, views=4)
    with pytest.raises(NotImplementedError):
        tp.device_sparse_operator(A, nx=None, angles=np.zeros(4),
                                  device="cpu")
    with pytest.raises(NotImplementedError):
        tp.Tomography(device="cpu").gen_true("SL60", nx=8, ny=8)


def test_import_loads_no_jax():
    code = ("import sys, trips_tpu_torch, trips_tpu_torch.problems, "
            "trips_tpu_torch.solvers, trips_tpu_torch.krylov, "
            "trips_tpu_torch.operators\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'trips_tpu.'))]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
