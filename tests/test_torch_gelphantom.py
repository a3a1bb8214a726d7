"""gelPhantom dynamic CT of the port against ``trips_tpu`` on the CPU.

- On a bundle in the layout of ``tests/test_dataset_fixtures.py:188``
  (a v5 struct with stacked sinograms and per-frame parameter structs,
  written into a ``tmp_path``; nothing downloads): ``read_frames`` equal
  to JAX's, ``generate_gelPhantom``'s seven outputs equal (bitwise with
  the NumPy builder on both sides, the matrices within 1e-12 relative
  with the C++ builders), the CIL formulas equal.
- The geometry checks of ``tests/test_gel_geometry.py`` run on the port:
  the CIL magnification and voxel size, the geometry ``gel_operator``
  hands ``fan_beam_matrix`` (also with the file's magnification field
  poisoned), and the real geometry's matrix rows.
- A gel CGLS at nx = 32 (the real geometry, 3 frames of 12 angles, data
  from a phantom) over ``BatchedBlockDiagOperator``, 6 iterations, in
  float64 over the exact matrix within 1e-10 of JAX's; over the float32
  bucketed banded pack (JAX's bytes on both sides) each apply within
  1e-6 of JAX's banded operator, and the float32 CGLS's relErrors within
  1e-4 of the float64 ones.
"""
import numpy as np
import pytest
import scipy.io as spio
import torch
from scipy import sparse as sp

import trips_tpu.problems.gelphantom as jg
import trips_tpu_torch.problems.gelphantom as tg
from test_gel_geometry import (N_DET, OD, PIXEL, SO, SD,
                               cil_reference_arithmetic, make_info)
from torch_threads import one_torch_thread  # noqa: F401

NAME = "GelPhantomData_b4.mat"
# CGLS on the gel system at nx = 32 amplifies the roundoff of the two
# packages' sums about tenfold an iteration from the fourth on (float64:
# 3e-13 apart at 6 iterations, 3e-11 at 8, 2e-9 at 10), so it is held
# over 6
GEL_ITERS = 6


def _write_bundle(path, sinos, angles_deg, n_det, pixel):
    """A bundle of ``sinos (nt, angles, n_det)`` in the real file's layout
    (cil_io.py:35-91)."""
    nt = len(sinos)
    params = {"distanceSourceDetector": SD, "distanceSourceOrigin": SO,
              "geometricMagnification": SD / SO,
              "numDetectors": float(n_det), "pixelSize": pixel,
              "pixelSizeRaw": pixel / 2,
              "effectivePixelSize": 2 * pixel * SO / SD,
              "angles": np.asarray(angles_deg, float)}
    parr = np.zeros((nt,), dtype=[(k, "O") for k in params])
    for k, v in params.items():
        for t in range(nt):
            parr[k][t] = v
    spio.savemat(str(path / NAME), {"GelPhantomData_b4": {
        "type": "2D", "sinogram": sinos, "parameters": parr}})


@pytest.fixture
def fixture_bundle(tmp_path):
    """The dataset fixture's bundle: 3 frames, 12 angles, 16 detectors."""
    _write_bundle(tmp_path, np.random.default_rng(4).random((3, 12, 16)),
                  np.linspace(0.0, 330.0, 12), 16, 0.2)
    return tmp_path


def test_read_frames_equal(fixture_bundle):
    j = jg.read_frames(str(fixture_bundle / NAME))
    t = tg.read_frames(str(fixture_bundle / NAME))
    assert j.keys() == t.keys()
    for k in j:
        if isinstance(j[k], np.ndarray):
            assert j[k].dtype == t[k].dtype and np.array_equal(j[k], t[k])
        else:
            assert type(j[k]) is type(t[k]) and j[k] == t[k]


@pytest.mark.parametrize("builder", ["numpy", "cpp"])
def test_generate_gel_phantom_equal(fixture_bundle, monkeypatch, builder):
    if builder == "numpy":
        monkeypatch.setenv("TRIPS_TPU_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("TRIPS_TPU_NO_NATIVE", raising=False)
    kw = dict(nx=8, angle_step=4, data_dir=str(fixture_bundle))
    j, t = jg.generate_gelPhantom(**kw), tg.generate_gelPhantom(**kw)
    assert len(t) == 7 and t[4:] == j[4:] == (8, 8, 3)
    assert all(a is t[2][0] for a in t[2])  # one geometry for every frame
    rel = 0.0 if builder == "numpy" else 1e-12
    for a, b in [(j[0], t[0])] + list(zip(j[2], t[2])):
        a, b = sp.csr_matrix(a), sp.csr_matrix(b)
        assert a.shape == b.shape and np.array_equal(a.indptr, b.indptr)
        assert np.array_equal(a.indices, b.indices)
        assert (np.abs(a.data - b.data) <= rel * np.abs(a.data)).all()
    assert np.array_equal(j[1], t[1])
    assert all(np.array_equal(a, b) for a, b in zip(j[3], t[3]))


def test_cil_formulas_equal():
    for so, od, px in ((SO, OD, 2 * PIXEL), (100.0, 37.5, 0.05)):
        assert (tg.cil_cone2d_magnification(so, od)
                == jg.cil_cone2d_magnification(so, od))
        assert tg.cil_voxel_size(px, so, od) == jg.cil_voxel_size(px, so, od)
    mag, v = cil_reference_arithmetic(2 * PIXEL, SO, OD)
    assert tg.cil_cone2d_magnification(SO, OD) == pytest.approx(mag,
                                                                 rel=1e-14)
    assert tg.cil_voxel_size(2 * PIXEL, SO, OD) == pytest.approx(v,
                                                                 rel=1e-14)


@pytest.mark.parametrize("file_magnification", [None, 99.0])
def test_gel_operator_hands_cil_geometry(monkeypatch, file_magnification):
    """The geometry reaches ``fan_beam_matrix`` in voxel units from the
    configured distances; the file's magnification field is not read."""
    captured = {}

    def fake_fan_beam_matrix(nx, **kw):
        captured.update(nx=nx, **kw)
        return object()

    monkeypatch.setattr(tg, "fan_beam_matrix", fake_fan_beam_matrix)
    info = make_info()
    if file_magnification is not None:
        info["geometricMagnification"] = file_magnification
    tg.gel_operator(info, 256, np.arange(0, 360, 20))
    mag, v = cil_reference_arithmetic(2 * PIXEL, SO, OD)
    assert captured["nx"] == 256 and captured["det_count"] == N_DET
    assert captured["source_origin"] == pytest.approx(SO / v, rel=1e-12)
    assert captured["origin_det"] == pytest.approx(OD / v, rel=1e-12)
    assert captured["det_width"] == pytest.approx(mag, rel=1e-12)
    expect = np.arange(360.0)[np.arange(0, 360, 20)] * np.pi / 180.0
    np.testing.assert_allclose(np.asarray(captured["angles"]), expect,
                               rtol=0, atol=1e-15)
    assert len(captured["angles"]) == 18


def test_gel_operator_builds_real_matrix_rows():
    A = tg.gel_operator(make_info(), 32, np.arange(0, 360, 40)).toarray()
    assert A.shape == (9 * N_DET, 32 * 32) and (A >= 0).all()
    assert A.sum(axis=1).max() <= np.sqrt(2) * 32 + 1e-6
    rows = A.sum(axis=1).reshape(9, N_DET)
    center = N_DET // 2
    assert (rows[:, center - 5:center + 5] > 0).all()
    assert (A.sum(axis=1) > 0).mean() > 0.15
    ref = jg.gel_operator(make_info(), 32, np.arange(0, 360, 40)).toarray()
    assert np.abs(A - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.fixture(scope="module")
def gel32(tmp_path_factory):
    """The real geometry at nx = 32: 3 frames, 36 angles kept every 3rd
    (12), 40 detectors. Each frame a Shepp-Logan phantom in the middle
    16x16 with a disk that grows, projected through all 36 angles, with
    1% Gaussian noise from a seed. -> (JAX's outputs, the port's, the kept
    angles, the frames)."""
    from trips_tpu_torch.problems.phantoms import shepp_logan

    path = tmp_path_factory.mktemp("gel")
    deg = np.arange(0.0, 360, 10)
    info = dict(make_info(deg), numDetectors=40)
    X = np.zeros((3, 32, 32))
    X[:, 8:24, 8:24] = shepp_logan(16)
    yy, xx = np.mgrid[:32, :32]
    for t in range(3):
        X[t] += 0.5 * ((yy - 17) ** 2 + (xx - 14) ** 2 <= (2 + t) ** 2)
    sinos = (tg.gel_operator(info, 32, np.arange(36))
             @ X.reshape(3, -1).T).T.reshape(3, 36, 40)
    e = np.random.default_rng(7).standard_normal(sinos.shape)
    sinos += 0.01 * np.linalg.norm(sinos) / np.linalg.norm(e) * e
    _write_bundle(path, sinos, deg, 40, PIXEL)
    kw = dict(nx=32, angle_step=3, data_dir=str(path))
    return (jg.generate_gelPhantom(**kw), tg.generate_gelPhantom(**kw),
            info["angles"][::3], X.reshape(-1))


def _gel_cgls(CGLS, op, b, x0, x_true):
    x, info = CGLS(op, b, x0, GEL_ITERS, 1e-8, x_true=x_true)
    assert info["its"] == GEL_ITERS
    return np.asarray(x, np.float64).reshape(-1), np.array(info["relError"])


def test_gel_cgls_float64_matches_jax(gel32):
    """Float64 over the exact matrix (the banded pack computes in
    float32): JAX's ELL operator and the port's CSR one."""
    import jax.numpy as jnp

    from trips_tpu.core.linop import BatchedBlockDiagOperator as JaxBlk
    from trips_tpu.solvers import CGLS as JaxCGLS
    from trips_tpu.sparse import EllOperator
    from trips_tpu_torch.core import BatchedBlockDiagOperator
    from trips_tpu_torch.solvers import CGLS
    from trips_tpu_torch.sparse import CsrOperator

    (_, b, AA, _, nx, _, nt), (_, tb, tAA, _, _, _, _), _, x_true = gel32
    n = nt * nx * nx
    jx, jh = _gel_cgls(JaxCGLS, JaxBlk(EllOperator.from_scipy(AA[0]), nt),
                       jnp.asarray(b), jnp.zeros(n), x_true)
    tx, th = _gel_cgls(CGLS, BatchedBlockDiagOperator(CsrOperator.from_scipy(
        tAA[0], dtype=torch.float64, device="cpu"), nt),
        torch.from_numpy(tb), torch.zeros(n, dtype=torch.float64), x_true)
    assert np.linalg.norm(tx - jx) <= 1e-10 * np.linalg.norm(jx)
    np.testing.assert_allclose(th, jh, rtol=1e-10, atol=0)


def test_gel_banded_frames_match_jax(gel32):
    """The float32 bucketed pack over the frames (JAX's bytes on both
    sides): each apply within 1e-6 of JAX's; its float32 CGLS relError
    history within 1e-4 of the float64 one over the exact matrix (float32
    roundoff, amplified as above)."""
    import jax.numpy as jnp

    from trips_tpu.core.linop import BatchedBlockDiagOperator as JaxBlk
    from trips_tpu.sparse import BucketedBandedProjector as JaxBucketed
    from trips_tpu_torch.core import BatchedBlockDiagOperator
    from trips_tpu_torch.solvers import CGLS
    from trips_tpu_torch.sparse import BucketedBandedProjector, CsrOperator

    (_, b, AA, _, nx, _, nt), _, angles, x_true = gel32
    j_op = JaxBucketed.from_scipy_fan(AA[0].astype(np.float32), nx, None,
                                      angles=angles, n_groups=8)
    t_op = BucketedBandedProjector.from_numpy_stacks(
        [[np.asarray(a) for a in st] for st in j_op.stacks], j_op.aidxs,
        j_op.is_cols, j_op.shape, j_op.nx, j_op.det_count, j_op.n_groups,
        j_op.nnz, j_op.n_pad, device="cpu")
    jb, tb = JaxBlk(j_op, nt), BatchedBlockDiagOperator(t_op, nt)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(jb.shape[1]).astype(np.float32)
    y = rng.standard_normal(jb.shape[0]).astype(np.float32)
    for fn, v in (("matvec", x), ("rmatvec", y), ("normal_matvec", x)):
        got = getattr(tb, fn)(torch.from_numpy(v)).double().numpy()
        ref = np.asarray(getattr(jb, fn)(jnp.asarray(v)), np.float64)
        assert np.linalg.norm(got - ref) <= 1e-6 * np.linalg.norm(ref), fn
    n = nt * nx * nx
    _, h32 = _gel_cgls(CGLS, tb, torch.from_numpy(b.astype(np.float32)),
                       torch.zeros(n), x_true)
    _, h64 = _gel_cgls(CGLS, BatchedBlockDiagOperator(CsrOperator.from_scipy(
        AA[0], dtype=torch.float64, device="cpu"), nt), torch.from_numpy(b),
        torch.zeros(n, dtype=torch.float64), x_true)
    np.testing.assert_allclose(h32, h64, rtol=0, atol=1e-4)
