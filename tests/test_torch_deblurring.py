"""trips_tpu_torch.problems.deblurring and utils.images against trips_tpu.

Data generation and noise are the JAX package's host NumPy/SciPy code, so
every array is compared bitwise: each ``gen_xtrue`` signal, ``gen_data``
with and without ``CommitCrime``, ``add_noise`` (Gaussian, Poisson,
Laplace) under one ``np.random.seed``, ``gen_true('h_im')`` at 64 and at a
resampled size, ``build_x_true`` and ``load_image_mat`` on a fixture file
(it never downloads: without its file it raises). The problems' operators
are the port's ``Blur1D``/``Blur2D`` on the asked device and dtype, their
applies held to JAX's to 1e-12 in float64.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as spio
import torch

import trips_tpu.problems as jp
import trips_tpu.utils as ju
import trips_tpu_torch.problems as tp
import trips_tpu_torch.utils as tu

from torch_threads import one_torch_thread  # noqa: F401

CPU = {"device": "cpu"}
SIGNALS = ["sigma", "piecewise", "curve0", "curve1", "curve2", "curve3"]


@pytest.mark.parametrize("n", [100, 137])
def test_gen_xtrue_bitwise(n):
    t, j = tp.Deblurring1D(**CPU), jp.Deblurring1D()
    for s in SIGNALS:
        assert np.array_equal(t.gen_xtrue(n, s), j.gen_xtrue(n, s)), s
    with pytest.raises(ValueError, match="unknown test signal"):
        t.gen_xtrue(n, "nope")


@pytest.mark.parametrize("crime", [False, True])
def test_deblurring1d_data_and_noise_bitwise(crime):
    n, par = 90, 6.0
    t = tp.Deblurring1D(CommitCrime=crime, dtype=torch.float64, **CPU)
    j = jp.Deblurring1D(CommitCrime=crime)
    tA, jA = t.forward_Op_1D(par, n), j.forward_Op_1D(par, n)
    assert np.array_equal(tA.mat.numpy(), np.asarray(jA.mat))
    assert np.array_equal(tA._adj.numpy(), np.asarray(jA._adj))
    assert np.array_equal(t.PSF, j.PSF) and t.center == j.center
    x = t.gen_xtrue(n, "curve0")
    bt, bj = t.gen_data(x), j.gen_data(x)
    assert bt.shape == (n, 1) and np.array_equal(bt, bj)
    assert np.array_equal(t.gen_data(x, parameter=3.0,
                                     boundary_condition="nearest"),
                          j.gen_data(x, parameter=3.0,
                                     boundary_condition="nearest"))
    for opt in ("Gaussian", "Poisson", "Laplace"):
        np.random.seed(5)
        nt, dt = t.add_noise(bt, opt, 0.02)
        np.random.seed(5)
        nj, dj = j.add_noise(bj, opt, 0.02)
        assert np.array_equal(nt, nj) and float(dt) == float(dj), opt
    with pytest.raises(ValueError, match="unknown noise type"):
        t.add_noise(bt, "speckle", 0.01)


@pytest.mark.parametrize("crime", [False, True])
def test_deblurring2d_data_and_noise_bitwise(crime, rng):
    nx = ny = 24
    t = tp.Deblurring2D(CommitCrime=crime, dtype=torch.float64, **CPU)
    j = jp.Deblurring2D(CommitCrime=crime)
    tA = t.forward_Op([5, 5], (1.5, 1.5), nx, ny)
    jA = j.forward_Op([5, 5], (1.5, 1.5), nx, ny)
    assert np.array_equal(tA.psf.numpy(), np.asarray(jA.psf))
    x = t.gen_true("h_im")
    assert np.array_equal(x, j.gen_true("h_im"))
    bt, bj = t.gen_data(x), j.gen_data(x)
    assert np.array_equal(bt, bj)
    v = rng.standard_normal(nx * ny)
    for name in ("matvec", "rmatvec"):
        got = getattr(tA, name)(torch.from_numpy(v)).numpy()
        ref = np.asarray(getattr(jA, name)(jnp.asarray(v)))
        assert np.linalg.norm(got - ref) <= 1e-12 * np.linalg.norm(ref)
    for opt in ("Gaussian", "Poisson", "Laplace"):
        np.random.seed(9)
        nt, dt = t.add_noise(bt, opt, 0.01)
        np.random.seed(9)
        nj, dj = j.add_noise(bj, opt, 0.01)
        assert nt.shape == (nx, ny)
        assert np.array_equal(nt, nj) and float(dt) == float(dj), opt
    assert np.array_equal(t.vec(nt), j.vec(nj))
    assert np.array_equal(t.im(t.vec(nt), (nx, ny)), nj)


def test_gen_true_sizes():
    for nx, ny in ((64, 64), (40, 40), (30, 50)):
        t = tp.Deblurring2D(**CPU)
        j = jp.Deblurring2D()
        assert np.array_equal(t.gen_true("h_im", nx=nx, ny=ny),
                              j.gen_true("h_im", nx=nx, ny=ny))
    with pytest.raises(TypeError, match="dimension of the image"):
        tp.Deblurring2D(**CPU).gen_true("h_im")
    for kw in ({}, dict(dx=4, dy=6, up_width=3, bar_width=2, size=32)):
        assert np.array_equal(tu.build_x_true(**kw), ju.build_x_true(**kw))


def test_load_image_mat_fixture(tmp_path, rng, monkeypatch):
    rgb = rng.random((20, 16, 3))
    gray = rng.random((12, 12))
    spio.savemat(tmp_path / "rgb.mat", {"x_true": rgb})
    spio.savemat(tmp_path / "gray.mat", {"x_true": gray})
    for name in ("rgb", "gray"):
        got = tu.load_image_mat(name, data_dir=str(tmp_path))
        assert np.array_equal(got, ju.load_image_mat(name,
                                                     data_dir=str(tmp_path)))
    np.testing.assert_array_equal(
        tu.load_image_mat("rgb", data_dir=str(tmp_path)),
        0.4 * rgb[:, :, 0] + 0.4 * rgb[:, :, 1] + 0.1 * rgb[:, :, 2])
    with pytest.raises(FileNotFoundError, match="no network egress"):
        tu.load_image_mat("satellite", data_dir=str(tmp_path))
    # gen_true reads ./data/image_data: resampled to the asked size
    (tmp_path / "data" / "image_data").mkdir(parents=True)
    spio.savemat(tmp_path / "data" / "image_data" / "rgb.mat",
                 {"x_true": rgb})
    monkeypatch.chdir(tmp_path)
    t = tp.Deblurring2D(**CPU).gen_true("rgb", nx=10, ny=10)
    j = jp.Deblurring2D().gen_true("rgb", nx=10, ny=10)
    with pytest.raises(FileNotFoundError):
        tp.Deblurring2D(**CPU).gen_true("satellite", nx=10, ny=10)
    assert t.shape == (10, 10) and np.array_equal(t, j)


def test_problems_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid")
    for cls in (tp.Deblurring1D, tp.Deblurring2D):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls()
    prob = tp.Deblurring1D(**CPU)
    assert prob.forward_Op(2.0, 16).dtype == torch.float32
