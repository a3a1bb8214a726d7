"""trips_tpu_torch.operators.blur and .framelet against trips_tpu on the CPU.

- The PSF builders, ``analysis_matrix`` and ``Blur1D``'s two matrices are
  host NumPy/SciPy code copied as it is: bitwise equal.
- ``Blur1D`` applies (a dense product in another BLAS): 1e-12 relative in
  float64.
- ``Blur2D`` (an index-gather symmetric pad and one ``conv2d``, against
  JAX's ``jnp.pad`` and ``conv_general_dilated``) for PSFs (3, 3), (9, 9)
  and the even (4, 6), on square and non-square images: every apply and
  column apply within 1e-12 relative in float64 and, in float32, within
  1e-6 of JAX's float64; each against ``scipy.ndimage.convolve`` (the
  reference's own call) to 1e-12. The port's ``rmatvec`` is the
  flipped-PSF convolution, not the transpose.
- ``FrameletOperator`` (l = 1, 2, 3; two products per apply on the F-order
  image): within 1e-12 of JAX's; the tight frame W^T W = I and
  <Wx, y> = <x, W^T y> to 1e-12.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import convolve, convolve1d

import trips_tpu.operators as jo
import trips_tpu.operators.blur as jblur
import trips_tpu_torch.operators as to
import trips_tpu_torch.operators.blur as tblur

from torch_threads import one_torch_thread  # noqa: F401

CPU = {"device": "cpu"}
F64 = dict(dtype=torch.float64, **CPU)


def _rel(a, b):
    a = np.asarray(a, dtype=float).reshape(-1)
    b = np.asarray(b, dtype=float).reshape(-1)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("n, parameter", [(64, 4.0), (101, 0.7), (50, 0)])
def test_psfs_bitwise(n, parameter):
    if parameter:
        for fn in ("gauss_psf_1d", "defocus_psf_1d"):
            tp, tc = getattr(tblur, fn)(n, parameter)
            jp, jc = getattr(jblur, fn)(n, parameter)
            assert tc == jc and np.array_equal(tp, jp)
    else:
        tp, tc = tblur.defocus_psf_1d(n, 0)
        jp, jc = jblur.defocus_psf_1d(n, 0)
        assert tc == jc and np.array_equal(tp, jp)
    for dim, spread in (((9, 9), (3, 3)), ((4, 6), (1.0, 2.0)), ((5, 5), 1.5)):
        tp, tc = tblur.gauss_psf_2d(dim, spread)
        jp, jc = jblur.gauss_psf_2d(dim, spread)
        assert np.array_equal(tp, jp) and np.array_equal(tc, jc)


@pytest.mark.parametrize("n, l", [(8, 1), (16, 2), (12, 3)])  # noqa: E741
def test_analysis_matrix_bitwise(n, l):  # noqa: E741
    from trips_tpu.operators.framelet import construct_filters as jcf
    from trips_tpu_torch.operators.framelet import construct_filters as tcf

    assert np.array_equal(to.analysis_matrix(n, l), jo.analysis_matrix(n, l))
    for a, b in zip(tcf(l, n), jcf(l, n)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("bc", ["reflect", "constant", "wrap"])
def test_blur1d_matches_jax(rng, bc):
    n = 60
    t = to.Blur1D(n, 4.0, bc, **F64)
    j = jo.Blur1D(n, 4.0, bc)
    assert np.array_equal(t.mat.numpy(), np.asarray(j.mat))
    assert np.array_equal(t._adj.numpy(), np.asarray(j._adj))
    x, X = rng.standard_normal(n), rng.standard_normal((n, 3))
    tx, tX = torch.from_numpy(x), torch.from_numpy(X)
    assert _rel(t.matvec(tx), j.matvec(jnp.asarray(x))) <= 1e-12
    assert _rel(t.rmatvec(tx), j.rmatvec(jnp.asarray(x))) <= 1e-12
    assert _rel(t.rmatmat(tX), j.rmatmat(jnp.asarray(X))) <= 1e-12
    # the reference's adjoint: the reversed-PSF convolution, not mat.T
    assert _rel(t.rmatvec(tx), convolve1d(x, t.psf[::-1], mode=bc)) <= 1e-12
    assert _rel(t.matvec(tx), convolve1d(x, t.psf, mode=bc)) <= 1e-12
    assert t.shape == (n, n) and t.dtype == torch.float64


CASES = [((3, 3), (1.0, 1.0), 16, 16), ((9, 9), (3, 3), 20, 20),
         ((4, 6), (1.0, 2.0), 12, 12), ((9, 9), (3, 3), 14, 22),
         ((4, 6), (1.0, 2.0), 17, 11)]


@pytest.mark.parametrize("dim, spread, nx, ny", CASES)
def test_blur2d_matches_jax_and_scipy(rng, dim, spread, nx, ny):
    j = jo.Blur2D(dim, spread, nx, ny)
    t64 = to.Blur2D(dim, spread, nx, ny, **F64)
    t32 = to.Blur2D(dim, spread, nx, ny, device="cpu")
    assert t32.dtype == torch.float32 and t64.shape == (nx * ny, nx * ny)
    psf = t64.psf.numpy()
    assert np.array_equal(psf, np.asarray(j.psf))
    x = rng.standard_normal(nx * ny)
    X = rng.standard_normal((nx * ny, 3))
    for name, arg in (("matvec", x), ("rmatvec", x), ("matmat", X),
                      ("rmatmat", X)):
        ref = np.asarray(getattr(j, name)(jnp.asarray(arg)))
        got = getattr(t64, name)(torch.from_numpy(arg))
        assert got.shape == ref.shape
        assert _rel(got, ref) <= 1e-12, name
        got32 = getattr(t32, name)(torch.from_numpy(arg).float())
        assert got32.dtype == torch.float32
        assert _rel(got32, ref) <= 1e-6, name
    img = x.reshape(nx, ny)
    fwd = convolve(img, psf, mode="reflect").reshape(-1)
    adj = convolve(img, psf[::-1, ::-1], mode="reflect").reshape(-1)
    assert _rel(t64.matvec(torch.from_numpy(x)), fwd) <= 1e-12
    assert _rel(t64.rmatvec(torch.from_numpy(x)), adj) <= 1e-12


def test_blur2d_pad_index_is_numpy_symmetric():
    """The index gather is np.pad(mode='symmetric'), also for pads wider
    than the axis (NumPy reflects again)."""
    for n, lo, hi in ((5, 2, 3), (4, 4, 0), (3, 5, 7), (1, 2, 2)):
        a = np.arange(n)
        assert np.array_equal(a[tblur._symmetric_index(n, lo, hi)],
                              np.pad(a, (lo, hi), mode="symmetric"))


@pytest.mark.parametrize("n, m, l", [(8, 8, 1), (12, 10, 2), (9, 14, 3)])  # noqa: E741
def test_framelet_matches_jax(rng, n, m, l):  # noqa: E741
    j = jo.FrameletOperator(n, m, l)
    t = to.FrameletOperator(n, m, l, **F64)
    assert t.shape == j.shape
    x = rng.standard_normal(n * m)
    y = rng.standard_normal(t.shape[0])
    X = rng.standard_normal((n * m, 3))
    Y = rng.standard_normal((t.shape[0], 3))
    for name, arg in (("matvec", x), ("rmatvec", y), ("matmat", X),
                      ("rmatmat", Y)):
        ref = np.asarray(getattr(j, name)(jnp.asarray(arg)))
        got = getattr(t, name)(torch.from_numpy(arg))
        assert got.shape == ref.shape and _rel(got, ref) <= 1e-12, name
    # F-order: the image of x is x.reshape(n, m, order='F')
    Wn, Wm = to.analysis_matrix(n, l), to.analysis_matrix(m, l)
    img = x.reshape(n, m, order="F")
    assert _rel(t.matvec(torch.from_numpy(x)),
                (Wn @ img @ Wm.T).reshape(-1, order="F")) <= 1e-12
    # tight frame and exact adjoint
    D = t.todense().numpy()
    assert np.abs(D.T @ D - np.eye(n * m)).max() <= 1e-12
    lhs = float(t.matvec(torch.from_numpy(x)) @ torch.from_numpy(y))
    rhs = float(torch.from_numpy(x) @ t.rmatvec(torch.from_numpy(y)))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)
    t32 = to.FrameletOperator(n, m, l, device="cpu")
    assert _rel(t32.matvec(torch.from_numpy(x).float()),
                t.matvec(torch.from_numpy(x))) <= 1e-6


def test_operators_default_to_the_card():
    """Without a card the default device raises; nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid")
    for make in (lambda: to.Blur1D(8, 1.0), lambda: to.Blur2D(
            (3, 3), 1.0, 4, 4), lambda: to.FrameletOperator(4, 4, 1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
