"""The port's C++ matrix builder (``trips_tpu_torch.native``) against the
JAX package's, on the CPU.

- The fan- and parallel-beam Siddon matrices of both C++ libraries have
  the same sparsity and entries within 1e-12 relative (the two libraries
  are compiled apart, so they are not held bitwise).
- The C++ and NumPy builders of the port each hold to the exact chord
  oracle of ``tests/test_torch_support.py``.
- The banded packs (flat, bucketed in three storage classes, dynamic flat
  and bucketed) are byte-equal to JAX's from the same matrix, with
  ``TRIPS_TPU_NO_NATIVE`` unset (the C++ pack and fill on both sides) and
  set to 1 (the NumPy code on both sides).
- ``TRIPS_TPU_NO_NATIVE=1`` turns the library off; a compiler that is
  missing, or a source that does not compile (a broken copy in a
  temporary directory), raises with the compiler's output.
"""
import numpy as np
import pytest
import torch
from scipy import sparse as sp

import trips_tpu.problems as jp
import trips_tpu_torch.problems as tp
from test_torch_support import _hold_to_oracle
from torch_threads import one_torch_thread  # noqa: F401
from trips_tpu.sparse import BandedProjector as JaxFlat
from trips_tpu.sparse import BucketedBandedProjector as JaxBucketed
from trips_tpu.sparse.dynamic_banded import \
    BucketedDynamicBandedOperator as JaxBucketedDyn
from trips_tpu.sparse.dynamic_banded import DynamicBandedOperator as JaxDyn
from trips_tpu_torch import native
from trips_tpu_torch.sparse import (BandedProjector, BucketedBandedProjector,
                                    BucketedDynamicBandedOperator,
                                    DynamicBandedOperator)

REL = 1e-12


@pytest.fixture
def builder(request, monkeypatch):
    """Both packages on the C++ builder ("cpp") or on NumPy ("numpy")."""
    if request.param == "numpy":
        monkeypatch.setenv("TRIPS_TPU_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("TRIPS_TPU_NO_NATIVE", raising=False)
    return request.param


def _jax_native_loads():
    from trips_tpu.native import load

    return load() is not None


def _same_matrix(a, b, rel=REL):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    assert a.shape == b.shape
    assert np.array_equal(a.indptr, b.indptr)
    assert np.array_equal(a.indices, b.indices)
    assert (np.abs(a.data - b.data) <= rel * np.abs(b.data)).all()


MATRICES = {
    "fan 32x12": lambda m: m.fan_beam_matrix(32, views=12),
    "fan gel-like 40x7": lambda m: m.fan_beam_matrix(
        40, angles=np.linspace(0.1, 2 * np.pi, 7), det_count=60,
        det_width=1.35, source_origin=2768.0, origin_det=964.0),
    "parallel line 24x9": lambda m: m.parallel_beam_matrix(
        24, np.linspace(0, np.pi, 9, endpoint=False), det_count=30,
        det_width=0.9),
}


@pytest.mark.parametrize("builder", ["cpp"], indirect=True)
@pytest.mark.parametrize("name", list(MATRICES))
def test_cpp_matrices_match_jax_cpp(builder, name):
    if not _jax_native_loads():
        pytest.skip("trips_tpu's C++ library does not load here")
    _same_matrix(MATRICES[name](tp), MATRICES[name](jp))


@pytest.mark.parametrize("builder", ["numpy"], indirect=True)
@pytest.mark.parametrize("name", list(MATRICES))
def test_numpy_matrices_match_jax_numpy(builder, name):
    _same_matrix(MATRICES[name](tp), MATRICES[name](jp), rel=0.0)


@pytest.mark.parametrize("builder", ["cpp", "numpy"], indirect=True)
@pytest.mark.parametrize("nx", [32, 40])
def test_builders_match_chord_oracle(builder, nx):
    """Either builder: every entry off the grid-line rays within 1e-9 of
    the exact chord, and the grid-line rays' chords whole."""
    M = tp.fan_beam_matrix(nx, views=12).toarray()
    edge = _hold_to_oracle(M, nx, 12)
    p = int(np.sqrt(2) * nx)
    assert edge.tolist() == ([p // 2, 6 * p + p // 2] if p % 2 else [])


def test_builders_differ_by_roundoff_and_one_chord(monkeypatch):
    """The C++ and NumPy matrices: the same up to roundoff, except for
    the square that holds the chord of the pi/2 middle ray at nx = 32."""
    monkeypatch.delenv("TRIPS_TPU_NO_NATIVE", raising=False)
    C = tp.fan_beam_matrix(32, views=12).toarray()
    monkeypatch.setenv("TRIPS_TPU_NO_NATIVE", "1")
    N = tp.fan_beam_matrix(32, views=12).toarray()
    p = int(np.sqrt(2) * 32)
    rows = np.unique(np.nonzero(np.abs(C - N) > 1e-9)[0])
    assert rows.tolist() == [6 * p + p // 2]
    others = np.delete(np.arange(len(C)), rows)
    assert np.abs(C[others] - N[others]).max() <= 1e-11


def _stacks(op):
    if hasattr(op, "stacks"):
        return [list(st) for st in op.stacks]
    return [[op.W_rows, op.shift_rows, op.P_rows, op.aidx_rows],
            [op.W_cols, op.shift_cols, op.P_cols, op.aidx_cols]]


def _stacks_equal(j_stacks, t_stacks):
    assert len(j_stacks) == len(t_stacks)
    for js, ts in zip(j_stacks, t_stacks):
        assert len(js) == len(ts)
        for a, b in zip(js, ts):
            a = np.asarray(a)
            b = b.view(torch.int16) if b.dtype == torch.bfloat16 else b
            a = a.view(np.int16) if a.dtype.name == "bfloat16" else a
            assert a.shape == tuple(b.shape)
            assert np.array_equal(a, b.numpy()), (a.dtype, b.dtype)


@pytest.mark.parametrize("builder", ["cpp", "numpy"], indirect=True)
def test_packs_byte_equal_to_jax(builder):
    import jax.numpy as jnp

    A = jp.fan_beam_matrix(32, views=12).astype(np.float32)
    for jdt, tdt in ((None, None), (jnp.bfloat16, torch.bfloat16),
                     ("int8", "int8")):
        j = JaxBucketed.from_scipy_fan(A, 32, 12, n_groups=8, n_buckets=2,
                                       dtype=jdt)
        t = BucketedBandedProjector.from_scipy_fan(
            A, 32, 12, n_groups=8, n_buckets=2, dtype=tdt, device="cpu")
        _stacks_equal(j.stacks, t.stacks)
    j = JaxFlat.from_scipy_fan(A, 32, 12, n_groups=8)
    t = BandedProjector.from_scipy_fan(A, 32, 12, n_groups=8, device="cpu")
    _stacks_equal([(j.W_rows, j.shift_rows, j.P_rows),
                   (j.W_cols, j.shift_cols, j.P_cols)],
                  [(t.W_rows, t.shift_rows, t.P_rows),
                   (t.W_cols, t.shift_cols, t.P_cols)])


@pytest.mark.parametrize("builder", ["cpp", "numpy"], indirect=True)
def test_dynamic_packs_byte_equal_to_jax(builder):
    (A, b, AA, B, nx, ny, nt, delta, x_true,
     angles) = jp.generate_synthetic_dynamic(nx=16, nt=3, views=9,
                                             return_angles=True)
    j = JaxDyn.from_frames(AA, nx, angles, n_groups=8)
    t = DynamicBandedOperator.from_frames(AA, nx, angles, n_groups=8,
                                          device="cpu")
    _stacks_equal(_stacks(j), _stacks(t))
    j = JaxBucketedDyn.from_frames(AA, nx, angles, n_groups=8, n_buckets=2)
    t = BucketedDynamicBandedOperator.from_frames(AA, nx, angles, n_groups=8,
                                                  n_buckets=2, device="cpu")
    _stacks_equal(_stacks(j), _stacks(t))


def test_no_native_turns_the_library_off(monkeypatch):
    monkeypatch.setenv("TRIPS_TPU_NO_NATIVE", "1")
    assert native.load() is None
    angles = np.linspace(0, np.pi, 4, endpoint=False)
    assert native.fan_beam_csr_native(8, 8, angles, 11, 1.3, 24, 8) is None
    assert native.parallel_beam_csr_native(8, 8, angles, 8, 1.0) is None
    z = np.zeros(3, np.int32)
    assert native.pack_angle(z, z, z, 8, 4, 2, 128) is None
    assert native.scatter_fill(z, z, z, np.ones(3, np.float32),
                               np.zeros((1, 2, 4), np.float32)) is False
    monkeypatch.delenv("TRIPS_TPU_NO_NATIVE")
    assert native.load() is not None
    W = np.zeros((2, 3, 4), np.float32)
    assert native.scatter_fill([1, 0], [2, 1], [3, 0], [5.0, 7.0], W)
    assert W[1, 2, 3] == 5.0 and W[0, 1, 0] == 7.0 and W.sum() == 12.0
    with pytest.raises(IndexError):
        native.scatter_fill([2], [0], [0], [1.0], W)


def test_library_is_built_once_and_named_by_its_source(monkeypatch,
                                                       tmp_path):
    monkeypatch.delenv("TRIPS_TPU_NO_NATIVE", raising=False)
    monkeypatch.setattr(native, "_OUT", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    lib = native.load()
    assert native.build_info["built"] and lib is not None
    so = native.library_path()
    assert so.parent == tmp_path / "build" and so.exists()
    assert [f.name for f in so.parent.iterdir()] == [so.name]
    monkeypatch.setattr(native, "_lib", None)
    native.load()
    assert not native.build_info["built"]


@pytest.mark.parametrize("fault", ["compiler", "source"])
def test_failed_build_raises(monkeypatch, tmp_path, fault):
    """No silent fallback: a build that fails raises with its output."""
    monkeypatch.delenv("TRIPS_TPU_NO_NATIVE", raising=False)
    monkeypatch.setattr(native, "_OUT", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    if fault == "compiler":
        monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
        match = "no-such-g"
    else:
        src = tmp_path / "projector.cpp"
        src.write_text(native._SRC.read_text() + "\nthis is not C++;\n")
        monkeypatch.setattr(native, "_SRC", src)
        match = "error"
    with pytest.raises(RuntimeError, match=match):
        native.load()
    with pytest.raises(RuntimeError):
        tp.fan_beam_matrix(8, views=3)
    assert not list((tmp_path / "build").glob("*.so"))
