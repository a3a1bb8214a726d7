"""Dynamic CT: trips_tpu_torch against trips_tpu on the CPU.

- The generators and the three loaders give the JAX package's outputs
  exactly; the loaders read fixture files each test writes, in the real
  datasets' on-disk formats (as ``tests/test_dataset_fixtures.py`` does).
- ``DynamicBandedOperator`` and ``BucketedDynamicBandedOperator``: the
  port's ``from_frames`` packs the JAX package's bytes in every storage
  class; on the JAX bytes carried across, the plain frame applies (K2, K3,
  K1 over all frames) match JAX's ``matvec`` and ``rmatvec`` to 2e-5 and
  ``normal_matvec`` to 2e-4 of the norm, the tolerances of
  ``tests/test_banded.py``'s dynamic tests (float32 sums in another order);
  a padded angle writes and reads no sinogram row.
- The dynamic demo's solvers (``demos/demo_dynamic_ct.py``: MMGKS with
  anisotropic and isotropic space-time TV and group sparsity, Hybrid LSQR,
  GCV) in float64 over ``CsrOperator`` against JAX over ``EllOperator``:
  iterates to 1e-6 and lam to 1e-6 where lam >= 1e-4, as
  ``tests/test_torch_solvers.py`` holds them (the products sum in another
  order, the projected solves amplify it). Hybrid LSQR's lam is held to
  1e-4 (measured 2.0e-5): its modified GCV divides by (m - trace)^2 with m
  = 528 rows against k <= 5 columns, so the curve moves by 3e-11 for a 1%
  change of lam near its minimum, and the last bits of the bidiagonal move
  the minimum by ~1e-5 while the iterates agree to 1e-6. In float32 over
  the dynamic banded operator: the final relError within 1e-3 (float32
  Krylov bases part by that much between two correct implementations).

The matrices come from the NumPy builder on both sides
(``TRIPS_TPU_NO_NATIVE=1``); nx 16-32, 3-4 frames, 8-9 views, 8 line
groups. With 9 views the row- and column-driven angle counts change from
frame to frame, so the stacks hold padded angles.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as spio
import torch
from scipy import sparse as sp

import trips_tpu.operators as jo
import trips_tpu.problems as jp
import trips_tpu.solvers as js
import trips_tpu_torch.operators as to
import trips_tpu_torch.problems as tp
import trips_tpu_torch.solvers as ts
from trips_tpu.sparse import EllOperator
from trips_tpu.sparse.dynamic_banded import \
    BucketedDynamicBandedOperator as JaxBucketedDyn
from trips_tpu.sparse.dynamic_banded import \
    DynamicBandedOperator as JaxDyn
from trips_tpu_torch.sparse import (BucketedDynamicBandedOperator,
                                    CsrOperator, DynamicBandedOperator)
from trips_tpu_torch.sparse import banded_kernels as bk

from torch_threads import one_torch_thread  # noqa: F401

X_RTOL, LAM_FLAT = 1e-6, 1e-4
LAM_RTOL = {"anisoTV": 1e-6, "isoTV": 1e-6, "GS": 1e-6, "Hybrid_LSQR": 1e-4}
CLASSES = [("flat", None), ("flat", "bfloat16"), ("bucketed", None),
           ("bucketed", "bfloat16"), ("bucketed", "int8")]
JAX_DTYPE = {None: None, "bfloat16": jnp.bfloat16, "int8": "int8"}


@pytest.fixture(autouse=True)
def _numpy_builder(monkeypatch):
    monkeypatch.setenv("TRIPS_TPU_NO_NATIVE", "1")


@pytest.fixture(scope="module")
def problem():
    """The synthetic dynamic problem of both packages, 32x32, 4 frames, 9
    views (padded angles in the stacks)."""
    old = os.environ.get("TRIPS_TPU_NO_NATIVE")
    os.environ["TRIPS_TPU_NO_NATIVE"] = "1"
    try:
        kw = dict(nx=32, nt=4, views=9, noise_level=0.01, return_angles=True)
        return jp.generate_synthetic_dynamic(**kw), \
            tp.generate_synthetic_dynamic(**kw)
    finally:
        if old is None:
            os.environ.pop("TRIPS_TPU_NO_NATIVE")
        else:
            os.environ["TRIPS_TPU_NO_NATIVE"] = old


def _same_outputs(j, t):
    """Tuples of arrays, scipy matrices, lists of them and scalars are
    equal, entry for entry."""
    assert type(j) is type(t) or isinstance(j, (list, tuple))
    if sp.issparse(j):
        assert j.shape == t.shape and (sp.csr_matrix(j)
                                       != sp.csr_matrix(t)).nnz == 0
    elif isinstance(j, (list, tuple)):
        assert len(j) == len(t)
        for a, b in zip(j, t):
            _same_outputs(a, b)
    elif isinstance(j, np.ndarray):
        assert j.dtype == t.dtype and np.array_equal(j, t)
    else:
        assert j == t


def test_synthetic_dynamic_identical(problem):
    j, t = problem
    assert len(t) == 10
    _same_outputs(j, t)
    j3 = jp.generate_synthetic_dynamic(nx=16, nt=3, views=8)
    _same_outputs(j3, tp.generate_synthetic_dynamic(nx=16, nt=3, views=8))


def _pair(problem, kind, dtype):
    """The JAX operator and the port's from_frames on the same frames."""
    _, (A, b, AA, B, nx, ny, nt, delta, x, al) = problem
    if kind == "flat":
        j = JaxDyn.from_frames(AA, nx, al, n_groups=8,
                               dtype=JAX_DTYPE[dtype])
        t = DynamicBandedOperator.from_frames(AA, nx, al, n_groups=8,
                                              dtype=dtype, device="cpu")
    else:
        j = JaxBucketedDyn.from_frames(AA, nx, al, n_groups=8,
                                       dtype=JAX_DTYPE[dtype])
        t = BucketedDynamicBandedOperator.from_frames(
            AA, nx, al, n_groups=8, dtype=dtype, device="cpu")
    return j, t


def _bits(a):
    """An array's bytes as integers (bfloat16 of either package)."""
    if isinstance(a, torch.Tensor):
        a = (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _stacks(op):
    if hasattr(op, "stacks"):
        return [list(st) for st in op.stacks]
    return [[op.W_rows, op.shift_rows, op.P_rows, op.aidx_rows],
            [op.W_cols, op.shift_cols, op.P_cols, op.aidx_cols]]


def _carried(j, kind):
    """The port's operator on the JAX operator's bytes."""
    st = [[np.asarray(a) for a in s] for s in _stacks(j)]
    args = (j.shape, j.nx, j.det_count, j.views, j.n_groups, j.nnz, j.nt,
            j.n_pad)
    if kind == "flat":
        return DynamicBandedOperator.from_numpy_stacks(st, *args,
                                                       device="cpu")
    return BucketedDynamicBandedOperator.from_numpy_stacks(
        st, j.is_cols, *args, device="cpu")


@pytest.mark.parametrize("kind,dtype", CLASSES)
def test_from_frames_bytes_equal_jax(problem, kind, dtype):
    j, t = _pair(problem, kind, dtype)
    sj, st = _stacks(j), _stacks(t)
    assert len(sj) == len(st)
    for a, b in zip(sj, st):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            assert np.array_equal(_bits(u), _bits(v))
    assert t.stored_bytes == j.stored_bytes
    assert (t.shape, t.nnz, t.views, t.n_pad) == (j.shape, j.nnz, j.views,
                                                  j.n_pad)
    # the geometry varies: some frame's stack holds a padded angle
    assert any((_bits(s[3]) == j.views).any() for s in st)


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    a, b = a.reshape(-1).astype(np.float64), np.asarray(b).reshape(-1)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("kind,dtype", CLASSES)
def test_frame_applies_match_jax(problem, kind, dtype, rng):
    j, _ = _pair(problem, kind, dtype)
    t = _carried(j, kind)
    calls = {"fwd": 0, "adj": 0, "ata": 0}

    def count(name, fn):
        def wrapper(*args):
            calls[name] += 1
            return fn(*args)
        return wrapper

    for name in calls:
        setattr(t, "_" + name, count(name, getattr(t, "_" + name)))
    x = rng.standard_normal(t.shape[1]).astype(np.float32)
    y = rng.standard_normal(t.shape[0]).astype(np.float32)
    for fn, v, tol in (("matvec", x, 2e-5), ("rmatvec", y, 2e-5),
                       ("normal_matvec", x, 2e-4)):
        got = getattr(t, fn)(torch.from_numpy(v))
        ref = np.asarray(getattr(j, fn)(jnp.asarray(v)))
        assert got.dtype == torch.float32 and got.shape == ref.shape
        assert _rel(got, ref) <= tol, fn
    # one wrapper call (one launch on the card) over all frames per apply
    assert calls == {"fwd": 1, "adj": 1, "ata": 1}


def test_padded_angles_write_no_row(problem, rng):
    """Weights put into the padded angles' slots (id ``views``, one past
    the frame's sinogram) change nothing: K2 writes no row for them and K3
    reads none."""
    j, _ = _pair(problem, "bucketed", None)
    t = _carried(j, "bucketed")
    x = torch.from_numpy(rng.standard_normal(t.shape[1]).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal(t.shape[0]).astype(np.float32))
    clean = t.matvec(x), t.rmatvec(y)
    pads = 0
    for W, _, _, ids in t.stacks:
        pad = ids == t.views
        pads += int(pad.sum())
        W[pad] = 1.0  # every weight of every padded slot
    assert pads
    X = torch.zeros((t.nt, t.n_pad, t.n_pad))
    X[:, :t.nx, :t.nx] = x.reshape(t.nt, t.nx, t.nx)
    Y = bk.banded_fwd_buckets(X, X.transpose(1, 2).contiguous(), t._bks,
                              t._aidx, t.det_count, t.n_groups, t.views)
    assert Y.shape == (t.nt, t.views, t.det_count)
    assert torch.equal(Y.reshape(-1), clean[0])
    assert torch.equal(t.rmatvec(y), clean[1])


def test_from_frames_checks(problem):
    _, (A, b, AA, B, nx, ny, nt, delta, x, al) = problem
    with pytest.raises(ValueError, match="uniform angle count"):
        DynamicBandedOperator.from_frames(AA, nx, [al[0], al[1][:-1]] + al[2:],
                                          n_groups=8, device="cpu")
    with pytest.raises(ValueError, match="int8"):
        DynamicBandedOperator.from_frames(AA, nx, al, n_groups=8,
                                          dtype="int8", device="cpu")
    j, _ = _pair(problem, "bucketed", None)
    st = [[np.asarray(a) for a in s] for s in _stacks(j)]
    st[0][3] = np.full_like(st[0][3], j.views)  # frames lose their rows
    with pytest.raises(ValueError, match="angle ids"):
        BucketedDynamicBandedOperator.from_numpy_stacks(
            st, j.is_cols, j.shape, j.nx, j.det_count, j.views, j.n_groups,
            j.nnz, j.nt, j.n_pad, device="cpu")


def test_cgls_normal_on_dynamic_operator(problem):
    """The frame-batched fused normal apply solves end to end, as JAX's
    ``test_dynamic_banded_frame_varying`` does (30 iterations)."""
    from trips_tpu_torch.krylov import cgls_normal

    _, (A, b, AA, B, nx, ny, nt, delta, x_true, al) = problem
    _, t = _pair(problem, "bucketed", "int8")
    xr, _ = cgls_normal(t, torch.from_numpy(b.astype(np.float32)),
                        torch.zeros(t.shape[1]), 30, 0.0)
    assert _rel(xr, x_true) < 0.6


# ---- the dynamic demo's solvers ----------------------------------------
@pytest.fixture(scope="module")
def small():
    """demos/demo_dynamic_ct.py's problem at 16x16, 3 frames, 8 views."""
    old = os.environ.get("TRIPS_TPU_NO_NATIVE")
    os.environ["TRIPS_TPU_NO_NATIVE"] = "1"
    try:
        out = jp.generate_synthetic_dynamic(nx=16, nt=3, views=8,
                                            noise_level=0.01,
                                            return_angles=True)
    finally:
        if old is None:
            os.environ.pop("TRIPS_TPU_NO_NATIVE")
        else:
            os.environ["TRIPS_TPU_NO_NATIVE"] = old
    A, b, AA, B, nx, ny, nt, delta, x_true, al = out
    return dict(A=A, b=b, AA=AA, B=B, dims=(nx, ny, nt), x_true=x_true,
                al=al)


def _demo(s, o, b, dims, mode, n_iter, x_true):
    """One of the demo's dynamic solves with package ``s``'s solvers and
    operators."""
    nx, ny, nt = dims
    cpu = {"device": "cpu"} if s is ts else {}
    ops = to if s is ts else jo
    kw = dict(n_iter=n_iter, regparam="gcv", x_true=x_true)
    if mode == "Hybrid_LSQR":
        return s.Hybrid_LSQR(o, b, **kw)
    kw.update(pnorm=2, qnorm=1, projection_dim=4)
    if mode == "anisoTV":
        return s.MMGKS(o, b, ops.SpaceTimeDerivative(nx, ny, nt, **cpu), **kw)
    if mode == "isoTV":
        return s.MMGKS(o, b, ops.CenteredSpaceTimeDerivative(nx, ny, nt,
                                                             **cpu),
                       isoTV="isoTV", prob_dims=dims, **kw)
    return s.MMGKS(o, b, None, GS="GS", prob_dims=dims, **kw)


MODES = ["anisoTV", "isoTV", "GS", "Hybrid_LSQR"]


def _held_lams(t, j, rtol):
    t, j = np.asarray(t, float), np.asarray(j, float)
    assert t.shape == j.shape
    held = j >= LAM_FLAT
    np.testing.assert_allclose(t[held], j[held], rtol=rtol, atol=0)


@pytest.mark.parametrize("mode", MODES)
def test_demo_solvers_f64_csr_match_jax_ell(small, mode):
    d = small
    tx, ti = _demo(ts, CsrOperator.from_scipy(d["A"], device="cpu"), d["b"],
                   d["dims"], mode, 4, d["x_true"])
    jx, ji = _demo(js, EllOperator.from_scipy(d["A"]), d["b"], d["dims"],
                   mode, 4, d["x_true"])
    assert tx.dtype == torch.float64 and tx.shape == jx.shape
    assert ti["its"] == ji["its"]
    assert len(ti["xHistory"]) == len(ji["xHistory"])
    for a, b in zip(ti["xHistory"], ji["xHistory"]):
        assert _rel(a, np.asarray(b)) <= X_RTOL
    _held_lams(ti["regParam_history"], ji["regParam_history"],
               LAM_RTOL[mode])
    np.testing.assert_allclose(ti["relError"], ji["relError"], rtol=X_RTOL)


@pytest.mark.parametrize("mode", MODES)
def test_demo_solvers_f32_dynamic_banded_match_jax(small, mode):
    d = small
    nx, ny, nt = d["dims"]
    jop = JaxDyn.from_frames(d["AA"], nx, d["al"], n_groups=8)
    top = _carried(jop, "flat")
    b = d["b"].astype(np.float32)
    tx, ti = _demo(ts, top, torch.from_numpy(b), d["dims"], mode, 4,
                   d["x_true"])
    jx, ji = _demo(js, jop, jnp.asarray(b), d["dims"], mode, 4, d["x_true"])
    assert tx.dtype == torch.float32
    assert abs(ti["relError"][-1] - ji["relError"][-1]) <= 1e-3


# ---- the loaders on fixture files ---------------------------------------
@pytest.fixture()
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _block_diag(rng, nt, block_m, block_n, density=0.3):
    blocks = []
    for _ in range(nt):
        M = (rng.random((block_m, block_n)) < density) * rng.random(
            (block_m, block_n))
        M[-1, -1] = 1.0
        blocks.append(sp.csr_matrix(M))
    return sp.csc_matrix(sp.block_diag(blocks))


def _both_loaders(name, *args, seed=0, **kw):
    """The JAX package's and the port's loader on the same file, the same
    NumPy seed before each."""
    out = []
    for mod in (jp, tp):
        np.random.seed(seed)
        out.append(getattr(mod, name)(*args, **kw))
    return out


@pytest.mark.parametrize("noise", [0, 0.05])
def test_emoji_loader_identical(in_tmp, noise):
    import h5py

    rng = np.random.default_rng(0)
    T, N, mm = 33, 4, 2
    A = _block_diag(rng, T, 3 * 2, N * N)
    os.makedirs("data/emoji_data")
    with h5py.File("data/emoji_data/DataDynamic_128x30.mat", "w") as f:
        g = f.create_group("A")
        g["data"], g["ir"], g["jc"] = A.data, A.indices, A.indptr
        f["sinogram"] = rng.random((mm, 3 * T)).T
    j, t = _both_loaders("generate_emoji", 30, noise_level=noise)
    assert len(t) == (8 if noise else 7)
    _same_outputs(j, t)


def test_crossphantom_loader_identical(in_tmp):
    rng = np.random.default_rng(2)
    T, N, mm = 16, 4, 2
    A = _block_diag(rng, T, 3 * 2, N * N)
    os.makedirs("data/crossphantom_data")
    spio.savemat("data/crossphantom_data/DataDynamic_128x15.mat",
                 {"A": A, "sinogram": rng.random((mm, 3 * T))})
    j, t = _both_loaders("generate_crossPhantom", 15, noise_level=0.02)
    _same_outputs(j, t)


def test_stempo_real_loader_identical(in_tmp):
    import h5py

    rng = np.random.default_rng(3)
    thinning, nt = 8, 8
    N = 2240 // thinning
    A = sp.csc_matrix((rng.random(200), (rng.integers(0, N * 45, 200),
                                         rng.integers(0, N * N, 200))),
                      shape=(N * 45, N * N))
    os.makedirs("data/stempo_data")
    with h5py.File(f"data/stempo_data/stempo_seq8x45_2d_b{thinning}.mat",
                   "w") as f:
        f.create_group("CtData")["sinogram"] = rng.random((45 * nt, N)).T
    with h5py.File("data/stempo_data/A_seqData.mat", "w") as f:
        g = f.create_group("A")
        g["data"], g["ir"], g["jc"] = A.data, A.indices, A.indptr
    j, t = _both_loaders("generate_stempo", "real", data_thinning=thinning,
                         noise_level=0.01)
    _same_outputs(j, t)


def test_stempo_simulation_identical(in_tmp):
    """Simulation mode: the ground truth resampled to 16x16 (``interp2linear``,
    ``image_to_new_size``), per-frame Joseph parallel-beam matrices at
    rotating angles."""
    rng = np.random.default_rng(4)
    os.makedirs("data/stempo_data")
    spio.savemat("data/stempo_data/stempo_ground_truth_2d_b4.mat",
                 {"obj": rng.random((20, 24, 360))})
    j, t = _both_loaders("generate_stempo", "simulation", views=5,
                         new_shape=(16, 16), nt=3, noise_level=0.01)
    _same_outputs(j, t)
    from trips_tpu.utils.images import image_to_new_size as jresize

    from trips_tpu_torch.utils import image_to_new_size
    img = rng.random((9, 7))
    np.testing.assert_array_equal(image_to_new_size(img, (12, 5)),
                                  jresize(img, (12, 5)))


def test_loaders_without_files_raise(in_tmp):
    """No file, no download: FileNotFoundError with the guidance."""
    for name, args in (("generate_emoji", (30,)),
                       ("generate_crossPhantom", (15,)),
                       ("generate_stempo", ("simulation",))):
        with pytest.raises(FileNotFoundError,
                           match="generate_synthetic_dynamic"):
            getattr(tp, name)(*args)
