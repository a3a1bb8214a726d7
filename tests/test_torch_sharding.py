"""The sharded operators of ``trips_tpu_torch.parallel`` in one process.

- Partitions: for every rank of a mesh (built as that rank sees it, with
  no process group), the rank's slab of the flat, bucketed float32 and
  int8 banded packs (2 and 4 ranks) and of the dynamic packs (time 2,
  angles 2; 9 views, so some frames hold padded angles) is bitwise the
  real angles of the JAX package's device shard
  (``jax.Array.addressable_shards``) on ``trips_tpu.parallel.make_mesh``
  of the same shape, the port's pack carrying JAX's bytes
  (``from_numpy_stacks``); the ELL tables bitwise JAX's shards, and the
  ELL and BSR-as-CSR row and column partitions the scipy slices of the
  padded matrix.
- At world size 1 (no process group: the all_reduce is the identity),
  every class against its JAX counterpart on a one-device mesh: ELL in
  float64 within 1e-12, BSR-as-CSR in float32 within 1e-5 (JAX's
  ``tests/test_parallel.py`` tolerance), the banded classes in float32
  within 2e-5 absolute and their fused normal apply within 2e-4
  (``tests/test_parallel.py:246-249``, ``:334-345``; float32 sums in
  another order), int8 within 2e-4 and 5e-4. Each apply of every class
  counts one all_reduce.
- The refusals: ``nt`` not a multiple of the time axis, ``ap`` other than
  1, a mesh of several ranks without a process group, an apply on a
  rank's view of such a mesh.

The JAX applies run under ``jax.jit`` (the way its solvers call them): the
same function, compiled once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import sparse as sp

import trips_tpu.parallel as jpar
from trips_tpu.problems import generate_synthetic_dynamic
from trips_tpu.problems.projector import fan_beam_matrix
from trips_tpu.sparse import BandedProjector as JaxFlat
from trips_tpu.sparse import EllOperator as JaxEll
from trips_tpu.sparse.banded_buckets import \
    BucketedBandedProjector as JaxBucketed
from trips_tpu.sparse.dynamic_banded import \
    BucketedDynamicBandedOperator as JaxBucketedDyn
from trips_tpu.sparse.dynamic_banded import DynamicBandedOperator as JaxDyn
from trips_tpu_torch.parallel import (
    Mesh, ShardedBandedProjector, ShardedBsrOperator,
    ShardedBucketedBandedProjector, ShardedBucketedDynamicBandedOperator,
    ShardedDynamicBandedOperator, ShardedDynamicBsrOperator,
    ShardedDynamicOperator, ShardedEllOperator, collective_counts,
    init_multihost, make_mesh, pod_mesh)
from trips_tpu_torch.sparse import (BandedProjector, BucketedBandedProjector,
                                    BucketedDynamicBandedOperator,
                                    DynamicBandedOperator, EllOperator)

from torch_threads import one_torch_thread  # noqa: F401

FLAT_FIELDS = ("W_rows", "shift_rows", "P_rows", "W_cols", "shift_cols",
               "P_cols")


@pytest.fixture(scope="module")
def fan():
    nx, views = 32, 12
    return fan_beam_matrix(nx, views=views).astype(np.float32), nx, views


@pytest.fixture(scope="module")
def dyn():
    return generate_synthetic_dynamic(nx=16, nt=4, views=9,
                                      noise_level=0.0, return_angles=True)


def _static_pair(fan, kind):
    """(JAX pack, the port's pack on its bytes) of ``kind``: flat, bucketed
    (float32, 3 buckets) or int8 (2 buckets)."""
    A, nx, views = fan
    if kind == "flat":
        j = JaxFlat.from_scipy_fan(A, nx, views, n_groups=8)
        t = BandedProjector.from_numpy_stacks(
            *(np.asarray(getattr(j, f)) for f in FLAT_FIELDS[:3]),
            j._angles_rows,
            *(np.asarray(getattr(j, f)) for f in FLAT_FIELDS[3:]),
            j._angles_cols, j.shape, j.nx, j.det_count, j.n_groups, j.nnz,
            n_pad=j.n_pad, device="cpu")
        return j, t
    j = JaxBucketed.from_scipy_fan(
        A, nx, views, n_groups=8, n_buckets=3 if kind == "bucketed" else 2,
        dtype="int8" if kind == "int8" else None)
    t = BucketedBandedProjector.from_numpy_stacks(
        [[np.asarray(a) for a in st] for st in j.stacks], j.aidxs, j.is_cols,
        j.shape, j.nx, j.det_count, j.n_groups, j.nnz, j.n_pad,
        device="cpu")
    return j, t


def _dynamic_pair(dyn, kind):
    _, _, AA, _, nx, _, _, _, _, al = dyn
    if kind == "flat":
        j = JaxDyn.from_frames(AA, nx, al, n_groups=8)
        st = [[np.asarray(getattr(j, f + g)) for f in ("W", "shift", "P",
                                                        "aidx")]
              for g in ("_rows", "_cols")]
    else:
        j = JaxBucketedDyn.from_frames(AA, nx, al, n_groups=8, n_buckets=2,
                                       dtype="int8" if kind == "int8"
                                       else None)
        st = [[np.asarray(a) for a in s] for s in j.stacks]
    args = (j.shape, j.nx, j.det_count, j.views, j.n_groups, j.nnz, j.nt,
            j.n_pad)
    if kind == "flat":
        return j, DynamicBandedOperator.from_numpy_stacks(st, *args,
                                                          device="cpu")
    return j, BucketedDynamicBandedOperator.from_numpy_stacks(
        st, j.is_cols, *args, device="cpu")


def _shard(arr, mesh, pos):
    """(data, index) of JAX's shard of ``arr`` on the device at ``pos`` of
    ``mesh``."""
    s, = [s for s in arr.addressable_shards
          if s.device == mesh.devices[pos]]
    return np.asarray(s.data), s.index


def _japply(op, name, v):
    f = jax.jit(lambda o, u: getattr(o, name)(u))
    return np.asarray(f(op, jnp.asarray(v)))


def _view(shape, names, rank):
    return Mesh(np.arange(int(np.prod(shape))).reshape(shape), names,
                rank=rank)


@pytest.mark.parametrize("kind", ["flat", "bucketed", "int8"])
@pytest.mark.parametrize("S", [2, 4])
def test_banded_slabs_are_jax_shards(fan, kind, S):
    j, t = _static_pair(fan, kind)
    jm = jpar.make_mesh({"rows": S})
    js = (jpar.ShardedBandedProjector.from_banded(j, jm) if kind == "flat"
          else jpar.ShardedBucketedBandedProjector.from_bucketed(
              j, jm, axis="rows"))
    held = 0
    for r in range(S):
        mesh = _view((S,), ("rows",), r)
        ts = (ShardedBandedProjector.from_banded(t, mesh, device="cpu")
              if kind == "flat" else
              ShardedBucketedBandedProjector.from_bucketed(
                  t, mesh, axis="rows", device="cpu"))
        want, ids = [], []
        for W, Sf, Pm, ai, na, _, sc in js._groups():
            _, idx = _shard(W, jm, r)
            a0, a1 = idx[0].start, min(idx[0].stop, na)
            if a1 > a0:
                want.append([_shard(a, jm, r)[0][:a1 - a0]
                             for a in (W, Sf, Pm) + ((sc,) if sc is not None
                                                     else ())])
                ids.append(tuple(ai[a0:a1]))
        assert len(ts.stacks) == len(want) and ts.aidxs == tuple(ids)
        for got, ref in zip(ts.stacks, want):
            assert len(got) == len(ref)
            for g, w in zip(got, ref):
                assert g.numpy().dtype == w.dtype
                np.testing.assert_array_equal(g.numpy(), w)
        held += sum(len(a) for a in ts.aidxs)
    assert held == t.shape[0] // t.det_count  # every angle on one rank


@pytest.mark.parametrize("kind", ["flat", "bucketed", "int8"])
def test_dynamic_slabs_are_jax_shards(dyn, kind):
    j, t = _dynamic_pair(dyn, kind)
    jm = jpar.make_mesh({"time": 2, "angles": 2})
    js = (jpar.ShardedDynamicBandedOperator.from_dynamic(j, jm)
          if kind == "flat" else
          jpar.ShardedBucketedDynamicBandedOperator.from_dynamic(j, jm))
    na = [g[0].shape[1] for g in t._groups()]
    real = 0
    for ti in range(2):
        for ai in range(2):
            ts_cls = (ShardedDynamicBandedOperator if kind == "flat"
                      else ShardedBucketedDynamicBandedOperator)
            ts = ts_cls.from_dynamic(t, _view((2, 2), ("time", "angles"),
                                              2 * ti + ai), device="cpu")
            want = []
            for (W, Sf, Pm, Ai, _, sc), n in zip(js._groups(), na):
                _, idx = _shard(W, jm, (ti, ai))
                a0, a1 = idx[1].start, min(idx[1].stop, n)
                if a1 <= a0:
                    continue
                parts = [_shard(a, jm, (ti, ai))[0][:, :a1 - a0]
                         for a in (W, Sf, Pm)]
                # JAX shards the angle ids over time only
                parts.append(_shard(Ai, jm, (ti, ai))[0][:, a0:a1])
                if sc is not None:
                    parts.append(_shard(sc, jm, (ti, ai))[0][:, :a1 - a0])
                want.append(parts)
                assert ts.frames == (idx[0].start, idx[0].stop)
            assert len(ts.stacks) == len(want)
            for got, ref in zip(ts.stacks, want):
                for g, w in zip(got, ref):
                    np.testing.assert_array_equal(g.numpy(), w)
            real += sum(int(((st[3] >= 0) & (st[3] < t.views)).sum())
                        for st in ts.stacks)
    assert real == t.nt * t.views  # every frame's angles on one rank


@pytest.mark.parametrize("S", [2, 4])
def test_ell_and_bsr_partitions(S):
    A = sp.random(94, 122, density=0.1, format="csr",
                  random_state=np.random.RandomState(5))
    j = jpar.ShardedEllOperator.from_ell(JaxEll.from_scipy(A),
                                         jpar.make_mesh({"rows": S}))
    jm = jpar.make_mesh({"rows": S})
    A32 = A.astype(np.float32)
    for r in range(S):
        mesh = _view((S,), ("rows",), r)
        e = ShardedEllOperator.from_ell(
            EllOperator.from_scipy(A, device="cpu"), mesh, device="cpu")
        assert e.shape == j.shape
        for name, (r0, r1), ncols, M in (
                ("vals", e.rows, A.shape[1], A),
                ("vals_t", e.cols_range, A.shape[0], A.T.tocsr())):
            ref, idx = _shard(getattr(j, name), jm, r)
            assert (r0, r1) == (idx[0].start, min(idx[0].stop, M.shape[0]))
            vals = getattr(e, name).numpy()
            cols = getattr(e, name.replace("vals", "cols")).numpy()
            np.testing.assert_array_equal(vals, ref[:r1 - r0])
            assert not ref[r1 - r0:].any()
            rows = np.repeat(np.arange(r1 - r0), vals.shape[1])
            got = sp.csr_matrix((vals.ravel(), (rows, cols.ravel())),
                                shape=(r1 - r0, ncols))
            assert (got != M[r0:r1]).nnz == 0
        b = ShardedBsrOperator.from_scipy(A, mesh, block_shape=(8, 16),
                                          device="cpu")
        m_pad, n_pad = b.shape
        assert b.rows == (min(r * m_pad // S, 94), min((r + 1) * m_pad // S,
                                                       94))
        assert b.cols_range == (min(r * n_pad // S, 122),
                                min((r + 1) * n_pad // S, 122))
        for op, (r0, r1), M in ((b.fwd, b.rows, A32),
                                (b.adj, b.cols_range, A32.T.tocsr())):
            if r1 <= r0:
                assert op is None
                continue
            got = op.to_scipy()
            assert got.shape[0] == r1 - r0
            assert (got[:, :M.shape[1]] != M[r0:r1]).nnz == 0


def test_ell_operator_tables_match_jax(rng):
    A = sp.random(40, 50, density=0.2, format="csr",
                  random_state=np.random.RandomState(2))
    j, t = JaxEll.from_scipy(A), EllOperator.from_scipy(A, device="cpu")
    for f in ("vals", "cols", "vals_t", "cols_t"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)))
    assert (t.to_scipy() != j.to_scipy()).nnz == 0
    d = EllOperator.from_dense(A.toarray(), dtype=np.float32, device="cpu")
    assert d.vals.dtype == torch.float32 and d.nnz == A.nnz
    x = rng.standard_normal(50)
    np.testing.assert_allclose(t.matvec(torch.from_numpy(x)).numpy(), A @ x,
                               rtol=1e-13, atol=1e-13)


def _counted(op, name, v):
    before = collective_counts["all_reduce"]
    out = getattr(op, name)(torch.from_numpy(v))
    assert collective_counts["all_reduce"] - before == 1
    return out.numpy()


@pytest.mark.parametrize("kind", ["flat", "bucketed", "int8"])
def test_banded_world1_matches_jax(fan, kind, rng):
    """World size 1 against JAX's one-device mesh. Each apply makes one
    all_reduce; JAX's forward makes no psum (its output stays sharded over
    angles), the port's vectors are whole on every rank, so its forward
    sums the ranks' rows once."""
    j, t = _static_pair(fan, kind)
    jm = jpar.make_mesh({"angles": 1})
    js = (jpar.ShardedBandedProjector.from_banded(j, jm, axis="angles")
          if kind == "flat" else
          jpar.ShardedBucketedBandedProjector.from_bucketed(j, jm))
    mesh = make_mesh({"angles": 1})
    ts = (ShardedBandedProjector.from_banded(t, mesh, axis="angles",
                                             device="cpu")
          if kind == "flat" else
          ShardedBucketedBandedProjector.from_bucketed(t, mesh, device="cpu"))
    x = rng.standard_normal(t.shape[1]).astype(np.float32)
    y = rng.standard_normal(t.shape[0]).astype(np.float32)
    tol = {"matvec": (0, 2e-5), "rmatvec": (0, 2e-5),
           "normal_matvec": (2e-4, 2e-4)}
    if kind == "int8":
        tol = {"matvec": (2e-4, 2e-4), "rmatvec": (2e-4, 2e-4),
               "normal_matvec": (5e-4, 5e-4)}
    for name, v in (("matvec", x), ("rmatvec", y), ("normal_matvec", x)):
        rtol, atol = tol[name]
        np.testing.assert_allclose(_counted(ts, name, v),
                                   _japply(js, name, v), rtol=rtol,
                                   atol=atol)
    assert ts.stored_bytes == t.stored_bytes


@pytest.mark.parametrize("kind", ["flat", "bucketed", "int8"])
def test_dynamic_banded_world1_matches_jax(dyn, kind, rng):
    j, t = _dynamic_pair(dyn, kind)
    jm = jpar.make_mesh({"time": 1, "angles": 1})
    mesh = make_mesh({"time": 1, "angles": 1})
    if kind == "flat":
        js = jpar.ShardedDynamicBandedOperator.from_dynamic(j, jm)
        ts = ShardedDynamicBandedOperator.from_dynamic(t, mesh, device="cpu")
    else:
        js = jpar.ShardedBucketedDynamicBandedOperator.from_dynamic(j, jm)
        ts = ShardedBucketedDynamicBandedOperator.from_dynamic(
            t, mesh, device="cpu")
    x = rng.standard_normal(t.shape[1]).astype(np.float32)
    y = rng.standard_normal(t.shape[0]).astype(np.float32)
    for name, v, atol in (("matvec", x, 2e-4), ("rmatvec", y, 2e-4),
                          ("normal_matvec", x, 5e-4)):
        np.testing.assert_allclose(_counted(ts, name, v),
                                   _japply(js, name, v), rtol=2e-4,
                                   atol=atol)
        # the padded angles' rows stay zero, the rest is the operator's
        np.testing.assert_array_equal(
            _counted(ts, name, v), getattr(t, name)(torch.from_numpy(v)))


def test_ell_world1_matches_jax(dyn, rng):
    A = sp.random(96, 120, density=0.1, format="csr",
                  random_state=np.random.RandomState(5))
    jm, mesh = jpar.make_mesh({"rows": 1}), make_mesh({"rows": 1})
    js = jpar.ShardedEllOperator.from_ell(JaxEll.from_scipy(A), jm)
    ts = ShardedEllOperator.from_ell(EllOperator.from_scipy(A, device="cpu"),
                                     mesh, device="cpu")
    x, y = rng.standard_normal(120), rng.standard_normal(96)
    for name, v in (("matvec", x), ("rmatvec", y)):
        np.testing.assert_allclose(_counted(ts, name, v),
                                   _japply(js, name, v), rtol=0, atol=1e-12)
    X = rng.standard_normal((120, 3))
    np.testing.assert_allclose(ts.matmat(torch.from_numpy(X)).numpy(), A @ X,
                               rtol=0, atol=1e-12)

    _, _, AA, _, _, _, _, _, _, _ = dyn
    jm = jpar.make_mesh({"time": 1, "rows": 1})
    js = jpar.ShardedDynamicOperator.from_blocks(AA, jm)
    ts = ShardedDynamicOperator.from_blocks(AA, make_mesh({"time": 1,
                                                           "rows": 1}),
                                            device="cpu")
    assert ts.shape == js.shape and ts.frame_shape == js.frame_shape
    x, y = rng.standard_normal(ts.shape[1]), rng.standard_normal(ts.shape[0])
    for name, v in (("matvec", x), ("rmatvec", y)):
        np.testing.assert_allclose(_counted(ts, name, v),
                                   _japply(js, name, v), rtol=0, atol=1e-12)


def test_bsr_world1_matches_jax(dyn, rng):
    A = sp.random(96, 250, density=0.1, format="csr",
                  random_state=np.random.RandomState(5)).astype(np.float32)
    jm, mesh = jpar.make_mesh({"rows": 1}), make_mesh({"rows": 1})
    js = jpar.ShardedBsrOperator.from_scipy(A, jm, block_shape=(8, 16))
    ts = ShardedBsrOperator.from_scipy(A, mesh, block_shape=(8, 16),
                                       device="cpu")
    assert ts.shape == js.shape
    x = rng.standard_normal(ts.shape[1]).astype(np.float32)
    y = rng.standard_normal(ts.shape[0]).astype(np.float32)
    for name, v in (("matvec", x), ("rmatvec", y)):
        np.testing.assert_allclose(_counted(ts, name, v),
                                   _japply(js, name, v), rtol=0, atol=1e-5)
    X = rng.standard_normal((ts.shape[1], 3)).astype(np.float32)
    np.testing.assert_allclose(ts.matmat(torch.from_numpy(X)).numpy()[:96],
                               A @ X[:250], rtol=0, atol=1e-5)
    # bfloat16 blocks: JAX also rounds x to bfloat16, the port keeps it
    # float32; both within JAX's 2e-2 of the float32 product
    jb = jpar.ShardedBsrOperator.from_scipy(A, jm, block_shape=(8, 16),
                                            block_dtype=jnp.bfloat16)
    tb = ShardedBsrOperator.from_scipy(A, mesh, block_shape=(8, 16),
                                       block_dtype=torch.bfloat16,
                                       device="cpu")
    got, ref = _counted(tb, "matvec", x), A @ x[:250]
    for out in (got, _japply(jb, "matvec", x)):
        assert np.linalg.norm(out[:96] - ref) / np.linalg.norm(ref) < 2e-2
    with pytest.raises(ValueError, match="too diffuse"):
        ShardedBsrOperator.from_scipy(A, mesh, block_shape=(8, 16),
                                      max_stored_gb=1e-6, device="cpu")

    _, _, AA, _, _, _, _, _, _, _ = dyn
    jm = jpar.make_mesh({"time": 1, "rows": 1})
    js = jpar.ShardedDynamicBsrOperator.from_blocks(AA, jm,
                                                    block_shape=(8, 32))
    ts = ShardedDynamicBsrOperator.from_blocks(
        AA, make_mesh({"time": 1, "rows": 1}), block_shape=(8, 32),
        device="cpu")
    assert ts.shape == js.shape and ts.frame_shape == js.frame_shape
    x = rng.standard_normal(ts.shape[1]).astype(np.float32)
    y = rng.standard_normal(ts.shape[0]).astype(np.float32)
    for name, v in (("matvec", x), ("rmatvec", y)):
        np.testing.assert_allclose(_counted(ts, name, v),
                                   _japply(js, name, v), rtol=0, atol=1e-4)


def test_refusals(fan, dyn):
    _, t = _dynamic_pair(dyn, "bucketed")
    with pytest.raises(ValueError, match="multiple of the 'time'"):
        ShardedBucketedDynamicBandedOperator.from_dynamic(
            t, _view((3, 1), ("time", "angles"), 0), device="cpu")
    AA = dyn[2]
    with pytest.raises(ValueError, match="divide over time"):
        ShardedDynamicOperator.from_blocks(
            AA, _view((3, 1), ("time", "rows"), 0), device="cpu")
    _, b = _static_pair(fan, "bucketed")
    b.ap = 2
    with pytest.raises(ValueError, match="ap=1"):
        ShardedBucketedBandedProjector.from_bucketed(b, make_mesh(
            {"angles": 1}), device="cpu")
    with pytest.raises(ValueError, match="needs an initialized"):
        make_mesh({"rows": 2}, ranks=[0, 1])
    with pytest.raises(ValueError, match="need 2 ranks"):
        make_mesh({"rows": 2})
    del b.ap
    view = ShardedBucketedBandedProjector.from_bucketed(
        b, _view((2,), ("angles",), 1), device="cpu")
    with pytest.raises(RuntimeError, match="without a process group"):
        view.matvec(torch.zeros(view.shape[1]))
    assert init_multihost("127.0.0.1:1", 1, 0) is False
    assert init_multihost() is False
    assert pod_mesh().shape == {"time": 1, "rows": 1}
    with pytest.raises(ValueError, match="2 x 0"):
        pod_mesh(time_shards=2)
