"""What the redesigned K1-K3 and K6 wrappers compute on the host, and the
entry points' device default, on the CPU.

- ``shear_kernels.k_split``: K6's split of the C*C axis covers ``[0, K)``
  exactly once, in ascending block order (the order its partials are
  summed), in whole tiles (64 rows, as ``csrc/shear.cu`` has them).
- ``banded_kernels.launch_plan``: K1's cluster, and K2's and K3's parts,
  chunks and TMA boxes for every bucket of tomo256x60 (n = 256) and of
  nx = 300 (n = 384, 20 views) stay within the 227 KB of shared memory a
  block may have; a plan that cannot fit is refused.
- The 3xTF32 split of K6's float32 path, emulated by rounding mantissas to
  TF32 in torch: hi.hi + hi.lo + lo.hi is within 1e-6 of the float64
  product (single TF32 is not).
- ``shear_kernels.rotate_plan``: K4's and K5's footprint per output tile
  holds every tap of the 8-tap chain (brute force over every output of
  tomo256x60, nx = 300 and random shifts beyond +-C, each tile shape of the
  sweep); K5's view lists cover each view once; what the kernels cannot run
  is refused; the staged tile, emulated in NumPy, computes the plain
  versions' functions.
- Every public entry point defaults to ``device="cuda"`` and, with no card,
  raises instead of running on the CPU: the operators and problems, the
  fused, info and checkpointed solvers, ``lsqr`` and the device parameter
  searches.
"""
import inspect

import numpy as np
import pytest
import torch

from trips_tpu_torch.operators import (OnTheFlyFanProjector,
                                       OnTheFlyParallelProjector,
                                       ShearFanProjector,
                                       ShearStackParallelProjector)
from trips_tpu_torch.operators.shear_kernels import (SMEM_BYTES as
                                                     ROTATE_SMEM_BYTES,
                                                     TILES, k_split,
                                                     rotate_plan,
                                                     rotate_smem_bytes)
from trips_tpu_torch.problems import (Tomography, device_sparse_operator,
                                      fan_beam_matrix)
from trips_tpu_torch import sparse
from trips_tpu_torch.core import DenseOperator, aslinearoperator
from trips_tpu_torch.krylov import lsqr
from trips_tpu_torch.regparam import device as regdev
from trips_tpu_torch.solvers import checkpointed, fused, fused_info
from trips_tpu_torch.sparse import BucketedBandedProjector
from trips_tpu_torch.sparse.banded_kernels import (SMEM_BYTES, launch_plan,
                                                   tile_plan)

from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("K,blocks", [(160000, 132), (10000, 132),
                                      (43264, 114), (256, 132), (4096, 1),
                                      (160000, 7)])
def test_k_split_covers_k_once_in_order(K, blocks):
    chunk, nsplit = k_split(K, blocks, 64)
    assert chunk % 64 == 0 and 1 <= nsplit <= blocks
    ranges = [(s * chunk, min(K, (s + 1) * chunk)) for s in range(nsplit)]
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert k_split(K, blocks, 64) == (chunk, nsplit)


def _pack_taps(nx, views):
    """T of every bucket of the Tomography geometry's bucketed pack."""
    theta = np.linspace(0, np.pi, views, endpoint=False)
    so, od = 3 * nx, nx
    A = fan_beam_matrix(nx, nx, angles=theta, det_count=int(np.sqrt(2) * nx),
                        det_width=(so + od) / so, source_origin=so,
                        origin_det=od)
    op = BucketedBandedProjector.from_scipy_fan(
        A, nx, None, angles=theta, n_groups=32, device="cpu")
    return [st[0].shape[1] for st in op.stacks], op.n_pad


@pytest.fixture(scope="module")
def geometries():
    return {"tomo256x60": _pack_taps(256, 60), "nx300": _pack_taps(300, 20)}


@pytest.mark.parametrize("itemsize", [4, 2, 1])
@pytest.mark.parametrize("geometry", ["tomo256x60", "nx300"])
def test_ata_plan_fits_shared_memory(geometries, geometry, itemsize):
    taps, n = geometries[geometry]
    assert n == {"tomo256x60": 256, "nx300": 384}[geometry]
    pl = launch_plan("banded_ata", tuple(taps), n, itemsize)
    assert pl["parts"] in (1, 2, 4, 8, 16) and pl["det"] in (32, 64)
    assert pl["parts"] * pl["lines"] >= n
    assert pl["smem_bytes"] <= SMEM_BYTES
    for T, b in zip(taps, pl["buckets"]):
        assert b["parts"] == pl["parts"] and b["lines"] == pl["lines"]
        assert b["chunks"] * b["chunk_lines"] >= b["lines"]
        assert T % b["taps_per_box"] == 0 and b["taps_per_box"] <= 256
        assert b["chunk_lines"] <= 256
        assert b["smem_bytes"] <= pl["smem_bytes"]
    if geometry == "tomo256x60":
        # bf16 and int8 slabs come in one load; float32 tiles (64
        # detectors, 26 KB slabs) in at most three chunks, all but the
        # last reloaded from L2
        most = 3 if itemsize == 4 else 1
        assert all(b["chunks"] <= most for b in pl["buckets"])


def test_ata_plan_refuses_what_does_not_fit():
    assert tile_plan("banded_ata", 15, 12288, 4)["chunks"] > 1  # in chunks
    with pytest.raises(ValueError, match="shared memory"):
        tile_plan("banded_ata", 2000, 256, 4)


@pytest.mark.parametrize("itemsize", [4, 2, 1])
@pytest.mark.parametrize("geometry", ["tomo256x60", "nx300"])
@pytest.mark.parametrize("kernel", ["banded_fwd", "banded_adj"])
def test_fwd_adj_plans_fit_shared_memory(geometries, kernel, geometry,
                                         itemsize):
    """K2's parts are a cluster (at most 16 blocks); K3's are independent
    blocks. Each TMA box is legal: at most 256 per dimension, its tap count
    a divisor of T, rows of 16-byte multiples."""
    taps, n = geometries[geometry]
    pl = launch_plan(kernel, tuple(taps), n, itemsize)
    assert pl["det"] in (32, 64) and pl["det"] * itemsize % 16 == 0
    assert pl["parts"] * pl["lines"] >= n and pl["lines"] >= 1
    if kernel == "banded_fwd":
        assert pl["parts"] in (1, 2, 4, 8, 16)
    assert pl["smem_bytes"] <= SMEM_BYTES
    for T, b in zip(taps, pl["buckets"]):
        assert b["parts"] == pl["parts"] and b["lines"] == pl["lines"]
        assert b["chunks"] * b["chunk_lines"] >= b["lines"]
        assert 1 <= b["chunk_lines"] <= 256
        assert T % b["taps_per_box"] == 0 and b["taps_per_box"] <= 256
        assert b["smem_bytes"] == T * b["chunk_lines"] * pl["det"] * itemsize
        assert b["smem_bytes"] <= pl["smem_bytes"]


@pytest.mark.parametrize("kernel", ["banded_fwd", "banded_adj"])
def test_fwd_adj_plans_refuse_what_does_not_fit(kernel):
    assert tile_plan(kernel, 15, 12288, 4)["chunks"] > 1  # in chunks
    with pytest.raises(ValueError, match="shared memory"):
        tile_plan(kernel, 2000, 256, 4)


def _tf32(x):
    """Round float32 to TF32 (10 mantissa bits), nearest, ties away from
    zero, as cvt.rna.tf32.f32 does."""
    b = x.view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("shape", [(64, 2048, 96), (60, 4096, 64)])
def test_3xtf32_split_matches_float64(shape):
    m, k, n = shape
    rng = np.random.default_rng(0)
    A = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    Ah, Bh = _tf32(A), _tf32(B)
    Al, Bl = _tf32(A - Ah), _tf32(B - Bh)
    assert torch.equal(Ah + (A - Ah), A)  # exact before lo is rounded
    exact = A.double() @ B.double()

    def rel(C):
        return float((C.double() - exact).norm() / exact.norm())

    # each TF32 product is exact in float64; the sums round to float32
    three = (Al.double() @ Bh.double() + Ah.double() @ Bl.double()
             + Ah.double() @ Bh.double()).float()
    assert rel(three) <= 1e-6
    assert rel((Ah.double() @ Bh.double()).float()) > 1e-5  # one pass: no


def _entry_points():
    theta = np.linspace(0, np.pi, 4, endpoint=False)
    A = fan_beam_matrix(8, angles=theta)
    return {
        "Tomography": (Tomography, lambda: Tomography()),
        "device_sparse_operator": (
            device_sparse_operator,
            lambda: device_sparse_operator(A, nx=8, angles=theta)),
        "BucketedBandedProjector": (
            BucketedBandedProjector,
            lambda: BucketedBandedProjector([], [], [], A.shape, 8, 11, 1, 0,
                                            8)),
        "BucketedBandedProjector.from_scipy_fan": (
            BucketedBandedProjector.from_scipy_fan,
            lambda: BucketedBandedProjector.from_scipy_fan(
                A, 8, None, angles=theta, n_groups=1)),
        "BucketedBandedProjector.from_numpy_stacks": (
            BucketedBandedProjector.from_numpy_stacks,
            lambda: BucketedBandedProjector.from_numpy_stacks(
                [(np.zeros((1, 1, 8, 32), np.float32),
                  np.zeros((1, 8), np.int32), np.zeros((1, 1, 32), np.int32))],
                [[0]], [False], A.shape, 8, 11, 1, 0, 8)),
        "ShearFanProjector": (ShearFanProjector,
                              lambda: ShearFanProjector(16, views=4)),
        "ShearFanProjector.from_numpy": (
            ShearFanProjector.from_numpy,
            lambda: ShearFanProjector.from_numpy(
                np.zeros((16, 16, 128)), *[np.zeros((4, 16))] * 4,
                np.zeros(4, int), 16, 8, 11, 24.0, 8.0, 4 / 3)),
        "OnTheFlyParallelProjector": (
            OnTheFlyParallelProjector,
            lambda: OnTheFlyParallelProjector(8, theta)),
        "OnTheFlyFanProjector": (OnTheFlyFanProjector,
                                 lambda: OnTheFlyFanProjector(8, views=4)),
        "ShearStackParallelProjector": (
            ShearStackParallelProjector,
            lambda: ShearStackParallelProjector(8, theta)),
        "BandedProjector.from_scipy_fan": (
            sparse.BandedProjector.from_scipy_fan,
            lambda: sparse.BandedProjector.from_scipy_fan(
                A, 8, None, angles=theta, n_groups=1)),
        "DynamicBandedOperator.from_frames": (
            sparse.DynamicBandedOperator.from_frames,
            lambda: sparse.DynamicBandedOperator.from_frames(
                [A, A], 8, [theta, theta], n_groups=1)),
        "BucketedDynamicBandedOperator.from_frames": (
            sparse.BucketedDynamicBandedOperator.from_frames,
            lambda: sparse.BucketedDynamicBandedOperator.from_frames(
                [A, A], 8, [theta, theta], n_groups=1)),
        "CsrOperator.from_scipy": (sparse.CsrOperator.from_scipy,
                                   lambda: sparse.CsrOperator.from_scipy(A)),
        "aslinearoperator": (aslinearoperator, lambda: aslinearoperator(A)),
        **_solver_entry_points(),
    }


def _solver_entry_points():
    """The fused, info and checkpointed solvers, ``lsqr`` and the device
    parameter searches, each called with CPU inputs and no device."""
    D = DenseOperator(torch.eye(4, dtype=torch.float64))
    b, R = np.ones(4), np.eye(4)
    calls = {
        "lsqr": (lsqr, lambda: lsqr(D, b, 3)),
        "fminbound": (regdev.fminbound,
                      lambda: regdev.fminbound(lambda x: x * x, 0.0, 1.0)),
        "gcv_lambda": (regdev.gcv_lambda,
                       lambda: regdev.gcv_lambda(R, R, b)),
        "lcurve_lambda": (regdev.lcurve_lambda,
                          lambda: regdev.lcurve_lambda(R, R, b)),
        "dp_lambda": (regdev.dp_lambda, lambda: regdev.dp_lambda(R, b, 0.1)),
        "gcv_tsvd_k": (regdev.gcv_tsvd_k, lambda: regdev.gcv_tsvd_k(b, 3)),
        "gcv_tgsvd_k": (regdev.gcv_tgsvd_k,
                        lambda: regdev.gcv_tgsvd_k(b, 3, 4)),
        "dp_tsvd_k": (regdev.dp_tsvd_k, lambda: regdev.dp_tsvd_k(b, 3, 0.1)),
        "dp_tgsvd_k": (regdev.dp_tgsvd_k,
                       lambda: regdev.dp_tgsvd_k(b, 3, 0.1)),
        "cgls_normal_checkpointed": (
            checkpointed.cgls_normal_checkpointed,
            lambda: checkpointed.cgls_normal_checkpointed(D, b, b, 3)),
    }
    for mod, names in ((fused, ("fused_gks", "fused_mmgks")),
                       (fused_info, ("fused_gks_info", "fused_mmgks_info")),
                       (checkpointed, ("fused_gks_checkpointed",
                                       "fused_mmgks_checkpointed"))):
        for name in names:
            fn = getattr(mod, name)
            calls[name] = (fn, (lambda f: lambda: f(D, b, D, n_iter=2))(fn))
    for mod, names in ((fused, ("fused_hybrid_lsqr", "fused_hybrid_gmres")),
                       (fused_info, ("fused_hybrid_lsqr_info",
                                     "fused_hybrid_gmres_info"))):
        for name in names:
            fn = getattr(mod, name)
            calls[name] = (fn, (lambda f: lambda: f(D, b, n_iter=2))(fn))
    return calls


@pytest.mark.parametrize("name", list(_entry_points()))
def test_entry_point_defaults_to_the_card(name, monkeypatch):
    fn, call = _entry_points()[name]
    if name == "Tomography":  # device comes through **kwargs
        assert "device" not in inspect.signature(fn).parameters
    else:
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_from_scipy_fan_checks_the_device_before_packing(monkeypatch):
    from trips_tpu_torch.sparse import banded_buckets

    def no_packing(*args, **kwargs):
        raise AssertionError("packed before the device was checked")

    theta = np.linspace(0, np.pi, 4, endpoint=False)
    A = fan_beam_matrix(8, angles=theta)
    monkeypatch.setattr(banded_buckets, "_pack_groups", no_packing)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BucketedBandedProjector.from_scipy_fan(A, 8, None, angles=theta,
                                               n_groups=1)


# ---- K4/K5: rotate_plan --------------------------------------------------
def _fan_shifts(nx, views):
    """(kx, ky, kq, C) of ``ShearFanProjector(nx, views=views)``, computed
    as its constructor does, without building its ``G``."""
    angles = np.linspace(0, np.pi, views, endpoint=False)
    bulge = nx / np.sqrt(2.0) * np.sqrt(1.0 + np.tan(np.pi / 8) ** 2) + 3.0
    C = -(-(int(np.ceil(2 * bulge)) + 2) // 16) * 16
    cc = (C - 1) / 2.0
    k = np.round(angles / (np.pi / 2)).astype(int)
    phi = angles - k * (np.pi / 2)
    kx = np.floor(np.tan(-phi / 2.0)[:, None] * (cc - np.arange(C))[None, :])
    ky = np.floor(-np.sin(phi)[:, None] * (np.arange(C) - cc)[None, :])
    return kx.astype(np.int64), ky.astype(np.int64), k, C


def test_fan_shifts_are_the_operators():
    op = ShearFanProjector(32, views=7, device="cpu")
    kx, ky, kq, C = _fan_shifts(32, 7)
    assert C == op._C and list(kq) == list(op._kq)
    assert np.array_equal(kx, op._kx.numpy())
    assert np.array_equal(ky, op._ky.numpy())


def _shift_case(case):
    if case == "tomo256x60":
        kx, ky, kq, C = _fan_shifts(256, 60)
        assert C == 400 and list(np.bincount(kq)) == [16, 29, 15]
        return kx, ky, kq, C
    if case == "nx300":
        return _fan_shifts(300, 20)
    # random smooth shifts of 12 views on C = 72, each moved by a random
    # multiple of C (|k| up to 4C), quarters shuffled
    rng = np.random.default_rng(5)
    C, na = 72, 12
    slope = rng.uniform(-1, 1, (2, na, 1))
    base = np.floor(slope * (np.arange(C) - C / 2)).astype(np.int64)
    kx, ky = base + C * rng.integers(-4, 5, (2, na, C))
    return kx, ky, rng.permutation(np.arange(na) % 3), C


def _chain_taps(kx, ky, i, j, C, adjoint):
    """The 8-tap chain of output (i, j) as the plain versions read it: the
    stage-2 columns and, for each, the stage-1 rows."""
    if adjoint:
        cols = [(j - kx[i]) % C, (j - kx[i] - 1) % C]
        return [(c, [(i - ky[c]) % C, (i - ky[c] - 1) % C]) for c in cols]
    cols = [(j + kx[i]) % C, (j + kx[i] + 1) % C]
    return [(c, [(i + ky[c]) % C, (i + ky[c] + 1) % C]) for c in cols]


@pytest.mark.parametrize("kernel", ["shear_rotate", "shear_rotate_adjoint"])
@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("case", ["tomo256x60", "nx300", "random"])
def test_rotate_plan_holds_every_tap(case, tile, kernel):
    """Every output of every (view, tile): the window positions the kernel
    computes (``csrc/shear.cu`` tile_view) lie inside the plan's footprint
    and name the canvas columns and rows the 8-tap chain reads."""
    kx, ky, kq, C = _shift_case(case)
    adj = kernel == "shear_rotate_adjoint"
    pl = rotate_plan(kernel, kx, ky, kq, C, tile)
    ty, tx = tile
    w2, r1 = pl["w2"], pl["r1"]
    assert pl["smem_bytes"] == rotate_smem_bytes(ty, w2, r1) \
        <= ROTATE_SMEM_BYTES
    assert w2 >= tx + 1 and r1 >= ty + 1
    ntx = -(-C // tx)
    kxe, kye = (-kx - 1, -ky - 1) if adj else (kx, ky)
    assert np.array_equal(pl["kx"], kxe % C) and pl["kx"].dtype == np.int32
    assert np.array_equal(pl["ky"], kye % C)
    ii, jj = np.meshgrid(np.arange(C), np.arange(C), indexing="ij")
    tile_id = ii // ty * ntx + jj // tx
    i0, j0 = ii // ty * ty, jj // tx * tx
    for a in range(len(kq)):
        xs, ys = pl["starts"][a, tile_id, 0], pl["starts"][a, tile_id, 1]
        dk = (j0 + kxe[a, ii] - xs) % C
        t = (jj - j0) + dk
        assert t.max() + 1 < w2
        want = _chain_taps(kx[a], ky[a], ii, jj, C, adj)
        # K5's taps come turned round: window columns t + 1, t
        for e, (c_want, rows_want) in enumerate(want):
            tt = t + (1 - e if adj else e)
            col = (xs + tt) % C
            assert np.array_equal(col, c_want)
            dy = (i0 + kye[a, col] - ys) % C
            for u, r_want in enumerate(rows_want):
                k = dy + (ii - i0) + (1 - u if adj else u)
                assert k.max() < r1
                assert np.array_equal((ys + k) % C, r_want)


@pytest.mark.parametrize("chunk", [None, 1, 8])
def test_rotate_plan_view_lists(chunk):
    """K5's view order covers each view once, grouped by quarter in view
    order with ``kq`` shuffled; chunks tile each quarter's run in order."""
    kx, ky, kq, C = _fan_shifts(64, 30)
    rng = np.random.default_rng(1)
    perm = rng.permutation(len(kq))
    kx, ky, kq = kx[perm], ky[perm], kq[perm]
    kq[kq == 2] = 1  # quarter 2 has no view
    pl = rotate_plan("shear_rotate_adjoint", kx, ky, kq, C, (16, 64), chunk)
    order, chunks, qfirst = pl["order"], pl["chunks"], pl["qfirst"]
    assert sorted(order) == list(range(len(kq)))
    for z in range(3):
        mine = chunks[qfirst[z]:qfirst[z + 1]]
        views = [int(v) for b, n, _ in mine for v in order[b:b + n]]
        assert views == [int(v) for v in np.flatnonzero(kq == z)]
        assert all(1 <= n <= (chunk or len(kq)) for _, n, _ in mine)
        assert [s for *_, s in mine] == list(range(qfirst[z], qfirst[z + 1]))
        if not chunk:
            assert len(mine) == min(1, len(views))
    assert qfirst[-1] == len(chunks) and qfirst[2] == qfirst[3]  # quarter 2


def test_rotate_plan_refuses_what_it_cannot_run():
    kx, ky, kq, C = _fan_shifts(32, 8)
    with pytest.raises(ValueError, match="multiple of 4"):
        rotate_plan("shear_rotate", kx, ky, kq, C, (8, 30))
    with pytest.raises(ValueError, match="TY of 2"):
        rotate_plan("shear_rotate", kx, ky, kq, C, (7, 64))
    with pytest.raises(ValueError, match="within 32"):
        rotate_plan("shear_rotate", kx, ky, kq, C, (128, 64))  # 1024 threads
    with pytest.raises(ValueError, match="quarter ids"):
        rotate_plan("shear_rotate_adjoint", kx, ky, kq + 1, C, (16, 64))
    with pytest.raises(ValueError, match="shifts must be"):
        rotate_plan("shear_rotate", kx[:, 1:], ky, kq, C, (16, 64))
    # shifts with no order along a line need a window of the whole canvas
    rng = np.random.default_rng(0)
    C = 2048
    kx, ky = rng.integers(-C, C, (2, 2, C))
    with pytest.raises(ValueError, match="shared memory"):
        rotate_plan("shear_rotate", kx, ky, np.array([0, 1]), C, (32, 64))


def _emulate(kernel, src, kx, fx, ky, fy, kq, tile):
    """K4 or K5 as ``csrc/shear.cu`` computes it, window by window, in
    float64 NumPy: one view's tile at a time through the plan's footprint."""
    adj = kernel == "shear_rotate_adjoint"
    na, C = kx.shape
    pl = rotate_plan(kernel, kx, ky, kq, C, tile)
    ty, tx = tile
    kxe, kye = pl["kx"], pl["ky"]  # reduced mod C, as the kernel reads them

    def blend(f, lo, hi):
        return (1 - f) * hi + f * lo if adj else (1 - f) * lo + f * hi

    out = np.zeros((3 if adj else na, C, C))
    ntx = -(-C // tx)
    for a in range(na):
        canvas = src[a] if adj else src[kq[a]]
        for tid, (xs, ys) in enumerate(pl["starts"][a]):
            i0, j0 = tid // ntx * ty, tid % ntx * tx
            col = (xs + np.arange(pl["w2"])) % C
            dy = (i0 + kye[a, col] - ys) % C
            row = (ys + np.arange(pl["r1"])) % C
            k = dy[None, :] + np.arange(ty + 1)[:, None]        # (ty+1, w2)
            cc = (col[None, :] + kxe[a, row[k]]) % C
            s1 = blend(fx[a, row[k]], canvas[row[k], cc],
                       canvas[row[k], (cc + 1) % C])
            s2 = blend(fy[a, col][None, :], s1[:-1], s1[1:])     # (ty, w2)
            i = np.arange(i0, min(C, i0 + ty))
            j = np.arange(j0, min(C, j0 + tx))
            r = i - i0
            t = (j - j0)[None, :] + ((j0 + kxe[a, i] - xs) % C)[:, None]
            v = blend(fx[a, i][:, None], s2[r[:, None], t],
                      s2[r[:, None], t + 1])
            out[kq[a] if adj else a, i0:i0 + len(i), j0:j0 + len(j)] += v
    return out


@pytest.mark.parametrize("tile", [(8, 32), (16, 64)])
@pytest.mark.parametrize("kernel", ["shear_rotate", "shear_rotate_adjoint"])
def test_tile_routine_matches_plain(kernel, tile):
    """The staged tile computes K4 and K5's functions: emulated on random
    shifts (beyond +-C, quarters shuffled) against the plain versions."""
    from trips_tpu_torch.operators import shear_kernels as sk

    kx, ky, kq, C = _shift_case("random")
    rng = np.random.default_rng(2)
    fx, fy = rng.uniform(0, 1, (2,) + kx.shape)
    src = rng.standard_normal((len(kq) if "adj" in kernel else 3, C, C))
    got = _emulate(kernel, src, kx, fx, ky, fy, kq, tile)
    args = [torch.from_numpy(v) for v in (src, kx, fx, ky, fy, kq)]
    if kernel == "shear_rotate":
        ref = sk.shear_rotate_ref(*args, out_dtype=torch.float64)
    else:
        ref = sk.shear_rotate_adjoint_ref(*args)
    assert np.abs(got - ref.numpy()).max() <= 1e-12 * np.abs(got).max()
