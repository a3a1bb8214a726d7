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
- Every public entry point defaults to ``device="cuda"`` and, with no card,
  raises instead of running on the CPU.
"""
import inspect

import numpy as np
import pytest
import torch

from trips_tpu_torch.operators import (OnTheFlyFanProjector,
                                       OnTheFlyParallelProjector,
                                       ShearFanProjector,
                                       ShearStackParallelProjector)
from trips_tpu_torch.operators.shear_kernels import k_split
from trips_tpu_torch.problems import (Tomography, device_sparse_operator,
                                      fan_beam_matrix)
from trips_tpu_torch.sparse import BucketedBandedProjector
from trips_tpu_torch.sparse.banded_kernels import (SMEM_BYTES, launch_plan,
                                                   tile_plan)


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
    }


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
