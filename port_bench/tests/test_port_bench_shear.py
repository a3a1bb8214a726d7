"""The ``fan_shear`` kind on the CPU: the reference's explicit matrix
against the program's float64 operator at the tiny size, and the K4-K6
roofline readers' byte counts and kernel names."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench import harness
from port_bench.metrics import k4_roofline, k5_roofline, k6_roofline
from port_bench.problems import fan_shear, fan_static
from port_bench.reference import shear_fan
from port_bench.tests import celldata

REPO = Path(__file__).resolve().parents[2]
FULL = celldata.CELLS["tomo256x60_shear.cgls_normal"]["config"]
HBM = k4_roofline.HBM_BYTES_PER_S


def _cfg(size):
    import json

    base = json.loads((REPO / "port_bench" / "configs"
                       / f"{FULL}.json").read_text())
    if size != "full":
        base.update(celldata.config(FULL)[size])
    return base


@pytest.fixture(scope="module")
def tiny():
    """(configuration, reference matrix, the program's float64 CPU operator
    with ``fused_ata`` True and False) at the tiny size."""
    from trips_tpu_torch.operators import ShearFanProjector

    cfg = _cfg("tiny")
    ops = {fused: ShearFanProjector(
        cfg["nx"], angles=fan_static.angles(cfg), det_count=cfg["det_count"],
        det_width=cfg["det_spacing"], source_origin=cfg["source_origin"],
        origin_det=cfg["origin_det"], dtype=torch.float64, fused_ata=fused,
        device="cpu") for fused in (True, False)}
    return cfg, fan_shear.reference_matrix(cfg), ops


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_port_bench_shear_reference_is_the_programs_operator(tiny):
    cfg, A, ops = tiny
    rng = np.random.default_rng(7)
    X = rng.standard_normal((A.shape[1], 3))
    Y = rng.standard_normal((A.shape[0], 3))
    for op in ops.values():
        assert op.shape == A.shape
        for x, y in zip(X.T, Y.T):
            ax = op.matvec(torch.from_numpy(x)).numpy()
            aty = op.rmatvec(torch.from_numpy(y)).numpy()
            assert _rel(ax, A @ x) <= 1e-12
            assert _rel(aty, A.T @ y) <= 1e-12


@pytest.mark.parametrize("fused", [True, False])
def test_port_bench_shear_normal_matvec(tiny, fused):
    _, A, ops = tiny
    x = np.random.default_rng(8).standard_normal(A.shape[1])
    got = ops[fused].normal_matvec(torch.from_numpy(x)).numpy()
    assert _rel(got, A.T @ (A @ x)) <= 1e-12


def test_port_bench_shear_adjoint(tiny):
    _, A, ops = tiny
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal(A.shape[1]))
    y = torch.from_numpy(rng.standard_normal(A.shape[0]))
    op = ops[True]
    ax, aty = op.matvec(x), op.rmatvec(y)
    lhs, rhs = float(ax @ y), float(x @ aty)
    assert abs(lhs - rhs) <= 1e-12 * float(ax.norm() * y.norm())
    assert abs(float(x @ torch.from_numpy(A.T @ y.numpy())) - rhs) <= (
        1e-12 * float(x.norm() * aty.norm()))


def test_port_bench_shear_counts_from_the_geometry(tiny):
    """The canvas side and G's nonzeros as the reference counts them, at
    the tiny size against the program's own G, and at the full geometry."""
    cfg, A, ops = tiny
    op = ops[True]
    geo = dict(det_count=cfg["det_count"], det_spacing=cfg["det_spacing"],
               source_origin=cfg["source_origin"],
               origin_det=cfg["origin_det"])
    assert shear_fan.canvas_side(cfg["nx"]) == op._C
    assert shear_fan.g_nonzeros(cfg["nx"], **geo) == int((op.G != 0).sum())
    assert shear_fan.canvas_views(*reversed(A.shape)) == (
        cfg["nx"], op._C, cfg["views"])
    assert shear_fan.canvas_views(A.shape[1], A.shape[0] + 1) is None
    full = _cfg("full")
    assert shear_fan.canvas_views(256 * 256, 60 * 362) == (256, 400, 60)
    assert shear_fan.g_nonzeros(full["nx"], full["det_count"],
                                full["det_spacing"], full["source_origin"],
                                full["origin_det"]) == 260840


def _run(kernels, nnz=260840, value_bytes=4):
    return harness.Run({}, nnz, 256 * 256, value_bytes, m=60 * 362,
                       kernels=kernels)


def test_port_bench_k4_k5_k6_bytes_and_kernels():
    """At the full geometry, the least bytes of PERF.md's table; each
    reader matches its kernels by exact short name and reads None with
    none of them."""
    canvas = 60 * 400 * 400
    assert k4_roofline.least_bytes(400, 60, 4) == 3 * 400 * 400 * 4 + (
        canvas * 4) == 40_320_000
    assert k6_roofline.least_bytes(400, 60, 260840, 4) == (
        canvas * 8 + 260840 * 4) == 77_843_360
    kernels = [("void rotate_tile_kernel<float>(float const*, ...)", 0.0,
                60.0),
               ("void ata_p1_tf32(CUtensorMap, ...)", 60.0, 150.0),
               ("void ata_reduce_kernel<float>(float const*, ...)", 210.0,
                10.0),
               ("ata_p2_tf32(CUtensorMap, float const*, ...)", 220.0, 100.0),
               ("void rotate_adj_tile_kernel<float>(float const*, ...)",
                320.0, 50.0),
               ("rotate_adj_reduce(float const*, int const*, float*, int)",
                370.0, 20.0),
               ("elementwise_kernel", 390.0, 5.0),
               ("void rotate_tile_kernel<float>(float const*, ...)", 400.0,
                62.0)]
    run = _run(kernels)
    bound_us = 40_320_000 / HBM * 1e6
    # K4: its own two launches, not K5's rotate_adj_tile_kernel
    assert k4_roofline.read(run) == pytest.approx(100 * bound_us / 61.0)
    assert k5_roofline.read(run) == pytest.approx(100 * bound_us / 70.0)
    assert k6_roofline.read(run) == pytest.approx(
        100 * 77_843_360 / HBM * 1e6 / 260.0)
    # a bfloat16 G: the canvases at 2 bytes in K4 and K5, K6's input and G
    bf = _run([("void ata_p1_wgmma(...)", 0.0, 80.0),
               ("void ata_reduce_kernel<__nv_bfloat16>(...)", 80.0, 5.0),
               ("void ata_p2_wgmma(...)", 85.0, 15.0)], value_bytes=2)
    assert k6_roofline.read(bf) == pytest.approx(
        100 * (canvas * 6 + 260840 * 2) / HBM * 1e6 / 100.0)
    for reader in (k4_roofline, k5_roofline, k6_roofline):
        assert reader.read(_run([("ata_kernel", 0.0, 5.0),
                                 ("adj_kernel", 5.0, 5.0)])) is None
        assert reader.read(harness.Run({}, 1, 256 * 256, 4)) is None
    only_adj = _run([("void rotate_adj_tile_kernel<float>(...)", 0.0, 5.0)])
    assert k4_roofline.read(only_adj) is None


def test_port_bench_shear_reference_imports_nothing_of_the_program():
    code = ("import sys, port_bench.reference.shear_fan; "
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'trips_tpu_torch', 'trips_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_port_bench_shear_refuses_another_detector_count():
    cfg = {**_cfg("tiny"), "det_count": 44}
    with pytest.raises(ValueError, match="det_count 44"):
        fan_shear.reference_matrix(cfg)
