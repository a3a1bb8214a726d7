"""The harness on the CPU at tiny sizes: every cell's result line, the
per-layer readers, the comparison's faults, and what the runs import."""
import ast
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from port_bench import harness
from port_bench.metrics import idle_share, k1_roofline

REPO = Path(__file__).resolve().parents[2]
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in SPEC["workloads"]]
TINY_CONFIG = {
    "tomo256x60": {"nx": 32, "det_count": 45, "source_origin": 96,
                   "origin_det": 32, "views": 12},
    "dyn128x33": {"nx": 32, "det_count": 45, "source_origin": 96,
                  "origin_det": 32, "nt": 4},
}
TINY_PARAMS = {"cgls_normal": {"max_iter": 5}, "mmgks_isotv": {"n_iter": 3},
               "fused_gks_gcv": {"n_iter": 4}}
SEED = 2**31 + 17


def tiny(workload):
    config, traffic = workload.split(".")
    return {"config": TINY_CONFIG[config], "params": TINY_PARAMS[traffic],
            "traffic": {"trace_recons": 1, "checked": 1}}


def run(workload, trace=False, **kw):
    return harness.run_cell(workload, SEED, 0.2, trace, time.perf_counter(),
                            device="cpu", overrides=tiny(workload), **kw)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_port_bench_result_line(workload, trace):
    r = run(workload, trace)
    cell = harness.load_cell(workload)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert r["correct"] is True and r["attempted"] >= 1 and r["failed"] == 0
    want = cell.per_layer if trace else cell.end_to_end
    units = {m["name"]: m["unit"] for m in want}
    assert set(r["metrics"]) <= set(units)
    if not trace:
        assert set(r["metrics"]) == set(units)
        assert r["metrics"]["setup_s"]["value"] > 0
    for name, m in r["metrics"].items():
        assert m["unit"] == units[name] and np.isfinite(m["value"])
    assert set(r["checks"]) == set(cell.limits)
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())
    assert json.loads(json.dumps(r)) == r


def _perturbed(x):
    x = x.clone()
    x[x.numel() // 2] += 0.1 * x.norm()
    return x


def faults(workload):
    """(name, module, attribute, replacement factory) of each fault the
    cell can have, planted where the timed path produces it."""
    traffic = workload.split(".")[1]
    if traffic == "cgls_normal":
        from trips_tpu_torch import krylov

        cgls = importlib.import_module("trips_tpu_torch.krylov.cgls")

        init, solve = cgls._cgn_init, krylov.cgls_normal

        def half(A, b, x0):
            b = b.clone()
            b[b.numel() // 2:] = 0
            return init(A, b, x0)

        def altered(*a, **k):
            x, n = solve(*a, **k)
            return _perturbed(x), n

        return [("unchanged step", cgls, "_cgn_step", lambda A, tol, s: s),
                ("half the data", cgls, "_cgn_init", half),
                ("answer altered", krylov, "cgls_normal", altered)]
    if traffic == "mmgks_isotv":
        from trips_tpu_torch import solvers

        module, name = solvers, "MMGKS"
    else:
        from trips_tpu_torch.solvers import fused

        module, name = fused, "fused_gks"
    orig = getattr(module, name)

    def unchanged(A, b, L, **k):  # every step after the first a no-op
        return orig(A, b, L, **{**k, "n_iter": 1})

    def half(A, b, L, **k):
        b = b.clone()
        b[b.numel() // 2:] = 0
        return orig(A, b, L, **k)

    def altered(*a, **k):
        x, *rest = orig(*a, **k)
        return (_perturbed(x), *rest)

    return [("unchanged step", module, name, unchanged),
            ("half the data", module, name, half),
            ("answer altered", module, name, altered)]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_port_bench_faults_fail(workload, monkeypatch):
    for label, module, name, fake in faults(workload):
        with monkeypatch.context() as m:
            m.setattr(module, name, fake)
            r = run(workload)
        assert r["correct"] is False, (label, r["checks"])


SMALL_CONFIG = {
    "tomo256x60": {"nx": 64, "det_count": 90, "source_origin": 192,
                   "origin_det": 64, "views": 30},
    "dyn128x33": {"nx": 32, "det_count": 45, "source_origin": 96,
                  "origin_det": 32, "nt": 4},
}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_port_bench_control_fails(workload):
    """The comparison's control, the pack stored in bfloat16 (the next
    precision below the configuration's float32), fails the cell's limits
    at a small size with the cell's own iteration counts, where the
    float32 pack passes them."""
    small = {"config": SMALL_CONFIG[workload.split(".")[0]],
             "traffic": {"checked": 1}}
    got = {dtype: harness.run_cell(workload, SEED, 0.05, False,
                                   time.perf_counter(), device="cpu",
                                   overrides=small, dtype=dtype)
           for dtype in ("float32", "bfloat16")}
    assert got["float32"]["correct"] is True, got["float32"]["checks"]
    assert got["bfloat16"]["correct"] is False, got["bfloat16"]["checks"]


def test_port_bench_loads_no_jax():
    code = ("import time, json; from port_bench import harness; "
            "from port_bench.tests.test_port_bench_harness import run; "
            "run('tomo256x60.cgls_normal', True); "
            "print(json.dumps(harness.forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_port_bench_reference_imports_nothing_of_the_program():
    imported = set()
    for f in (REPO / "port_bench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                imported |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                imported.add(node.module.split(".")[0])
    assert not imported & {"trips_tpu_torch", "trips_tpu", "jax"}
    code = ("import sys, port_bench.reference.regularized, "
            "port_bench.reference.cgls, port_bench.reference.siddon, "
            "port_bench.reference.phantoms; "
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'trips_tpu_torch', 'trips_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_port_bench_k1_bytes_from_nnz_and_image():
    from port_bench.reference import siddon

    A = siddon.fan_beam_matrix(8, np.linspace(0, np.pi, 3, endpoint=False),
                               11, 4 / 3, 24, 8)
    assert k1_roofline.least_bytes(A.nnz, A.shape[1], 4) == (
        A.nnz * 4 + 2 * 64 * 4)
    # an apply is ata_kernel and the fixed_to_float after it; the one
    # after K3's adj_kernel is not K1's
    run_ = harness.Run({}, A.nnz, A.shape[1], 4,
                       kernels=[("void ata_kernel<float>(...)", 0.0, 2.0),
                                ("fixed_to_float(Args)", 2.0, 1.0),
                                ("other", 3.0, 5.0),
                                ("adj_kernel", 8.0, 3.0),
                                ("fixed_to_float(Args)", 11.0, 7.0),
                                ("ata_kernel", 18.0, 4.0),
                                ("fixed_to_float(Args)", 22.0, 1.0)])
    bound_us = (A.nnz * 4 + 2 * 64 * 4) / k1_roofline.HBM_BYTES_PER_S * 1e6
    assert k1_roofline.read(run_) == pytest.approx(100 * bound_us / 4.0)
    assert k1_roofline.read(harness.Run({}, 1, 1, 4)) is None


def test_port_bench_trace_reader(tmp_path):
    ev = [{"name": harness.RECON, "cat": "user_annotation", "ts": 0,
           "dur": 100},
          {"name": "ata_kernel", "cat": "kernel", "ts": 10, "dur": 30},
          {"name": "memcpy", "cat": "gpu_memcpy", "ts": 30, "dur": 20},
          {"name": "k2", "cat": "kernel", "ts": 80, "dur": 10},
          {"name": "cudaStreamSynchronize", "cat": "cuda_runtime",
           "ts": 55, "dur": 20}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    r = harness.Run({}, 1, 1, 4)
    harness.read_trace(path, r)
    assert r.window_s == pytest.approx(100e-6)
    assert r.busy_s == pytest.approx(50e-6)
    assert idle_share.read(r) == pytest.approx(0.5)
    gaps = dict(r.breakdown["idle_gaps"])
    assert gaps["cudaStreamSynchronize"] == pytest.approx(30e-6)
    assert sum(gaps.values()) == pytest.approx(50e-6)


@pytest.mark.parametrize("nx,views", [(32, 12), (33, 7), (64, 90)])
def test_port_bench_builder_is_the_programs(nx, views):
    """The reference's matrix and the program's C++ builder's agree to
    rounding, grid-aligned rays included."""
    from port_bench.reference import siddon
    from trips_tpu_torch.problems.projector import fan_beam_matrix

    th = np.linspace(0, np.pi, views, endpoint=False)
    p = int(np.sqrt(2) * nx)
    A = fan_beam_matrix(nx, nx, angles=th, det_count=p, det_width=4 / 3,
                        source_origin=3 * nx, origin_det=nx)
    R = siddon.fan_beam_matrix(nx, th, p, 4 / 3, 3 * nx, nx)
    assert abs(A - R).max() <= 1e-9


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_port_bench_card_run(workload, card):
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", workload,
         "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
