"""The harness on the CPU at tiny sizes: every cell's result line, the
per-layer readers, the comparison's faults, and what the runs import."""
import ast
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from port_bench import harness
from port_bench.metrics import (idle_share, k1_roofline, k2_roofline,
                                k3_roofline)
from port_bench.tests import celldata

REPO = Path(__file__).resolve().parents[2]
WORKLOADS = list(celldata.CELLS)
SEED = 2**31 + 17


def tiny(workload):
    w = celldata.CELLS[workload]
    return {"config": celldata.config(w["config"])["tiny"],
            "params": celldata.traffic(w["traffic"])["tiny"],
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


@pytest.mark.parametrize("workload", WORKLOADS)
def test_port_bench_faults_fail(workload, monkeypatch):
    entry = harness.load_cell(workload).traffic["entry"]
    for label, module, name, fake in celldata.faults(entry):
        with monkeypatch.context() as m:
            m.setattr(module, name, fake)
            r = run(workload)
        assert r["correct"] is False, (label, r["checks"])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_port_bench_control_fails(workload):
    """The comparison's control, the pack stored in bfloat16 (the next
    precision below the configuration's float32), fails the cell's limits
    at a small size with the cell's own iteration counts, where the
    float32 pack passes them."""
    config = celldata.CELLS[workload]["config"]
    small = {"config": celldata.config(config)["small"],
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


def test_port_bench_read_trace_keeps_its_readings(tmp_path):
    """On a fixed trace, ``read_trace`` gives the kernels, busy and window
    seconds and breakdown that it gave before it read program spans, bit
    for bit (``data/fixed_trace_read.json``)."""
    data = Path(__file__).resolve().parent / "data"
    want = json.loads((data / "fixed_trace_read.json").read_text())
    r = harness.Run({}, 1, 1, 4)
    harness.read_trace(data / "fixed_trace.json", r)
    assert [list(k) for k in r.kernels] == want["kernels"]
    assert (r.busy_s, r.window_s) == (want["busy_s"], want["window_s"])
    assert json.loads(json.dumps(r.breakdown)) == want["breakdown"]
    # the spans: three reconstructions (the device's copy of the recon
    # annotation is not one), each span inside one of them
    assert len(r.idle) == 3
    assert {n for n, *_ in r.annotations} == {
        "solve.cgls", "loop.cgls", "loop.capture", "loop.replay"}
    assert all(i in (0, 1, 2) for *_, i in r.annotations)
    idle_ms = sum(b - a for rec in r.idle for a, b in rec) / 1e3 / 3
    assert 0 < r.idle_ms_per_recon("loop.capture") <= idle_ms
    assert r.idle_ms_per_recon("solve.cgls") <= idle_ms
    assert r.idle_ms_per_recon("mmgks.lambda") is None


def test_port_bench_k2_k3_rooflines():
    """K2 reads ``fwd_kernel`` alone; K3 reads ``adj_kernel`` and the
    ``fixed_to_float`` after it, not the one after K1's ``ata_kernel``."""
    nnz, n, m = 1000, 64, 90
    assert k2_roofline.least_bytes(nnz, n, m, 4) == nnz * 4 + (n + m) * 4
    run_ = harness.Run({}, nnz, n, 4, m=m,
                       kernels=[("void fwd_kernel<float>(...)", 0.0, 2.0),
                                ("other", 2.0, 1.0),
                                ("adj_kernel", 3.0, 3.0),
                                ("elementwise", 6.0, 1.0),
                                ("fixed_to_float(Args)", 7.0, 1.0),
                                ("ata_kernel", 8.0, 4.0),
                                ("fixed_to_float(Args)", 12.0, 7.0),
                                ("fwd_kernel", 19.0, 4.0),
                                ("adj_kernel", 23.0, 5.0),
                                ("fixed_to_float(Args)", 28.0, 1.0)])
    bound_us = (nnz * 4 + (n + m) * 4) / k2_roofline.HBM_BYTES_PER_S * 1e6
    assert k2_roofline.read(run_) == pytest.approx(100 * bound_us / 3.0)
    assert k3_roofline.read(run_) == pytest.approx(100 * bound_us / 5.0)
    assert k2_roofline.read(harness.Run({}, nnz, n, 4)) is None
    for reader in (k2_roofline, k3_roofline):
        assert reader.read(harness.Run({}, nnz, n, 4, m=m)) is None


@pytest.mark.parametrize("kind,path", [
    ("config", "port_bench/tests/configs/nosuch.json"),
    ("traffic", "port_bench/tests/traffic/nosuch.json"),
    ("faults", "port_bench/tests/faults/nosuch.py")])
def test_port_bench_missing_test_data_names_the_file(kind, path):
    with pytest.raises(celldata.MissingTestData, match=re.escape(path)):
        getattr(celldata, kind)("nosuch")


NEW_CELL = "newcfg.newmix"


def test_port_bench_takes_a_cell_from_new_files(tmp_path):
    """A cell made of new files alone (a configuration, a traffic mix, an
    entry, its limits, their test data, and entries appended to
    ``BENCHMARK.json``), in a copy of the benchmark, passes the tests that
    every cell runs: its result lines, faults, control and spans."""
    root = tmp_path / "tree"
    pb = root / "port_bench"
    shutil.copytree(REPO / "port_bench", pb,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "trips_tpu_torch").symlink_to(REPO / "trips_tpu_torch")
    # copies of tomo256x60.cgls_normal's files under new names, its entry
    # and faults imported by a new entry of their own
    copies = {"configs/newcfg.json": "configs/tomo256x60.json",
              f"limits/{NEW_CELL}.json": "limits/tomo256x60.cgls_normal.json",
              "tests/configs/newcfg.json": "tests/configs/tomo256x60.json",
              "tests/traffic/newmix.json": "tests/traffic/cgls_normal.json"}
    for new, old in copies.items():
        (pb / new).write_text((pb / old).read_text())
    mix = json.loads((pb / "traffic/cgls_normal.json").read_text())
    (pb / "traffic/newmix.json").write_text(json.dumps({**mix,
                                                        "entry": "newent"}))
    (pb / "entries/newent.py").write_text(
        "from .cgls_normal import check, program  # noqa: F401\n")
    (pb / "tests/faults/newent.py").write_text(
        "from .cgls_normal import faults  # noqa: F401\n")
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"].append({**spec["configs"][0], "name": "newcfg",
                            "file": "port_bench/configs/newcfg.json"})
    spec["workloads"].append({"name": NEW_CELL, "config": "newcfg",
                              "traffic": "newmix", "chips": 1,
                              "why": "a cell from new files"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "tomo256x60.cgls_normal" in m.get("workloads", []):
            m["workloads"].append(NEW_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "port_bench/tests", "-q",
         "-p", "no:cacheprovider", "-k", "newcfg", "-rs"],
        cwd=root, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-2000:]
    tail = out.stdout.strip().splitlines()[-1]
    # two result lines, the faults, the control, the spans; the card
    # test skips here
    assert re.search(r"\b5 passed\b", tail), out.stdout[-3000:]
