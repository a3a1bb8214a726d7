"""One run of one cell of the port's benchmark.

A cell (``BENCHMARK.json``'s ``workloads``) is a configuration under a
traffic mix, each found by name:

- ``configs/<config>.json``: the sizes as run; its ``kind`` names
  ``problems/<kind>.py``, which makes the data and works A out again for
  the reference (plain NumPy) and calls the program's set-up;
- ``traffic/<mix>.json``: the pool of sinograms, the solver entry
  (``entries/<entry>.py``: the program's call, the plain reference and the
  numbers compared) and its parameters;
- ``limits/<cell>.json``: each number compared and its limit;
- ``metrics/<metric>.py``: one reader per per-layer metric.

A new cell needs new files alone: those above, and its test data under
``tests/`` (which no run reads).

Traffic is a closed loop: one user reconstructs scan after scan on one
geometry, cycling through a pool of noisy sinograms made on the device
from the seed. A reconstruction's time runs from its call to its result
synchronized on the host; the window closes at the end of the last
reconstruction begun within ``seconds``. With ``trace``, the window is
followed by a short profiled sub-window (the process's only profiler
session) whose device trace, loop counters and host spans the per-layer
readers read. Then the program's state is freed and a sample of the
window's reconstructions, drawn from the seed as they finish (a
reservoir, so that the window keeps only the sampled outputs), is
compared with the reference run on the same sinograms.
"""
from __future__ import annotations

import bisect
import gc
import importlib
import json
import os
import re
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# top-level modules that no run may load: JAX and the JAX package
FORBIDDEN = {"jax", "jaxlib", "flax", "trips_tpu"}
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver", "user_annotation"}
RECON = "port_bench.recon"
VALUE_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}
# host spans searched back from an idle gap for the one that covers it
GAP_LOOKBACK = 256


@dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


@dataclass
class Run:
    """What a traced run hands the per-layer readers."""
    params: dict
    nnz: int
    n: int
    value_bytes: int
    spans: dict = field(default_factory=dict)   # name -> host seconds
    loops: list = field(default_factory=list)   # per recon: (name, reads,
    #                                             steps) of each device loop
    kernels: list = field(default_factory=list)  # (name, ts us, dur us)
    traced: int = 0                              # recons traced
    window_s: float | None = None
    busy_s: float | None = None
    breakdown: dict | None = None
    m: int | None = None                         # the operator's rows
    # (name, ts us, end us, recon index) of each program span: every
    # user_annotation but the recons', the index None outside them
    annotations: list = field(default_factory=list)
    # per recon: [(ts us, end us)] in which no operation ran on the device
    idle: list = field(default_factory=list)

    def idle_ms_per_recon(self, name):
        """Device-idle milliseconds per traced reconstruction under the
        program span ``name``: in each reconstruction, the union of its
        annotations intersected with the idle intervals. None where no
        such span was traced."""
        if not self.idle or not any(a[0] == name for a in self.annotations):
            return None
        us = 0.0
        for i, idle in enumerate(self.idle):
            under = union((a, b) for n, a, b, r in self.annotations
                          if n == name and r == i)
            us += overlap(under, idle)
        return us / 1e3 / len(self.idle)


def union(intervals):
    """Sorted disjoint [a, b] covering the given intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap(xs, ys):
    """Length of the intersection of two sorted disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def load_cell(workload, overrides=None):
    """The cell's files; ``overrides`` ({"config": {...}, "traffic": {...},
    "params": {...}}) replace entries, for the CPU tests' tiny sizes."""
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"port_bench: no workload {workload!r}; "
                         f"known: {sorted(cells)}")
    w = cells[workload]
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    cfg = json.loads((REPO / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    ov = overrides or {}
    cfg.update(ov.get("config", {}))
    traffic.update(ov.get("traffic", {}))
    traffic["params"] = {**traffic["params"], **ov.get("params", {})}
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    return Cell(workload, w["chips"], cfg, traffic, limits, e2e, per_layer)


def make_pool(b_true, noise_level, size, seed, device):
    """(size, m) float32 noisy sinograms: b_true plus Gaussian noise drawn
    on ``device`` from ``seed``, each draw scaled to
    ``noise_level * ||b_true||``. A run draws its pool from its own seed,
    large enough that a window of a regularized solver, whose lambda
    search follows the noise, sees a fresh draw in each reconstruction."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    b = torch.as_tensor(b_true, dtype=torch.float64, device=device)
    e = torch.randn((size, b.numel()), generator=gen, dtype=torch.float64,
                    device=device)
    e *= noise_level * b.norm() / e.norm(dim=1, keepdim=True)
    return (b + e).to(torch.float32)


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def short_name(key):
    """A kernel's name without its signature, template and namespace."""
    name = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    return re.split(r"[(<]", name)[0].split("::")[-1][:120] or key[:120]


def read_trace(path, run):
    """Fill ``run``'s kernels, busy and window seconds, breakdown, program
    spans and idle intervals from a Chrome trace of the traced
    sub-window."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("name") == RECON and "dur" in e]
    if not spans:
        return
    lo = min(e["ts"] for e in spans)
    hi = max(e["ts"] + e["dur"] for e in spans)
    dev = sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi), e["name"])
                 for e in events if e.get("cat") in DEVICE_CATS
                 and "dur" in e and e["ts"] < hi and e["ts"] + e["dur"] > lo)
    run.kernels = [(n, a, b - a) for a, b, n in dev]
    merged = union((a, b) for a, b, _ in dev)
    busy = sum(b - a for a, b in merged)
    run.window_s, run.busy_s = (hi - lo) / 1e6, busy / 1e6
    by_op = {}
    for n, _, d in run.kernels:
        k = short_name(n)
        by_op[k] = by_op.get(k, 0.0) + d / 1e6
    # each idle gap, named by the innermost host span over its middle
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") in HOST_CATS and "dur" in e
                  and e["name"] != RECON)
    starts = np.array([h[0] for h in host]) if host else np.zeros(0)
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    by_gap = {}
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        name = "python between host calls"
        j = int(np.searchsorted(starts, mid, "right")) - 1
        for j in range(j, max(j - GAP_LOOKBACK, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        by_gap[name] = by_gap.get(name, 0.0) + (b - a) / 1e6
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(by_gap.items(), key=lambda kv: -kv[1])[:10]
    run.breakdown = {"device_ops": [list(kv) for kv in top],
                     "idle_gaps": [list(kv) for kv in gaps]}
    # each reconstruction's idle intervals, and the program spans in it
    recons = sorted((e["ts"], e["ts"] + e["dur"]) for e in spans
                    if e.get("cat") == "user_annotation")
    run.idle = []
    for a, b in recons:
        inside = [[max(x, a), min(y, b)] for x, y in merged
                  if x < b and y > a]
        edges = [a] + [x for xy in inside for x in xy] + [b]
        run.idle.append([(x, y) for x, y in zip(edges[::2], edges[1::2])
                         if y > x])
    firsts = [a for a, _ in recons]

    def recon_of(ts):
        i = bisect.bisect_right(firsts, ts) - 1
        return i if i >= 0 and ts <= recons[i][1] else None

    run.annotations = [(e["name"], e["ts"], e["ts"] + e["dur"],
                        recon_of(e["ts"])) for e in events
                       if e.get("cat") == "user_annotation" and "dur" in e
                       and e["name"] != RECON]


def traced(solve, pool, n, run, dev):
    """Run ``n`` reconstructions under the profiler and the loops' trace,
    and read what they left into ``run``."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from trips_tpu_torch.core import loop

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    per_recon = []
    _sync(dev)
    with profile(activities=acts) as prof:
        for i in range(n):
            loop.TRACE = []
            with record_function(RECON):
                solve(pool[i % len(pool)])
                _sync(dev)
            per_recon.append(loop.TRACE)
    loop.TRACE = None
    run.traced = n
    run.loops = [[(name, reads, None if c is None else int(c))
                  for name, reads, c in rec] for rec in per_recon]
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        read_trace(path, run)
    finally:
        os.unlink(path)


def end_to_end(walls, window_s, setup_s):
    """The end-to-end metrics by name. The reconstruction rate has two
    names: ``recon_per_s`` in the cells of fixed-step solvers, whose runs
    spread by a few percent, and ``regularized_recon_per_s`` in those
    whose lambda search and host work follow the data and the host, whose
    runs spread more, so that each holds a bound that fits it."""
    rate = len(walls) / window_s
    return {"recon_per_s": rate, "regularized_recon_per_s": rate,
            "recon_p95_ms": float(np.percentile(walls, 95)) * 1e3,
            "setup_s": setup_s}


def start(cell, device):
    """(problem kind, solver entry, torch device) of the cell, with the
    card initialised and the program's kernel libraries loaded (built by a
    checkout's first run)."""
    import torch

    kind = importlib.import_module(f"port_bench.problems.{cell.cfg['kind']}")
    entry = importlib.import_module(
        f"port_bench.entries.{cell.traffic['entry']}")
    dev = torch.device(device)
    if dev.type == "cuda":
        from trips_tpu_torch import _build, native

        torch.zeros(1, device=dev)
        _build.load()
        native.load()
    return kind, entry, dev


def program(cell, kind, entry, dev, dtype):
    """The program's operator built from the geometry, the nonzeros of
    its host matrix, the solve of one sinogram, and the build's host
    seconds."""
    t = time.perf_counter()
    op, nnz = kind.build(cell.cfg, dev, dtype)
    _sync(dev)
    build_s = time.perf_counter() - t
    return op, nnz, entry.program(op, kind.dims(cell.cfg),
                                  cell.traffic["params"]), build_s


def compare(cell, kind, entry, sample, bs):
    """{number: {"value", "limit"}} of the program's outputs ``sample``
    against the reference's on the sinograms ``bs`` (columns); a number
    the cell does not compare has the limit None."""
    numbers = entry.check(kind.reference_matrix(cell.cfg), bs, sample,
                          kind.dims(cell.cfg), cell.traffic["params"])
    return {k: {"value": float(v), "limit": cell.limits.get(k)}
            for k, v in numbers.items()}


def finite_of(out):
    """Per output tensor, a flag on its device: all of it finite."""
    import torch

    return [torch.isfinite(v).all() for v in out.values()]


def copy_of(out):
    """A copy of each output tensor, detached."""
    return {key: v.detach().clone() for key, v in out.items()}


def run_cell(workload, seed, seconds, trace, t0, device="cuda",
             overrides=None, dtype=None):
    """Run the cell once; returns the result line's object. ``dtype``
    replaces the configuration's storage type of the pack (the
    comparison's control); ``device`` "cpu" serves the CPU tests."""
    import torch

    cell = load_cell(workload, overrides)
    cfg, traffic = cell.cfg, cell.traffic
    kind, entry, dev = start(cell, device)

    # ---- set-up: data, the program's operator, one warm reconstruction
    _, b_true = kind.data(cfg)
    dtype = dtype or cfg["dtype"]
    op, nnz, solve, build_s = program(cell, kind, entry, dev, dtype)
    run = Run(traffic["params"], nnz, op.shape[1], VALUE_BYTES[dtype],
              spans={"build": build_s}, m=op.shape[0])
    pool = make_pool(b_true, cfg["noise_level"], traffic["pool"], seed,
                     dev)
    rng = np.random.default_rng(seed)
    # the warm reconstruction, and on its output the window's own reads,
    # so that no kernel of theirs loads inside the window
    warm = solve(pool[0])
    finite_of(warm), copy_of(warm)
    del warm
    _sync(dev)
    setup_s = time.perf_counter() - t0

    # ---- the window
    walls, finite = [], []
    kept, rows = [], []  # reservoir: a uniform sample of the outputs
    k = traffic["checked"]
    start_t = end = time.perf_counter()
    while True:
        t = time.perf_counter()
        if t - start_t >= seconds:
            break
        i = len(walls)
        out = solve(pool[i % len(pool)])
        finite.append(finite_of(out))
        j = i if i < k else int(rng.integers(i + 1))
        if j < k:
            o = copy_of(out)
            if j == len(kept):
                kept.append(o)
                rows.append(i % len(pool))
            else:
                kept[j], rows[j] = o, i % len(pool)
        _sync(dev)
        end = time.perf_counter()
        walls.append(end - t)
    window_s = end - start_t
    if trace:
        traced(solve, pool, traffic["trace_recons"], run, dev)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)

    # ---- the comparison, with the program's state freed
    failed = sum(not all(bool(f) for f in fs) for fs in finite)
    sample = [{key: v.double() for key, v in o.items()} for o in kept]
    bs = pool[rows].double().T.contiguous()
    del op, solve, kept, pool
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = {k: c for k, c in compare(cell, kind, entry, sample, bs).items()
              if c["limit"] is not None}
    correct = failed == 0 and all(
        np.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())

    if trace:
        metrics = {}
        for m in cell.per_layer:
            reader = importlib.import_module(f"port_bench.metrics.{m['name']}")
            v = reader.read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = end_to_end(walls, window_s, setup_s)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": peak}
    if trace:
        device_info.update(busy_s=run.busy_s, window_s=run.window_s)
    result = {"correct": bool(correct), "attempted": len(walls),
              "failed": failed, "metrics": metrics, "device": device_info}
    if trace and run.breakdown is not None:
        result["breakdown"] = run.breakdown
    result["checks"] = checks
    return result


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
