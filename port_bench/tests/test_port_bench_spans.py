"""The program's spans (``trips_tpu_torch.utils.telemetry``) in the
harness's traced runs, on the CPU at tiny sizes: every cell's profiled
sub-window holds its solver's spans as ``user_annotation`` events, though
the harness leaves the span recorder off; the program's counters read as
they do with every span silenced; and ``read_trace`` names an idle gap
under no host call but a program span by that span."""
import json

import pytest

from port_bench import harness
from port_bench.metrics import (capture_idle_ms_per_recon,
                                lambda_idle_ms_per_recon,
                                replay_idle_ms_per_recon)
from port_bench.tests import celldata
from test_port_bench_harness import WORKLOADS, run


@pytest.mark.parametrize("workload", WORKLOADS)
def test_port_bench_trace_holds_the_programs_spans(workload, monkeypatch):
    from trips_tpu_torch.utils import telemetry

    seen = set()
    read = harness.read_trace

    def reading(path, run_):
        with open(path) as f:
            seen.update(e["name"] for e in json.load(f)["traceEvents"]
                        if e.get("cat") == "user_annotation")
        read(path, run_)

    monkeypatch.setattr(harness, "read_trace", reading)
    spanned = run(workload, trace=True)
    traffic = celldata.CELLS[workload]["traffic"]
    assert set(celldata.traffic(traffic)["spans"]) <= seen
    monkeypatch.setattr(telemetry, "span", lambda *a, **k: telemetry._OFF)
    seen.clear()
    silent = run(workload, trace=True)
    assert seen == {harness.RECON}
    # the rest read as they do with every span silenced: all but the
    # program_span metrics (the span readers, and build_s: a host clock)
    spans = {m["name"] for m in harness.load_cell(workload).per_layer
             if m["source"] == "program_span"}
    for m in set(spanned["metrics"]) - spans:
        assert spanned["metrics"][m] == silent["metrics"][m], m


def test_port_bench_gap_under_a_program_span(tmp_path):
    ev = [{"name": harness.RECON, "cat": "user_annotation", "ts": 0,
           "dur": 100},
          {"name": "solve.mmgks", "cat": "user_annotation", "ts": 1,
           "dur": 98},
          {"name": "k", "cat": "kernel", "ts": 10, "dur": 10},
          {"name": "mmgks.lambda", "cat": "user_annotation", "ts": 25,
           "dur": 40},
          {"name": "cudaMemcpyAsync", "cat": "cuda_runtime", "ts": 62,
           "dur": 6},
          {"name": "k", "cat": "kernel", "ts": 70, "dur": 10}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    r = harness.Run({}, 1, 1, 4)
    harness.read_trace(path, r)
    gaps = dict(r.breakdown["idle_gaps"])
    assert gaps == pytest.approx({"mmgks.lambda": 50e-6,
                                  "solve.mmgks": 30e-6})


def test_port_bench_span_readers(tmp_path):
    """Idle ms a reconstruction under a span: its annotations' union (a
    span nested in one of its own name counts once) intersected with the
    device's idle intervals; a gap under two spans counts for each."""
    ev = [{"name": harness.RECON, "cat": "user_annotation", "ts": 0,
           "dur": 100},
          {"name": "loop.cgls", "cat": "user_annotation", "ts": 2, "dur": 96},
          {"name": "loop.capture", "cat": "user_annotation", "ts": 5,
           "dur": 20},
          {"name": "loop.capture", "cat": "user_annotation", "ts": 10,
           "dur": 5},
          {"name": "k", "cat": "kernel", "ts": 20, "dur": 10},
          {"name": "loop.replay", "cat": "user_annotation", "ts": 30,
           "dur": 40},
          {"name": "k", "cat": "kernel", "ts": 40, "dur": 20},
          {"name": "mmgks.lambda", "cat": "user_annotation", "ts": 65,
           "dur": 15},
          {"name": harness.RECON, "cat": "user_annotation", "ts": 200,
           "dur": 50},
          {"name": "loop.replay", "cat": "user_annotation", "ts": 210,
           "dur": 10},
          {"name": "k", "cat": "kernel", "ts": 205, "dur": 10}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    r = harness.Run({}, 1, 1, 4)
    harness.read_trace(path, r)
    assert r.idle == [[(0, 20), (30, 40), (60, 100)],
                      [(200, 205), (215, 250)]]
    # capture: 5..25 less the kernel at 20..30 -> 15 us, over 2 recons
    assert capture_idle_ms_per_recon.read(r) == pytest.approx(15e-3 / 2)
    # replay: 30..40 and 60..70 in the first, 215..220 in the second
    assert replay_idle_ms_per_recon.read(r) == pytest.approx(25e-3 / 2)
    # lambda: 65..80, a gap that falls under loop.replay too
    assert lambda_idle_ms_per_recon.read(r) == pytest.approx(15e-3 / 2)
    assert r.idle_ms_per_recon("loop.cgls") == pytest.approx(66e-3 / 2)
    assert r.idle_ms_per_recon("loop.brent") is None
