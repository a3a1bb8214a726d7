"""The program's spans (``trips_tpu_torch.utils.telemetry``) in the
harness's traced runs, on the CPU at tiny sizes: every cell's profiled
sub-window holds its solver's spans as ``user_annotation`` events, though
the harness leaves the span recorder off; the program's counters read as
they do with every span silenced; and ``read_trace`` names an idle gap
under no host call but a program span by that span."""
import json

import pytest

from port_bench import harness
from test_port_bench_harness import WORKLOADS, run

SPANS = {"cgls_normal": {"solve.cgls_normal", "loop.cgls_normal"},
         "mmgks_isotv": {"solve.mmgks", "mmgks.lambda"},
         "fused_gks_gcv": {"solve.fused_gks", "loop.brent"}}


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
    assert SPANS[workload.split(".")[1]] <= seen
    monkeypatch.setattr(telemetry, "span", lambda *a, **k: telemetry._OFF)
    seen.clear()
    silent = run(workload, trace=True)
    assert seen == {harness.RECON}
    for m in set(spanned["metrics"]) - {"build_s"}:  # build_s: a host clock
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
