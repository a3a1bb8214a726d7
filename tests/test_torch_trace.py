"""The port's span recorder (``utils.telemetry``) on a tiny problem.

``cgls_normal`` (the card's path under ``core.loop.emulated()``) and a
small ``MMGKS`` on a 60 x 40 dense operator in float64:

- with the recorder off nothing is recorded, and the outputs are bitwise
  those with it on;
- with it on the spans form the tree the solver calls make: a root
  ``solve.*`` a call, each with its own request id, which every span
  beneath it carries; a ``loop.<name>`` per device loop, whose ``reads``
  and ``steps`` are ``core.loop.TRACE``'s tuple, a ``loop.replay`` per
  chunk, a ``mmgks.lambda`` per MMGKS iteration;
- under a CPU ``torch.profiler`` session every span stands once in the
  trace as a ``user_annotation`` of its name and about its duration, and
  with the recorder off the same annotations are there;
- ``export`` writes a Chrome trace that loads.

The card's ``loop.capture`` spans are held in ``tests/test_torch_cuda.py``.
"""
import json
import os
import tempfile

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from trips_tpu_torch.core import DenseOperator, loop
from trips_tpu_torch.krylov import cgls_normal
from trips_tpu_torch.krylov.cgls import CHUNK
from trips_tpu_torch.operators import FirstDerivative1D
from trips_tpu_torch.solvers import MMGKS
from trips_tpu_torch.utils import telemetry

from torch_threads import one_torch_thread  # noqa: F401

N_ITER, CGLS_STEPS = 3, 2 * CHUNK + 3


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((60, 40)) / 8
    b = A @ rng.standard_normal(40) + 1e-2 * rng.standard_normal(60)
    return (DenseOperator(torch.from_numpy(A)), torch.from_numpy(b),
            FirstDerivative1D(40, device="cpu"))


def _solves(problem):
    """(cgls_normal's x, MMGKS's x and lambdas, loop.TRACE)."""
    A, b, L = problem
    loop.TRACE = []
    try:
        with loop.emulated():
            x, _ = cgls_normal(A, b, torch.zeros(40, dtype=b.dtype),
                               CGLS_STEPS)
            xm, info = MMGKS(A, b, L, projection_dim=2, n_iter=N_ITER,
                             regparam="gcv")
        return (x, xm, info["regParam"]), loop.TRACE
    finally:
        loop.TRACE = None


def test_off_records_nothing_and_on_changes_no_bit(problem):
    with telemetry.tracing() as before:
        pass
    off, _ = _solves(problem)
    assert before.spans == [] and telemetry._ON is None
    assert telemetry.span("a") is telemetry.span("b", request=True)
    with telemetry.tracing() as t:
        on, _ = _solves(problem)
    assert t.spans
    assert torch.equal(off[0], on[0]) and torch.equal(off[1], on[1])
    assert off[2] == on[2]


def test_span_tree_requests_and_loop_counters(problem):
    with telemetry.tracing() as t:
        _, trace = _solves(problem)
    spans = t.spans
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["solve.cgls_normal", "solve.mmgks"]
    assert [s.request for s in roots] == [0, 1]
    for s in spans:
        root = s
        while root.parent is not None:
            assert root.start_ns >= root.parent.start_ns
            assert root.end_ns <= root.parent.end_ns
            root = root.parent
        assert s.request == root.request
    # the loops: one span each, its attributes TRACE's tuple
    loops = [s for s in spans if s.name.startswith("loop.")
             and s.name not in ("loop.replay", "loop.capture")]
    assert [(s.name, s.attrs["reads"], s.attrs["steps"]) for s in loops] \
        == [("loop." + n, r, c) for n, r, c in trace]
    cg = loops[0]
    assert cg.name == "loop.cgls_normal" and cg.parent is roots[0]
    assert cg.attrs["reads"] == 3 and cg.attrs["captures"] == 1
    assert cg.attrs["replays"] == CGLS_STEPS - 1
    replays = [s for s in spans if s.name == "loop.replay"]
    assert all(s.parent.name.startswith("loop.") for s in replays)
    assert sum(s.parent is cg for s in replays) == cg.attrs["reads"]
    assert not any(s.name == "loop.capture" for s in spans)  # card only
    lam = [s for s in spans if s.name == "mmgks.lambda"]
    assert len(lam) == N_ITER and all(s.parent is roots[1] for s in lam)


def _annotations(prof):
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return sorted((e["ts"], e["name"], e["dur"]) for e in events
                  if e.get("cat") == "user_annotation")


def test_spans_are_profiler_annotations(problem):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _solves(problem)  # recorder off: the profiler still sees the spans
    off = [n for _, n, _ in _annotations(prof)]
    # a host thread preempted between an annotation's edge and the span's
    # stamp stretches that one annotation: the first of three sessions in
    # which none was
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with telemetry.tracing() as t:
                _solves(problem)
        ann = _annotations(prof)
        assert [n for _, n, _ in ann] == [s.name for s in t.spans] == off
        gaps = [abs(dur - (s.end_ns - s.start_ns) / 1e3)
                for (_, _, dur), s in zip(ann, t.spans)]
        if max(gaps) <= 200.0:
            break
    assert max(gaps) <= 200.0, gaps


def test_export_writes_a_chrome_trace(problem, tmp_path):
    with telemetry.tracing() as t:
        _solves(problem)
    t.export(tmp_path / "spans.json")
    with open(tmp_path / "spans.json") as f:
        events = json.load(f)["traceEvents"]
    assert [e["name"] for e in events] == [s.name for s in t.spans]
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    by_id = {e["args"]["id"]: e for e in events}
    for e, s in zip(events, t.spans):
        parent = e["args"]["parent"]
        assert (parent is None) == (s.parent is None)
        if parent is not None:
            assert by_id[parent]["name"] == s.parent.name
        assert e["args"]["request"] == s.request
    steps = [e["args"]["steps"] for e in events
             if e["name"] == "loop.cgls_normal"]
    assert steps == [None]  # cgls_normal's loop has no counter entry
