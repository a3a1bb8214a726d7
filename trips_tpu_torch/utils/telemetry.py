"""Tracing / profiling / observability.

Counterpart of ``trips_tpu/utils/telemetry.py``:

- ``Timer``: lightweight wall-clock scopes with a report (copied).
- ``SolverTrace``: per-iteration records every solver can emit through its
  ``callback`` kwarg (lambda, residual, relative error, iteration time)
  (copied).
- ``profile()``: context manager around ``torch.profiler`` (the CPU's
  activity, and the card's on a CUDA device) that writes a Chrome trace
  into ``logdir``, where the JAX package's wraps ``jax.profiler.trace``.
- ``device_busy_ms()``: the device time a profile recorded. It raises when
  a profile of the card recorded no device kernel, so that a session that
  saw nothing can never read as a device idle the whole run.
- ``tracing()``: the port's span recorder (the port's own; JAX has none).
  The solver entries, their device loops (``core.loop``) and MMGKS's host
  lambda open spans; ``with tracing() as t:`` keeps them in memory, with
  their parents and the request (one solver call) each serves, and
  ``t.export(path)`` writes them as a Chrome trace. Inside a
  ``torch.profiler`` session every span is also a ``record_function`` of
  its name, so it stands in the profiler's trace as a ``user_annotation``
  on the clock of the device's events, whether the recorder is on or not.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import time
from collections import defaultdict

import torch.autograd.profiler as _profiler

from ..core.device import DEFAULT, resolve

_ON = None  # the recorder ``tracing()`` switched on, or None


class Timer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def scope(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self):
        return {
            k: {"total_s": round(v, 4), "count": self.counts[k]}
            for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])
        }


class SolverTrace:
    """Collects per-iteration solver telemetry; usable as solver callback.

    ``dt_s`` is the host's wall between two callbacks (``time.perf_counter``).
    The port enqueues device work and returns, so it holds the device's
    time only where the solver or the callback reads device state on the
    host between them (a residual read as a float, ``host(x)``); otherwise
    it times the enqueue."""

    def __init__(self, log_every=0, name="solver"):
        self.name = name
        self.log_every = log_every
        self.records = []
        self._t_last = time.perf_counter()

    def __call__(self, iteration, **fields):
        now = time.perf_counter()
        rec = {"it": iteration, "dt_s": round(now - self._t_last, 6), **fields}
        self._t_last = now
        self.records.append(rec)
        if self.log_every and iteration % self.log_every == 0:
            print(f"[{self.name}] {json.dumps(rec)}", flush=True)

    def summary(self):
        if not self.records:
            return {}
        total = sum(r["dt_s"] for r in self.records)
        return {
            "iterations": len(self.records),
            "total_s": round(total, 4),
            "mean_iter_s": round(total / len(self.records), 6),
            "last": self.records[-1],
        }


def device_busy_ms(prof):
    """Milliseconds in which the device was busy in the ``torch.profiler``
    session ``prof``: the union of its device events' intervals (kernels,
    copies, memsets), as ``port_bench.harness.read_trace`` takes it, so
    that events on concurrent streams count once and an aten op, which the
    profiler also credits with its kernels' time, counts not at all; nor
    does a span's annotation projected onto the device's timeline. A
    replayed CUDA graph (the port's loops on the card, ``core/loop.py``)
    is recorded kernel by kernel: each kernel of a replay is a device event
    of its own, and the graph's launch (``cudaGraphLaunch``) a host event
    with no device time, so a replayed loop's busy time is summed as an
    eager loop's (``tests/test_torch_cuda.py``, the card tests). A session
    without the CUDA activity has no device time to give: ValueError. A
    CUDA session that recorded no device time raises RuntimeError rather
    than return 0, which would read as a device idle the whole run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    if ProfilerActivity.CUDA not in prof.activities:
        raise ValueError("the profile traced no CUDA device")
    us, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and not e.is_user_annotation):
        us += max(0.0, b - max(a, end))
        end = max(end, b)
    if us <= 0:
        raise RuntimeError("the profiler recorded no device kernel on the "
                           "card")
    return us / 1e3


@contextlib.contextmanager
def profile(logdir="trips_tpu_trace", device=DEFAULT):
    """Profile a region with ``torch.profiler``: the CPU's activity, and
    the card's where ``device`` is a CUDA device (the default; it raises
    without a card). Yields the profiler; on exit writes its Chrome trace
    to ``logdir/trace.json`` and, on the card, raises if no device kernel
    was recorded (``device_busy_ms``)."""
    import torch
    from torch.profiler import ProfilerActivity

    dev = resolve(device)
    act = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        act.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=act) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    if dev.type == "cuda":
        device_busy_ms(prof)


class _Off:
    """The span of a recorder that is off, outside a profiler session."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_OFF = _Off()


class Span:
    """One span: ``name``, ``start_ns`` and ``end_ns`` (``perf_counter_ns``),
    its ``parent`` span, the ``request`` id it serves and ``attrs``."""
    __slots__ = ("name", "start_ns", "end_ns", "parent", "request", "attrs",
                 "_rec", "_root", "_annotation")

    def __init__(self, rec, name, root):
        self.name, self._rec, self._root = name, rec, root
        self.start_ns = self.end_ns = self.parent = self.request = None
        self.attrs, self._annotation = {}, None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self._annotation = _profiler.record_function(self.name)
            self._annotation.__enter__()
        rec = self._rec
        if rec is not None:
            if rec._open:
                self.parent = rec._open[-1]
                self.request = self.parent.request
            if self.request is None and self._root:
                self.request = next(rec._requests)
            rec.spans.append(self)
            rec._open.append(self)
            self.start_ns = time.perf_counter_ns()  # inside the annotation
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            self.end_ns = time.perf_counter_ns()
            self._rec._open.pop()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        return False

    def set(self, **attrs):
        """Attributes: host ints, or device tensors read at export."""
        self.attrs.update(attrs)


class Tracing:
    """The spans recorded while ``tracing()`` was on, in the order they
    opened. One host thread opens them."""

    def __init__(self):
        self.spans = []
        self._open = []
        self._requests = itertools.count()

    def export(self, path):
        """Write the closed spans as a Chrome trace (the format of
        ``profile()``'s ``trace.json``): a complete event each, ``ts`` and
        ``dur`` in microseconds from the first span's start, ``args`` its
        ``id``, its ``parent``'s id, its ``request`` and its attributes,
        a device tensor read to the host here."""
        done = [s for s in self.spans if s.end_ns is not None]
        ids = {id(s): i for i, s in enumerate(done)}
        t0 = min((s.start_ns for s in done), default=0)
        events = [{"name": s.name, "ph": "X", "cat": "trips_span",
                   "pid": os.getpid(), "tid": 0,
                   "ts": (s.start_ns - t0) / 1e3,
                   "dur": (s.end_ns - s.start_ns) / 1e3,
                   "args": {"id": i, "parent": ids.get(id(s.parent)),
                            "request": s.request,
                            **{k: _host(v) for k, v in s.attrs.items()}}}
                  for i, s in enumerate(done)]
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


def _host(v):
    return v.tolist() if hasattr(v, "tolist") else v


@contextlib.contextmanager
def tracing():
    """Switch the span recorder on; yields the ``Tracing`` that keeps the
    spans opened inside. Off by default: a span then costs a check of
    this switch and of the profiler's, and records nothing."""
    global _ON
    prev, _ON = _ON, Tracing()
    try:
        yield _ON
    finally:
        _ON = prev


def span(name, request=False):
    """A span ``name`` as a context manager (``set(**attrs)`` adds
    attributes). ``request``: the span is a solver call's root, which
    opens a new request unless it runs inside one. No span reads the
    device or launches on it."""
    if _ON is None and not _profiler._is_profiler_enabled:
        return _OFF
    return Span(_ON, name, request)


def request(name):
    """Decorator: every call of the function is a request, a root span
    ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name, request=True):
                return fn(*args, **kwargs)
        return call
    return wrap
