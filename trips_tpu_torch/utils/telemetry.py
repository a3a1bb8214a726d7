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
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

from ..core.device import DEFAULT, resolve


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
    """Collects per-iteration solver telemetry; usable as solver callback."""

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
    """Milliseconds of device time that the ``torch.profiler`` session
    ``prof`` recorded: its device events (kernels, copies, memsets)
    summed, each once (the profiler also credits a kernel that an aten op
    launched to the op's own device time, so a sum over all its entries
    would count those twice); events on concurrent streams may overlap.
    A replayed CUDA graph (the port's loops on the card, ``core/loop.py``)
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
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
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
