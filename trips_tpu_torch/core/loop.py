"""Data-dependent loops without a host read per step.

The port's counterpart of ``jax.lax.while_loop`` for its device loops
(CGLS, Brent's search, the discrepancy-principle Newton, LSQR; a
``while_loop(cond, ...)`` is ``run`` with ``done = ~cond``). The step
function is pure on a state of tensors (a dict, a NamedTuple's dict or a
dataclass; entries that are not tensors pass through). ``run`` returns the
first state in which ``done`` holds, or the ``max_steps``-th: the same
tensors, bit for bit, as a loop that tests every step. The host reads
once per chunk of steps.

Two ways to get there:

- **On the card** (a state on a CUDA device, a step the caller declares
  capturable): the first step runs eagerly (it warms the caches that read
  the host: the kernels' plans, the packs' bounds), then one *masked* step
  ``s <- where(done(s), s, step(s))`` with a device step counter is
  captured once as a ``torch.cuda.CUDAGraph`` and replayed, a chunk of
  replays between two host reads of (done, counter). A replay after the
  stop leaves the state at the stopping state, so what the read finds is
  the first state done, as the reference's ``lax.while_loop`` compiles its
  step once and runs it on the device until the test fails. A capture or
  replay that fails raises; the loop never falls back to the eager path.
  Kernel launch counts (``counted``) count replays: a captured step's
  launches are taken at capture and added per replay.
- **Eagerly** (the CPU, a step that cannot be captured, and the card
  tests' yardstick under ``eager()``): a chunk of steps is enqueued
  without a test, every state of the chunk and the test's flag of each
  kept, and one read gives the first state that passed; the steps after
  it are dropped.

Both run the same number of steps between reads (the first chunk counts
the eager step), so launch counts and reads per solve are the same.
``emulated()`` runs the card's path on any device with the masked step
called eagerly in place of each replay: the CPU tests hold it bitwise to
the eager path.

Graphs share one memory pool per device, kept for the process by a small
anchor graph: a loop's graph is freed when the loop returns and the next
capture reuses the pool, which holds at most the largest captured step's
transient tensors (a pool per graph would leave every freed pool's
memory cached until the allocator runs short).

``TRACE``, when set to a list, receives ``(name, host reads, steps)`` for
every loop (``steps`` the state's ``counter`` entry, a device tensor read
by the caller when it wants), so a run can count its syncs and each
search's length.

Spans (``utils.telemetry``): every loop is a span ``loop.<name>`` whose
attributes are ``reads`` and ``steps`` (what ``TRACE`` receives),
``captures`` (graphs captured; under ``emulated()``, where the card would
capture) and ``replays`` (replays made or emulated). On the card's path a
span ``loop.capture`` runs from ``capture_begin`` to ``capture_end``
(instantiation included), and a span ``loop.replay`` over each chunk's
replays and the host read that ends it.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from ..utils import telemetry

TRACE = None
_MODE = None  # None, "eager" or "emulated": see eager() and emulated()
_COUNTS = []  # launch-count dicts of the kernel wrappers (counted)
_POOL = {}    # device index -> (capture stream, pool handle, anchor graph,
#               the anchor's tensor)


def counted(counts):
    """Register a wrapper module's ``launch_counts`` dict, so that a
    replayed step's launches are counted per replay; returns it."""
    _COUNTS.append(counts)
    return counts


@contextlib.contextmanager
def eager():
    """Run every loop eagerly, also on the card (the graph path's
    yardstick)."""
    global _MODE
    prev, _MODE = _MODE, "eager"
    try:
        yield
    finally:
        _MODE = prev


@contextlib.contextmanager
def emulated():
    """Run every loop through the card's path with the masked step called
    eagerly in place of each replay, on any device (for tests)."""
    global _MODE
    prev, _MODE = _MODE, "emulated"
    try:
        yield
    finally:
        _MODE = prev


def _fields(state):
    """{name: tensor} of the state's tensor entries."""
    items = (state.items() if isinstance(state, dict) else
             ((f.name, getattr(state, f.name))
              for f in dataclasses.fields(state)))
    return {k: v for k, v in items if isinstance(v, torch.Tensor)}


def _get(state, name):
    return state[name] if isinstance(state, dict) else getattr(state, name)


def _rebuild(state, tensors):
    if isinstance(state, dict):
        return {**state, **tensors}
    return dataclasses.replace(state, **tensors)


def _trace(span, name, reads, state, counter, **counts):
    steps = _get(state, counter) if counter is not None else None
    span.set(reads=reads, steps=steps, **counts)
    if TRACE is not None:
        TRACE.append((name, reads, steps))


def run(step, state, done, chunk, max_steps=None, name="loop", counter=None,
        capture=True):
    """The first of ``state``, ``step(state)``, ``step(step(state))``, ...
    for which ``done`` (a 0-d bool tensor) holds; the ``max_steps``-th
    (None: no limit) if none before it does. Returns ``(state, steps)``,
    ``steps`` the host count of steps from ``state`` to it. The steps after
    that state are computed and dropped, so ``step`` must not fail on
    them. ``capture``: the step may be captured in a CUDA graph (the
    caller's operators say so); a state on the card then runs as replays
    of one captured step."""
    dev = next(iter(_fields(state).values())).device
    if _MODE == "emulated" or (_MODE is None and capture
                               and dev.type == "cuda"):
        return _replayed(step, state, done, chunk, max_steps, name, counter,
                         graph=_MODE != "emulated")
    return run_eager(step, state, done, chunk, max_steps, name, counter)


def run_eager(step, state, done, chunk, max_steps=None, name="loop",
              counter=None):
    """``run`` enqueued step by step: a chunk of steps without a test,
    every state kept, one read of the first one done."""
    with telemetry.span("loop." + name) as span:
        reads, steps, flag = 0, 0, done(state)
        while max_steps is None or max_steps > 0:
            states, flags = [state], [flag]
            n = chunk if max_steps is None else min(chunk, max_steps)
            for _ in range(n):
                states.append(step(states[-1]))
                flags.append(done(states[-1]))
            if max_steps is not None:
                max_steps -= n
            stacked = torch.stack(flags)
            # the chunk's one host read: the first state done, or none
            first = int(torch.where(stacked.any(), stacked.byte().argmax(),
                                    len(states)))
            reads += 1
            if first < len(states):
                state, steps = states[first], steps + first
                break
            state, flag, steps = states[-1], flags[-1], steps + n
        _trace(span, name, reads, state, counter)
        return state, steps


def _pool(idx):
    """(capture stream, graph pool) of device ``idx``. An anchor graph
    holds the pool, so that it outlives each loop's graph and the next
    capture reuses it."""
    if idx not in _POOL:
        side = torch.cuda.Stream(idx)
        handle = torch.cuda.graph_pool_handle()
        cell = torch.zeros(1, device=idx)
        anchor = torch.cuda.CUDAGraph()
        side.wait_stream(torch.cuda.current_stream(idx))
        with torch.cuda.stream(side):
            anchor.capture_begin(pool=handle)
            cell.add_(1)
            anchor.capture_end()
        _POOL[idx] = (side, handle, anchor, cell)
    return _POOL[idx][:2]


def _replayed(step, state, done, chunk, max_steps, name, counter, graph):
    """``run`` as replays of one captured masked step (``graph``), or with
    that step called eagerly in place of each replay."""
    with telemetry.span("loop." + name) as span:
        if max_steps is not None and max_steps <= 0:
            _trace(span, name, 0, state, counter, captures=0, replays=0)
            return state, 0
        names = list(_fields(state))
        # step 1, eagerly; its state becomes the loop's static tensors
        flag0 = done(state)
        first = _fields(step(state))
        cur = {k: torch.where(flag0, _get(state, k), first[k]) for k in names}
        static = _rebuild(state, cur)
        count = (~flag0).to(torch.int64)
        flag = done(static).clone()

        def masked():
            live = ~flag
            new = _fields(step(static))
            vals = [torch.where(live, new[k], cur[k]) for k in names]
            for k, v in zip(names, vals):
                cur[k].copy_(v)
            count.add_(live.to(torch.int64))
            flag.copy_(done(static))

        # the graph, captured at the first replay (a loop of one step needs
        # none) and freed when the loop returns
        g, per_replay, replays = None, (), 0
        left = max_steps
        n = chunk if left is None else min(chunk, left)
        todo, reads = n - 1, 0  # the first chunk holds the eager step
        while True:
            if todo and graph and g is None:
                g, per_replay = _capture(masked, flag.device)
            with telemetry.span("loop.replay"):
                for _ in range(todo):
                    g.replay() if graph else masked()
                stopped, steps = torch.stack([flag.to(torch.int64),
                                              count]).tolist()
            for counts, delta in per_replay:
                for k, v in delta.items():
                    counts[k] += v * todo
            replays += todo
            if left is not None:
                left -= n
            reads += 1
            if stopped or left == 0:
                break
            n = chunk if left is None else min(chunk, left)
            todo = n
        static = _rebuild(state, cur)
        _trace(span, name, reads, static, counter,
               captures=int(replays > 0), replays=replays)
        return static, steps


def _capture(fn, dev):
    """(graph of ``fn`` captured on the side stream, the launches it makes
    per replay: [(counts dict, {kernel: launches})])."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    side, pool = _pool(idx)
    before = [dict(c) for c in _COUNTS]
    g = torch.cuda.CUDAGraph()
    side.wait_stream(torch.cuda.current_stream(dev))
    try:
        with torch.cuda.stream(side), telemetry.span("loop.capture"):
            g.capture_begin(pool=pool)
            try:
                fn()
            finally:
                g.capture_end()
    except BaseException:
        _POOL.pop(idx)  # the next capture starts on a new stream and pool
        raise
    finally:
        # a capture launches nothing: take its counts back
        per = []
        for counts, old in zip(_COUNTS, before):
            delta = {k: counts[k] - old.get(k, 0) for k in counts}
            counts.update(old)
            if any(delta.values()):
                per.append((counts, delta))
    torch.cuda.current_stream(dev).wait_stream(side)
    return g, per
