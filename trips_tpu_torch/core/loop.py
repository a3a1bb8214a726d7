"""Data-dependent loops without a host read per step.

The port's counterpart of ``jax.lax.while_loop`` for its device loops
(CGLS, Brent's search, the discrepancy-principle Newton, LSQR; a
``while_loop(cond, ...)`` is ``run`` with ``done = ~cond``). The step
function is pure on a state of tensors. ``run`` enqueues a chunk of steps
without a test, keeps every state of the chunk and the test's flag of
each, and reads once per chunk which state first passed the test; it
returns that state. So the result is the state a loop that tests every
step would stop at (the same tensors, no rounding changed), at the price
of at most ``chunk - 1`` discarded steps after the stop: one host read a
chunk.

``TRACE``, when set to a list, receives ``(name, host reads, steps)`` for
every loop (``steps`` the state's ``counter`` entry, a device tensor read
by the caller when it wants), so a run can count its syncs and each
search's length.
"""
from __future__ import annotations

import torch

TRACE = None


def run(step, state, done, chunk, max_steps=None, name="loop", counter=None):
    """The first of ``state``, ``step(state)``, ``step(step(state))``, ...
    for which ``done`` (a 0-d bool tensor) holds; the ``max_steps``-th
    (None: no limit) if none before it does. The steps after that state
    are computed and dropped, so ``step`` must not fail on them."""
    reads, flag = 0, done(state)
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
            state = states[first]
            break
        state, flag = states[-1], flags[-1]
    if TRACE is not None:
        TRACE.append((name, reads,
                      state[counter] if counter is not None else None))
    return state
