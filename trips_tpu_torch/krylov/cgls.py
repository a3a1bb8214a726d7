"""CGLS: conjugate gradients on the normal equations, eager torch loops.

Counterpart of ``trips_tpu/krylov/cgls.py`` with the same recurrences,
stopping rules and ``(x, k)`` returns. The JAX loops run on the device in
one ``lax.while_loop``; here each iteration is enqueued from Python.
``cgls`` and ``cgls_normal`` run in chunks of ``CHUNK`` steps and read the
stopping test back once per chunk (one host sync, ``core.loop.run``): the
steps of a chunk are enqueued without a test, each step's state is kept,
and one read gives the first step at which the rule fired; the loop
returns that step's state. So the iterates and ``k`` are those of a loop
that tests the rule every step (the same tensors, no rounding changed);
the price is at most ``CHUNK - 1`` wasted steps (their applies) after the
rule fires. The fixed-length variants never sync inside the loop, and
``cgls_history`` freezes the state with ``torch.where`` once the rule
fires, as the JAX scan does.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..core.loop import run

CHUNK = 8  # steps between two host reads of the stopping test


def _eps(x):
    return torch.finfo(x.dtype).eps


def _done(s):
    return s.done


@dataclass
class CGLSState:
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    gamma: torch.Tensor
    norms_t0: torch.Tensor
    k: int
    done: torch.Tensor


def _init(A, b, x0):
    x = x0.reshape(-1)
    b = b.reshape(-1)
    r = b - A.matvec(x)
    t = A.rmatvec(r)
    norms_t0 = torch.linalg.norm(t)
    return CGLSState(x=x, r=r, p=t, gamma=norms_t0**2, norms_t0=norms_t0,
                     k=0, done=torch.zeros((), dtype=torch.bool,
                                           device=x.device))


def _step(A, tol, s: CGLSState) -> CGLSState:
    w = A.matvec(s.p)
    delta = torch.linalg.norm(w) ** 2
    delta = torch.where(delta == 0, _eps(s.x), delta)
    beta = s.gamma / delta
    x = s.x + beta * s.p
    r = s.r - beta * w
    t = A.rmatvec(r)
    norm_t = torch.linalg.norm(t)
    gamma = norm_t**2
    p = t + (gamma / s.gamma) * s.p
    norm_x = torch.linalg.norm(x)
    done = (norm_t <= s.norms_t0 * tol) | (norm_x * tol >= 1)
    return CGLSState(x=x, r=r, p=p, gamma=gamma, norms_t0=s.norms_t0,
                     k=s.k + 1, done=done)


def cgls(A, b, x0, max_iter: int, tol):
    """CGLS; returns (x, k_iterations)."""
    s = run(lambda s: _step(A, tol, s), _init(A, b, x0), _done, CHUNK,
            max_iter, "cgls")
    return s.x, s.k


def cgls_fixed(A, b, x0, iters: int):
    """Fixed-iteration CGLS (no stopping test, no sync in the loop)."""
    s = _init(A, b, x0)
    for _ in range(iters):
        s = _step(A, 0.0, s)
    return s.x, s.k


@dataclass
class CGNState:
    x: torch.Tensor
    t: torch.Tensor
    p: torch.Tensor
    gamma: torch.Tensor
    norms_t0: torch.Tensor
    k: int
    done: torch.Tensor


def _normal_apply(A):
    if hasattr(A, "normal_matvec"):
        return A.normal_matvec
    return lambda v: A.rmatvec(A.matvec(v))


def _cgn_init(A, b, x0):
    x = x0.reshape(-1)
    b = b.reshape(-1)
    t = A.rmatvec(b) - _normal_apply(A)(x)
    norms_t0 = torch.linalg.norm(t)
    return CGNState(x=x, t=t, p=t, gamma=norms_t0**2, norms_t0=norms_t0,
                    k=0, done=torch.zeros((), dtype=torch.bool,
                                          device=x.device))


def _cgn_step(A, tol, s: CGNState) -> CGNState:
    q = _normal_apply(A)(s.p)
    delta = torch.dot(s.p, q)
    # delta = p.(A^T A p) >= 0 in exact arithmetic, but a quantized normal
    # apply can round it below zero near convergence; a negative delta
    # would flip the step, so treat it as converged instead.
    bad = delta <= 0
    delta = torch.where(bad, _eps(s.x), delta)
    beta = torch.where(bad, torch.zeros_like(delta), s.gamma / delta)
    x = s.x + beta * s.p
    t = s.t - beta * q
    norm_t = torch.linalg.norm(t)
    gamma = norm_t**2
    p = t + (gamma / s.gamma) * s.p
    done = (norm_t <= s.norms_t0 * tol) | bad
    return CGNState(x=x, t=t, p=p, gamma=gamma, norms_t0=s.norms_t0,
                    k=s.k + 1, done=done)


def _cgn_chunk(A, tol, s: CGNState, k_end: int) -> CGNState:
    """Run the ``cgls_normal`` recurrence up to iteration ``k_end``: the same
    loop as ``cgls_normal``, so stopping at ``k_end`` and resuming does not
    change any rounding."""
    return run(lambda s: _cgn_step(A, tol, s), s, _done, CHUNK, k_end - s.k,
               "cgls_normal")


def cgls_normal(A, b, x0, max_iter: int, tol=0.0):
    """CG on the normal equations ``A^T A x = A^T b`` with one
    ``A.normal_matvec`` per iteration (for the banded operator: one fused
    K1 pass per bucket, so the weights stream once per iteration). Same
    iterates as ``cgls`` in exact arithmetic. Returns (x, k)."""
    s = _cgn_chunk(A, tol, _cgn_init(A, b, x0), max_iter)
    return s.x, s.k


def cgls_normal_fixed(A, b, x0, iters: int):
    """Fixed-iteration ``cgls_normal`` (no stopping test, no sync)."""
    s = _cgn_init(A, b, x0)
    for _ in range(iters):
        s = _cgn_step(A, 0.0, s)
    return s.x, s.k


def cgls_history(A, b, x0, max_iter: int, tol):
    """CGLS recording every iterate, for the reference's bookkeeping: once
    the stopping rule fires, later entries repeat the converged iterate.
    Returns (x, k, xs (max_iter, n), rel_steps (max_iter,))."""
    s = _init(A, b, x0)
    k = torch.zeros((), dtype=torch.long, device=s.x.device)
    xs, rel_steps = [], []
    for _ in range(max_iter):
        new = _step(A, tol, s)
        active = ~s.done
        keep = {f: torch.where(active, getattr(new, f), getattr(s, f))
                for f in ("x", "r", "p", "gamma", "done")}
        rel_steps.append(torch.linalg.norm(keep["x"] - s.x)
                         / torch.linalg.norm(keep["x"]))
        k = k + active.long()
        s = replace(s, **keep)
        xs.append(s.x)
    if not xs:
        return s.x, 0, s.x.new_zeros((0, s.x.numel())), s.x.new_zeros(0)
    return s.x, int(k), torch.stack(xs), torch.stack(rel_steps)
