"""Checkpointable fused solver loops.

Counterpart of ``trips_tpu/solvers/checkpointed.py``. The fused solvers
(``fused.py``) run all ``n_iter`` iterations at once; a long solve that
dies restarts from zero. These functions run the SAME iteration body in
chunks of ``chunk`` iterations: the state surfaces between chunks, a
:class:`~trips_tpu_torch.utils.checkpoint.CheckpointCallback` persists it,
and ``resume_state`` restarts from the last checkpoint. The state's names
and shapes are the JAX package's, so a checkpoint written by one package
resumes in the other.

A resumed run repeats the uninterrupted one's operations in the same
order on the same bytes, so it ends bitwise equal, on the CPU and on the
card (where K1 and K3 add in fixed point: the same bits every run).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import DEFAULT
from ..krylov.golub_kahan import _basis
from ..utils.checkpoint import load_state
from .fused import (_check_weight_mode, _fused_gks_chunk, _fused_mmgks_chunk,
                    _gks_init, _inputs, _mmgks_init, _mmgks_regularizer)

_GKS_FIELDS = ("V", "AV", "LV", "x", "lams", "resids")


def _host(t):
    """A NumPy copy of tensor ``t`` (the carry is updated in place)."""
    return t.detach().cpu().numpy().copy()


def _carry_to_state(carry, ii):
    state = {k: _host(v) for k, v in zip(_GKS_FIELDS, carry)}
    state["ii"] = int(ii)
    return state


def _state_to_carry(state, b):
    """The carry of a saved state on ``b``'s device, in ``b``'s dtype; the
    bases column-contiguous, as the uninterrupted run holds them."""
    carry = []
    for k in _GKS_FIELDS:
        t = torch.tensor(np.asarray(state[k]), device=b.device,
                         dtype=b.dtype)
        if t.dim() == 2:
            t = _basis(*t.shape, b).copy_(t)
        carry.append(t)
    return tuple(carry), int(state["ii"])


def _run_chunked(chunk_fn, init_fn, b, n_iter, chunk, callback,
                 resume_state):
    if resume_state is not None:
        if isinstance(resume_state, str):
            resume_state = load_state(resume_state)
        carry, start = _state_to_carry(resume_state, b)
    else:
        carry, start = init_fn(), 0
    ii = start
    while ii < n_iter:
        c = min(chunk, n_iter - ii)
        carry = chunk_fn(carry, ii, c)
        ii += c
        if callback is not None:
            callback(ii, **_carry_to_state(carry, ii))
    return carry


def fused_gks_checkpointed(A, b, L, projection_dim=3, n_iter=20,
                           regparam=1.0, regparam_mode="gcv", delta=0.0,
                           eta=1.01, chunk=10, callback=None,
                           resume_state=None, device=DEFAULT):
    """Chunked :func:`~trips_tpu_torch.solvers.fused.fused_gks`.
    ``callback(it, **state)`` fires after every chunk (a
    ``CheckpointCallback`` with ``every=1`` persists each chunk);
    ``resume_state`` is a state dict or an ``.npz`` path of an earlier run.
    Returns (x, lams, resids)."""
    A, b, L = _inputs(device, A, b, L)
    carry = _run_chunked(
        lambda carry, i0, c: _fused_gks_chunk(
            A, b, L, carry, i0, c, projection_dim=projection_dim,
            n_iter=n_iter, regparam=regparam, regparam_mode=regparam_mode,
            delta=delta, eta=eta),
        lambda: _gks_init(A, b, L, projection_dim, n_iter),
        b, n_iter, chunk, callback, resume_state)
    return carry[3], carry[4], carry[5]


def fused_mmgks_checkpointed(A, b, L, pnorm=2.0, qnorm=1.0, epsilon=0.1,
                             projection_dim=3, n_iter=20, regparam=1.0,
                             regparam_mode="gcv", delta=0.0, eta=1.01,
                             weight_mode="holder", prob_dims=None,
                             chunk=10, callback=None, resume_state=None,
                             device=DEFAULT):
    """Chunked :func:`~trips_tpu_torch.solvers.fused.fused_mmgks` (every
    weight mode, the dynamic isoTV/GS too). Returns (x, lams, resids)."""
    A, b, L = _inputs(device, A, b, L)
    _check_weight_mode(weight_mode, prob_dims)
    Lr = _mmgks_regularizer(L, weight_mode, prob_dims, b.device)
    carry = _run_chunked(
        lambda carry, i0, c: _fused_mmgks_chunk(
            A, b, L, carry, i0, c, pnorm=pnorm, qnorm=qnorm,
            epsilon=epsilon, projection_dim=projection_dim, n_iter=n_iter,
            regparam=regparam, regparam_mode=regparam_mode, delta=delta,
            eta=eta, weight_mode=weight_mode, prob_dims=prob_dims),
        lambda: _mmgks_init(A, b, Lr, projection_dim, n_iter),
        b, n_iter, chunk, callback, resume_state)
    return carry[3], carry[4], carry[5]


_CGN_FIELDS = ("x", "t", "p", "gamma", "norms_t0", "k", "done")


def cgls_normal_checkpointed(A, b, x0, max_iter, tol=0.0, chunk=25,
                             callback=None, resume_state=None,
                             device=DEFAULT):
    """Chunked :func:`~trips_tpu_torch.krylov.cgls_normal`: the identical
    CG-on-normal-equations recurrence, ``chunk`` iterations per call, the
    ``CGNState`` surfacing between chunks. Returns (x, k)."""
    from ..krylov.cgls import CGNState, _cgn_chunk, _cgn_init

    A, b, _ = _inputs(device, A, b)
    if resume_state is not None:
        if isinstance(resume_state, str):
            resume_state = load_state(resume_state)
        fields = {k: torch.tensor(np.asarray(resume_state[k]),
                                  device=b.device) for k in _CGN_FIELDS}
        fields["k"] = int(fields["k"])
        fields["done"] = fields["done"].to(torch.bool)
        for k in ("x", "t", "p", "gamma", "norms_t0"):
            fields[k] = fields[k].to(b.dtype)
        s = CGNState(**fields)
    else:
        s = _cgn_init(A, b, torch.as_tensor(x0, device=b.device).reshape(-1))
    while s.k < max_iter and not bool(s.done):
        s = _cgn_chunk(A, tol, s, min(s.k + chunk, max_iter))
        if callback is not None:
            state = {f: np.asarray(getattr(s, f)) if f == "k"
                     else _host(getattr(s, f)) for f in _CGN_FIELDS}
            callback(s.k, **state)
    return s.x, s.k
