"""Reference-parity ``(x, info)`` adapters for the fused solvers.

Counterpart of ``trips_tpu/solvers/fused_info.py``. The fused solvers
return bare ``(x, lambda_history[, residual_history])``; the reference's
solvers return ``(x, info)`` with ``xHistory``, ``regParam``,
``regParam_history``, ``relError``, ``Residual``, ``its``
(``trips/solvers/GKS.py:97-105``, ``Hybrid_LSQR.py:108-113``). These run
the SAME fused bodies and keep each iterate, as JAX's ``lax.scan`` stacks
it: the iterates are collected and stacked once at the end (a history of
n_iter x n entries), never concatenated per step. ``x_true`` adds the
per-iteration ``relError``, computed on the device.
"""
from __future__ import annotations

import torch

from ..core.device import DEFAULT
from .fused import (_gks_body, _gks_init, _hybrid_gmres_parts,
                    _hybrid_lsqr_parts, _inputs, _mmgks_body, _mmgks_init,
                    _mmgks_regularizer, _check_weight_mode, _resolve_mode)


def _scan_history(body, init, start, n_iter, x_of):
    carry, xs = init, []
    for ii in range(start, n_iter):
        carry = body(ii, carry)
        xs.append(x_of(carry))
    return carry, torch.stack(xs)


def _info(xh, lams, resids, b, n_done, x_true, rel_residual=False):
    """``Residual`` carries each solver's REFERENCE meaning: for GKS/MMGKS
    the reorthogonalized normal-equations gradient norm
    (``trips/solvers/GKS.py:85-88``), for the hybrids the projected
    ``||A x - b||``. ``relResidual`` (hybrids only) divides by ``||b||``.
    Index i of every history belongs to the same iteration."""
    info = {
        "xHistory": xh,
        "regParam": lams[-1],
        "regParam_history": lams,
        "Residual": resids,
        "its": n_done,
    }
    if rel_residual:
        info["relResidual"] = resids / torch.linalg.norm(b.reshape(-1))
    if x_true is not None:
        xt = torch.as_tensor(x_true, device=xh.device).reshape(-1).to(
            xh.dtype)
        info["relError"] = (torch.linalg.norm(xh - xt[None, :], dim=1)
                            / torch.linalg.norm(xt))
    return info


def fused_gks_info(A, b, L, projection_dim=3, n_iter=20, regparam=1.0,
                   regparam_mode="gcv", delta=0.0, eta=1.01, x_true=None,
                   device=DEFAULT):
    """:func:`~trips_tpu_torch.solvers.fused.fused_gks` with reference
    info."""
    A, b, L = _inputs(device, A, b, L)
    mode = _resolve_mode(regparam_mode, None)
    body = _gks_body(A, b, L, mode, regparam, delta, eta, projection_dim,
                     projection_dim + n_iter)
    carry, xh = _scan_history(
        body, _gks_init(A, b, L, projection_dim, n_iter), 0, n_iter,
        lambda c: c[3])
    return carry[3], _info(xh, carry[4], carry[5], b, n_iter, x_true)


def fused_mmgks_info(A, b, L, pnorm=2.0, qnorm=1.0, epsilon=0.1,
                     projection_dim=3, n_iter=20, regparam=1.0,
                     regparam_mode="gcv", delta=0.0, eta=1.01,
                     weight_mode="holder", prob_dims=None, x_true=None,
                     device=DEFAULT):
    """:func:`~trips_tpu_torch.solvers.fused.fused_mmgks` with reference
    info."""
    A, b, L = _inputs(device, A, b, L)
    mode = _resolve_mode(regparam_mode, None)
    _check_weight_mode(weight_mode, prob_dims)
    L = _mmgks_regularizer(L, weight_mode, prob_dims, b.device)
    body = _mmgks_body(A, b, L, mode, pnorm, qnorm, epsilon, regparam, delta,
                       eta, weight_mode, prob_dims, projection_dim,
                       projection_dim + n_iter)
    carry, xh = _scan_history(
        body, _mmgks_init(A, b, L, projection_dim, n_iter), 0, n_iter,
        lambda c: c[3])
    return carry[3], _info(xh, carry[4], carry[5], b, n_iter, x_true)


def fused_hybrid_lsqr_info(A, b, n_iter=50, regparam=1.0, reorth=False,
                           regparam_mode="gcv", delta=0.0, eta=1.01,
                           x_true=None, device=DEFAULT):
    """:func:`~trips_tpu_torch.solvers.fused.fused_hybrid_lsqr` with
    reference info. ``xHistory`` has one row per solve (the reference's
    first solve is at iteration 1, Hybrid_LSQR.py:77-78)."""
    A, b, _ = _inputs(device, A, b)
    mode = _resolve_mode(regparam_mode, None)
    body, init, start = _hybrid_lsqr_parts(A, b, n_iter, mode, regparam,
                                           delta, eta, reorth)
    carry, xh = _scan_history(body, init, start, n_iter, lambda c: c[0])
    # drop the never-written leading entries: every history index refers
    # to the same performed solve
    return carry[0], _info(xh, carry[1][start:], carry[2][start:], b,
                           n_iter - start, x_true, rel_residual=True)


def fused_hybrid_gmres_info(A, b, n_iter=50, regparam=1.0, reorth=False,
                            regparam_mode="gcv", delta=0.0, eta=1.01,
                            x_true=None, device=DEFAULT):
    """:func:`~trips_tpu_torch.solvers.fused.fused_hybrid_gmres` with
    reference info."""
    A, b, _ = _inputs(device, A, b)
    mode = _resolve_mode(regparam_mode, None)
    body, init, start = _hybrid_gmres_parts(A, b, n_iter, mode, regparam,
                                            delta, eta, reorth)
    carry, xh = _scan_history(body, init, start, n_iter, lambda c: c[0])
    return carry[0], _info(xh, carry[1][start:], carry[2][start:], b,
                           n_iter - start, x_true, rel_residual=True)
