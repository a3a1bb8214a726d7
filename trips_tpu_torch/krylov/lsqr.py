"""LSQR (Paige-Saunders) with optional Tikhonov damping, on the device.

Counterpart of ``trips_tpu/krylov/lsqr.py``. With lam known (or zero), the
damped least-squares iteration is one ``A v`` and one ``A^T u`` per step
plus scalar Givens recurrences, the hot loop of CGLS with the better
conditioned bidiagonal recurrence. Stopping: atol/btol on the residual
estimates, or the iteration cap.

JAX runs it as one ``lax.while_loop``; here it is ``core.loop.run``: on
the card (an operator whose ``capturable`` is true) replays of one
captured CUDA graph of the masked step, else the steps of a chunk
enqueued with their tests and kept. The state at the first test that
fails is returned (so ``x`` and ``k`` are the ``while_loop``'s), and the
host reads the tests once per ``CHUNK`` steps.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.device import DEFAULT, check_operators, resolve
from ..core import loop
from ..core.linop import _capturable

CHUNK = 8  # steps between two host reads of the stopping test


class LSQRState(NamedTuple):
    x: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    alfa: torch.Tensor
    beta: torch.Tensor
    rhobar: torch.Tensor
    phibar: torch.Tensor
    rnorm: torch.Tensor
    arnorm: torch.Tensor
    k: torch.Tensor
    done: torch.Tensor


def lsqr(A, b, max_iter: int, damp=0.0, atol=1e-8, btol=1e-8,
         device=DEFAULT):
    """Solve min ||Ax-b||^2 + damp^2 ||x||^2; returns (x, iterations)."""
    dev = resolve(device)
    check_operators(dev, A)
    b = torch.as_tensor(b, device=dev).reshape(-1)
    n = A.shape[1]

    beta0 = torch.linalg.norm(b)
    u0 = b / beta0
    v_raw = A.rmatvec(u0)
    alfa0 = torch.linalg.norm(v_raw)
    v0 = v_raw / alfa0
    s0 = LSQRState(
        x=b.new_zeros(n), u=u0, v=v0, w=v0, alfa=alfa0, beta=beta0,
        rhobar=alfa0, phibar=beta0, rnorm=beta0, arnorm=alfa0 * beta0,
        k=torch.zeros((), dtype=torch.int32, device=dev),
        done=torch.zeros((), dtype=torch.bool, device=dev))
    rnorm0, arnorm0 = s0.rnorm, s0.arnorm

    def cond(s):
        return (s["k"] < max_iter) & ~s["done"]

    def step(d):
        s = LSQRState(**d)
        # bidiagonalization step
        u = A.matvec(s.v) - s.alfa * s.u
        beta = torch.linalg.norm(u)
        u = u / beta
        v = A.rmatvec(u) - beta * s.v
        alfa = torch.linalg.norm(v)
        v = v / alfa

        # eliminate damping
        rhobar1 = torch.sqrt(s.rhobar**2 + damp**2)
        cs1 = s.rhobar / rhobar1
        phibar = cs1 * s.phibar

        # Givens rotation
        rho = torch.sqrt(rhobar1**2 + beta**2)
        cs = rhobar1 / rho
        sn = beta / rho
        theta = sn * alfa
        rhobar = -cs * alfa
        phi = cs * phibar
        phibar_new = sn * phibar

        x = s.x + (phi / rho) * s.w
        w = v - (theta / rho) * s.w

        # phibar carries an alternating sign through the rotations; the
        # residual-norm estimates are its magnitude
        rnorm = torch.abs(phibar_new)
        arnorm = alfa * torch.abs(sn * phibar)
        done = (rnorm <= btol * rnorm0 + atol) | (arnorm <= atol * arnorm0)
        return LSQRState(x, u, v, w, alfa, beta, rhobar, phibar_new, rnorm,
                         arnorm, s.k + 1, done)._asdict()

    s, k = loop.run(step, s0._asdict(), lambda s: ~cond(s), CHUNK,
                    name="lsqr", counter="k",
                    capture=_capturable(A))
    return s["x"], k
