"""Regularization-parameter search on the device, no host read per step.

Counterpart of ``trips_tpu/regparam/device.py``. The host rules
(``gcv.py``/``dp.py``) run in NumPy/SciPy; these run the same searches on
the tensors' device so the fused solvers never wait on a per-step read:

- ``fminbound``: Brent's bounded scalar minimization with the bracketing
  and tolerances of ``scipy.optimize.fminbound`` (golden section and
  successive parabolic interpolation);
- ``gcv_lambda``: Tikhonov-GCV on a projected pencil (R_A, R_L, bproj);
- ``dp_lambda``: the discrepancy principle's Newton on beta = 1/lam in
  filtered SVD coordinates;
- ``gcv_tsvd_k`` .. ``dp_tgsvd_k``: the discrete truncation searches.

JAX runs Brent and Newton as ``lax.while_loop``s; here each is
``core.loop.run``: on the card replays of one captured CUDA graph of the
masked step (the function and the pencil are new tensors at every call,
so a search captures its own graph), on the CPU every step enqueued with
its test and kept. The state at the first failing test is returned (the
same iterates step for step), the later steps are dropped, and the host
reads once per chunk of steps. A float32 search takes 14-69 steps
(``chip_smoke.py`` [8] prints the lengths): ``BRENT_CHUNK`` reads it in
one to five reads, since a replayed step costs its device time (~0.2 ms)
and a longer chunk would cost more in steps past the stop than it saves
in reads. A Newton step is a few small kernels, so ``NEWTON_CHUNK``'s
steps past the stop cost little.

Brent also stops at the first step that changes no entry of its state.
The step is a function of that state alone, so every later step would
repeat it and the minimizer is the same to the bit; JAX's loop runs those
steps up to ``maxfun``. It matters in float32: the stopping test asks for
an interval of sqrt(2.2e-16) |x|, finer than float32 resolves, so an
interior search stalls after ~20-60 steps and would spin to ``maxfun``
(1000 steps of ~70 launches each on the card).

The search runs in the pencil's dtype. Where JAX runs with x64 on, its
``fminbound`` makes the lower bound float64 whatever the pencil's dtype
(``trips_tpu/regparam/device.py:45``), so a float32 pencil is searched in
float64 there; with x64 off (a TPU) it is searched in float32, as here.
"""
from __future__ import annotations

import torch

from ..core.device import DEFAULT, resolve, svd
from ..core import loop

BRENT_CHUNK = 16  # Brent steps between two host reads
NEWTON_CHUNK = 32  # DP Newton steps between two host reads


def _golden_mean(dtype, device):
    """The golden-section constant computed in ``dtype`` with a tensor
    sqrt, never a Python float: in float32 the sqrt's value is one ulp
    below the rounded float64 constant, and the float32 GCV trajectories
    are sensitive to that ulp (JAX computes it the same way)."""
    five = torch.full((), 5.0, dtype=dtype, device=device)
    return 0.5 * (3.0 - torch.sqrt(five))


def fminbound(func, x1, x2, xtol=1e-12, maxfun=1000, dtype=torch.float64,
              device=DEFAULT):
    """Bounded Brent minimizer with ``scipy.optimize.fminbound``'s
    semantics; ``func`` maps a 0-d tensor of ``dtype`` to a 0-d tensor.
    Returns the minimizer as a 0-d tensor on ``device``."""
    dev = resolve(device)

    def t(v):  # a fill on the device: a host copy would sync
        return torch.full((), v, dtype=dtype, device=dev)

    golden = _golden_mean(dtype, dev)
    sqrt_eps = torch.sqrt(t(2.2e-16))
    a0, b0 = t(x1), t(x2)
    fulc0 = a0 + golden * (b0 - a0)
    fx0 = func(fulc0)
    zero = torch.zeros_like(fulc0)
    state = dict(a=a0, b=b0, fulc=fulc0, nfc=fulc0, xf=fulc0, ffulc=fx0,
                 fnfc=fx0, fx=fx0, rat=zero, e=zero,
                 num=torch.ones((), dtype=torch.int32, device=dev),
                 moved=torch.ones((), dtype=torch.bool, device=dev))
    fields = ("a", "b", "fulc", "nfc", "xf", "ffulc", "fnfc", "fx", "rat",
              "e")

    def cond(s):
        xm = 0.5 * (s["a"] + s["b"])
        tol1 = sqrt_eps * torch.abs(s["xf"]) + xtol / 3.0
        tol2 = 2.0 * tol1
        return ((torch.abs(s["xf"] - xm) > (tol2 - 0.5 * (s["b"] - s["a"])))
                & (s["num"] < maxfun) & s["moved"])

    def body(s):
        a, b = s["a"], s["b"]
        xf, fx = s["xf"], s["fx"]
        fulc, nfc = s["fulc"], s["nfc"]
        ffulc, fnfc = s["ffulc"], s["fnfc"]
        rat, e = s["rat"], s["e"]
        xm = 0.5 * (a + b)
        tol1 = sqrt_eps * torch.abs(xf) + xtol / 3.0
        tol2 = 2.0 * tol1

        # parabolic fit attempt
        r_ = (xf - nfc) * (fx - ffulc)
        q_ = (xf - fulc) * (fx - fnfc)
        p_ = (xf - fulc) * q_ - (xf - nfc) * r_
        q2 = 2.0 * (q_ - r_)
        p_ = torch.where(q2 > 0, -p_, p_)
        q2 = torch.abs(q2)
        ok_par = ((torch.abs(e) > tol1)
                  & (torch.abs(p_) < torch.abs(0.5 * q2 * e))
                  & (p_ > q2 * (a - xf)) & (p_ < q2 * (b - xf)))
        rat_par = torch.where(q2 != 0, p_ / q2, zero)
        x_par = xf + rat_par
        si_x = torch.sign(xm - xf) + (xm == xf)
        rat_par = torch.where(((x_par - a) < tol2) | ((b - x_par) < tol2),
                              tol1 * si_x, rat_par)

        # golden-section step
        e_gold = torch.where(xf >= xm, a - xf, b - xf)
        rat_gold = golden * e_gold

        e_new = torch.where(ok_par, rat, e_gold)
        rat_new = torch.where(ok_par, rat_par, rat_gold)

        si = torch.sign(rat_new) + (rat_new == 0)
        x = xf + si * torch.maximum(torch.abs(rat_new), tol1)
        fu = func(x)

        better = fu <= fx
        left = x >= xf
        a_n = torch.where(better, torch.where(left, xf, a),
                          torch.where(x < xf, x, a))
        b_n = torch.where(better, torch.where(left, b, xf),
                          torch.where(x < xf, b, x))

        # bookkeeping of the two next-best points
        cond2 = (fu <= fnfc) | (nfc == xf)
        cond3 = (fu <= ffulc) | (fulc == xf) | (fulc == nfc)
        fulc_w = torch.where(cond2, nfc, torch.where(cond3, x, fulc))
        ffulc_w = torch.where(cond2, fnfc, torch.where(cond3, fu, ffulc))
        nfc_w = torch.where(cond2, x, nfc)
        fnfc_w = torch.where(cond2, fu, fnfc)
        new = dict(
            a=a_n, b=b_n,
            fulc=torch.where(better, nfc, fulc_w),
            nfc=torch.where(better, xf, nfc_w),
            xf=torch.where(better, x, xf),
            ffulc=torch.where(better, fnfc, ffulc_w),
            fnfc=torch.where(better, fx, fnfc_w),
            fx=torch.where(better, fu, fx),
            rat=rat_new, e=e_new, num=s["num"] + 1)
        new["moved"] = (torch.stack([new[k] for k in fields])
                        != torch.stack([s[k] for k in fields])).any()
        return new

    s, _ = loop.run(body, state, lambda s: ~cond(s), BRENT_CHUNK,
                    name="brent", counter="num")
    return s["xf"]


def _solve(A, B):
    """``A^{-1} B`` with no host read of the factorization's status."""
    return torch.linalg.solve_ex(A, B)[0]


def _gcv_value(lam, R_A, R_L, bproj, out_norm2, t_term, modified):
    G = R_A.T @ R_A + lam * (R_L.T @ R_L)
    z = _solve(G, R_A.T @ bproj)
    num = torch.sum((R_A @ z - bproj) ** 2)
    if modified:
        num = num + out_norm2
    trace = torch.trace(R_A @ _solve(G, R_A.T))
    return num / (t_term - trace) ** 2


def _tensors(device, *arrays):
    dev = resolve(device)
    return [torch.as_tensor(a, device=dev) for a in arrays]


def gcv_lambda(R_A, R_L, bproj, out_norm2=0.0, t_term=None,
               variant="standard", device=DEFAULT):
    """Tikhonov-GCV on the device (the host rule's search domain and
    tolerances: lam in [1e-9, 1e2], xtol 1e-12, maxfun 1000)."""
    R_A, R_L, bproj = _tensors(device, R_A, R_L, bproj)
    bproj = bproj.reshape(-1)
    modified = variant == "modified"
    if t_term is None:
        t_term = float(R_A.shape[0])
    return fminbound(
        lambda lam: _gcv_value(lam, R_A, R_L, bproj, out_norm2, t_term,
                               modified),
        1e-9, 1e2, xtol=1e-12, maxfun=1000, dtype=R_A.dtype,
        device=R_A.device)


def _lcurve_curvature(lam, R_A, R_L, bproj, pin):
    """Plain (non-log) curvature of (||R_A x - b||^2, ||R_L x||^2), the
    reference's parametrization (l_curve.py:23-88,171-188). ``pin`` adds 1
    to the inactive diagonal (0 for unmasked use)."""
    C = R_A.T @ R_A
    D = R_L.T @ R_L
    lhs = C + lam * D + pin
    x = _solve(lhs, R_A.T @ bproj)
    dx = -_solve(lhs, D @ x)
    inv4 = _solve(lhs, D @ x)
    d2x = 2.0 * _solve(lhs, D @ dx - D @ inv4)

    def term(M, c):
        r = M @ x - c
        Mdx = M @ dx
        first = 2.0 * torch.dot(r, Mdx)
        second = 2.0 * (torch.dot(Mdx, Mdx) + torch.dot(r, M @ d2x))
        return first, second

    f1, f2 = term(R_A, bproj)
    g1, g2 = term(R_L, x.new_zeros(R_L.shape[0]))
    num = -g1 * f2 + f1 * g2
    den = (g1**2 + f1**2) ** 1.5
    return num / den


def lcurve_lambda(R_A, R_L, bproj, device=DEFAULT):
    """L-curve on the device: lam maximizing the analytic curvature,
    bounded Brent on [1e-9, 2] (the host rule's domain and tolerances)."""
    R_A, R_L, bproj = _tensors(device, R_A, R_L, bproj)
    bproj = bproj.reshape(-1)
    pin = bproj.new_zeros((R_A.shape[1], R_A.shape[1]))
    return fminbound(
        lambda lam: -_lcurve_curvature(lam, R_A, R_L, bproj, pin),
        1e-9, 2.0, xtol=1e-12, maxfun=1000, dtype=R_A.dtype,
        device=R_A.device)


def _dp_newton_filtered(sv2, bhat, thresh, testzero):
    """Newton on beta = 1/lam in filtered SVD coordinates (mirrors the host
    rule and reference discrepancy_principle.py:76-99). Returns 0 when the
    threshold is unattainable (testzero >= 0).

    float32-robust as in JAX: f' in the cancellation-free form
    -2 sum(sv2 (filt bhat)^2 filt), and a non-finite or non-positive step
    stalls at the last good beta. JAX picks the branch with ``lax.cond``;
    here both are taken and ``torch.where`` selects, the loop starting
    done where the threshold is unattainable (its value is not used)."""
    def cond(s):
        return ~s["done"] & (s["it"] < 100)

    def body(s):
        beta = s["beta"]
        filt = 1.0 / (sv2 * beta + 1.0)
        zbeta = filt * bhat
        f = torch.sum(zbeta**2) - thresh
        fp = -2.0 * torch.sum(sv2 * zbeta**2 * filt)
        beta_new = beta - f / fp
        ok = torch.isfinite(beta_new) & (beta_new > 0)
        beta_new = torch.where(ok, beta_new, beta)
        done = (torch.abs(beta_new - beta) < 1e-12 * beta) | ~ok
        return dict(beta=beta_new, done=done, it=s["it"] + 1)

    unattainable = testzero >= 0
    s, _ = loop.run(body, dict(
        beta=torch.full((), 1e-8, dtype=bhat.dtype, device=bhat.device),
        done=unattainable,
        it=torch.zeros((), dtype=torch.int32, device=bhat.device)),
        lambda s: ~cond(s), NEWTON_CHUNK, name="dp_newton", counter="it")
    return torch.where(unattainable, torch.zeros_like(s["beta"]),
                       1.0 / s["beta"])


def dp_lambda(B, bproj, delta, eta=1.01, device=DEFAULT):
    """The discrepancy principle on the device for the standard-form
    projected system (L = I)."""
    B, bproj = _tensors(device, B, bproj)
    thresh = (eta * delta) ** 2
    U, S, _ = svd(B)
    mA, nA = B.shape
    sv2 = torch.cat([S**2, S.new_zeros(max(mA - nA, 0))])
    bhat = U.T @ bproj.reshape(-1)
    tail2 = torch.sum(bhat[nA:] ** 2) if mA > nA else bhat.new_zeros(())
    return _dp_newton_filtered(sv2, bhat, thresh, tail2 - thresh)


# ---- discrete truncation-index selection (tsvd/tgsvd) --------------------
#
# Vectorized mirrors of the host discrete searches (regparam/gcv.py,
# regparam/dp.py; reference gcv.py:96-122, discrepancy_principle.py:
# 100-128): the reference's Python loops become reversed cumulative sums
# and argmin/argmax, so k is chosen on the device.


def _suffix_sums(bhat, n):
    """rev[i] = sum of |bhat_j|^2 for j in [n-1-i, n): the residual energy
    released by zeroing the smallest i+1 retained coefficients."""
    c = bhat[:n] ** 2
    return torch.cumsum(c.flip(0), 0), torch.sum(bhat[n:] ** 2)


def _first(mask, n):
    """Index of the first True of ``mask``, or ``n`` where there is none."""
    return torch.where(mask.any(), torch.argmax(mask.to(torch.uint8)), n)


def gcv_tsvd_k(bhat, n, device=DEFAULT):
    """GCV truncation index for TSVD: k minimizing (residual energy past k
    + out-of-range tail) / (m - k)^2 over k = n-1 .. 0 (host gcv.py;
    reference gcv.py:96-109). ``bhat = U^T b`` with U the full (m, m)
    left-singular basis."""
    (bhat,) = _tensors(device, bhat)
    bhat = bhat.reshape(-1)
    m = bhat.shape[0]
    rev, tail = _suffix_sums(bhat, n)
    i = torch.arange(n, device=bhat.device)
    vals = (rev + tail) / (m - (n - (i + 1))) ** 2
    return n - (torch.argmin(vals) + 1)


def gcv_tgsvd_k(bhat, n, p, device=DEFAULT):
    """GCV truncation index for TGSVD: progressive zeroing of |bhat|^2 from
    index n-1 downward, denominator (p - i - 1)^2 (reference gcv.py:110-122,
    including the inf at the zero denominator)."""
    (bhat,) = _tensors(device, bhat)
    bhat = bhat.reshape(-1)
    rev, _ = _suffix_sums(bhat, n)
    total = torch.sum(bhat[:n] ** 2)
    i = torch.arange(n, device=bhat.device)
    den = (p - i - 1.0) ** 2
    vals = torch.where(den != 0, (total - rev) / den,
                       torch.full_like(rev, float("inf")))
    return torch.argmin(vals)


def dp_tsvd_k(bhat, n, delta, eta=1.01, device=DEFAULT):
    """DP truncation index for TSVD: walk k = n-1 .. 0 while the truncated
    residual stays below (eta delta)^2, stop at the first violation
    (reference discrepancy_principle.py:100-114). Returns n when even the
    first step violates."""
    (bhat,) = _tensors(device, bhat)
    bhat = bhat.reshape(-1)
    thresh = (eta * delta) ** 2
    rev, tail = _suffix_sums(bhat, n)
    ok = rev + tail - thresh >= 0  # dp_val >= 0: the walk breaks here
    return n - _first(ok, n)


def dp_tgsvd_k(bhat, n, delta, eta=1.01, device=DEFAULT):
    """DP truncation index for TGSVD: progressive zeroing while the running
    energy stays >= (eta delta)^2; alpha = the last passing index
    (reference discrepancy_principle.py:115-128)."""
    (bhat,) = _tensors(device, bhat)
    bhat = bhat.reshape(-1)
    thresh = (eta * delta) ** 2
    rev, _ = _suffix_sums(bhat, n)
    total = torch.sum(bhat[:n] ** 2)
    lead = _first((total - rev) - thresh < 0, n)
    return torch.where(lead == 0, n, lead - 1)
