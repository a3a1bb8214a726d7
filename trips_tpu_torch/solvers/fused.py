"""All-on-device GKS, MMGKS and hybrid solvers: no host read per step.

Counterpart of ``trips_tpu/solvers/fused.py``. The host-driven solvers
(``gks.py``/``mmgks.py``/``hybrid.py``) read the projected k x k system
back every iteration and choose lam in NumPy. These preallocate the basis
at its final width K = projection_dim + n_iter and run every iteration on
the device with *masked* linear algebra, as JAX's one-program versions do:

- columns >= k (the active width) of V/AV/LV and R are exactly zero;
- padded projected solves pin the inactive block by adding 1 to the
  inactive diagonal of G = R_A^T R_A + lam R_L^T R_L;
- the GCV trace term uses the active count, so lam matches the
  growing-size computation;
- panel factorizations are Householder QRs of the padded panel; Q's
  inactive columns are arbitrary completions (and cuSOLVER may complete
  them otherwise than LAPACK or XLA), so every projection is masked and
  the tests compare x and lam, never Q.

lam is chosen on the device by ``regparam.device``'s searches in filtered
SVD coordinates ('gcv' | 'dp' | 'l_curve', or a fixed 'scalar'), each a
loop with one host read per chunk of steps (on the card a captured CUDA
graph of one step, replayed, ``core/loop.py``). The iteration loop itself is a
Python loop over a fixed count and reads nothing back. The K x K and
m x K algebra stays with ``torch.linalg`` (``qr``, ``svd``, ``solve_ex``;
``svd`` with the driver of ``core.device.svd`` on the card); ``svd`` has
no form without a status check, so on the card it may sync
(``chip_smoke.py`` [8] counts the syncs of one iteration). The bases are
column-contiguous and filled in place: the carry's tensors are updated,
never copied.

Entry points take ``device`` (the card unless "cpu" is asked for); ``b``
is moved there and the operators must live there.
"""
from __future__ import annotations

import torch

from ..core.device import DEFAULT, check_operators, resolve, svd
from ..core.linop import BatchedBlockDiagOperator
from ..krylov import arnoldi, golub_kahan
from ..krylov.golub_kahan import _basis
from ..operators.derivatives import FirstDerivative2D
from ..operators.weights import (gs_weights, iso_tv_weights,
                                 smoothed_holder_weights)
from ..regparam.device import _dp_newton_filtered, _solve, fminbound
from ..utils import telemetry


def _inputs(device, A, b, L=None):
    """The operators (which must live on ``device``) and ``b`` moved
    there as a flat tensor."""
    dev = resolve(device)
    check_operators(dev, A, L)
    return A, torch.as_tensor(b, device=dev).reshape(-1), L


def _masked_qr(P, active_mask):
    """Householder QR of a padded panel whose inactive (trailing) columns
    are zero. R's inactive columns come out zero; Q's inactive columns are
    arbitrary completions, so every consumer of Q masks its projections by
    ``active_mask``."""
    Q, R = torch.linalg.qr(P, mode="reduced")
    return Q, R * active_mask[None, :]


def _masked_r(P, active_mask):
    """R alone of ``_masked_qr`` (the same ``geqrf``, without forming Q):
    the regularization panel's Q is never used."""
    return torch.linalg.qr(P, mode="r")[1] * active_mask[None, :]


def _pin(active_mask, like):
    return torch.diag((~active_mask).to(like.dtype))


def _masked_tikhonov_solve(R_A, R_L, bproj, lam, active_mask):
    G = R_A.T @ R_A + lam * (R_L.T @ R_L) + _pin(active_mask, R_A)
    return _solve(G, R_A.T @ bproj) * active_mask


def _standard_form(R_A, R_L, active):
    """Anew = R_A (R_L + pin)^{-1}, the inactive columns zero."""
    pin = _pin(active, R_A)
    return _solve((R_L + pin).T, R_A.T).T * active[None, :]


def _filtered_pencil(R_A, R_L, bproj, active):
    """Standard-form reduction of the masked pencil: sv^2 and the data
    coefficients of Anew = R_A (R_L + pin)^{-1}.

    The scalar rules (GCV / DP / L-curve) become elementwise sums over
    (sv2, bhat), evaluated inside Brent/Newton with no k x k solves: O(k)
    per lam, and float32-robust where the normal-equations solve squares
    the pencil's condition number. Works for square masked pencils
    (GKS/MMGKS) and rectangular (k+1, k) hybrid factors. ``rest2`` is the
    part of ||bproj||^2 outside the range of Anew (0 for a square one).

    A singular vector's sign may differ between LAPACK, cuSOLVER and XLA:
    it flips an entry of bhat but not bhat^2 or U bhat, the only uses.
    ``svd`` returns descending singular values, as the
    ``live`` masks assume.
    """
    Anew = _standard_form(R_A, R_L, active)
    U, S, _ = svd(Anew, full_matrices=False)
    bproj = bproj.reshape(-1)
    bhat = U.T @ bproj
    if Anew.shape[0] == Anew.shape[1]:
        # Deviation: a square pencil's U spans the whole space, so rest2
        # is 0. JAX computes it all the same; in float32 it is then the
        # SVD's rounding, ~1e-7 ||bproj||^2, which GCV divides by lam^2
        # and which pushes lam up by decades (tomo256x60's fused GKS: lam
        # 1.6e-7 in float64, 0.036 in JAX's float32, 0.5-0.7 from
        # cuSOLVER's Jacobi SVD, before ``core.device.svd``)
        return S**2, bhat, bhat.new_zeros(())
    # explicit residual, not ||b||^2 - ||bhat||^2: the difference form is
    # a cancellation of near-equal numbers and noise in float32
    rest2 = torch.sum((bproj - U @ bhat) ** 2)
    return S**2, bhat, rest2


def _gcv_lambda_masked(R_A, R_L, bproj, t_term, active_mask, out_norm2=0.0,
                       projected_only=False):
    """Masked GCV in filtered SVD coordinates; t_term = the active count
    (standard) or the full row count (the hybrid's modified variant,
    reference gcv.py:69-72). ``projected_only`` restricts the numerator to
    the live filtered directions (the reference's standard variant, which
    Hybrid GMRES uses)."""
    sv2, bhat, rest2 = _filtered_pencil(R_A, R_L, bproj, active_mask)
    bhat2 = bhat**2
    k_active = torch.sum(active_mask.to(sv2.dtype))
    # the first k_active singular values (descending) are the live ones
    live = torch.arange(sv2.shape[0], device=sv2.device) < k_active
    zero = sv2.new_zeros(())

    def gcv(lam):
        d = sv2 + lam
        if projected_only:
            num = lam**2 * torch.sum(torch.where(live, bhat2 / d**2, zero))
        else:
            num = lam**2 * torch.sum(bhat2 / d**2) + rest2 + out_norm2
        # t_term - trace = (t_term - k) + sum_live(lam / d): free of the
        # cancellation k - (k - eps), which is noise in float32
        den = (t_term - k_active) + torch.sum(torch.where(live, lam / d,
                                                          zero))
        return num / den**2

    return fminbound(gcv, 1e-9, 1e2, xtol=1e-12, maxfun=1000,
                     dtype=sv2.dtype, device=sv2.device)


def _dp_lambda_masked(R_A, R_L, bproj, out_norm2, delta, eta, active):
    """Masked DP for a square projected pencil (GKS/MMGKS): the standard
    form through a pinned solve, then Newton in filtered SVD coordinates.
    As the host rule (reference discrepancy_principle.py:33-99):
    testzero = out_norm2 - thresh decides attainability, and out_norm2
    does not enter f."""
    thresh = (eta * delta) ** 2
    U, S, _ = svd(_standard_form(R_A, R_L, active))
    bhat = U.T @ bproj.reshape(-1)
    return _dp_newton_filtered(S**2, bhat, thresh, out_norm2 - thresh)


def _dp_lambda_masked_rect(Bm, bh, delta, eta, k_active):
    """Masked DP for the hybrid (K+1, K) padded factor with ``k_active``
    live columns. The host rule's tail term (bh outside the active range,
    discrepancy_principle.py:66-75) is the energy of the coefficients past
    the k_active largest singular values."""
    thresh = (eta * delta) ** 2
    U, S, _ = svd(Bm)
    sv2 = torch.cat([S**2, S.new_zeros(1)])
    bhat = U.T @ bh.reshape(-1)
    live = torch.arange(Bm.shape[1] + 1, device=Bm.device) < k_active
    # the energy of the coefficients outside the live range, summed
    # directly: JAX forms ||bh||^2 less the live part, a cancellation
    # (the same in exact arithmetic, U being orthogonal)
    tail2 = torch.sum(torch.where(live, bhat.new_zeros(()), bhat**2))
    return _dp_newton_filtered(sv2, bhat, thresh, tail2 - thresh)


def _lcurve_lambda_masked(R_A, R_L, bproj, active):
    """Masked L-curve: lam maximizing the plain curvature of (f, g) =
    (||R_A x - b||^2, ||R_L x||^2), Brent on [1e-9, 2] (reference
    l_curve.py:171-203), the derivatives as filtered-SVD sums:

      f' = 2 lam sum(b^2 s2/d^3)       g' = -2 sum(b^2 s2/d^3)
      f'' = 2 sum(b^2 s2 (s2-2lam)/d^4) g'' = 6 sum(b^2 s2/d^4),  d = s2+lam
    """
    sv2, bhat, _ = _filtered_pencil(R_A, R_L, bproj, active)
    b2s2 = bhat**2 * sv2

    def neg_curv(lam):
        d = sv2 + lam
        t3 = torch.sum(b2s2 / d**3)
        t4 = torch.sum(b2s2 / d**4)
        f1 = 2.0 * lam * t3
        g1 = -2.0 * t3
        f2 = 2.0 * torch.sum(b2s2 * (sv2 - 2.0 * lam) / d**4)
        g2 = 6.0 * t4
        num = -g1 * f2 + f1 * g2
        den = (g1**2 + f1**2) ** 1.5
        return -num / den

    return fminbound(neg_curv, 1e-9, 2.0, xtol=1e-12, maxfun=1000,
                     dtype=sv2.dtype, device=sv2.device)


def _resolve_mode(regparam_mode, use_gcv):
    if use_gcv is not None:  # legacy flag of the JAX package's first API
        return "gcv" if use_gcv else "scalar"
    if regparam_mode not in ("gcv", "dp", "l_curve", "scalar"):
        raise ValueError(
            f"regparam_mode must be 'gcv' | 'dp' | 'l_curve' | 'scalar', "
            f"got {regparam_mode!r}")
    return regparam_mode


def _panels(A, b, L, projection_dim, n_iter):
    """Zero (V, AV, LV) at width K, column-contiguous, with their first
    ``projection_dim`` columns from Golub-Kahan."""
    m, n = A.shape
    K = projection_dim + n_iter
    _, _, V0 = golub_kahan(A, b, projection_dim)
    V, AV, LV = (_basis(r, K, b) for r in (n, m, L.shape[0]))
    V[:, :projection_dim] = V0
    AV[:, :projection_dim] = A.matmat(V0)
    LV[:, :projection_dim] = L.matmat(V0)
    return V, AV, LV


def _gks_init(A, b, L, projection_dim, n_iter):
    V, AV, LV = _panels(A, b, L, projection_dim, n_iter)
    return (V, AV, LV, b.new_zeros(A.shape[1]), b.new_zeros(n_iter),
            b.new_zeros(n_iter))


def _out_norm2(b, QA, bproj):
    """DP's data energy outside the projected subspace, ||b - QA bproj||^2
    (``bproj`` masked, so QA's arbitrary inactive columns drop out).

    Deviation: JAX forms ||b||^2 - ||bproj||^2. In float32 at full width
    that difference of two numbers ~1e6 times the threshold is rounding
    noise, and it alone decides whether DP is attainable: on tomo256x60
    JAX's float32 GKS turns DP on at iteration 22, its float64 run at 19.
    The explicit residual is the same in exact arithmetic and accurate to
    its own size."""
    return torch.sum((b - QA @ bproj) ** 2)


def _select(mode, R_A, R_L, bproj, k, active, regparam, delta, eta,
            out_norm2=None, bsolve=None):
    """lam of the GKS/MMGKS iteration at active width ``k`` (a tensor of
    R's dtype); ``out_norm2()`` is DP's out-of-subspace data energy."""
    if mode == "gcv":
        return _gcv_lambda_masked(R_A, R_L, bproj, float(k), active)
    if mode == "dp":
        return _dp_lambda_masked(R_A, R_L, bproj, out_norm2(), delta, eta,
                                 active)
    if mode == "l_curve":
        return _lcurve_lambda_masked(R_A, R_L,
                                     bproj if bsolve is None else bsolve,
                                     active)
    return torch.full((), regparam, dtype=R_A.dtype, device=R_A.device)


def _expand(carry, ii, k, A, L, x, lam, r, n_reorth):
    """Write iteration ``ii``'s outputs and the new basis column ``k`` (the
    reorthogonalized, normalized residual ``r``) into the carry."""
    V, AV, LV, _, lams, resids = carry
    for _ in range(n_reorth):
        r = r - V @ (V.T @ r)
    rnorm = torch.linalg.norm(r)
    vn = r / rnorm
    V[:, k] = vn
    AV[:, k] = A.matvec(vn)
    LV[:, k] = L.matvec(vn)
    lams[ii] = lam
    resids[ii] = rnorm
    return (V, AV, LV, x, lams, resids)


def _gks_body(A, b, L, mode, regparam, delta, eta, projection_dim, K):
    col_idx = torch.arange(K, device=b.device)

    def body(ii, carry):
        V, AV, LV = carry[:3]
        k = projection_dim + ii
        active = col_idx < k
        QA, R_A = _masked_qr(AV, active)
        R_L = _masked_r(LV, active)
        bproj = (QA.T @ b) * active
        lam = _select(mode, R_A, R_L, bproj, k, active, regparam, delta,
                      eta, out_norm2=lambda: _out_norm2(b, QA, bproj))
        y = _masked_tikhonov_solve(R_A, R_L, bproj, lam, active)
        x = V @ y
        r = A.rmatvec(AV @ y - b) + lam * L.rmatvec(LV @ y)
        return _expand(carry, ii, k, A, L, x, lam, r, 3)

    return body


def _run(body, carry, i0, i1):
    for ii in range(i0, i1):
        carry = body(ii, carry)
    return carry


@telemetry.request("solve.fused_gks")
def fused_gks(A, b, L, projection_dim=3, n_iter=20, regparam=1.0,
              use_gcv=None, regparam_mode="gcv", delta=0.0, eta=1.01,
              device=DEFAULT):
    """All-on-device GKS. Returns (x, lambda_history, residual_history).

    regparam_mode: 'gcv' | 'dp' | 'l_curve' | 'scalar', all on the
    device; 'dp' needs ``delta``; ``regparam`` is the fixed lam of
    'scalar'; ``use_gcv`` is the legacy flag (True -> 'gcv', False ->
    'scalar')."""
    A, b, L = _inputs(device, A, b, L)
    mode = _resolve_mode(regparam_mode, use_gcv)
    body = _gks_body(A, b, L, mode, regparam, delta, eta, projection_dim,
                     projection_dim + n_iter)
    carry = _run(body, _gks_init(A, b, L, projection_dim, n_iter), 0, n_iter)
    return carry[3], carry[4], carry[5]


def _fused_gks_chunk(A, b, L, carry, i0, chunk, projection_dim=3, n_iter=20,
                     regparam=1.0, use_gcv=None, regparam_mode="gcv",
                     delta=0.0, eta=1.01):
    mode = _resolve_mode(regparam_mode, use_gcv)
    body = _gks_body(A, b, L, mode, regparam, delta, eta, projection_dim,
                     projection_dim + n_iter)
    return _run(body, carry, i0, i0 + chunk)


def _check_weight_mode(weight_mode, prob_dims):
    if weight_mode not in ("holder", "isoTV", "GS"):
        raise ValueError(
            f"weight_mode must be 'holder' | 'isoTV' | 'GS', got "
            f"{weight_mode!r}")
    if weight_mode in ("isoTV", "GS") and prob_dims is None:
        raise TypeError(
            "For isotropic TV / group sparsity you must enter the "
            "dimensions of the dynamic problem, e.g. "
            "prob_dims=(nx, ny, nt).")


def fused_mmgks(A, b, L, pnorm=2.0, qnorm=1.0, epsilon=0.1,
                projection_dim=3, n_iter=20, regparam=1.0, use_gcv=None,
                regparam_mode="gcv", delta=0.0, eta=1.01,
                weight_mode="holder", prob_dims=None, device=DEFAULT):
    """All-on-device MMGKS. Returns (x, lambda_history, residual_history).

    regparam_mode: 'gcv' | 'dp' | 'l_curve' | 'scalar', all on the device.
    GCV and DP see the *weighted* projected data (QA^T (wf b)), the solve
    and the L-curve QA^T b, as the host rule (reference MMGKS.py:96-106).
    weight_mode: 'holder' (smoothed Holder, the reference's default) |
    'isoTV' | 'GS' (the reference's dynamic modes, MMGKS.py:61-91), the
    last two with ``prob_dims=(nx, ny, nt)``; in 'GS' the regularizer is
    kron(I_nt, D_2d), as the reference rebuilds it (MMGKS.py:44-50), and
    ``L`` is ignored."""
    A, b, L = _inputs(device, A, b, L)
    mode = _resolve_mode(regparam_mode, use_gcv)
    _check_weight_mode(weight_mode, prob_dims)
    L = _mmgks_regularizer(L, weight_mode, prob_dims, b.device)
    body = _mmgks_body(A, b, L, mode, pnorm, qnorm, epsilon, regparam, delta,
                       eta, weight_mode, prob_dims, projection_dim,
                       projection_dim + n_iter)
    carry = _run(body, _mmgks_init(A, b, L, projection_dim, n_iter), 0,
                 n_iter)
    return carry[3], carry[4], carry[5]


def _mmgks_regularizer(L, weight_mode, prob_dims, device):
    if weight_mode != "GS":
        return L
    nxd, nyd, ntd = prob_dims
    return BatchedBlockDiagOperator(FirstDerivative2D(nxd, nyd,
                                                      device=device), ntd)


def _mmgks_init(A, b, L, projection_dim, n_iter):
    V, AV, LV = _panels(A, b, L, projection_dim, n_iter)
    return (V, AV, LV, A.rmatvec(b), b.new_zeros(n_iter),
            b.new_zeros(n_iter))


def _mmgks_body(A, b, L, mode, pnorm, qnorm, epsilon, regparam, delta, eta,
                weight_mode, prob_dims, projection_dim, K):
    col_idx = torch.arange(K, device=b.device)
    if weight_mode in ("isoTV", "GS"):
        nxd, nyd, ntd = prob_dims

    def body(ii, carry):
        V, AV, LV, x = carry[:4]
        k = projection_dim + ii
        active = col_idx < k

        v = A.matvec(x) - b
        wf = smoothed_holder_weights(v, epsilon, pnorm)
        u = L.matvec(x)
        if weight_mode == "isoTV":
            wr = iso_tv_weights(x, u, nxd, nyd, ntd, epsilon, qnorm)
        elif weight_mode == "GS":
            wr = gs_weights(x, L.op.matmat, nxd, nyd, ntd, qnorm)
        else:
            wr = smoothed_holder_weights(u, epsilon, qnorm)

        wb = wf * b
        QA, R_A = _masked_qr(AV * wf[:, None], active)
        R_L = _masked_r(LV * wr[:, None], active)
        bproj = (QA.T @ wb) * active
        bsolve = (QA.T @ b) * active
        lam = _select(mode, R_A, R_L, bproj, k, active, regparam, delta, eta,
                      out_norm2=lambda: _out_norm2(wb, QA, bproj),
                      bsolve=bsolve)
        y = _masked_tikhonov_solve(R_A, R_L, bsolve, lam, active)
        x = V @ y
        r = A.rmatvec(wf * (AV @ y - b)) + lam * L.rmatvec(wr * (LV @ y))
        return _expand(carry, ii, k, A, L, x, lam, r, 2)

    return body


def _fused_mmgks_chunk(A, b, L, carry, i0, chunk, pnorm=2.0, qnorm=1.0,
                       epsilon=0.1, projection_dim=3, n_iter=20,
                       regparam=1.0, use_gcv=None, regparam_mode="gcv",
                       delta=0.0, eta=1.01, weight_mode="holder",
                       prob_dims=None):
    mode = _resolve_mode(regparam_mode, use_gcv)
    L = _mmgks_regularizer(L, weight_mode, prob_dims, b.device)
    body = _mmgks_body(A, b, L, mode, pnorm, qnorm, epsilon, regparam, delta,
                       eta, weight_mode, prob_dims, projection_dim,
                       projection_dim + n_iter)
    return _run(body, carry, i0, i0 + chunk)


def fused_hybrid_lsqr(A, b, n_iter=50, regparam=1.0, use_gcv=None,
                      reorth=False, regparam_mode="gcv", delta=0.0,
                      eta=1.01, device=DEFAULT):
    """All-on-device Hybrid LSQR: the Golub-Kahan factorization, then a
    sweep over k with masked projected (k+1, k) systems and lam chosen on
    the device: modified GCV (fullsize = m, reference
    Hybrid_LSQR.py:80-84), DP (Newton in filtered SVD coordinates,
    :85-93), L-curve (:94-98) or a fixed scalar. Returns (x,
    lambda_history)."""
    A, b, _ = _inputs(device, A, b)
    mode = _resolve_mode(regparam_mode, use_gcv)
    body, init, start = _hybrid_lsqr_parts(A, b, n_iter, mode, regparam,
                                           delta, eta, reorth)
    x, lams, _ = _run(body, init, start, n_iter)
    return x, lams


def _hybrid_sweep(Bfull, Qb, bhat, basis, mode, regparam, delta, eta,
                  t_term, gmres):
    """The body of the hybrids' sweep over k on a (K+1, K) factor
    ``Bfull`` (bidiagonal or Hessenberg) with basis ``basis (n, K)``;
    carry (x, lambda_history, projected_residual_history)."""
    K = Bfull.shape[1]
    dev, dtype = Bfull.device, Bfull.dtype
    row_idx = torch.arange(K + 1, device=dev)
    col_idx = torch.arange(K, device=dev)
    eye = torch.eye(K, dtype=dtype, device=dev)

    def body(ii, carry):
        x, lams, resids = carry
        k = ii + 1  # active columns
        col_active = col_idx < k
        row_active = row_idx < k + 1
        Bm = Bfull * col_active[None, :] * row_active[:, None]
        R_L = eye * col_active[None, :]
        # the selection and the solve use the computed projection in DP,
        # bhat = ||b|| e_1 otherwise (Qb is bhat then; host hybrid.py)
        bh = Qb * row_active
        if gmres and ii == 0:  # lam = 0 at the first iteration
            lam = Bfull.new_zeros(())
        elif mode == "gcv":
            lam = _gcv_lambda_masked(Bm, R_L, bh, t_term(col_active),
                                     col_active, projected_only=gmres)
        elif mode == "dp":
            lam = _dp_lambda_masked_rect(Bm, bh, delta, eta, k)
        elif mode == "l_curve":
            lam = _lcurve_lambda_masked(Bm, R_L, bh, col_active)
        else:
            lam = torch.full((), regparam, dtype=dtype, device=dev)
        y = _masked_tikhonov_solve(Bm, R_L, bh, lam, col_active)
        x = basis @ y
        lams[ii] = lam
        resids[ii] = torch.linalg.norm(Bfull @ y - bhat)
        return (x, lams, resids)

    return body


def _hybrid_lsqr_parts(A, b, n_iter, mode, regparam, delta, eta, reorth):
    """(body, init_carry, start_iter) of the fused Hybrid LSQR sweep; the
    carry is (x, lambda_history, projected_residual_history), so the info
    adapter (``fused_info``) runs the same body. The first solve is at
    iteration 1, as the reference's."""
    m, n = A.shape
    U, B, V = golub_kahan(A, b, n_iter, reorth=reorth)
    bhat = b.new_zeros(n_iter + 1)
    bhat[0] = torch.linalg.norm(b)
    # DP projects with the *computed* basis (which loses orthogonality
    # without reorth), as the reference passes Q=U to its DP
    # (Hybrid_LSQR.py:85-93)
    Qb = U.T @ b if mode == "dp" else bhat
    body = _hybrid_sweep(B, Qb, bhat, V, mode, regparam, delta, eta,
                         lambda col_active: float(m), gmres=False)
    init = (b.new_zeros(n), b.new_zeros(n_iter), b.new_zeros(n_iter))
    return body, init, 1


def fused_hybrid_gmres(A, b, n_iter=50, regparam=1.0, use_gcv=None,
                       reorth=False, regparam_mode="gcv", delta=0.0,
                       eta=1.01, device=DEFAULT):
    """All-on-device Hybrid GMRES: the Arnoldi factorization of a square
    A, then a sweep over k with masked projected (k+1, k) Hessenberg
    systems and lam chosen on the device (standard GCV, DP with the
    computed-basis projection, L-curve or a scalar; reference
    Hybrid_GMRES.py:23-87; lam = 0 at the first iteration). Returns (x,
    lambda_history)."""
    A, b, _ = _inputs(device, A, b)
    mode = _resolve_mode(regparam_mode, use_gcv)
    body, init, start = _hybrid_gmres_parts(A, b, n_iter, mode, regparam,
                                            delta, eta, reorth)
    x, lams, _ = _run(body, init, start, n_iter)
    return x, lams


def _hybrid_gmres_parts(A, b, n_iter, mode, regparam, delta, eta, reorth):
    """(body, init_carry, start_iter) of the fused Hybrid GMRES sweep;
    carry (x, lambda_history, projected_residual_history). JAX evaluates
    the rule at the first iteration and then sets lam = 0; here the rule
    is skipped there (the same lam)."""
    n = A.shape[1]
    Q, H = arnoldi(A, b, n_iter, reorth=reorth)
    bhat = b.new_zeros(n_iter + 1)
    bhat[0] = torch.linalg.norm(b)
    Qb = Q.T @ b if mode == "dp" else bhat
    body = _hybrid_sweep(H, Qb, bhat, Q[:, :n_iter], mode, regparam, delta,
                         eta, lambda col_active: torch.sum(
                             col_active.to(b.dtype)), gmres=True)
    init = (b.new_zeros(n), b.new_zeros(n_iter), b.new_zeros(n_iter))
    return body, init, 0
