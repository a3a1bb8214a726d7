"""Checkpointed fused solvers: trips_tpu_torch against itself and against
trips_tpu on the CPU.

A chunked run repeats the uninterrupted run's operations in the same order
on the same bytes, so on the CPU (the kernels' plain versions, no atomics)
a run killed after a chunk and resumed from its checkpoint ends bitwise
equal to the uninterrupted one: GKS, MMGKS and ``cgls_normal``. The
checkpoint's ``.npz`` layout is the JAX package's: a state written by
``trips_tpu``'s ``fused_gks_checkpointed`` resumes in the port and ends at
JAX's uninterrupted iterates (float64, 1e-10 relative: the remaining
iterations run in another BLAS order; measured 1.0e-13), and a state
written by the port loads with ``trips_tpu``'s ``load_state`` and resumes
there to the port's uninterrupted iterates, to the same tolerance. These
two use the discrepancy principle: with GCV this run's lam sits on the
flat bottom of its curve at some iterations (1e-9), where two correct
runs part by 3.5e-10.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trips_tpu.solvers.checkpointed as jc
import trips_tpu.utils.checkpoint as jck
from trips_tpu.core import DenseOperator as JaxDense
from trips_tpu.operators import Blur1D
from trips_tpu.operators import FirstDerivative1D as JaxD1
from trips_tpu_torch.core import DenseOperator
from trips_tpu_torch.krylov import cgls_normal
from trips_tpu_torch.operators import FirstDerivative1D
from trips_tpu_torch.solvers.checkpointed import (cgls_normal_checkpointed,
                                                  fused_gks_checkpointed,
                                                  fused_mmgks_checkpointed)
from trips_tpu_torch.solvers.fused import fused_gks, fused_mmgks
from trips_tpu_torch.utils.checkpoint import (CheckpointCallback,
                                              load_state, save_state)

from torch_threads import one_torch_thread  # noqa: F401

CPU = {"device": "cpu"}
GKS_KW = dict(projection_dim=3, n_iter=12, regparam_mode="gcv", chunk=3)
DP_KW = dict(GKS_KW, regparam_mode="dp")


class _Killed(Exception):
    pass


@pytest.fixture(scope="module")
def blur():
    """tests/test_checkpoint_fused.py's problem (Blur1D, n = 80)."""
    n = 80
    rng = np.random.default_rng(7)
    op = Blur1D(n, 4.0)
    A = np.asarray(op.mat)
    h = np.pi / n
    g = -np.pi / 2 + np.arange(0.5, n, 1) * h
    x_true = 2 * np.exp(-6 * (g - 0.8) ** 2) + np.exp(-2 * (g + 0.5) ** 2)
    b_true = A @ x_true
    e = rng.standard_normal(n)
    b = b_true + 0.02 * np.linalg.norm(b_true) / np.linalg.norm(e) * e
    # both packages apply the same dense matrix (Blur1D's own apply is
    # another discretization)
    return dict(jA=JaxDense(jnp.asarray(A)), b=b,
                delta=float(np.linalg.norm(b - b_true)),
                tA=DenseOperator(torch.from_numpy(A.copy())),
                L=FirstDerivative1D(n, **CPU), jL=JaxD1(n))


def _killer(path, at):
    def cb(it, **state):
        save_state(path, state)
        if it >= at:
            raise _Killed
    return cb


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_gks_chunked_equals_monolithic(blur):
    mono = fused_gks(blur["tA"], blur["b"], blur["L"], projection_dim=3,
                     n_iter=9, regparam_mode="gcv", **CPU)
    chk = fused_gks_checkpointed(blur["tA"], blur["b"], blur["L"],
                                 projection_dim=3, n_iter=9,
                                 regparam_mode="gcv", chunk=4, **CPU)
    assert _same(chk, mono)


def test_gks_kill_resume_bitwise(blur, tmp_path):
    path = str(tmp_path / "gks.npz")
    args = (blur["tA"], blur["b"], blur["L"])
    ref = fused_gks_checkpointed(*args, **GKS_KW, **CPU)
    with pytest.raises(_Killed):
        fused_gks_checkpointed(*args, callback=_killer(path, 6), **GKS_KW,
                               **CPU)
    assert int(load_state(path)["ii"]) == 6
    res = fused_gks_checkpointed(*args, resume_state=path, **GKS_KW, **CPU)
    assert _same(res, ref)


@pytest.mark.parametrize("mode", ["gcv", "dp"])
def test_mmgks_kill_resume_bitwise(blur, tmp_path, mode):
    path = str(tmp_path / "mmgks.npz")
    args = (blur["tA"], blur["b"], blur["L"])
    kw = dict(pnorm=2.0, qnorm=1.0, projection_dim=3, n_iter=8,
              regparam_mode=mode, delta=0.05, chunk=3)
    mono = fused_mmgks(*args, pnorm=2.0, qnorm=1.0, projection_dim=3,
                       n_iter=8, regparam_mode=mode, delta=0.05, **CPU)
    full = fused_mmgks_checkpointed(*args, callback=CheckpointCallback(
        path, every=1), **kw, **CPU)
    assert _same(full, mono)
    # the final checkpoint resumes to the same iterate (no step left)
    assert _same(fused_mmgks_checkpointed(*args, resume_state=path, **kw,
                                          **CPU), full)
    with pytest.raises(_Killed):
        fused_mmgks_checkpointed(*args, callback=_killer(path, 3), **kw,
                                 **CPU)
    res = fused_mmgks_checkpointed(*args, resume_state=load_state(path),
                                   **kw, **CPU)
    assert _same(res, full)


def test_cgls_normal_kill_resume_bitwise(blur, tmp_path):
    path = str(tmp_path / "cgn.npz")
    op, b = blur["tA"], torch.from_numpy(blur["b"])
    x0 = torch.zeros(op.shape[1], dtype=b.dtype)
    x_mono, k_mono = cgls_normal(op, b, x0, 40, 0.0)
    x_ref, k_ref = cgls_normal_checkpointed(op, b, x0, 40, chunk=7, **CPU)
    assert torch.equal(x_ref, x_mono) and k_ref == k_mono == 40
    with pytest.raises(_Killed):
        cgls_normal_checkpointed(op, b, x0, 40, chunk=7,
                                 callback=_killer(path, 14), **CPU)
    state = load_state(path)
    assert int(state["k"]) == 14 and set(state) == {
        "x", "t", "p", "gamma", "norms_t0", "k", "done"}
    x_res, k_res = cgls_normal_checkpointed(op, b, x0, 40, chunk=7,
                                            resume_state=path, **CPU)
    assert torch.equal(x_res, x_ref) and k_res == k_ref


def test_jax_checkpoint_resumes_in_the_port(blur, tmp_path):
    path = str(tmp_path / "jax_gks.npz")
    jargs = (blur["jA"], jnp.asarray(blur["b"]), blur["jL"])
    kw = dict(DP_KW, delta=blur["delta"])
    x_j, lams_j, res_j = jc.fused_gks_checkpointed(*jargs, **kw)

    def cb(it, **state):
        jck.save_state(path, state)
        if it >= 6:
            raise _Killed

    with pytest.raises(_Killed):
        jc.fused_gks_checkpointed(*jargs, callback=cb, **kw)
    x_t, lams_t, res_t = fused_gks_checkpointed(
        blur["tA"], blur["b"], blur["L"], resume_state=path, **kw, **CPU)
    x_j = np.asarray(x_j)
    assert np.linalg.norm(x_t.numpy() - x_j) / np.linalg.norm(x_j) <= 1e-10
    # the first 6 entries come from JAX's file, bit for bit
    assert np.array_equal(lams_t.numpy()[:6], np.asarray(lams_j)[:6])
    np.testing.assert_allclose(res_t.numpy(), np.asarray(res_j), rtol=1e-6)


def test_port_checkpoint_resumes_in_jax(blur, tmp_path):
    path = str(tmp_path / "torch_gks.npz")
    args = (blur["tA"], blur["b"], blur["L"])
    kw = dict(DP_KW, delta=blur["delta"])
    x_t, _, _ = fused_gks_checkpointed(*args, **kw, **CPU)
    with pytest.raises(_Killed):
        fused_gks_checkpointed(*args, callback=_killer(path, 6), **kw,
                               **CPU)
    state = jck.load_state(path)
    assert set(state) == {"V", "AV", "LV", "x", "lams", "resids", "ii"}
    assert state["V"].shape == (80, 15) and state["V"].dtype == np.float64
    x_j, _, _ = jc.fused_gks_checkpointed(
        blur["jA"], jnp.asarray(blur["b"]), blur["jL"], resume_state=state,
        **kw)
    x_t = x_t.numpy()
    assert np.linalg.norm(np.asarray(x_j) - x_t) / np.linalg.norm(x_t) <= 1e-10


def test_save_load_lists_and_tensors(tmp_path):
    """The list layout (``__len__name``, ``name__i``) both ways."""
    path = str(tmp_path / "lists.npz")
    save_state(path, {"xs": [torch.arange(3.0), np.ones(2)], "k": 4,
                      "t": torch.eye(2)})
    for loader in (load_state, jck.load_state):
        st = loader(path)
        assert np.array_equal(st["xs"][0], np.arange(3.0))
        assert np.array_equal(st["xs"][1], np.ones(2))
        assert int(st["k"]) == 4 and np.array_equal(st["t"], np.eye(2))
    jck.save_state(path, {"ys": [np.zeros(2)], "a": np.ones(3)})
    st = load_state(path)
    assert np.array_equal(st["ys"][0], np.zeros(2))
    assert np.array_equal(st["a"], np.ones(3))
