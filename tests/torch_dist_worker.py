"""One rank of the sharded operators' multi-process check.

``tests/test_torch_sharded.py`` starts ``world`` processes of ``main`` with
``torch.multiprocessing`` (start method spawn). They join one process
group over gloo on 127.0.0.1 through ``trips_tpu_torch.parallel.
init_multihost``, build every sharded operator of ``trips_tpu_torch.
parallel`` from the inputs the test wrote (``inputs.npz``: scipy matrices
and vectors), run the legs of ``tests/test_parallel.py`` and
``tests/multihost_worker.py`` at this world size (2: the static classes on
a 2-rank axis; 4: the dynamic ones on (time 2, angles 2) and (time 2, rows
2)), and save every output, all whole vectors, to ``out<rank>.npz``. The
test holds rank 0's outputs against the JAX package's on a mesh of the same
shape, and all ranks' outputs to each other bit for bit.

Imports torch, numpy, scipy and trips_tpu_torch only (the ``mesh`` leg
checks that no JAX module was loaded). Not collected by pytest (the name
does not start with ``test_``).
"""
import datetime
import sys

import numpy as np
import torch
from scipy import sparse as sp

CPU = "cpu"


def load_inputs(path):
    """inputs.npz -> {name: array or scipy CSR matrix}; a matrix is stored
    as ``<name>.data``, ``.indices``, ``.indptr`` and ``.shape``, a list of
    matrices as ``<name>.<i>.*``."""
    z = dict(np.load(path))
    out = {k: v for k, v in z.items() if "." not in k}
    for k in z:
        if k.endswith(".shape"):
            name = k[:-len(".shape")]
            out[name] = sp.csr_matrix(
                (z[name + ".data"], z[name + ".indices"],
                 z[name + ".indptr"]), shape=tuple(z[k]))
    for k in sorted(k for k in out if k.count(".") == 1):
        base = k.split(".")[0]
        out.setdefault(base, []).append(out[k])
    return out


def save_inputs(path, **items):
    """The writer of ``load_inputs``' file: arrays, scipy matrices, and
    lists of scipy matrices (at most 10)."""
    flat = {}
    for k, v in items.items():
        mats = ({f"{k}.{i}": m for i, m in enumerate(v)}
                if isinstance(v, list) else {k: v} if sp.issparse(v)
                else None)
        if mats is None:
            flat[k] = np.asarray(v)
            continue
        for name, m in mats.items():
            m = sp.csr_matrix(m)
            flat.update({name + ".data": m.data, name + ".indices": m.indices,
                         name + ".indptr": m.indptr,
                         name + ".shape": np.array(m.shape)})
    np.savez(path, **flat)


def _t(a, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        dtype or torch.from_numpy(np.asarray(a)).dtype)


def _padded(v, n, dtype):
    out = np.zeros(n, v.dtype)
    out[:len(v)] = v
    return _t(out, dtype)


def _counts(op, x, y):
    """all_reduce calls of one matvec, rmatvec and normal_matvec."""
    from trips_tpu_torch.parallel import sharding

    got = []
    for name, v in (("matvec", x), ("rmatvec", y), ("normal_matvec", x)):
        before = sharding.collective_counts["all_reduce"]
        getattr(op, name)(v)
        got.append(sharding.collective_counts["all_reduce"] - before)
    return np.array(got)


def _tv_steps(op, b, L, lam=0.01, steps=3):
    """``tests/test_parallel.py``'s regularized dynamic step, 3 times."""
    x = torch.zeros(op.shape[1], dtype=b.dtype)
    for _ in range(steps):
        r = op.matvec(x) - b
        g = op.rmatvec(r) + lam * L.rmatvec(L.matvec(x))
        x = x - 0.01 * g
    return x, torch.linalg.norm(g)


def static_legs(d, out):
    """World 2: the row-sharded ELL and BSR operators on {'rows': 2}, the
    flat banded pack on {'rows': 2}, the bucketed packs on {'angles':
    2}."""
    from trips_tpu_torch.krylov import cgls, cgls_normal
    from trips_tpu_torch.operators import FirstDerivative1D
    from trips_tpu_torch.parallel import (ShardedBandedProjector,
                                          ShardedBsrOperator,
                                          ShardedBucketedBandedProjector,
                                          ShardedEllOperator, make_mesh)
    from trips_tpu_torch.solvers import GKS
    from trips_tpu_torch.sparse import (BandedProjector,
                                        BucketedBandedProjector, EllOperator)

    rows, angles = make_mesh({"rows": 2}), make_mesh({"angles": 2})
    sop = ShardedEllOperator.from_ell(
        EllOperator.from_scipy(d["ell_A"], device=CPU), rows, device=CPU)
    m, n = sop.shape
    out["ell_mv"] = sop.matvec(_padded(d["ell_x"], n, torch.float64))
    out["ell_rmv"] = sop.rmatvec(_padded(d["ell_y"], m, torch.float64))
    sop = ShardedEllOperator.from_ell(
        EllOperator.from_scipy(d["cg_A"], device=CPU), rows, device=CPU)
    out["ell_cgls"], _ = cgls(sop, _t(d["cg_b"]),
                              torch.zeros(sop.shape[1], dtype=torch.float64),
                              300, 1e-12)
    sop = ShardedEllOperator.from_ell(
        EllOperator.from_dense(d["gks_A"], device=CPU), rows, device=CPU)
    x, _ = GKS(sop, _t(d["gks_b"]), FirstDerivative1D(sop.shape[1],
                                                        device=CPU),
               projection_dim=3, n_iter=5, regparam="gcv")
    out["gks"] = x.reshape(-1)

    bop = ShardedBsrOperator.from_scipy(d["bsr_A"], rows, block_shape=(8, 16),
                                        device=CPU)
    m, n = bop.shape
    out["bsr_mv"] = bop.matvec(_padded(d["bsr_x"], n, torch.float32))
    out["bsr_rmv"] = bop.rmatvec(_padded(d["bsr_y"], m, torch.float32))
    bop = ShardedBsrOperator.from_scipy(d["cg_A"], rows, block_shape=(8, 16),
                                        device=CPU)
    out["bsr_cgls"], _ = cgls(
        bop, _padded(d["cg_b"], bop.shape[0], torch.float32),
        torch.zeros(bop.shape[1], dtype=torch.float32), 300, 1e-12)
    bop = ShardedBsrOperator.from_scipy(d["bf16_A"], rows, block_shape=(8, 16),
                                        block_dtype=torch.bfloat16,
                                        device=CPU)
    out["bf16_mv"] = bop.matvec(_padded(d["bf16_x"], bop.shape[1],
                                        torch.float32))

    A, nx, views = d["fan_A"], int(d["fan_nx"]), int(d["fan_views"])
    x, y = _t(d["fan_x"]), _t(d["fan_y"])
    b = _t(d["fan_b"])
    x0 = torch.zeros(nx * nx, dtype=torch.float32)
    packs = {
        "banded": ShardedBandedProjector.from_banded(
            BandedProjector.from_scipy_fan(A, nx, views, n_groups=8,
                                           device=CPU), rows, device=CPU),
        "bucketed": ShardedBucketedBandedProjector.from_bucketed(
            BucketedBandedProjector.from_scipy_fan(
                A, nx, views, n_groups=8, n_buckets=3, device=CPU), angles,
            device=CPU),
        "int8": ShardedBucketedBandedProjector.from_bucketed(
            BucketedBandedProjector.from_scipy_fan(
                A, nx, views, n_groups=8, n_buckets=2, dtype="int8",
                device=CPU), angles, device=CPU)}
    for name, op in packs.items():
        out[name + "_mv"] = op.matvec(x)
        out[name + "_rmv"] = op.rmatvec(y)
        out[name + "_nmv"] = op.normal_matvec(x)
        out[name + "_counts"] = _counts(op, x, y)
    out["banded_cgls"], _ = cgls(packs["banded"], b, x0, 5, 0.0)
    out["banded_cgn"], _ = cgls_normal(packs["banded"], b, x0, 20, 0.0)
    out["int8_cgn"], _ = cgls_normal(packs["int8"], b, x0, 5, 0.0)


def dynamic_legs(d, out):
    """World 4: the dynamic ELL and BSR operators on pod_mesh(time_shards=2)
    (time 2, rows 2), the dynamic banded packs on (time 2, angles 2)."""
    from trips_tpu_torch.krylov import cgls_normal
    from trips_tpu_torch.operators import SpaceTimeDerivative
    from trips_tpu_torch.parallel import (
        ShardedBucketedDynamicBandedOperator, ShardedDynamicBandedOperator,
        ShardedDynamicBsrOperator, ShardedDynamicOperator, make_mesh,
        pod_mesh)
    from trips_tpu_torch.sparse import (BucketedDynamicBandedOperator,
                                        DynamicBandedOperator)

    from trips_tpu_torch.parallel import ShardedBucketedBandedProjector
    from trips_tpu_torch.sparse import BucketedBandedProjector

    # buckets of 3 angles over 4 ranks: rank 3 holds none
    A, nx, views = d["fan_A"], int(d["fan_nx"]), int(d["fan_views"])
    op = ShardedBucketedBandedProjector.from_bucketed(
        BucketedBandedProjector.from_scipy_fan(
            A, nx, views, n_groups=8, n_buckets=2, dtype="int8", device=CPU),
        make_mesh({"angles": 4}), device=CPU)
    x, y = _t(d["fan_x"]), _t(d["fan_y"])
    out["int8_4_mv"], out["int8_4_rmv"] = op.matvec(x), op.rmatvec(y)
    out["int8_4_nmv"], out["int8_4_counts"] = op.normal_matvec(x), \
        _counts(op, x, y)

    mesh = pod_mesh(time_shards=2)
    out["pod_shape"] = np.array([mesh.shape["time"], mesh.shape["rows"]])
    out["no_jax"] = np.array("jax" not in sys.modules)
    AA, nx, nt = d["dyn_AA"], int(d["dyn_nx"]), int(d["dyn_nt"])
    angles = list(d["dyn_angles"])
    L = SpaceTimeDerivative(nx, nx, nt, device=CPU)
    eop = ShardedDynamicOperator.from_blocks(AA, mesh, device=CPU)
    x64, y64 = _t(d["dyn_x"]), _t(d["dyn_y"])
    out["dyn_ell_mv"], out["dyn_ell_rmv"] = eop.matvec(x64), eop.rmatvec(y64)
    out["dyn_ell_tv"], out["dyn_ell_tv_gn"] = _tv_steps(eop, _t(d["dyn_b"]),
                                                        L)
    bop = ShardedDynamicBsrOperator.from_blocks(AA, mesh, block_shape=(8, 32),
                                                device=CPU)
    x32, y32 = x64.float(), y64.float()
    out["dyn_bsr_mv"], out["dyn_bsr_rmv"] = bop.matvec(x32), bop.rmatvec(y32)
    out["dyn_bsr_tv"], out["dyn_bsr_tv_gn"] = _tv_steps(
        bop, _t(d["dyn_b"], torch.float32), L)

    ta = make_mesh({"time": 2, "angles": 2})
    packs = {
        "dyn_banded": ShardedDynamicBandedOperator.from_dynamic(
            DynamicBandedOperator.from_frames(AA, nx, angles, n_groups=8,
                                              device=CPU), ta, device=CPU),
        "dyn_bucketed": ShardedBucketedDynamicBandedOperator.from_dynamic(
            BucketedDynamicBandedOperator.from_frames(
                AA, nx, angles, n_groups=8, n_buckets=2, device=CPU), ta,
            device=CPU),
        "dyn_int8": ShardedBucketedDynamicBandedOperator.from_dynamic(
            BucketedDynamicBandedOperator.from_frames(
                AA, nx, angles, n_groups=8, n_buckets=2, dtype="int8",
                device=CPU), ta, device=CPU)}
    b32 = _t(d["dyn_b"], torch.float32)
    for name, op in packs.items():
        out[name + "_mv"] = op.matvec(x32)
        out[name + "_rmv"] = op.rmatvec(y32)
        out[name + "_nmv"] = op.normal_matvec(x32)
        out[name + "_counts"] = _counts(op, x32, y32)
        out[name + "_cgn"], _ = cgls_normal(
            op, b32, torch.zeros(op.shape[1], dtype=torch.float32), 20, 0.0)


def main(rank, world, port, inputs, out_dir):
    """Rank ``rank`` of ``world``: join the group at 127.0.0.1:``port``
    (every wait bounded by 60 s), run this world's legs on ``inputs``,
    save ``out<rank>.npz`` in ``out_dir``."""
    import torch.distributed as dist

    from trips_tpu_torch.parallel import init_multihost

    torch.set_num_threads(1)
    init_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo",
                   timeout=datetime.timedelta(seconds=60))
    try:
        out = {}
        (static_legs if world == 2 else dynamic_legs)(load_inputs(inputs),
                                                      out)
        np.savez(f"{out_dir}/out{rank}.npz",
                 **{k: v.numpy() if torch.is_tensor(v) else v
                    for k, v in out.items()})
    finally:
        dist.destroy_process_group()
