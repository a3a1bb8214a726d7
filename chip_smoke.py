#!/usr/bin/env python3
"""Drive the PyTorch port's tomography CGLS paths once on one CUDA card.

Run from the repository root: ``python3 chip_smoke.py``. It needs one
card; without one it exits non-zero before printing any result.

Two paths on the same tomo256x60 problem: the bucketed banded operator
(kernels K1-K3, ``csrc/banded.cu``, each one launch over all buckets of
an apply) and the shear-rotate fan projector
``ShearFanProjector`` (K4-K6, ``csrc/shear.cu``). Phases, each failing the
run by raising:

0. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
1. build K1-K6 with nvcc, one process per source;
2. each kernel against its plain PyTorch version at the main paths' shapes
   (256x256 image, 60 fan-beam views; banded: 32 line groups, 4 buckets
   per drive orientation, float32, bfloat16 and int8 packs, K1-K3 per
   bucket and over all buckets in one launch, as the operator calls them,
   K2 the same to the bit from run to run; shear:
   C = 400, p_pad = 384, float32 and bfloat16 ``G``); the float32 banded
   operator against the host CSR matrix; the float32 shear operator against
   itself on the CPU; adjointness;
3. the main paths: ``Tomography`` -> operator -> ``solvers.CGLS`` and
   ``krylov.cgls_normal``, held against the JAX package's results on the
   same inputs, with launch counts showing the kernels ran, and the
   launches of one ``matvec`` and one ``rmatvec``;
4. times of each kernel against its plain version, the least time the
   card could take for the same work (``bound_ms``) and the library's
   call for the same function (device time from ``torch.profiler``): for
   K1-K3 one apply of the pack's matrix as a float32 CSR tensor
   (cuSPARSE), for K6 the product pair; applies and solvers (CUDA events
   and synchronized host clocks);
5. loop profiles of the solver paths that run K1-K3 and K6: device busy
   time per iteration by kernel (``torch.profiler``) against the wall time
   per iteration of the same solver in 4 (timed before any profiler
   session, which leaves the host slower), and the device's idle share.

The line before the last holds ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""
import contextlib
import copy
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

NX, VIEWS, NOISE, TOL = 256, 60, 0.001, 1e-6
CGLS_ITERS, CGN_ITERS, TIMED_ITERS = 30, 100, 50

# trips_tpu.solvers.CGLS(OP, b, 0, 30, 1e-6, x_true)["relError"] with OP =
# trips_tpu BucketedBandedProjector.from_scipy_fan(A, 256, None,
# angles=theta, n_groups=32) (float32 stacks), float32 arrays (x64 off),
# JAX 0.9.0 on the CPU, A from the NumPy builder (TRIPS_TPU_NO_NATIVE=1),
# and the inputs built below: grains phantom (phantom_seed 0), data from the
# 1e-8-rad shifted matrix, Gaussian noise 0.001 after np.random.seed(0).
JAX_CGLS_RELERR = [
    0.48551655194732685, 0.33065974185714087, 0.24397337911042638,
    0.1847096459060428, 0.1536139330770769, 0.1402493913389237,
    0.13236864934911902, 0.1282660935183623, 0.12486880546578528,
    0.12142531403251043, 0.11889801961549697, 0.11710769631895016,
    0.11582412133668037, 0.1149319803593167, 0.11438946235863344,
    0.11404782932812901, 0.11326853581546785, 0.11257041235047137,
    0.11192192374855299, 0.11142798888083681, 0.11112211663967772,
    0.11080069246376953, 0.11070715193575424, 0.11030684243349001,
    0.11003756538138831, 0.10988163286146824, 0.10966758195156111,
    0.1094550794418401, 0.10926396862732697, 0.1091527695021869]
# ||b_noisy|| of those inputs (float64, host), to prove they are the same
B_NOISY_NORM = 15780.119089302763
# Gates. Kernels and operator: float32 sums in another order, 1e-5 of the
# norm. CGLS: the final and the minimum relError within 1e-3 of the JAX
# run; each entry of the history within 6e-3, twice the measured distance
# of a float32 history from the float64 one on these inputs (3.0e-3 for
# both packages on the CPU, at iteration 9): float32 CG amplifies the
# order of sums, so two correct float32 runs differ by up to that much.
KERNEL_RTOL, FINAL_ATOL, HISTORY_ATOL, INT8_ATOL = 1e-5, 1e-3, 6e-3, 1e-2
REPLACES = {
    "banded_ata": "trips_tpu/sparse/pallas_banded_kernel.py:442",
    "banded_fwd": "trips_tpu/sparse/pallas_banded_kernel.py:335",
    "banded_adj": "trips_tpu/sparse/pallas_banded_kernel.py:381",
}
# trips_tpu.solvers.CGLS(OP, b, 0, 30, 1e-6, x_true)["relError"] with OP =
# trips_tpu ShearFanProjector(256, angles=theta, dtype=float32,
# g_dtype=float32), float32 arrays (x64 off), JAX 0.9.0 on the CPU, on the
# inputs built below.
JAX_SHEAR_CGLS_RELERR = [
    0.48521716148774746, 0.33009284606012207, 0.2429027055171598,
    0.18252426220961998, 0.15027965176173808, 0.13601658638205308,
    0.1273915563936571, 0.1202507676370931, 0.11653883386194708,
    0.11503549654735709, 0.11224735515975216, 0.11047922561159598,
    0.1094143755780544, 0.10890559859992716, 0.1086525609950555,
    0.10865505874588006, 0.10868940275278659, 0.1090195956539196,
    0.10965119459384434, 0.11032715324769678, 0.11091719683988745,
    0.11199681617740993, 0.11335843083944963, 0.11414182166237039,
    0.11521927746566787, 0.11560543343990226, 0.11674823909203809,
    0.11816105975455418, 0.11958825269730335, 0.12125040410564515]
# Shear gates. bfloat16 outputs (K4's canvases, K6's U before the second
# product): an entry whose float32 value falls near a bf16 rounding
# boundary may round the other way, one bf16 step (2^-8 relative), so
# those are held to 1e-3 of the norm, not 1e-5. CGLS history: each entry
# within 1.1e-2, twice the largest distance of the JAX float32 history
# from the float64 one on these inputs (5.4e-3 at iteration 29, both on
# the CPU): past the minimum at iteration 15 float32 rounding moves the
# semiconvergence tail more than on the banded path.
BF16_RTOL, SHEAR_HISTORY_ATOL, SOLVE_GAP = 1e-3, 1.1e-2, 1e-2
SHEAR_REPLACES = {
    "shear_rotate": "trips_tpu/operators/pallas_shear.py:98",
    "shear_rotate_adjoint": "trips_tpu/operators/pallas_shear.py:121",
    "gcontract_ata": "trips_tpu/operators/pallas_shear.py:181",
}


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def cuda_ms(fn, reps, flush=None):
    """Mean milliseconds of ``fn()`` over ``reps`` runs after one warm-up,
    each run between its own pair of CUDA events; ``flush()``, if given,
    runs before each run and outside the timed range."""
    import torch

    fn()
    events = []
    for _ in range(reps):
        if flush is not None:
            flush()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.mean([s.elapsed_time(e) for s, e in events]))


# The card's published peaks (NVIDIA H100 SXM data sheet, 700 W), for the
# bounds: HBM bytes/s; float32 outside the tensor cores, bf16 and TF32 on
# them (dense).
HBM_BPS, F32_FLOPS, BF16_FLOPS, TF32_FLOPS = 3.35e12, 67e12, 989e12, 495e12
LOOP_ITERS = 20  # profiled iterations per solver loop (phase 5)


def bound(nbytes, flops, peak):
    """(bound_ms, bound_by): the larger of bytes over HBM_BPS and flops over
    the peak rate for their type."""
    tb, tf = nbytes / HBM_BPS * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def device_ms(fn, reps, parts=None, sessions=3):
    """Device milliseconds per call of the kernels ``fn()`` launches, from
    ``torch.profiler`` over ``reps`` calls after one warm-up (host gaps
    between launches do not count): the median of ``sessions`` profiled
    sessions (a single session read up to 25% high now and then on an
    H100); ``parts``, if given, receives that session's milliseconds by
    kernel name."""
    import torch

    fn()
    torch.cuda.synchronize()
    act = [torch.profiler.ProfilerActivity.CUDA]
    runs = []
    for _ in range(sessions):
        # a session now and then records no kernel at all (seen once on an
        # H100 among dozens of runs): profile again, at most three times
        for _ in range(3):
            with torch.profiler.profile(activities=act) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages()
                      if e.self_device_time_total]
            us = sum(e.self_device_time_total for e in events)
            if us > 0:
                break
        check(us > 0, "the profiler saw no device time")
        runs.append((us, [(e.key, e.self_device_time_total)
                          for e in events]))
    us, events = sorted(runs, key=lambda r: r[0])[len(runs) // 2]
    if parts is not None:
        for key, t in events:
            # "void (anonymous namespace)::ata_kernel<float>(...)" -> name
            name = key.replace("(anonymous namespace)::", "")
            name = re.split(r"[(<]", name.removeprefix("void "))[0]
            name = name.split("::")[-1]
            parts[name] = parts.get(name, 0.0) + t / reps / 1e3
    return us / reps / 1e3


def loop_profile(solver, op, b, x0):
    """(device busy ms per iteration, {kernel: ms per iteration}) of
    ``solver(op, b, x0, LOOP_ITERS, 0.0)``, its set-up included: the device
    time of every kernel in one profiled run after a warm-up run."""
    by_kernel = {}
    busy = device_ms(lambda: solver(op, b, x0, LOOP_ITERS, 0.0), 1,
                     by_kernel) / LOOP_ITERS
    return busy, {n: v / LOOP_ITERS for n, v in by_kernel.items()}


def bucket_args(op, stack, isc, X):
    W, S, P, sc = op._parts(stack)
    return (X.T.contiguous() if isc else X), W, S, P, op.n_groups, sc


def shear_calls(op, gen, sk):
    """(kernel name, args, kwargs) of K4, K5 and K6 at ``op``'s shapes on
    random inputs (the G dtype where the path has it)."""
    import torch

    C, na, dev = op._C, op.n_angles, op.device
    sh = op._shifts()

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    return [("shear_rotate", (randn(3, C, C), *sh),
             {"out_dtype": op.g_dtype}),
            ("shear_rotate_adjoint", (randn(na, C, C).to(op.g_dtype), *sh),
             {}),
            ("gcontract_ata", (randn(na, C, C).to(op.g_dtype), op.G), {})]


def all_buckets(op, X):
    """``banded_ata_buckets`` arguments for ``op``'s pack: K1 over every
    bucket in one launch, as ``normal_matvec`` calls it."""
    return X, X.T.contiguous(), op._bks, op.n_groups


def fwd_buckets(op, X):
    """``banded_fwd_buckets`` arguments: K2 over every bucket in one
    launch, as ``matvec`` calls it."""
    return X, X.T.contiguous(), op._bks, op._aidx, op.det_count, op.n_groups


def adj_buckets(op, Y):
    """``banded_adj_buckets`` arguments: K3 on the ``(n_angles, p)``
    sinogram ``Y`` over every bucket in one launch, as ``rmatvec`` calls
    it."""
    return Y, op._bks, op._aidx, op.n_groups


def library_csr(M, dev):
    """The float32 scipy CSR matrix ``M`` as a torch CSR tensor on ``dev``,
    with int32 indices where torch's product takes them (else int64), and
    the index type taken."""
    import torch

    for idx in (torch.int32, torch.int64):
        t = torch.sparse_csr_tensor(
            torch.from_numpy(M.indptr).to(idx), torch.from_numpy(M.indices)
            .to(idx), torch.from_numpy(M.data.astype(np.float32)),
            size=M.shape, device=dev, check_invariants=True)
        try:
            t @ torch.zeros(M.shape[1], device=dev)
        except RuntimeError:
            continue
        return t, str(idx).removeprefix("torch.")
    raise RuntimeError("torch takes no CSR matrix-vector product here")


@contextlib.contextmanager
def shear_ata(on):
    """``TRIPS_TPU_SHEAR_ATA`` set to ``on`` inside the block."""
    old = os.environ.get("TRIPS_TPU_SHEAR_ATA")
    os.environ["TRIPS_TPU_SHEAR_ATA"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("TRIPS_TPU_SHEAR_ATA")
        else:
            os.environ["TRIPS_TPU_SHEAR_ATA"] = old


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from trips_tpu_torch import _build
    from trips_tpu_torch.krylov import cgls, cgls_normal
    from trips_tpu_torch.krylov.cgls import _cgn_chunk, _cgn_init
    from trips_tpu_torch.operators import ShearFanProjector
    from trips_tpu_torch.operators import shear_kernels as sk
    from trips_tpu_torch.problems import Tomography, device_sparse_operator
    from trips_tpu_torch.solvers import CGLS
    from trips_tpu_torch.sparse import banded_kernels as bk

    dev = torch.device("cuda")
    card = smi("name,power.limit")
    print(card)  # nvidia-smi's own line: name, power limit
    print(f"[0] torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}")

    # ---- 1. build ------------------------------------------------------
    _build.load()
    info = _build.build_info
    print(f"[1] kernels {'built' if info['built'] else 'loaded'} in "
          f"{info['seconds']:.2f} s: {info['path']}")
    for line in info["log"].splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")):
            print(f"[1]   {line.strip()}")

    # ---- 2. kernels vs plain at the main path's shapes ----------------
    t0 = time.perf_counter()
    tomo = Tomography(CommitCrime=False, device=dev)
    x_true, nx, ny = tomo.gen_true("grains", nx=NX, ny=NX, phantom_seed=0)
    OP, b, _, _, A = tomo.gen_data(x_true, nx, ny, VIEWS)
    np.random.seed(0)
    b_noisy, _ = tomo.add_noise(b, "Gaussian", NOISE)
    check(abs(np.linalg.norm(b_noisy) - B_NOISY_NORM) <= 1e-9 * B_NOISY_NORM,
          f"inputs differ from the reference's: ||b|| "
          f"{np.linalg.norm(b_noisy)!r}")
    ops = {"float32": OP}
    for kind, dt in (("bfloat16", torch.bfloat16), ("int8", "int8")):
        ops[kind] = device_sparse_operator(A, dtype=dt, nx=nx,
                                           angles=tomo.theta, device=dev)
    print(f"[2] A {A.shape} nnz {A.nnz}; problem and 3 packs in "
          f"{time.perf_counter() - t0:.2f} s")
    for kind, op in ops.items():
        print(f"[2]   {kind}: {len(op.stacks)} buckets, W "
              f"{[tuple(st[0].shape) for st in op.stacks]}, "
              f"{op.stored_bytes} bytes")

    gen = torch.Generator(device=dev).manual_seed(0)
    max_abs = {k: 0.0 for k in REPLACES}
    for kind, op in ops.items():
        worst = {k: 0.0 for k in REPLACES}
        for stack, isc in zip(op.stacks, op.is_cols):
            X = torch.randn(op.n_pad, op.n_pad, device=dev, generator=gen)
            Y = torch.randn(stack[0].shape[0], stack[0].shape[3], device=dev,
                            generator=gen)
            args = bucket_args(op, stack, isc, X)
            for name, inp in (("banded_fwd", None), ("banded_adj", Y),
                              ("banded_ata", None)):
                a = args if inp is None else (inp,) + args[1:]
                got = getattr(bk, name)(*a)
                ref = getattr(bk, name + "_ref")(*a)
                torch.cuda.synchronize()
                check(got.shape == ref.shape, f"{name} {kind} shape")
                e = rel(got, ref)
                worst[name] = max(worst[name], e)
                max_abs[name] = max(max_abs[name],
                                    float((got - ref).abs().max()))
                check(e <= KERNEL_RTOL, f"{name} {kind} rel err {e!r}")
        X = torch.randn(op.n_pad, op.n_pad, device=dev, generator=gen)
        args = all_buckets(op, X)
        got = bk.banded_ata_buckets(*args)
        ref = bk.banded_ata_buckets_ref(*args)
        torch.cuda.synchronize()
        e = rel(got, ref)
        max_abs["banded_ata"] = max(max_abs["banded_ata"],
                                    float((got - ref).abs().max()))
        check(e <= KERNEL_RTOL, f"banded_ata_buckets {kind} rel err {e!r}")
        # K2 and K3 over all buckets, on the (n_angles, p) sinogram
        p = op.det_count
        Ys = torch.randn(op.shape[0] // p, p, device=dev, generator=gen)
        e_all, outs = {}, {}
        for name, args in (("banded_fwd", fwd_buckets(op, X)),
                           ("banded_adj", adj_buckets(op, Ys))):
            got = getattr(bk, name + "_buckets")(*args)
            ref = getattr(bk, name + "_buckets_ref")(*args)
            torch.cuda.synchronize()
            check(got.shape == ref.shape, f"{name}_buckets {kind} shape")
            e_all[name], outs[name] = rel(got, ref), got
            max_abs[name] = max(max_abs[name],
                                float((got - ref).abs().max()))
            check(e_all[name] <= KERNEL_RTOL,
                  f"{name}_buckets {kind} rel err {e_all[name]!r}")
        again = bk.banded_fwd_buckets(*fwd_buckets(op, X))
        check(torch.equal(again, outs["banded_fwd"]),
              f"banded_fwd_buckets {kind} differs from run to run")
        print(f"[2] {kind} kernels vs plain, worst bucket rel err: "
              + ", ".join(f"{k} {v!r}" for k, v in worst.items())
              + f"; over all {len(op.stacks)} buckets in one launch each: "
              f"banded_ata {e!r}, "
              + ", ".join(f"{k} {v!r}" for k, v in e_all.items())
              + "; banded_fwd bitwise the same in a second run")

    A64 = A.astype(np.float32).astype(np.float64)
    rng = np.random.default_rng(1)
    xh = rng.standard_normal(A.shape[1])
    yh = rng.standard_normal(A.shape[0])
    x = torch.tensor(xh, dtype=torch.float32, device=dev)
    y = torch.tensor(yh, dtype=torch.float32, device=dev)
    f32 = ops["float32"]
    for name, got, ref in (
            ("matvec", f32.matvec(x), A64 @ x.double().cpu().numpy()),
            ("rmatvec", f32.rmatvec(y), A64.T @ y.double().cpu().numpy()),
            ("normal_matvec", f32.normal_matvec(x),
             A64.T @ (A64 @ x.double().cpu().numpy()))):
        e = rel(got.cpu(), torch.from_numpy(ref))
        print(f"[2] float32 {name} vs host CSR (float64): rel err {e!r}")
        check(e <= KERNEL_RTOL, f"{name} vs CSR {e!r}")
    for kind, op in ops.items():
        Ax, Aty = op.matvec(x), op.rmatvec(y)
        gap = abs(float(Ax.double() @ y.double())
                  - float(x.double() @ Aty.double()))
        a = gap / float(Ax.double().norm() * y.double().norm())
        print(f"[2] {kind} adjointness |<Ax,y>-<x,A'y>|/(|Ax||y|) = {a!r}")
        check(a <= KERNEL_RTOL, f"{kind} adjointness {a!r}")

    shear_ops = {kind: ShearFanProjector(nx, angles=tomo.theta, g_dtype=dt,
                                         device=dev)
                 for kind, dt in (("float32", torch.float32),
                                  ("bfloat16", torch.bfloat16))}
    shear_abs = {kind: {k: 0.0 for k in SHEAR_REPLACES}
                 for kind in shear_ops}
    for kind, op in shear_ops.items():
        print(f"[2] shear {kind}: C {op._C}, G {tuple(op.G.shape)} "
              f"{op.G.numel() * op.G.element_size()} bytes, views per "
              f"quarter {[op._kq.count(q) for q in range(3)]}")
        calls = shear_calls(op, gen, sk)
        errs = []
        for name, args, kw in calls:
            got = getattr(sk, name)(*args, **kw)
            ref = getattr(sk, name + "_ref")(*args, **kw)
            torch.cuda.synchronize()
            check(got.shape == ref.shape and got.dtype == ref.dtype,
                  f"{name} {kind} shape/dtype")
            e = rel(got.float(), ref.float())
            diff = float((got.float() - ref.float()).abs().max())
            shear_abs[kind][name] = max(shear_abs[kind][name], diff)
            gate = (BF16_RTOL if kind == "bfloat16"
                    and name != "shear_rotate_adjoint" else KERNEL_RTOL)
            errs.append(f"{name} {e!r} (gate {gate})")
            check(e <= gate, f"{name} {kind} rel err {e!r}")
        print(f"[2] shear {kind} kernels vs plain: " + ", ".join(errs))
    s32, s32_cpu = shear_ops["float32"], shear_ops["float32"].to("cpu")
    for name, v in (("matvec", x), ("rmatvec", y), ("normal_matvec", x),
                    ("normal_matvec K6", x)):
        with shear_ata(name.endswith("K6")):
            fn = name.split()[0]
            e = rel(getattr(s32, fn)(v).cpu(), getattr(s32_cpu, fn)(v.cpu()))
        print(f"[2] shear float32 {name} vs the CPU: rel err {e!r}")
        check(e <= KERNEL_RTOL, f"shear {name} vs CPU {e!r}")
    del s32_cpu
    for kind, op in shear_ops.items():
        Ax, Aty = op.matvec(x), op.rmatvec(y)
        gap = abs(float(Ax.double() @ y.double())
                  - float(x.double() @ Aty.double()))
        a = gap / float(Ax.double().norm() * y.double().norm())
        # rmatvec rounds the sinogram to the G dtype before its product
        gate = BF16_RTOL if kind == "bfloat16" else KERNEL_RTOL
        print(f"[2] shear {kind} adjointness {a!r} (gate {gate})")
        check(a <= gate, f"shear {kind} adjointness {a!r}")

    # ---- 3. the main path ---------------------------------------------
    bv = torch.tensor(b_noisy.reshape(-1), dtype=torch.float32, device=dev)
    x0 = torch.zeros(nx * ny, dtype=torch.float32, device=dev)
    xt = torch.tensor(x_true.reshape(-1), dtype=torch.float32, device=dev)
    xt_norm = xt.norm()
    bk.reset_launch_counts()
    xs, info = CGLS(OP, bv, x0, CGLS_ITERS, TOL, x_true=x_true)
    cgls_launches = dict(bk.launch_counts)
    hist = np.array(info["relError"])
    final, best = float(hist[-1]), float(hist.min())
    check(tuple(xs.shape) == (nx * ny, 1) and bool(torch.isfinite(xs).all()),
          "CGLS solution shape/finite")
    check(info["its"] == CGLS_ITERS == len(hist), f"CGLS its {info['its']}")
    ref = np.array(JAX_CGLS_RELERR)
    ref_final, ref_best = float(ref[-1]), float(ref.min())
    dev_hist = float(np.abs(hist - ref).max())
    print(f"[3] CGLS float32: its {info['its']}, relError final "
          f"{final!r} (JAX CPU {ref_final!r}), min {best!r} at "
          f"iteration {int(hist.argmin()) + 1} (JAX CPU {ref_best!r}), "
          f"max |history - JAX| {dev_hist!r} at iteration "
          f"{int(np.abs(hist - ref).argmax()) + 1}")
    check(abs(final - ref_final) <= FINAL_ATOL, "CGLS final relError")
    check(abs(best - ref_best) <= FINAL_ATOL, "CGLS min relError")
    check(dev_hist <= HISTORY_ATOL, "CGLS relError history")

    cgn_min = {}
    for kind in ("float32", "int8"):
        op = ops[kind]
        x_n, k = cgls_normal(op, bv, x0, CGN_ITERS)
        check(bool(torch.isfinite(x_n).all()), f"cgls_normal {kind} finite")
        # the same recurrence one iteration at a time, for the history
        s, errs = _cgn_init(op, bv, x0), []
        for it in range(1, CGN_ITERS + 1):
            s = _cgn_chunk(op, 0.0, s, it)
            errs.append(float((s.x - xt).norm() / xt_norm))
        cgn_min[kind] = min(errs)
        print(f"[3] cgls_normal {kind}: k {k}, relError final "
              f"{float((x_n - xt).norm() / xt_norm)!r}, min {min(errs)!r} "
              f"at iteration {int(np.argmin(errs)) + 1}")
    d8 = abs(cgn_min["int8"] - cgn_min["float32"])
    print(f"[3] int8 vs float32 min relError gap {d8!r}")
    check(d8 <= INT8_ATOL, f"int8 min relError gap {d8!r}")
    launches = dict(bk.launch_counts)
    print(f"[3] launches in the main path: {launches}; of which CGLS "
          f"({info['its']} iterations and its set-up): {cgls_launches}")
    check(all(v > 0 for v in launches.values()), "a kernel never launched")
    bk.reset_launch_counts()
    f32.matvec(x)
    f32.rmatvec(y)
    per_apply = dict(bk.launch_counts)
    print(f"[3] launches of one float32 matvec and one rmatvec: {per_apply}")
    check(per_apply == {"banded_fwd": 1, "banded_adj": 1, "banded_ata": 0},
          f"one launch per apply: {per_apply}")

    # the shear path: f32-G and bf16-G CGLS, then cgls_normal on K6 for
    # each G type (the bench's bf16 first), launches counted per G type
    sk.reset_launch_counts()
    hist_sh = {}
    for kind, op in shear_ops.items():
        xs, info = CGLS(op, bv, x0, CGLS_ITERS, TOL, x_true=x_true)
        check(tuple(xs.shape) == (nx * ny, 1)
              and bool(torch.isfinite(xs).all()), f"shear CGLS {kind}")
        check(info["its"] == CGLS_ITERS == len(info["relError"]),
              f"shear CGLS {kind} its {info['its']}")
        hist_sh[kind] = np.array(info["relError"])
    shear_launches, cgn_sh = {}, {}
    with shear_ata(True):
        for kind in ("bfloat16", "float32"):
            op = shear_ops[kind]
            s, errs = _cgn_init(op, bv, x0), []
            for it in range(1, CGN_ITERS + 1):
                s = _cgn_chunk(op, 0.0, s, it)
                errs.append(float((s.x - xt).norm() / xt_norm))
            check(bool(torch.isfinite(s.x).all()),
                  f"shear cgls_normal {kind} finite")
            cgn_sh[kind] = errs
            shear_launches[kind] = dict(sk.launch_counts)
            sk.reset_launch_counts()
    errs = cgn_sh["bfloat16"]
    ref = np.array(JAX_SHEAR_CGLS_RELERR)
    h = hist_sh["float32"]
    dev_hist = float(np.abs(h - ref).max())
    mins = {k: float(v.min()) for k, v in hist_sh.items()}
    print(f"[3] shear CGLS float32: relError final {float(h[-1])!r} (JAX "
          f"CPU {float(ref[-1])!r}), min {mins['float32']!r} at iteration "
          f"{int(h.argmin()) + 1} (JAX CPU {float(ref.min())!r}), max "
          f"|history - JAX| {dev_hist!r} at iteration "
          f"{int(np.abs(h - ref).argmax()) + 1}")
    print(f"[3] shear CGLS bfloat16: relError final "
          f"{float(hist_sh['bfloat16'][-1])!r}, min {mins['bfloat16']!r} at "
          f"iteration {int(hist_sh['bfloat16'].argmin()) + 1}")
    for kind, e in cgn_sh.items():
        print(f"[3] shear cgls_normal {kind} (TRIPS_TPU_SHEAR_ATA=1): "
              f"relError final {e[-1]!r}, min {min(e)!r} at iteration "
              f"{int(np.argmin(e)) + 1}")
    print(f"[3] shear vs banded float32 CGLS min relError: "
          f"{mins['float32']!r} / {best!r}")
    print(f"[3] launches in the shear path: {shear_launches}")
    check(abs(float(h[-1]) - float(ref[-1])) <= FINAL_ATOL,
          "shear CGLS final relError")
    check(abs(mins["float32"] - float(ref.min())) <= FINAL_ATOL,
          "shear CGLS min relError")
    check(dev_hist <= SHEAR_HISTORY_ATOL, "shear CGLS relError history")
    check(abs(mins["bfloat16"] - mins["float32"]) <= SOLVE_GAP,
          "shear bf16 vs f32 min relError")
    for kind, e in cgn_sh.items():
        check(abs(min(e) - mins[kind]) <= SOLVE_GAP,
              f"shear cgls_normal vs cgls min relError ({kind})")
    check(mins["float32"] <= 1.2 * best, "shear vs banded reconstruction")
    check(all(v > 0 for c in shear_launches.values() for v in c.values()),
          "a shear kernel never launched")

    # ---- 4. times ------------------------------------------------------
    def plain(op):
        p = copy.copy(op)
        p._fwd, p._adj = bk.banded_fwd_buckets_ref, bk.banded_adj_buckets_ref
        p._ata = bk.banded_ata_buckets_ref
        return p

    nnz = A.nnz
    kernel_wall = {}  # (path, kind, solver) -> ms/iter of the kernels' runs
    for kind, op in ops.items():
        for solver, fn in (("cgls_normal", cgls_normal), ("cgls", cgls)):
            walls = {}
            for label, o in (("plain", plain(op)), ("kernels", op),
                             ("kernels", op), ("plain", plain(op))):
                fn(o, bv, x0, 2, 0.0)
                torch.cuda.synchronize()
                t = time.perf_counter()
                _, k = fn(o, bv, x0, TIMED_ITERS, 0.0)
                torch.cuda.synchronize()
                walls.setdefault(label, []).append(
                    (time.perf_counter() - t, k))
            line = []
            for label, runs in walls.items():
                rate = float(np.mean([k * 2 * nnz / w for w, k in runs]))
                ms = float(np.mean([w / k for w, k in runs])) * 1e3
                line.append(f"{label} {rate!r} nnz/s ({ms!r} ms/iter)")
                if label == "kernels":
                    kernel_wall["banded", kind, solver] = ms
            print(f"[4] {solver} {kind}, {TIMED_ITERS} iterations: "
                  + "; ".join(line))
    def shear_plain(op):
        p = copy.copy(op)
        p._rot, p._rot_t = sk.shear_rotate_ref, sk.shear_rotate_adjoint_ref
        p._ata = sk.gcontract_ata_ref
        return p

    for kind, op in shear_ops.items():
        for solver, fn, on in (("cgls", cgls, False),
                               ("cgls_normal pair", cgls_normal, False),
                               ("cgls_normal K6", cgls_normal, True)):
            walls = {}
            with shear_ata(on):
                for label, o in (("plain", shear_plain(op)), ("kernels", op),
                                 ("kernels", op), ("plain", shear_plain(op))):
                    fn(o, bv, x0, 2, 0.0)
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    _, k = fn(o, bv, x0, TIMED_ITERS, 0.0)
                    torch.cuda.synchronize()
                    walls.setdefault(label, []).append(
                        (time.perf_counter() - t, k))
            line = []
            for label, runs in walls.items():
                rate = float(np.mean([k * 2 * nnz / w for w, k in runs]))
                ms = float(np.mean([w / k for w, k in runs])) * 1e3
                line.append(f"{label} {ms!r} ms/iter (effective "
                            f"{rate!r} nnz/s)")
                if label == "kernels":
                    kernel_wall["shear", kind, solver] = ms
            print(f"[4] shear {solver} {kind} G, {TIMED_ITERS} iterations: "
                  + "; ".join(line))
    print(f"[4] card: {card}; kernel ms: device time (torch.profiler) "
          f"per call; event ms: CUDA events around the calls (host gaps "
          f"included); bounds at {HBM_BPS:.3g} B/s, {F32_FLOPS:.3g} f32, "
          f"{BF16_FLOPS:.3g} bf16 and {TF32_FLOPS:.3g} TF32 FLOP/s")
    # 256 MB, written between runs where a cold L2 (50 MB) is wanted
    scrub = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    kernel_ms, banded_bound = {}, {}
    for kind, op in ops.items():
        X = torch.randn(op.n_pad, op.n_pad, device=dev, generator=gen)
        p = op.det_count
        Ys = torch.randn(op.shape[0] // p, p, device=dev, generator=gen)
        calls = {name: [] for name in REPLACES}
        for stack, isc in zip(op.stacks, op.is_cols):
            args = bucket_args(op, stack, isc, X)
            Y = torch.randn(stack[0].shape[0], stack[0].shape[3], device=dev,
                            generator=gen)
            calls["banded_fwd"].append(args)
            calls["banded_ata"].append(args)
            calls["banded_adj"].append((Y,) + args[1:])

        def apply(fn, arglist):
            return lambda: [fn(*a) for a in arglist]

        # one apply: each kernel over all buckets in one launch, as the
        # operator runs them (the float32 and bfloat16 packs exceed L2;
        # int8 is 59 MB)
        full = {"banded_fwd": fwd_buckets(op, X),
                "banded_adj": adj_buckets(op, Ys),
                "banded_ata": all_buckets(op, X)}
        runs = {name + sfx: (lambda f, a: lambda: f(*a))(
                    getattr(bk, name + "_buckets" + sfx), full[name])
                for name in REPLACES for sfx in ("", "_ref")}
        by_kernel = {name: {} for name in REPLACES}
        tot = {k: device_ms(f, 10, by_kernel.get(k)) for k, f in runs.items()}
        events = {name: cuda_ms(runs[name], 20) for name in REPLACES}
        kernel_ms[kind] = tot
        # least bytes: every stored weight, S, Pm, scales and angle ids
        # once, the image in, the sinogram or image out (once); 2 flops per
        # nonzero weight and pass
        pack = sum(nbytes(*st) for st in op.stacks)
        ids = nbytes(*op._aidx)
        nz = sum(int((st[0] != 0).sum()) for st in op.stacks)
        img = op.n_pad * op.n_pad * 4
        sino = nbytes(Ys)
        banded_bound[kind] = {
            "banded_ata": bound(pack + 2 * img, 4 * nz, F32_FLOPS),
            "banded_fwd": bound(pack + ids + img + sino, 2 * nz, F32_FLOPS),
            "banded_adj": bound(pack + ids + sino + img, 2 * nz, F32_FLOPS)}
        wbytes = sum(nbytes(st[0]) for st in op.stacks)
        print(f"[4] {kind} one apply (W {wbytes} B, {nz} nonzero weights), "
              f"one launch per kernel:")
        for name in REPLACES:
            ms, (bms, by) = tot[name], banded_bound[kind][name]
            print(f"[4]   {name} {ms!r} ms ({wbytes / ms / 1e6!r} GB/s of "
                  f"W; event ms {events[name]!r}), bound {bms!r} ms "
                  f"({by}), plain {tot[name + '_ref']!r} ms; by kernel "
                  f"{by_kernel[name]}")
        # per bucket with L2 scrubbed before each run, each kernel on one
        # bucket (nb = 1): K1 reads W once, K2 + K3 read it twice
        for i, stack in enumerate(op.stacks):
            r = {name: cuda_ms(apply(getattr(bk, name), calls[name][i:i + 1]),
                               10, flush=scrub.zero_)
                 for name in REPLACES}
            print(f"[4]   {kind} bucket W{tuple(stack[0].shape)} "
                  f"{nbytes(stack[0])} B, cold L2 (event ms): "
                  f"K1 {r['banded_ata']!r}, K2 + K3 "
                  f"{r['banded_fwd'] + r['banded_adj']!r} (K2 "
                  f"{r['banded_fwd']!r}, K3 {r['banded_adj']!r})")

    # the library's call for K1-K3's functions at the apply level: the
    # float32 pack's matrix as a CSR tensor (cuSPARSE); A^T its own CSR
    M = f32.to_scipy().astype(np.float32).tocsr()
    MT = M.T.tocsr()
    (Mt, idx), (MTt, _) = library_csr(M, dev), library_csr(MT, dev)
    xv = torch.randn(M.shape[1], device=dev, generator=gen)
    yv = torch.randn(M.shape[0], device=dev, generator=gen)
    lib_runs = {"banded_fwd": lambda: Mt @ xv, "banded_adj": lambda: MTt @ yv,
                "banded_ata": lambda: MTt @ (Mt @ xv)}
    library_ms = {k: device_ms(f, 10) for k, f in lib_runs.items()}
    # least bytes of one CSR product: values and column indices once, the
    # row pointers, the vector in and out
    ib = np.dtype(idx).itemsize
    csr_b = [m.nnz * (4 + ib) + (m.shape[0] + 1) * ib
             + 4 * (m.shape[0] + m.shape[1]) for m in (M, MT)]
    library_bound = {"banded_fwd": bound(csr_b[0], 2 * M.nnz, F32_FLOPS),
                     "banded_adj": bound(csr_b[1], 2 * M.nnz, F32_FLOPS),
                     "banded_ata": bound(sum(csr_b), 4 * M.nnz, F32_FLOPS)}
    e_lib = max(rel(Mt @ xv, f32.matvec(xv)), rel(MTt @ yv, f32.rmatvec(yv)))
    check(e_lib <= KERNEL_RTOL, f"CSR product vs the pack {e_lib!r}")
    print(f"[4] library: the float32 pack's matrix as torch CSR ({idx} "
          f"indices, nnz {M.nnz}), agrees with the kernels to {e_lib!r}: "
          + "; ".join(f"{name} {library_ms[name]!r} ms (bound "
                      f"{library_bound[name][0]!r} ms, "
                      f"{library_bound[name][1]})" for name in REPLACES))

    shear_ms = {}
    for kind, op in shear_ops.items():
        calls = shear_calls(op, gen, sk)
        k6_parts = {}
        tot = {name + sfx: device_ms(
                   (lambda f, a, k: lambda: f(*a, **k))(
                       getattr(sk, name + sfx), args, kw), 10,
                   k6_parts if name + sfx == "gcontract_ata" else None)
               for name, args, kw in calls for sfx in ("", "_ref")}
        # the library's pair for K6's function, in the G type (bf16
        # products with float32 sums, U rounded to bf16 between them)
        R, G = calls[2][1]
        C, N, dt = op._C, op.G.shape[2], op.g_dtype
        R2, G2 = R.view(-1, C * C), G.view(C * C, N)
        if dt == torch.bfloat16:
            def pair():
                U = torch.mm(R2, G2, out_dtype=torch.float32).to(dt)
                return torch.mm(U, G2.T, out_dtype=torch.float32)
        else:
            def pair():
                return (R2 @ G2) @ G2.T
        tot["gcontract_ata_library"] = device_ms(pair, 10)
        # least bytes: inputs once, outputs once; K4/K5 14 flops per
        # rotated canvas element (f32); K6 4 na C^2 p_pad on the tensor
        # cores: bf16 once, float32 G as 3xTF32, three TF32 passes
        na, elt = op.n_angles, op.G.element_size()
        canv, quart = na * C * C, 3 * C * C * 4
        shifts = nbytes(*op._shifts())
        passes, peak = ((1, BF16_FLOPS) if dt == torch.bfloat16
                        else (3, TF32_FLOPS))
        tot["bounds"] = {
            "shear_rotate": bound(quart + shifts + canv * elt, 14 * canv,
                                  F32_FLOPS),
            "shear_rotate_adjoint": bound(canv * elt + shifts + quart,
                                          14 * canv, F32_FLOPS),
            "gcontract_ata": bound(nbytes(R, G) + canv * 4,
                                   passes * 4 * canv * N, peak)}
        shear_ms[kind] = tot
        print(f"[4] shear {kind} G, one launch at C {op._C}, {op.n_angles} "
              f"views: " + "; ".join(
                  f"{name} {tot[name]!r} ms, bound "
                  f"{tot['bounds'][name][0]!r} ms "
                  f"({tot['bounds'][name][1]}), plain "
                  f"{tot[name + '_ref']!r} ms"
                  for name in SHEAR_REPLACES)
              + f"; library pair for K6 {tot['gcontract_ata_library']!r} ms"
              f" (K6 event ms {cuda_ms(lambda: sk.gcontract_ata(R, G), 20)!r}"
              f", pair {cuda_ms(pair, 20)!r}); K6 by kernel {k6_parts}")
        applies = {}
        for name, fn, v, on in (("matvec", op.matvec, x, False),
                                ("rmatvec", op.rmatvec, y, False),
                                ("normal_matvec pair", op.normal_matvec, x,
                                 False),
                                ("normal_matvec K6", op.normal_matvec, x,
                                 True)):
            with shear_ata(on):
                applies[name] = cuda_ms(lambda: fn(v), 20)
        print(f"[4] shear {kind} G applies: " + ", ".join(
            f"{k} {v!r} ms" for k, v in applies.items()))

    print(f"[4] clocks.sm,power.draw,temperature.gpu after: "
          f"{smi('clocks.sm,power.draw,temperature.gpu')}")

    # ---- 5. loop profiles ----------------------------------------------
    loops = [(f"banded {kind} cgls_normal", cgls_normal, ops[kind], False,
              ("banded", kind, "cgls_normal")) for kind in ("float32", "int8")]
    loops.append(("banded float32 cgls", cgls, ops["float32"], False,
                  ("banded", "float32", "cgls")))
    loops += [(f"shear {kind} G cgls_normal K6", cgls_normal, shear_ops[kind],
               True, ("shear", kind, "cgls_normal K6"))
              for kind in ("bfloat16", "float32")]
    for label, solver, op, on, key in loops:
        wall = kernel_wall[key]
        with shear_ata(on):
            busy, by_kernel = loop_profile(solver, op, bv, x0)
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]
        print(f"[5] {label}: device busy {busy * 1e3!r} us/iter, wall "
              f"{wall * 1e3!r} us/iter, idle share {1 - busy / wall!r}; "
              f"busy by kernel (us/iter): "
              + ", ".join(f"{k} {v * 1e3!r}" for k, v in top))

    def entry(name, source, replaces, launches, err, ms, plain_ms, bnd,
              library_ms, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": library_ms, **extra}

    kernels = [entry(name, "trips_tpu_torch/csrc/banded.cu", REPLACES[name],
                     launches[name], max_abs[name],
                     kernel_ms["float32"][name],
                     kernel_ms["float32"][name + "_ref"],
                     banded_bound["float32"][name], library_ms[name],
                     storage="float32",
                     ms_by_storage={k: v[name] for k, v in kernel_ms.items()},
                     bound_ms_by_storage={k: v[name][0]
                                          for k, v in banded_bound.items()},
                     library="float32 CSR (torch.sparse_csr_tensor, "
                             f"{idx} indices)",
                     library_bound_ms=library_bound[name][0])
               for name in ("banded_ata", "banded_fwd", "banded_adj")]
    for kind in ("bfloat16", "float32"):  # the bench's G type first
        t = shear_ms[kind]
        kernels += [entry(name, "trips_tpu_torch/csrc/shear.cu",
                          SHEAR_REPLACES[name], shear_launches[kind][name],
                          shear_abs[kind][name], t[name], t[name + "_ref"],
                          t["bounds"][name],
                          t["gcontract_ata_library"]
                          if name == "gcontract_ata" else None, g_dtype=kind)
                    for name in SHEAR_REPLACES
                    if kind == "bfloat16" or name == "gcontract_ata"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
