#!/usr/bin/env python3
"""Drive the PyTorch port's tomography CGLS paths once on one CUDA card.

Run from the repository root: ``python3 chip_smoke.py``. It needs one
card; without one it exits non-zero before printing any result.

Two paths on the same tomo256x60 problem: the bucketed banded operator
(kernels K1-K3, ``csrc/banded.cu``) and the shear-rotate fan projector
``ShearFanProjector`` (K4-K6, ``csrc/shear.cu``). Phases, each failing the
run by raising:

0. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
1. build K1-K6 with nvcc, one process per source;
2. each kernel against its plain PyTorch version at the main paths' shapes
   (256x256 image, 60 fan-beam views; banded: 32 line groups, 4 buckets
   per drive orientation, float32, bfloat16 and int8 packs; shear: C = 400,
   p_pad = 384, float32 and bfloat16 ``G``); the float32 banded operator
   against the host CSR matrix; the float32 shear operator against itself
   on the CPU; adjointness;
3. the main paths: ``Tomography`` -> operator -> ``solvers.CGLS`` and
   ``krylov.cgls_normal``, held against the JAX package's results on the
   same inputs, with launch counts showing the kernels ran;
4. times of each kernel, apply and solver against the plain versions
   (CUDA events and synchronized host clocks).

The line before the last holds ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""
import contextlib
import copy
import json
import os
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
    "banded_ata": "trips_tpu/sparse/pallas_banded_kernel.py:440",
    "banded_fwd": "trips_tpu/sparse/pallas_banded_kernel.py:333",
    "banded_adj": "trips_tpu/sparse/pallas_banded_kernel.py:379",
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
        print(f"[2] {kind} kernels vs plain, worst bucket rel err: "
              + ", ".join(f"{k} {v!r}" for k, v in worst.items()))

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
    shear_abs = {k: 0.0 for k in SHEAR_REPLACES}
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
            shear_abs[name] = max(shear_abs[name], diff)
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
    print(f"[3] launches in the main path: {launches}")
    check(all(v > 0 for v in launches.values()), "a kernel never launched")

    # the shear path: f32-G and bf16-G CGLS, bf16-G cgls_normal on K6
    sk.reset_launch_counts()
    hist_sh = {}
    for kind, op in shear_ops.items():
        xs, info = CGLS(op, bv, x0, CGLS_ITERS, TOL, x_true=x_true)
        check(tuple(xs.shape) == (nx * ny, 1)
              and bool(torch.isfinite(xs).all()), f"shear CGLS {kind}")
        check(info["its"] == CGLS_ITERS == len(info["relError"]),
              f"shear CGLS {kind} its {info['its']}")
        hist_sh[kind] = np.array(info["relError"])
    with shear_ata(True):
        op = shear_ops["bfloat16"]
        s, errs = _cgn_init(op, bv, x0), []
        for it in range(1, CGN_ITERS + 1):
            s = _cgn_chunk(op, 0.0, s, it)
            errs.append(float((s.x - xt).norm() / xt_norm))
        check(bool(torch.isfinite(s.x).all()), "shear cgls_normal finite")
    shear_launches = dict(sk.launch_counts)
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
    print(f"[3] shear cgls_normal bfloat16 (TRIPS_TPU_SHEAR_ATA=1): "
          f"relError final {errs[-1]!r}, min {min(errs)!r} at iteration "
          f"{int(np.argmin(errs)) + 1}")
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
    check(abs(min(errs) - mins["bfloat16"]) <= SOLVE_GAP,
          "shear cgls_normal vs cgls min relError")
    check(mins["float32"] <= 1.2 * best, "shear vs banded reconstruction")
    check(all(v > 0 for v in shear_launches.values()),
          "a shear kernel never launched")

    # ---- 4. times ------------------------------------------------------
    def plain(op):
        p = copy.copy(op)
        p._fwd, p._adj = bk.banded_fwd_ref, bk.banded_adj_ref
        p._ata = bk.banded_ata_ref
        return p

    print(f"[4] card: {card}; ms are CUDA-event means after a warm-up")
    # 256 MB, written between runs where a cold L2 (50 MB) is wanted
    scrub = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    kernel_ms = {}
    for kind, op in ops.items():
        X = torch.randn(op.n_pad, op.n_pad, device=dev, generator=gen)
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

        # one apply = the kernel on every bucket in turn, as the operator
        # runs it (the float32 and bfloat16 packs exceed L2; int8 is 59 MB)
        tot = {name + sfx: cuda_ms(apply(getattr(bk, name + sfx), calls[name]),
                                   20)
               for name in REPLACES for sfx in ("", "_ref")}
        kernel_ms[kind] = tot
        wbytes = sum(st[0].numel() * st[0].element_size() for st in op.stacks)
        print(f"[4] {kind} one apply over all buckets (W {wbytes} B):")
        for name in REPLACES:
            ms = tot[name]
            print(f"[4]   {name} {ms!r} ms ({wbytes / ms / 1e6!r} GB/s of W)"
                  f", plain {tot[name + '_ref']!r} ms")
        # per bucket with L2 scrubbed before each run: does K1's second
        # read of W come from L2? (K2 + K3 read W from HBM twice)
        for i, stack in enumerate(op.stacks):
            r = {name: cuda_ms(apply(getattr(bk, name), calls[name][i:i + 1]),
                               10, flush=scrub.zero_)
                 for name in REPLACES}
            print(f"[4]   {kind} bucket W{tuple(stack[0].shape)} "
                  f"{stack[0].numel() * stack[0].element_size()} B, cold L2: "
                  f"K1 {r['banded_ata']!r} ms, K2 {r['banded_fwd']!r} ms, "
                  f"K3 {r['banded_adj']!r} ms")

    nnz = A.nnz
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
            print(f"[4] {solver} {kind}, {TIMED_ITERS} iterations: "
                  + "; ".join(line))
    shear_ms = {}
    for kind, op in shear_ops.items():
        calls = shear_calls(op, gen, sk)
        tot = {name + sfx: cuda_ms(
                   (lambda f, a, k: lambda: f(*a, **k))(
                       getattr(sk, name + sfx), args, kw), 20)
               for name, args, kw in calls for sfx in ("", "_ref")}
        shear_ms[kind] = tot
        print(f"[4] shear {kind} G, one launch at C {op._C}, {op.n_angles} "
              f"views: " + "; ".join(
                  f"{name} {tot[name]!r} ms, plain {tot[name + '_ref']!r} ms"
                  for name in SHEAR_REPLACES))
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
            print(f"[4] shear {solver} {kind} G, {TIMED_ITERS} iterations: "
                  + "; ".join(line))
    print(f"[4] clocks.sm,power.draw,temperature.gpu after: "
          f"{smi('clocks.sm,power.draw,temperature.gpu')}")

    kernels = [{"name": name, "route": "cuda",
                "source": "trips_tpu_torch/csrc/banded.cu",
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": max_abs[name],
                "ms": kernel_ms["float32"][name],
                "plain_ms": kernel_ms["float32"][name + "_ref"]}
               for name in ("banded_ata", "banded_fwd", "banded_adj")]
    kernels += [{"name": name, "route": "cuda",
                 "source": "trips_tpu_torch/csrc/shear.cu",
                 "replaces": SHEAR_REPLACES[name],
                 "launches": shear_launches[name],
                 "max_abs_err": shear_abs[name],
                 "ms": shear_ms["bfloat16"][name],
                 "plain_ms": shear_ms["bfloat16"][name + "_ref"]}
                for name in SHEAR_REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
