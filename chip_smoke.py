#!/usr/bin/env python3
"""Drive the PyTorch port's solver paths once on one CUDA card.

Run from the repository root: ``python3 chip_smoke.py``. It needs one
card; without one it exits non-zero before printing any result.

Two paths on the same tomo256x60 problem: the bucketed banded operator
(kernels K1-K3, ``csrc/banded.cu``, each one launch over all buckets of
an apply) and the shear-rotate fan projector
``ShearFanProjector`` (K4-K6, ``csrc/shear.cu``). On the card the port's
loops (CGLS, LSQR, Brent's search, the DP Newton) run as replays of one
captured CUDA graph each (``trips_tpu_torch/core/loop.py``); phases 3, 4,
5, 7, 8, 9 and 12b also run them stepped eagerly (``core.loop.eager``)
and fail unless x, k and every lambda are the same to the bit and each
kernel launched as often (a replay counts its step's launches). Phases,
each failing the run by raising:

0. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
1. build K1-K6 with nvcc, one process per source;
2. each kernel against its plain PyTorch version at the main paths' shapes
   (256x256 image, 60 fan-beam views; banded: 32 line groups, 4 buckets
   per drive orientation, float32, bfloat16 and int8 packs, K1-K3 per
   bucket and over all buckets in one launch, as the operator calls them,
   each the same to the bit from run to run (K2 sums in a fixed order, K1
   and K3 back-project in fixed point), K3 of zeros zero and of a NaN all
   NaN; shear:
   C = 400, p_pad = 384, float32 and bfloat16 ``G``; K4 and K5 the same to
   the bit from run to run); the float32 banded operator against the host
   CSR matrix; the float32 shear operator against itself on the CPU;
   adjointness;
3. the main paths: ``Tomography`` -> operator -> ``solvers.CGLS`` and
   ``krylov.cgls_normal``, held against the JAX package's results on the
   same inputs, with launch counts showing the kernels ran, and the
   launches of one ``matvec`` and one ``rmatvec``; the banded float32
   ``cgls_normal`` run twice, its relError histories and final iterates
   bitwise equal; each loop (banded ``cgls`` and ``cgls_normal`` in three
   storage classes, shear ``cgls`` and K6 ``cgls_normal`` for both G types)
   replayed against the eager loop, and the launches of one replay;
4. times of each kernel against its plain version, the least time the
   card could take for the same work (``bound_ms``) and the library's
   call for the same function (device time from ``torch.profiler``): for
   K1-K3 one apply of the pack's matrix as a float32 CSR tensor
   (cuSPARSE), for K6 the product pair; applies and solvers (CUDA events
   and synchronized host clocks; each solver loop replayed, stepped
   eagerly and on the plain versions, in turns); K4 and K5 at each tile shape of
   ``shear_kernels.TILES`` (K5 also in chunks of 2, 4 and 8 views), each held
   against its plain version; where ``_local/parent`` holds another
   checkout of the repository (``git archive``), its K3 and K1 (built from
   its ``csrc/``) in turns with these, per storage class (and in 7 per
   dynamic pack, in 12b on the gel pack), and its banded float32
   ``cgls`` and ``cgls_normal`` loops in turns with these;
5. loop profiles of the solver paths that run K1-K6, replayed and
   stepped eagerly: device busy time per iteration by kernel
   (``torch.profiler``, which records a replay's kernels one by one)
   against the wall time per iteration of the same solver in 4 (timed
   before any profiler session, which leaves the host slower), and the
   device's idle share;
   the parent's loops beside the chunked ones;
6. the tomography demo's regularized solvers (``demos/demo_tomography.py``
   :50-61, 30 iterations) on the float32 banded operator: GKS with
   ``FirstDerivative2D``, Hybrid LSQR with reorthogonalization and MMGKS
   p=2 q=1, each with the discrepancy principle, and Hybrid LSQR with GCV;
   each final relError held against the JAX package's, K2 and K3 launches
   against the count each solver's loop implies (no K1), and the wall time
   per iteration, timed right after 3 (before any profiler session); after
   5, the device busy time per iteration of the first three and the idle
   share;
7. dynamic CT at Emoji's block structure (``generate_synthetic_dynamic``,
   33 frames of 128x128, 10 angles per frame, 1% noise): the frame-varying
   ``DynamicBandedOperator`` (float32, 8 line groups) and
   ``BucketedDynamicBandedOperator`` (3 buckets; float32, bfloat16, int8),
   K1-K3 each over all frames and stacks in one launch against their plain
   versions and bitwise against a second run, the float32 applies against
   the host block-diagonal CSR matrix, adjointness, one launch per apply;
   ``BatchedBlockDiagOperator`` over
   frame 0's ``BucketedBandedProjector`` for the 33 frames (one launch per
   apply, weight frame stride 0) against its plain version; then the
   dynamic demo's sequence (``demos/demo_dynamic_ct.py``:75-116): static
   per-frame MMGKS over ``CsrOperator``, dynamic MMGKS with anisotropic TV,
   isotropic TV and group sparsity, Hybrid LSQR (GCV), each final relError
   held to 1e-3 of the JAX package's, and ``cgls_normal`` on the bucketed
   float32 and int8 packs (minima within 0.01); launches against the counts
   the loops imply (each solve's ``tsqr_geqrf`` launches counted from 0
   just before it: two per host MMGKS iteration, no library QR); K1-K3's device ms per apply against their bound, plain
   version and the block-diagonal CSR product; each solver's wall and
   device busy time per iteration and idle share;
8. the all-on-device solvers at full width: on tomo256x60 (30 iterations)
   ``fused_gks`` with DP, GCV and the L-curve, ``fused_mmgks`` p=2 q=1 DP,
   ``fused_hybrid_lsqr`` with GCV and with DP and reorthogonalization,
   and ``lsqr`` (50 steps) damped by the square root of the GCV lambda;
   on the dynamic problem of 7 (20 iterations) ``fused_mmgks`` with
   isotropic TV and group sparsity, as the demo runs them (float32 data,
   GCV), with lambda fixed, and with GCV on float64 data; each solve run
   twice, each final relError held to 1e-3 of the JAX package's (the
   demo's float32 GCV pair printed, not gated), K2/K3 launches against the
   count each loop implies, each Brent/Newton loop's length and host
   reads, the wall per iteration and the host syncs of one iteration by
   source line (from ``torch.cuda.set_sync_debug_mode``); the GCV GKS
   with the Brent chunk as taken and with 8, in turns; the float64-data
   isoTV MMGKS and ``cgls_normal`` (K1, the bucketed float32 pack) killed
   after one chunk and resumed from their files, each held bit for bit to
   an uninterrupted run, and two uninterrupted runs to each other; after
   7's profiles, each solver's
   device busy time per iteration and idle share beside the host-driven
   solver's of 6/7;
9. deblurring (no K1-K6 on this path: the blurs are cuDNN ``conv2d`` and
   cuBLAS products, as the JAX package's are XLA's): ``Blur1D`` (n = 200),
   ``Blur2D`` (128x128, the 9x9 PSF and an even 4x6 one) and
   ``FrameletOperator(128, 128, 2)``, float32 against float64 on the card
   and float64 against scipy on the host, the reversed/flipped-PSF
   ``rmatvec``, the framelet's tight frame and adjointness, one ``conv2d``
   per column apply, device us per apply against the bound; then the 1D
   demo (n = 200: TSVD, TGSVD, Tikhonov, Hybrid GMRES, Hybrid LSQR, GKS,
   all DP), the 2D demo with ``--large`` (128x128, 9x9 PSF: Arnoldi-
   Tikhonov DP, Hybrid GMRES, Hybrid LSQR, GKS, MMGKS with the derivative
   and with the framelet, GCV), ``demos/demo_fused_tpu.py --config
   deblur1d`` (fused GKS with GCV, DP and the L-curve, fused MMGKS and
   Hybrid LSQR with GCV) and ``fused_hybrid_gmres`` (GCV, DP, DP with
   reorthogonalization) on the 2D problem, in float32, each run twice and
   its final relError held to 1e-3 of the JAX package's (float64 where the
   port's float32 formula departs and for fused Hybrid GMRES DP without
   reorthogonalization), TSVD's and TGSVD's k equal to JAX's; each solver's wall and device busy time
   per iteration and idle share; [9]'s seconds.
10. out-of-core and batched dynamic CT on the problem of 7: each frame a
   ``BucketedBandedProjector`` built on the host (8 line groups, 3
   buckets; float32 and int8), streamed by
   ``StreamedDynamicBandedOperator`` (forced: the pack fits the card):
   K2, K3 and K1 launched once a frame per apply, ``matvec`` bitwise equal
   to the frames' resident ``matvec``s with and without the compute
   stream slowed before each frame, ``rmatvec`` bitwise and
   ``normal_matvec`` within 1e-6 of the resident operator of 7 (float32
   also against the host CSR matrix), the peak memory of an apply within
   the two slots, the output and a slack; walls (CUDA events) of the
   streamed, resident and frame-alone applies and of the upload alone,
   the link's GB/s, the upload's hidden share and the host's enqueue of
   an apply;
   ``cgls_normal_streamed`` (20 iterations), its final relError held to
   1e-3 of the JAX package's, its nnz/s, and the device's idle share from
   a ``telemetry.profile`` trace;
   ``batched_frame_solve`` (fused MMGKS with GCV, fused GKS with DP;
   float64 ELL tables), each frame's final relError held to 1e-3 of the
   JAX package's, walls per frame and iteration, a frame's host syncs
   and device launches.
11. the sharded operators of ``parallel/`` (whole vectors on every rank,
   one all_reduce per apply): [11a] world size 1 over NCCL in this
   process: tomo256x60's bucketed packs (float32, bfloat16, int8) and
   flat pack, the dynamic bucketed and flat float32 packs of 7, the ELL
   and BSR-as-CSR operators on tomo256x60's matrix and on the dynamic
   frames; each banded ``matvec``, ``rmatvec`` and ``normal_matvec``
   bitwise the unsharded operator's, ELL/BSR within 1e-5 of the host
   product, one launch and one all_reduce per apply; the applies'
   times beside the unsharded ones (CUDA events, device time, host
   enqueue), the NCCL all_reduce alone; ``cgls_normal`` on the sharded
   float32 packs held as 3 and 10 hold it. [11b] two ranks on the one
   card over gloo (NCCL refuses two ranks on one device), spawned after
   the kernels are built: tomo256x60's float32 and int8 packs on
   ``angles`` 2, the dynamic float32 pack on (time 1, angles 2), rebuilt
   by each rank from NumPy stacks and sharded to the card; the same
   gates, ``cgls_normal`` on the float32 packs, the ranks' final iterates
   bitwise equal; each rank's K1-K3 device time over its angles beside
   the whole operator's, the gloo all_reduce's wall (staged through the
   host). A rank that fails or outlives 300 s fails the run.
12. the last modules (phases 2-11 build with the NumPy matrix builder, as
   the JAX numbers they hold were made; this one with the C++ builder):
   [12a] the C++ builder built on the card's host, its fan matrices at
   256x60 and 512x180 and parallel ones at the dynamic cell's 128x128 and
   330 angles against the NumPy builder's (the same rows but for chords
   along a grid line, entries within 1e-9), the tomo256x60 pack byte-equal
   under both, each builder's seconds; [12b] gelPhantom dynamic CT at the
   reference's size on a bundle written from a seed (``GEL``: the real
   geometry, 17 frames, 18 of 360 angles kept, 256x256):
   ``BatchedBlockDiagOperator`` over the bucketed float32 pack of the one
   shared geometry, K1-K3 over all frames against their plain versions
   (and a second run, bitwise) and the host CSR product, adjointness, one
   launch per apply; CGLS (30), ``cgls_normal`` (30) and Hybrid LSQR
   with GCV (20), each final relError held to 1e-3 of the JAX package's,
   launches against the loops' counts, wall and device busy time per
   iteration, idle share; K1-K3's device ms per apply beside their bound,
   plain versions and the block-diagonal CSR product; [12c]
   ``demos.demo_l_curve`` at its defaults (its six solves held to 1e-3 of
   JAX's float32 run, lambda printed beside JAX's, K2/K3 launches against
   the loops' counts, the six solves' wall and device busy time); [12d]
   ``demos.demo_small_scale_cgls`` (``its`` equal to JAX's, relError to
   1e-3); [12e] ``BsrOperator`` with float32, bfloat16 and int8 blocks on
   tomo256x60's matrix against the host product of its stored values,
   device ms beside the ``CsrOperator``'s; [12f]
   ``bench.iters_to_tol.compare`` on the card beside JAX's rows; [12]'s
   seconds.
13. the port's twins of the runnable demos (``trips_tpu_torch.demos``)
   at full width through their ``main``, with the C++ matrix builder as a
   user builds (``demo_your_data`` at its defaults, 64x64 'H' image, GKS
   with GCV; no banded kernel): ``demo_tomography --large`` (K2, K3),
   ``demo_dynamic_ct --nx 128 --nt 33`` (its 12 views; K2, K3),
   ``demo_1d_deblurring`` and ``demo_2d_deblurring --large`` (no banded
   kernel), ``demo_fused_tpu --config deblur1d`` and ``--config tomo --nx
   256 --views 60`` (the bfloat16 pack; K1-K3), ``demo_fused_dynamic
   --nx 128 --nt 33 --views 10`` (K2, K3; its resume bit for bit): each
   relError held to 1e-3 of the JAX demo's on the same arguments
   (float64 where [8] and [9] hold the same solve so; the fused dynamic
   demo's float32 GCV solves and their twins on float64 data alike),
   K1-K3 launches against the loops' counts, each twin's wall; [13]'s
   seconds.
14. the R-only tall-skinny QR of MMGKS's panels (``sparse/tall_qr.py``,
   ``csrc/tsqr.cu``) at the dynamic cell's shapes, 71,610 x 25 unweighted
   and weighted and 1,622,016 x 23 weighted, float32: against LAPACK's
   float64 R up to row signs, the float64 Gram matrix and the plain
   version, the same bits twice, one launch a call; its device ms beside
   the bound, the plain version and ``torch.linalg.qr(mode="r")``; its
   launches per solve from [7] (two per host MMGKS iteration, no library
   QR).

The line before the last holds ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""
import contextlib
import copy
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

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
# The relError of the final iterate of the tomography demo's solvers
# (demos/demo_tomography.py:50-61 with n_iter 30: GKS dp, Hybrid LSQR dp
# with reorth, MMGKS p2 q1 dp) and of Hybrid LSQR with regparam "gcv" on the
# same inputs, from trips_tpu on the CPU through the demo's own code
# (``python3 demo_reference.py jax``: ``demo_tomography.main()`` with
# ``--large``, its ``relerr`` recording the values), JAX 0.9.0, x64 off, A
# from the NumPy builder (TRIPS_TPU_NO_NATIVE=1); the JAX operator there is
# the ELL matrix.
JAX_DEMO_RELERR = {"GKS dp": 0.09874777382006275,
                   "Hybrid LSQR dp": 0.10890058901611843,
                   "MMGKS dp": 0.09466263254699593,
                   "Hybrid LSQR gcv": 0.10907182294303099}
DEMO_ITERS, DEMO_DIM = 30, 3
# Gates on those: 1e-3 absolute. The port's own float32 run on the CPU at
# full width (``python3 demo_reference.py torch``: plain K2/K3) ends 8.1e-9,
# 8.6e-9, 3.9e-8 and 2.0e-5 from them, all under 5e-4, so no gate is
# widened.
DEMO_GATES = {name: 1e-3 for name in JAX_DEMO_RELERR}
# Shear gates. bfloat16 outputs (K4's canvases, K6's U before the second
# product): an entry whose float32 value falls near a bf16 rounding
# boundary may round the other way, one bf16 step (2^-8 relative), so
# those are held to 1e-3 of the norm, not 1e-5. CGLS history: each entry
# within 1.1e-2, twice the largest distance of the JAX float32 history
# from the float64 one on these inputs (5.4e-3 at iteration 29, both on
# the CPU): past the minimum at iteration 15 float32 rounding moves the
# semiconvergence tail more than on the banded path.
BF16_RTOL, SHEAR_HISTORY_ATOL, SOLVE_GAP = 1e-3, 1.1e-2, 1e-2
# Phase 7: generate_synthetic_dynamic(**DYN, return_angles=True) and the
# dynamic demo's sequence on it, iterations as demos/demo_dynamic_ct.py
# (--iters 20: static per-frame MMGKS max(4, 20 // 4) = 5).
DYN = dict(nx=128, nt=33, views=10, noise_level=0.01)
DYN_ITERS, DYN_STATIC_ITERS, DYN_CGN_ITERS = 20, 5, 30
# The final relErrors of that sequence from trips_tpu on the CPU
# (``python3 demo_reference.py dynamic``: JAX 0.9.0, x64 off, A from the
# NumPy builder; static per-frame MMGKS over each frame's EllOperator, the
# dynamic solvers over DynamicBandedOperator.from_frames(AA, 128, angles,
# n_groups=8)), and ||b|| of its inputs.
JAX_DYN_RELERR = {"static per-frame MMGKS": 0.2276759306331221,
                  "dynamic MMGKS anisoTV": 0.23093699008263138,
                  "dynamic MMGKS isoTV": 0.21285289411831482,
                  "dynamic MMGKS GS": 0.21396484676883595,
                  "Hybrid LSQR": 0.23306440329101508}
B_DYN_NORM = 9160.875899366103
DYN_GATE = 1e-3
SHEAR_REPLACES = {
    "shear_rotate": "trips_tpu/operators/pallas_shear.py:99",
    "shear_rotate_adjoint": "trips_tpu/operators/pallas_shear.py:122",
    "gcontract_ata": "trips_tpu/operators/pallas_shear.py:183",
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
LOOP_PAIRS = 10  # parent/this pairs of the CGLS loop walls (phase 4)
# another checkout whose CGLS loops phase 4 times beside these, if present
PARENT = Path(__file__).resolve().parent / "_local" / "parent"


def bound(nbytes, flops, peak):
    """(bound_ms, bound_by): the larger of bytes over HBM_BPS and flops over
    the peak rate for their type."""
    tb, tf = nbytes / HBM_BPS * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def device_ms(fn, reps, parts=None, sessions=3, warm=True):
    """Device milliseconds per call of the kernels ``fn()`` launches, from
    ``torch.profiler`` over ``reps`` calls after one warm-up (host gaps
    between launches do not count): the median of ``sessions`` profiled
    sessions (a single session read up to 25% high now and then on an
    H100); ``parts``, if given, receives that session's milliseconds by
    kernel name. ``warm=False`` skips the warm-up call."""
    import torch
    from torch.autograd import DeviceType

    if warm:
        fn()
    torch.cuda.synchronize()
    act = [torch.profiler.ProfilerActivity.CUDA]
    runs = []
    for _ in range(sessions):
        # a session now and then records no kernel at all (on an H100, once
        # among dozens of runs, and once three sessions in a row): profile
        # again after a pause, at most six times
        for attempt in range(6):
            if attempt:
                time.sleep(0.5)
            with torch.profiler.profile(activities=act) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            # device events only: the profiler also credits a kernel that
            # an aten op launched to the op's own entry
            events = [e for e in prof.key_averages()
                      if e.self_device_time_total
                      and e.device_type == DeviceType.CUDA]
            us = sum(e.self_device_time_total for e in events)
            if us > 0:
                break
            print(f"chip_smoke: a profiler session saw no device time "
                  f"(attempt {attempt + 1})", file=sys.stderr)
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


def same_bits(a, b):
    """Whether ``a`` and ``b`` (tensors, numbers, or tuples of them) hold
    the same values to the bit."""
    import torch

    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a, b))
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(same_bits, a, b))
    return a == b


def graph_vs_eager(label, fn, probe=None):
    """``fn()`` with the port's loops replayed as CUDA graphs (the card's
    default), then stepped eagerly (``core.loop.eager``, the yardstick),
    each timed between synchronizes: the outputs must be the same to the
    bit and the K1-K6 launches the same, else the phase fails naming the
    first step that differs (``probe(k)``: ``fn`` cut to k steps; for a
    (x, lambdas) output the first lambda that differs). -> (the graph
    run's output, its seconds, the eager run's seconds, its launches)."""
    import torch

    from trips_tpu_torch.core import loop
    from trips_tpu_torch.operators import shear_kernels as sk
    from trips_tpu_torch.sparse import banded_kernels as bk

    runs = []
    for ctx in (contextlib.nullcontext, loop.eager):
        before = {**bk.launch_counts, **sk.launch_counts}
        torch.cuda.synchronize()
        t = time.perf_counter()
        with ctx():
            out = fn()
        torch.cuda.synchronize()
        now = {**bk.launch_counts, **sk.launch_counts}
        runs.append((out, time.perf_counter() - t,
                     {k: now[k] - before[k] for k in now}))
    (g, tg, lg), (e, te, le) = runs
    if not same_bits(g, e):
        where = "at the end"
        if probe is not None:
            for k in range(1, 1000):
                a = probe(k)
                with loop.eager():
                    b = probe(k)
                if not same_bits(a, b):
                    where = f"first at step {k}"
                    break
        elif isinstance(g, tuple) and len(g) == 2 and g[1].dim() == 1:
            diff = (g[1] != e[1]).nonzero()
            if len(diff):
                where = (f"first at iteration {int(diff[0]) + 1}: lambda "
                         f"{float(g[1][diff[0]])!r} against "
                         f"{float(e[1][diff[0]])!r}")
        check(False, f"{label}: the replayed loops differ from the eager "
              f"ones, {where}")
    check(lg == le, f"{label}: launches {lg} replayed, {le} eager")
    return g, tg, te, lg


def eagerly(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with the port's loops stepped eagerly."""
    from trips_tpu_torch.core import loop

    with loop.eager():
        return fn(*args, **kwargs)


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


def parent_package():
    """PARENT's package imported as ``parent_trips_tpu_torch`` (it imports
    only torch; its kernel library builds from its own ``csrc/`` into its
    checkout), or None without PARENT: -> the package's name."""
    pkg = PARENT / "trips_tpu_torch"
    if not (pkg / "krylov" / "cgls.py").exists():
        return None
    name = "parent_trips_tpu_torch"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod  # its submodules look their package up
        spec.loader.exec_module(mod)
    return name


def parent_loops():
    """{"cgls": fn, "cgls_normal": fn} of PARENT's ``krylov/cgls.py``, or
    None without PARENT."""
    name = parent_package()
    if name is None:
        return None
    mod = importlib.import_module(f"{name}.krylov.cgls")
    return {"cgls": mod.cgls, "cgls_normal": mod.cgls_normal}


def parent_banded():
    """PARENT's ``sparse/banded_kernels.py`` (its wrappers, plans, bounds
    and kernels), or None without PARENT."""
    name = parent_package()
    if name is None:
        return None
    return importlib.import_module(f"{name}.sparse.banded_kernels")


def parent_k13(pbk, adj_args, ata_args, timer):
    """K3 and K1 of PARENT (its wrappers, ``pbk``) beside this tree's on the
    same wrapper arguments (``banded_adj_buckets``'s and
    ``banded_ata_buckets``'s), each wrapper's device ms in turns (this,
    PARENT, PARENT, this; ``timer(fn)`` -> ms): -> {kernel: {"this": ms,
    "parent": ms, "rel": PARENT's output against this one's, "parent
    bitwise": whether two PARENT runs agree to the bit, "same bits":
    whether PARENT's output is this one's to the bit}}. K3 is PARENT's
    kernel; K1 walks tap spans here, which changes the cut of its stage-1
    float32 sums, so its bits may differ (PERF.md section 6)."""
    import torch

    from trips_tpu_torch.sparse import banded_kernels as bk

    runs = {"banded_adj": (lambda: bk.banded_adj_buckets(*adj_args),
                           lambda: pbk.banded_adj_buckets(*adj_args)),
            "banded_ata": (lambda: bk.banded_ata_buckets(*ata_args),
                           lambda: pbk.banded_ata_buckets(*ata_args))}
    out = {}
    for name, (this, par) in runs.items():
        got, p1, p2 = this(), par(), par()
        t = {"this": [], "parent": []}
        for label in ("this", "parent", "parent", "this"):
            t[label].append(timer(this if label == "this" else par))
        e = rel(p1, got)
        check(e <= KERNEL_RTOL, f"PARENT's {name} vs this one's: {e!r}")
        check(name != "banded_adj" or torch.equal(p1, got),
              "PARENT's K3 differs from this one's in the bits")
        out[name] = {"this": float(np.mean(t["this"])),
                     "parent": float(np.mean(t["parent"])), "rel": e,
                     "parent bitwise": torch.equal(p1, p2),
                     "same bits": torch.equal(p1, got)}
    return out


def k1_share(fn):
    """The share of the stored slabs' bytes that the K1 launches of
    ``fn()`` load (``banded_kernels.k1_bytes``: spans over stored)."""
    from trips_tpu_torch.sparse import banded_kernels as bk

    before = dict(bk.k1_bytes)
    fn()
    return ((bk.k1_bytes["spans"] - before["spans"])
            / (bk.k1_bytes["stored"] - before["stored"]))


def demo_solves(OP, bv, L, delta):
    """{name: (solve(x_true=None) -> (x, info), info -> the K2 and K3
    launches its loop implies)} for the tomography demo's solvers on
    ``OP``. GKS: golub_kahan over DEMO_DIM steps (one K3 and one K2 each),
    ``A.matmat(V)`` (one K2, the columns as its frames), then per iteration
    one K3 (the residual) and one K2 (the new column). MMGKS: the same
    set-up and one K3 for ``A.rmatvec(b)``, then per iteration two K2
    (``A x - b`` and the new column) and one K3. The hybrids count their
    own applies (``matvec_count``, half each way)."""
    from trips_tpu_torch.solvers import GKS, MMGKS, Hybrid_LSQR

    n, d = DEMO_ITERS, DEMO_DIM
    both = lambda info: (info["matvec_count"] // 2,) * 2  # noqa: E731
    return {
        "GKS dp": (lambda x_true=None: GKS(
            OP, bv, L, projection_dim=d, n_iter=n, regparam="dp",
            delta=delta, x_true=x_true), lambda info: (d + 1 + n, d + n)),
        "Hybrid LSQR dp": (lambda x_true=None: Hybrid_LSQR(
            OP, bv, n_iter=n, regparam="dp", delta=delta, reorth=True,
            x_true=x_true), both),
        "MMGKS dp": (lambda x_true=None: MMGKS(
            OP, bv, L, pnorm=2, qnorm=1, projection_dim=d, n_iter=n,
            regparam="dp", delta=delta, x_true=x_true),
            lambda info: (d + 1 + 2 * n, d + 1 + n)),
        "Hybrid LSQR gcv": (lambda x_true=None: Hybrid_LSQR(
            OP, bv, n_iter=n, x_true=x_true), both),
    }


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


def frame_args(op, X, Y):
    """K1-K3 wrapper arguments over all frames and stacks of a dynamic
    operator, as its applies call them: images ``X (nt, n, n)``, sinograms
    ``Y (nt, views, p)``."""
    XT = X.transpose(1, 2).contiguous()
    return {"banded_ata": (X, XT, op._bks, op.n_groups),
            "banded_fwd": (X, XT, op._bks, op._aidx, op.det_count,
                           op.n_groups, op.views),
            "banded_adj": (Y, op._bks, op._aidx, op.n_groups)}


def plain_copy(op):
    """``op`` with K1-K3 replaced by their plain versions."""
    from trips_tpu_torch.sparse import banded_kernels as bk

    p = copy.copy(op)
    p._fwd, p._adj = bk.banded_fwd_buckets_ref, bk.banded_adj_buckets_ref
    p._ata = bk.banded_ata_buckets_ref
    # the plain versions read the host (boolean masks): their loops step
    # eagerly
    p.capturable = False
    return p


def dynamic_path(dev, card, gen):
    """Phase 7 up to the gates: the problem, the packs, K1-K3 over frames
    against their plain versions, the operators against the host matrix,
    and the dynamic demo's solvers with their launches, relErrors and
    walls (before any profiler session). -> the state ``dynamic_times``
    measures."""
    import torch

    from trips_tpu_torch.core import BatchedBlockDiagOperator, loop
    from trips_tpu_torch.krylov import cgls_normal
    from trips_tpu_torch.krylov.cgls import _cgn_chunk, _cgn_init
    from trips_tpu_torch.operators import (CenteredSpaceTimeDerivative,
                                           FirstDerivative2D,
                                           SpaceTimeDerivative)
    from trips_tpu_torch.problems import generate_synthetic_dynamic
    from trips_tpu_torch.solvers import MMGKS, Hybrid_LSQR
    from trips_tpu_torch.sparse import (BucketedBandedProjector,
                                        BucketedDynamicBandedOperator,
                                        CsrOperator, DynamicBandedOperator)
    from trips_tpu_torch.sparse import banded_kernels as bk
    from trips_tpu_torch.sparse import tall_qr

    t0 = time.perf_counter()
    (A, b, AA, B, nx, ny, nt, delta, x_true,
     angles) = generate_synthetic_dynamic(**DYN, return_angles=True)
    check(abs(np.linalg.norm(b) - B_DYN_NORM) <= 1e-9 * B_DYN_NORM,
          f"dynamic inputs differ from the reference's: ||b|| "
          f"{np.linalg.norm(b)!r}")
    t1 = time.perf_counter()
    ops = {"flat float32": DynamicBandedOperator.from_frames(
        AA, nx, angles, n_groups=8, device=dev)}
    for kind, dt in (("float32", None), ("bfloat16", torch.bfloat16),
                     ("int8", "int8")):
        ops["bucketed " + kind] = BucketedDynamicBandedOperator.from_frames(
            AA, nx, angles, n_groups=8, dtype=dt, n_buckets=3, device=dev)
    print(f"[7] A {A.shape} nnz {A.nnz}: {nt} frames of {nx}x{nx}, "
          f"{DYN['views']} views; problem in {t1 - t0:.2f} s, 4 packs in "
          f"{time.perf_counter() - t1:.2f} s")
    for kind, op in ops.items():
        print(f"[7]   {kind}: {len(op._bks)} stacks, W "
              f"{[tuple(k[0].shape) for k in op._bks]}, {op.stored_bytes} "
              f"bytes")

    # K1-K3 over all frames and stacks in one launch, against plain
    names = tuple(REPLACES)
    max_abs = {k: 0.0 for k in names}
    for kind, op in ops.items():
        X = torch.randn(nt, op.n_pad, op.n_pad, device=dev, generator=gen)
        Y = torch.randn(nt, op.views, op.det_count, device=dev,
                        generator=gen)
        errs = {}
        for name, a in frame_args(op, X, Y).items():
            got = getattr(bk, name + "_buckets")(*a)
            ref = getattr(bk, name + "_buckets_ref")(*a)
            torch.cuda.synchronize()
            check(got.shape == ref.shape, f"{name} frames {kind} shape")
            check(torch.equal(got, getattr(bk, name + "_buckets")(*a)),
                  f"{name} frames {kind} differs from run to run")
            errs[name] = rel(got, ref)
            max_abs[name] = max(max_abs[name],
                                float((got - ref).abs().max()))
            check(errs[name] <= KERNEL_RTOL,
                  f"{name} frames {kind} rel err {errs[name]!r}")
        share = k1_share(lambda: bk.banded_ata_buckets(
            *frame_args(op, X, Y)["banded_ata"]))
        print(f"[7] {kind}, one launch over {nt} frames and "
              f"{len(op._bks)} stacks vs plain, rel err: "
              + ", ".join(f"{k} {v!r}" for k, v in errs.items())
              + f"; each bitwise the same in a second run; K1 loads "
              f"{share!r} of the stored bytes")
    f32 = ops["flat float32"]
    A64 = A.astype(np.float32).astype(np.float64)
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.standard_normal(A.shape[1]), dtype=torch.float32,
                     device=dev)
    y = torch.tensor(rng.standard_normal(A.shape[0]), dtype=torch.float32,
                     device=dev)
    xd, yd = x.double().cpu().numpy(), y.double().cpu().numpy()
    for name, got, ref in (
            ("matvec", f32.matvec(x), A64 @ xd),
            ("rmatvec", f32.rmatvec(y), A64.T @ yd),
            ("normal_matvec", f32.normal_matvec(x), A64.T @ (A64 @ xd))):
        e = rel(got.cpu(), torch.from_numpy(ref))
        print(f"[7] flat float32 {name} vs host block-diagonal CSR "
              f"(float64): rel err {e!r}")
        check(e <= KERNEL_RTOL, f"dynamic {name} vs CSR {e!r}")
    for kind, op in ops.items():
        Ax, Aty = op.matvec(x), op.rmatvec(y)
        gap = abs(float(Ax.double() @ y.double())
                  - float(x.double() @ Aty.double()))
        a = gap / float(Ax.double().norm() * y.double().norm())
        print(f"[7] {kind} adjointness {a!r}")
        check(a <= KERNEL_RTOL, f"dynamic {kind} adjointness {a!r}")
    bk.reset_launch_counts()
    f32.matvec(x)
    f32.rmatvec(y)
    f32.normal_matvec(x)
    per = dict(bk.launch_counts)
    print(f"[7] launches of one matvec, rmatvec and normal_matvec: {per}")
    check(per == {"banded_fwd": 1, "banded_adj": 1, "banded_ata": 1},
          f"dynamic: one launch per apply: {per}")
    # the shared-geometry form: frame 0's pack for every frame (weight
    # frame stride 0)
    op0 = BucketedBandedProjector.from_scipy_fan(
        AA[0], nx, None, angles=angles[0], n_groups=8, device=dev)
    blk = BatchedBlockDiagOperator(op0, nt)
    blk_plain = BatchedBlockDiagOperator(plain_copy(op0), nt)
    xb = torch.randn(blk.shape[1], device=dev, generator=gen)
    yb = torch.randn(blk.shape[0], device=dev, generator=gen)
    calls = (("matvec", xb), ("rmatvec", yb), ("normal_matvec", xb))
    bk.reset_launch_counts()
    outs = {fn: getattr(blk, fn)(v) for fn, v in calls}
    per = dict(bk.launch_counts)
    errs = {fn: rel(outs[fn], getattr(blk_plain, fn)(v)) for fn, v in calls}
    print(f"[7] BatchedBlockDiagOperator over frame 0's bucketed pack, "
          f"{nt} frames: launches {per}; vs plain, rel err {errs}")
    check(per == {"banded_fwd": 1, "banded_adj": 1, "banded_ata": 1},
          f"block diagonal: one launch per apply: {per}")
    check(max(errs.values()) <= KERNEL_RTOL, f"block diagonal {errs}")

    # the dynamic demo's sequence: counts from 0 just before, read after
    bv = torch.tensor(b, dtype=torch.float32, device=dev)
    x0 = torch.zeros(A.shape[1], dtype=torch.float32, device=dev)
    xt = torch.tensor(x_true, dtype=torch.float32, device=dev)
    xt_norm = xt.norm()
    L2 = FirstDerivative2D(nx, ny, device=dev)
    frames = [(CsrOperator.from_scipy(AA[f], dtype=torch.float32,
                                      device=dev),
               torch.tensor(B[f], dtype=torch.float32, device=dev))
              for f in range(nt)]

    def static():
        xs = [MMGKS(o, bf, L2, pnorm=2, qnorm=1, projection_dim=3,
                    n_iter=DYN_STATIC_ITERS, regparam="gcv")[0].reshape(-1)
              for o, bf in frames]
        return torch.cat(xs), None

    d, n = 4, DYN_ITERS
    kw = dict(pnorm=2, qnorm=1, projection_dim=d, n_iter=n, regparam="gcv")
    dims = dict(prob_dims=(nx, ny, nt))
    # MMGKS: golub_kahan over d steps, A.matmat(V) (a K2 per column: the
    # frame-varying pack has no column frames), A.rmatvec(b), then per
    # iteration two K2 and one K3 (chip_smoke.demo_solves); the hybrid
    # counts its own applies
    mm = lambda info: (2 * d + 2 * n, d + 1 + n)  # noqa: E731
    solves = {
        "static per-frame MMGKS": (static, lambda info: (0, 0),
                                   nt * DYN_STATIC_ITERS),
        "dynamic MMGKS anisoTV": (lambda: MMGKS(
            f32, bv, SpaceTimeDerivative(nx, ny, nt, device=dev), **kw),
            mm, n),
        "dynamic MMGKS isoTV": (lambda: MMGKS(
            f32, bv, CenteredSpaceTimeDerivative(nx, ny, nt, device=dev),
            isoTV="isoTV", **dims, **kw), mm, n),
        "dynamic MMGKS GS": (lambda: MMGKS(f32, bv, None, GS="GS", **dims,
                                           **kw), mm, n),
        "Hybrid LSQR": (lambda: Hybrid_LSQR(f32, bv, n_iter=n,
                                            regparam="gcv"),
                        lambda info: (info["matvec_count"] // 2,) * 2, n),
    }
    walls, iters, tsqr = {}, {}, {}
    bk.reset_launch_counts()
    for name, (fn, expect, its) in solves.items():
        before = dict(bk.launch_counts)
        tall_qr.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        xs, info = fn()
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t) / its * 1e3
        iters[name] = its
        got = {k: bk.launch_counts[k] - before[k] for k in before}
        want = expect(info)
        check(xs.numel() == A.shape[1] and bool(torch.isfinite(xs).all()),
              f"{name} solution")
        err = float(np.linalg.norm(xs.double().cpu().numpy().reshape(-1)
                                   - x_true) / np.linalg.norm(x_true))
        ref = JAX_DYN_RELERR[name]
        print(f"[7] {name}: relError final {err!r} (JAX CPU {ref!r}, gate "
              f"{DYN_GATE}); launches {got} (expected K2 {want[0]}, K3 "
              f"{want[1]}); wall {walls[name]!r} ms/iter ({its} "
              f"iterations, set-up included); card {card}")
        check((got["banded_fwd"], got["banded_adj"]) == want
              and got["banded_ata"] == 0, f"{name} launches {got} vs {want}")
        check(abs(err - ref) <= DYN_GATE, f"{name} final relError {err!r}")
        # every host MMGKS iteration: R of the data panel and of the
        # regularizer panel, both by tsqr_geqrf; no library QR
        tsqr[name] = dict(tall_qr.launch_counts)
        want = {"tsqr_geqrf": 2 * its if "MMGKS" in name else 0,
                "qr_library": 0}
        print(f"[7] {name}: tall QR launches {tsqr[name]} (expected "
              f"{want})")
        check(tsqr[name] == want, f"{name} tall QR launches {tsqr[name]}")
    cgn_min = {}
    for kind in ("float32", "int8"):
        op = ops["bucketed " + kind]
        before = dict(bk.launch_counts)
        s, errs = _cgn_init(op, bv, x0), []
        for it in range(1, DYN_CGN_ITERS + 1):
            s = _cgn_chunk(op, 0.0, s, it)
            errs.append(float((s.x - xt).norm() / xt_norm))
        got = {k: bk.launch_counts[k] - before[k] for k in before}
        check(bool(torch.isfinite(s.x).all()), f"cgls_normal {kind} finite")
        cgn_min[kind] = min(errs)
        print(f"[7] cgls_normal bucketed {kind}: relError final {errs[-1]!r}"
              f", min {min(errs)!r} at iteration {int(np.argmin(errs)) + 1}"
              f"; launches {got}")
        check(got == {"banded_fwd": 0, "banded_adj": 1,
                      "banded_ata": DYN_CGN_ITERS + 1},
              f"cgls_normal {kind} launches {got}")
    launches = dict(bk.launch_counts)
    d8 = abs(cgn_min["int8"] - cgn_min["float32"])
    print(f"[7] int8 vs float32 cgls_normal min relError gap {d8!r}; "
          f"launches in the dynamic path: {launches}")
    check(d8 <= INT8_ATOL, f"dynamic int8 min relError gap {d8!r}")
    check(all(v > 0 for v in launches.values()),
          "a kernel never launched in the dynamic path")
    # the loop replayed as a CUDA graph against the same loop stepped
    # eagerly: x and k to the bit, launches equal; then the walls of both
    for kind in ("float32", "bfloat16", "int8"):
        op = ops["bucketed " + kind]
        name = f"cgls_normal bucketed {kind}"
        (_, k), _, _, got = graph_vs_eager(
            f"dynamic {name}", lambda op=op: cgls_normal(op, bv, x0,
                                                         DYN_CGN_ITERS),
            lambda j, op=op: cgls_normal(op, bv, x0, j))
        wall = {}
        for how in ("graph", "eager", "eager", "graph"):
            with (loop.eager() if how == "eager"
                  else contextlib.nullcontext()):
                cgls_normal(op, bv, x0, 2)
                torch.cuda.synchronize()
                t = time.perf_counter()
                cgls_normal(op, bv, x0, DYN_CGN_ITERS)
                torch.cuda.synchronize()
            wall.setdefault(how, []).append(
                (time.perf_counter() - t) / DYN_CGN_ITERS * 1e3)
        if kind == "bfloat16":
            print(f"[7] {name}: replayed graph vs eager bitwise (k {k}, "
                  f"launches {got}); wall {wall!r} ms/iter; card {card}")
            continue
        walls[name] = float(np.mean(wall["graph"]))
        walls[name + " eager"] = float(np.mean(wall["eager"]))
        iters[name] = iters[name + " eager"] = DYN_CGN_ITERS
        solves[name] = ((lambda o: lambda: cgls_normal(
            o, bv, x0, DYN_CGN_ITERS))(op), None, DYN_CGN_ITERS)
        solves[name + " eager"] = ((lambda o: lambda: eagerly(
            cgls_normal, o, bv, x0, DYN_CGN_ITERS))(op), None,
            DYN_CGN_ITERS)
        print(f"[7] {name}: replayed graph vs eager bitwise (k {k}, "
              f"launches {got}); wall graph {walls[name]!r}, eager "
              f"{walls[name + ' eager']!r} ms/iter ({DYN_CGN_ITERS} "
              f"iterations; runs {wall!r}); card {card}")
    return dict(A=A, ops=ops, launches=launches, max_abs=max_abs,
                solves=solves, walls=walls, iters=iters, tsqr=tsqr,
                nt=nt, bv=bv,
                x_true=x_true, dims=(nx, ny, nt), AA=AA, B=B, delta=delta,
                angles=angles)


def dynamic_times(dyn, dev, card, gen):
    """Phase 7's measurements: K1-K3 per apply over all frames, their
    bounds, plain versions and the block-diagonal CSR product; each
    solver's device busy time per iteration and idle share. -> the kernel
    entries of the JSON line."""
    import torch

    from trips_tpu_torch.sparse import banded_kernels as bk

    ops, nt = dyn["ops"], dyn["nt"]
    names = tuple(REPLACES)
    ms, bounds, plain_ms, parent_ms = {}, {}, {}, {}
    parent_k = parent_banded()
    for kind, op in ops.items():
        X = torch.randn(nt, op.n_pad, op.n_pad, device=dev, generator=gen)
        Y = torch.randn(nt, op.views, op.det_count, device=dev,
                        generator=gen)
        args = frame_args(op, X, Y)
        ms[kind] = {k: device_ms((lambda f, a: lambda: f(*a))(
            getattr(bk, k + "_buckets"), args[k]), 10) for k in names}
        if parent_k is not None:
            parent_ms[kind] = parent_k13(parent_k, args["banded_adj"],
                                         args["banded_ata"],
                                         lambda f: device_ms(f, 10))
            print(f"[7] {kind} K3 and K1 over {nt} frames, this tree and "
                  f"PARENT in turns, device ms: {parent_ms[kind]}; card "
                  f"{card}")
        if kind == "flat float32":
            plain_ms = {k: device_ms((lambda f, a: lambda: f(*a))(
                getattr(bk, k + "_buckets_ref"), args[k]), 3,
                sessions=1) for k in names}
        # least bytes: the stacks (W, S, Pm, scales) and, for K2/K3, the
        # angle ids once; the images and sinograms in and out once; 2
        # flops per nonzero weight and pass
        pack = sum(nbytes(*k[:4]) for k in op._bks)
        ids = nbytes(*op._aidx)
        nz = sum(int((k[0] != 0).sum()) for k in op._bks)
        img, sino = nbytes(X), nbytes(Y)
        bounds[kind] = {
            "banded_ata": bound(pack + 2 * img, 4 * nz, F32_FLOPS),
            "banded_fwd": bound(pack + ids + img + sino, 2 * nz, F32_FLOPS),
            "banded_adj": bound(pack + ids + sino + img, 2 * nz, F32_FLOPS)}
        print(f"[7] {kind} one apply over {nt} frames ({pack} B of stacks, "
              f"{nz} nonzero weights), device ms: " + "; ".join(
                  f"{k} {ms[kind][k]!r} (bound {bounds[kind][k][0]!r}, "
                  f"{bounds[kind][k][1]})" for k in names)
              + f"; card {card}")
    print(f"[7] plain versions (flat float32, device ms): {plain_ms}")
    f32 = ops["flat float32"]
    M = dyn["A"].astype(np.float32).tocsr()
    MT = M.T.tocsr()
    (Mt, idx), (MTt, _) = library_csr(M, dev), library_csr(MT, dev)
    xv = torch.randn(M.shape[1], device=dev, generator=gen)
    yv = torch.randn(M.shape[0], device=dev, generator=gen)
    e_lib = max(rel(Mt @ xv, f32.matvec(xv)), rel(MTt @ yv, f32.rmatvec(yv)))
    check(e_lib <= KERNEL_RTOL, f"block-diagonal CSR vs the pack {e_lib!r}")
    lib_runs = {"banded_fwd": lambda: Mt @ xv, "banded_adj": lambda: MTt @ yv,
                "banded_ata": lambda: MTt @ (Mt @ xv)}
    library_ms = {k: device_ms(f, 10) for k, f in lib_runs.items()}
    print(f"[7] library: the block-diagonal float32 CSR ({idx} indices, nnz "
          f"{M.nnz}), agrees with the pack to {e_lib!r}: "
          + "; ".join(f"{k} {v!r} ms" for k, v in library_ms.items())
          + f"; card {card}")
    for name, (fn, _, its) in dyn["solves"].items():
        parts = {}
        busy = device_ms(fn, 1, parts, sessions=1) / its
        wall = dyn["walls"][name]
        top = sorted(parts.items(), key=lambda kv: -kv[1])[:5]
        print(f"[7] {name}: device busy {busy * 1e3!r} us/iter, wall "
              f"{wall * 1e3!r} us/iter, idle share {1 - busy / wall!r}; "
              f"busy by kernel (us/iter): "
              + ", ".join(f"{k} {v / its * 1e3!r}" for k, v in top)
              + f"; card {card}")
    return [{"name": k + "_frames", "route": "cuda",
             "source": "trips_tpu_torch/csrc/banded.cu",
             "replaces": REPLACES[k], "launches": dyn["launches"][k],
             "max_abs_err": dyn["max_abs"][k],
             "ms": ms["flat float32"][k], "plain_ms": plain_ms[k],
             "bound_ms": bounds["flat float32"][k][0],
             "bound_by": bounds["flat float32"][k][1],
             "library_ms": library_ms[k],
             "path": "dynamic CT, 33 frames of 128x128, 10 views",
             "storage": "flat float32",
             "ms_by_storage": {c: v[k] for c, v in ms.items()},
             "bound_ms_by_storage": {c: v[k][0] for c, v in bounds.items()},
             "library": f"block-diagonal float32 CSR "
                        f"(torch.sparse_csr_tensor, {idx} indices)",
             **({"parent_ms_by_storage": {c: v[k] for c, v in
                                          parent_ms.items()}}
                if k != "banded_fwd" and parent_ms else {})}
            for k in names]


# Phase 8: the all-on-device solvers at full width. The relError of each
# final iterate of trips_tpu's fused solvers on the CPU on the same inputs
# (``python3 demo_reference.py fused``: JAX 0.9.0, x64 off, the NumPy
# matrix builder; the static problem over JAX's EllOperator, the dynamic
# one over DynamicBandedOperator.from_frames(AA, 128, angles,
# n_groups=8)). ``lsqr`` is damped by the square root of the last lambda
# of the fused Hybrid LSQR with GCV (JAX's 5.646e-4 there, the port's own
# here).
JAX_FUSED_RELERR = {"fused GKS dp": 0.09926377213020238,
                    "fused GKS gcv": 0.10012044903752557,
                    "fused GKS l_curve": 0.10804490265535356,
                    "fused MMGKS dp": 0.09589458943181105,
                    "fused Hybrid LSQR gcv": 0.10907185704831984,
                    "fused Hybrid LSQR dp reorth": 0.10890058436136543,
                    "lsqr damped": 0.10750342137925675,
                    "fused dynamic MMGKS isoTV": 0.22415887257636444,
                    "fused dynamic MMGKS GS": 0.21321633937558807}
# The dynamic demo's float32 solves with lambda fixed (regparam_mode
# "scalar") at the last GCV lambda of JAX's float32 run above: the same
# ``demo_reference.py fused`` run, as ``FUSED_LAM_PIN`` there.
FUSED_LAM_PIN = {"isoTV": 0.003238760633394122,
                 "GS": 0.10979907959699631}
JAX_FUSED_RELERR.update({
    "fused dynamic MMGKS isoTV lambda fixed": 0.23288773468270096,
    "fused dynamic MMGKS GS lambda fixed": 0.23116693697135837})
# Where the port's float32 formula departs from JAX's, the gate is the same
# solve in float64 (``python3 demo_reference.py fused64``, x64 on), where
# the two formulas agree: (1) DP: JAX's float32 GKS/MMGKS decide whether
# DP is attainable from ||b||^2 - ||bproj||^2, a cancellation that is
# rounding noise at this width (JAX's float32 turns DP on at iteration 22,
# float64 at 19; relErrors 5.2e-4 and 1.2e-3 apart); the port sums the
# explicit residual (``solvers/fused.py`` ``_out_norm2``). (2) GCV on the
# square GKS/MMGKS pencils: JAX adds the SVD's rounding as a residual that
# is 0 in exact arithmetic and, divided by lam^2, moves lam by decades in
# float32 (tomo256x60's GKS: 1.6e-7 in float64, 0.036 in JAX's float32);
# the port drops it (``_filtered_pencil``). The JAX float32 value is
# printed beside. The dynamic GCV solves on float64 data (the applies cast
# to the float32 pack and back) hold the GCV rule there to JAX's float64.
JAX_FUSED_RELERR_F64 = {
    "fused GKS dp": 0.09874777866492965,
    "fused GKS gcv": 0.10035346173491452,
    "fused MMGKS dp": 0.09466272906649792,
    "fused Hybrid LSQR dp reorth": 0.10890057908925013,
    "fused dynamic MMGKS isoTV float64 data": 0.21295509989159797,
    "fused dynamic MMGKS GS float64 data": 0.21329556469074623}
# The demo's own float32 GCV solves on the dynamic problem are printed, not
# gated: where their lambda search stops follows the rounding (two runs on
# the card, the CPU run, JAX's float32 run each stop elsewhere; PERF.md
# section 7), so their relError does too. Their fixed-lambda runs above
# hold the float32 path to JAX.
FUSED_UNGATED = ("fused dynamic MMGKS isoTV", "fused dynamic MMGKS GS")
FUSED_GATE = 1e-3
FUSED_ITERS, FUSED_DYN_ITERS, LSQR_STEPS = 30, 20, 50
# the kill/resume runs: chunks of 10 iterations, killed after the first
FUSED_CHUNK = 10
# A resumed run repeats the uninterrupted one's operations on the same
# bytes, and K1 and K3 add in fixed point, so both kill/resume cases are
# held bit for bit (x, and the MMGKS's lambda history), as the JAX demo
# holds its own (demos/demo_fused_dynamic.py:84-87), and so are two
# uninterrupted runs.
SYNC_ITER = 10  # the iteration whose host syncs are counted


class Killed(Exception):
    pass


def count_syncs(fn):
    """Counter of "file:line" -> host syncs of ``fn()``, from
    ``torch.cuda.set_sync_debug_mode("warn")``."""
    import collections
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    root = str(Path(__file__).resolve().parent) + os.sep
    return collections.Counter(
        f"{w.filename.replace(root, '')}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))


def fused_solves(OP, bv, L, delta, dyn):
    """{name: (solve() -> (x, lams), one() -> a call that runs iteration
    SYNC_ITER, expected (K2, K3) launches or a function of the loop trace,
    iterations, the truth)} of phase 8.

    Launches: fused GKS and MMGKS as the host GKS and MMGKS ([6]): set-up
    golub_kahan over DEMO_DIM steps (a K2 and a K3 each), ``A.matmat(V0)``
    (one K2 on the banded operator; a K2 per column on the frame-varying
    dynamic one) and for MMGKS ``A.rmatvec(b)``; then per iteration GKS one
    K2 and one K3, MMGKS two K2 and one K3. The hybrids: one K2 and one K3
    per Golub-Kahan step. ``lsqr``: one K3 at set-up, one K2 and one K3 per
    enqueued step (the dropped ones too)."""
    from trips_tpu_torch.operators import CenteredSpaceTimeDerivative
    from trips_tpu_torch.solvers import fused as F

    n, d = FUSED_ITERS, DEMO_DIM

    def body_at(body, carry, start=0):
        carry = F._run(body, carry, start, SYNC_ITER)
        return lambda: body(SYNC_ITER, carry)

    def gks(mode):
        def one():
            body = F._gks_body(OP, bv, L, mode, 1.0, delta, 1.01, d, d + n)
            return body_at(body, F._gks_init(OP, bv, L, d, n))
        return (lambda: F.fused_gks(OP, bv, L, projection_dim=d, n_iter=n,
                                    regparam_mode=mode, delta=delta,
                                    device=bv.device)[:2],
                one, (d + 1 + n, d + n), n)

    def mmgks(A, b, Lm, mode, n, d, weight_mode="holder", dims=None,
              setup_k2=1, lam=1.0, profiled=True):
        def one():
            Lr = F._mmgks_regularizer(Lm, weight_mode, dims, b.device)
            body = F._mmgks_body(A, b, Lr, mode, 2.0, 1.0, 0.1, lam, delta,
                                 1.01, weight_mode, dims, d, d + n)
            return body_at(body, F._mmgks_init(A, b, Lr, d, n))
        return (lambda: F.fused_mmgks(
            A, b, Lm, pnorm=2.0, qnorm=1.0, projection_dim=d, n_iter=n,
            regparam=lam, regparam_mode=mode, delta=delta,
            weight_mode=weight_mode, prob_dims=dims, device=b.device)[:2],
            one if profiled else None,
            (d + setup_k2 + 2 * n, d + 1 + n), n)

    def hybrid(mode, reorth):
        def one():
            body, init, start = F._hybrid_lsqr_parts(OP, bv, n, mode, 1.0,
                                                     delta, 1.01, reorth)
            return body_at(body, init, start)
        return (lambda: F.fused_hybrid_lsqr(
            OP, bv, n_iter=n, regparam_mode=mode, delta=delta,
            reorth=reorth, device=bv.device), one, (n, n), n)

    out = {"fused GKS dp": gks("dp"), "fused GKS gcv": gks("gcv"),
           "fused GKS l_curve": gks("l_curve"),
           "fused MMGKS dp": mmgks(OP, bv, L, "dp", n, d),
           "fused Hybrid LSQR gcv": hybrid("gcv", False),
           "fused Hybrid LSQR dp reorth": hybrid("dp", True)}
    # the dynamic demo's solves (float32 data, GCV; profiled, not gated),
    # the same with lambda fixed, and with GCV on float64 data (the applies
    # cast it to the float32 pack and back)
    op, (nx, ny, nt) = dyn["ops"]["flat float32"], dyn["dims"]
    Ltv = CenteredSpaceTimeDerivative(nx, ny, nt, device=bv.device)
    for mode, Lm in (("isoTV", Ltv), ("GS", None)):
        for suffix, b, rule in (("", dyn["bv"], "gcv"),
                                (" lambda fixed", dyn["bv"], "scalar"),
                                (" float64 data", dyn["bv"].double(), "gcv")):
            out[f"fused dynamic MMGKS {mode}{suffix}"] = mmgks(
                op, b, Lm, rule, FUSED_DYN_ITERS, 3, mode, dyn["dims"],
                setup_k2=3, lam=FUSED_LAM_PIN[mode], profiled=not suffix)
    return out, Ltv


def fused_path(dev, card, OP, bv, L, delta, x_true, dyn):
    """Phase 8 up to the gates: each all-on-device solver at full width,
    its final relError against the JAX package's, its K1-K3 launches
    against the count its loop implies, its search loops' lengths and host
    reads, its wall per iteration (before any profiler session) and the
    host syncs of one iteration by source line; the kill/resume of the
    dynamic isoTV MMGKS and of ``cgls_normal``, bit for bit.
    -> what ``fused_times`` profiles."""
    import tempfile

    import torch

    from trips_tpu_torch.core import loop
    from trips_tpu_torch.krylov import cgls_normal, lsqr
    from trips_tpu_torch.solvers import checkpointed as C
    from trips_tpu_torch.sparse import banded_kernels as bk
    from trips_tpu_torch.utils import save_state

    lsqr_chunk = sys.modules["trips_tpu_torch.krylov.lsqr"].CHUNK
    truth = {"static": np.asarray(x_true).reshape(-1),
             "dynamic": np.asarray(dyn["x_true"]).reshape(-1)}

    def relerr(x, ref):
        x = x.double().cpu().numpy().reshape(-1)
        return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))

    solves, Ltv = fused_solves(OP, bv, L, delta, dyn)
    lam_gcv = []

    def lsqr_solve():
        damp = float(np.sqrt(lam_gcv[0]))
        x, k = lsqr(OP, bv, LSQR_STEPS, damp=damp, device=dev)
        check(k == LSQR_STEPS, f"lsqr stopped at {k}")
        return x, torch.full((1,), lam_gcv[0])

    def lsqr_launches(trace):
        reads = sum(r for name, r, _ in trace if name == "lsqr")
        return reads * lsqr_chunk, reads * lsqr_chunk + 1

    solves["lsqr damped"] = (lsqr_solve, None, lsqr_launches, LSQR_STEPS)
    walls, launches, searches, syncs, one_iter = {}, {}, {}, {}, {}
    for name, (solve, one, expect, its) in solves.items():
        ref_x = truth["dynamic" if "dynamic" in name else "static"]
        bk.reset_launch_counts()
        loop.TRACE = []
        x, lams = solve()
        torch.cuda.synchronize()
        got, trace = dict(bk.launch_counts), loop.TRACE
        loop.TRACE = None
        want = expect(trace) if callable(expect) else expect
        if name == "fused Hybrid LSQR gcv":
            lam_gcv.append(float(lams[-1]))
        torch.cuda.synchronize()
        t = time.perf_counter()
        x2, lams2 = solve()  # the wall, and a second run on the same inputs
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t) / its * 1e3
        launches[name] = got
        check(all(bool(torch.isfinite(v).all()) for v in (x, lams, x2, lams2)),
              f"{name} finite")
        errs = [relerr(v, ref_x) for v in (x, x2)]
        loops = {}
        for loop_name, reads, steps in trace:
            s = loops.setdefault(loop_name, [[], 0])
            s[0].append(int(steps))
            s[1] += reads
        searches[name] = loops
        ref = JAX_FUSED_RELERR_F64.get(name, JAX_FUSED_RELERR.get(name))
        which = ("float64" if name in JAX_FUSED_RELERR_F64 else "float32")
        f32 = JAX_FUSED_RELERR.get(name.removesuffix(" float64 data"))
        gate = ("not gated" if name in FUSED_UNGATED
                else f"gate {FUSED_GATE}")
        print(f"[8] {name}: relError final {errs[0]!r}, a second run "
              f"{errs[1]!r} (x {rel(x2, x)!r} apart) (JAX CPU {which} "
              f"{ref!r}, float32 {f32!r}; {gate}), last lambda "
              f"{float(lams[-1])!r}, second run {float(lams2[-1])!r}; "
              f"launches {got} (expected K2 {want[0]}, K3 {want[1]}); wall "
              f"{walls[name]!r} ms/iter (the second run, {its} iterations, "
              "set-up included); "
              + ("; ".join(f"{k}: {len(s)} loops, host reads {r}, steps "
                           f"{sorted(s)}" for k, (s, r) in loops.items())
                 or "no search loop") + f"; card {card}")
        check((got["banded_fwd"], got["banded_adj"]) == tuple(want)
              and got["banded_ata"] == 0, f"{name} launches {got} vs {want}")
        if name not in FUSED_UNGATED:
            check(max(abs(e - ref) for e in errs) <= FUSED_GATE,
                  f"{name} final relErrors {errs!r}")
        # the searches (and lsqr) stepped eagerly: x and every lambda the
        # replayed graphs' to the bit, the launches the same
        bk.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with loop.eager():
            xe, lamse = solve()
        torch.cuda.synchronize()
        walls[name + " eager"] = (time.perf_counter() - t) / its * 1e3
        diff = (lamse != lams).nonzero()
        check(torch.equal(xe, x) and not len(diff),
              f"{name}: the replayed searches differ from the eager ones"
              + (f", first at iteration {int(diff[0]) + 1}: lambda "
                 f"{float(lams[diff[0]])!r} against "
                 f"{float(lamse[diff[0]])!r}" if len(diff) else ", in x"))
        check(dict(bk.launch_counts) == got,
              f"{name}: eager launches {dict(bk.launch_counts)} vs {got}")
        print(f"[8] {name}: replayed graphs vs eager loops: x and the "
              f"{lams.numel()} lambdas bitwise equal, launches equal; wall "
              f"{walls[name]!r} / {walls[name + ' eager']!r} ms/iter; card "
              f"{card}")
        if name == "lsqr damped":  # over its steps
            for sfx, fn in (("", solve), (" eager", partial(eagerly, solve))):
                syncs[name + sfx] = {k: v / its for k, v in
                                     count_syncs(fn).items()}
                one_iter[name + sfx] = (fn, walls[name + sfx] * its, its)
        elif one is not None:  # iteration SYNC_ITER: syncs, then its wall
            step = one()
            for sfx, fn in (("", step), (" eager", partial(eagerly, step))):
                syncs[name + sfx] = count_syncs(fn)
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                one_iter[name + sfx] = (fn, (time.perf_counter() - t) * 1e3,
                                        1)

    # the Brent chunk as taken against a read every 8 steps (fewer dropped
    # steps, more reads) and every 72 (the eager loop's chunk until the
    # searches were replayed), in turns on iteration SYNC_ITER of the GCV
    # GKS
    regdev = sys.modules["trips_tpu_torch.regparam.device"]
    taken, step = regdev.BRENT_CHUNK, one_iter["fused GKS gcv"][0]
    chunk_walls = {}
    try:
        for chunk in (taken, 8, 72, 72, 8, taken) * 2:
            regdev.BRENT_CHUNK = chunk
            torch.cuda.synchronize()
            t = time.perf_counter()
            step()
            torch.cuda.synchronize()
            chunk_walls.setdefault(chunk, []).append(
                (time.perf_counter() - t) * 1e3)
        regdev.BRENT_CHUNK = 8
        sites8 = count_syncs(step)
    finally:
        regdev.BRENT_CHUNK = taken
    print(f"[8] fused GKS gcv, iteration {SYNC_ITER}, wall (ms) by Brent "
          f"chunk in turns: {chunk_walls!r}; host syncs with a chunk of 8: "
          f"{sum(sites8.values())} ({dict(sites8)}); card {card}")

    # kill/resume against two uninterrupted runs, all bit for bit: the
    # dynamic isoTV MMGKS with GCV on float64 data (K2, K3 over frames) and
    # cgls_normal on the bucketed float32 pack (K1)
    op, dims, bd = dyn["ops"]["flat float32"], dyn["dims"], dyn["bv"]
    tmp = tempfile.mkdtemp()

    def kill(path):
        def cb(it, **state):
            save_state(path, state)
            raise Killed
        return cb

    def killed_and_resumed(fn, path):
        try:
            fn(callback=kill(path))
        except Killed:
            pass
        else:
            check(False, "the checkpointed run was not killed")
        return fn(resume_state=path)

    mkw = dict(pnorm=2.0, qnorm=1.0, projection_dim=3, regparam_mode="gcv",
               weight_mode="isoTV", prob_dims=dims, chunk=FUSED_CHUNK)
    cop = dyn["ops"]["bucketed float32"]
    x0 = torch.zeros(cop.shape[1], dtype=torch.float32, device=dev)
    cases = {
        "fused_mmgks_checkpointed isoTV float64 data": (
            lambda n=FUSED_DYN_ITERS, **k: C.fused_mmgks_checkpointed(
                op, bd.double(), Ltv, n_iter=n, **mkw, device=dev, **k)[:2],
            "K3"),
        "cgls_normal_checkpointed bucketed float32": (
            lambda n=DYN_CGN_ITERS, **k: C.cgls_normal_checkpointed(
                cop, bd, x0, n, chunk=FUSED_CHUNK, device=dev, **k)[:1],
            "K1")}
    for name, (fn, kernels) in cases.items():
        bk.reset_launch_counts()
        full = [fn() for _ in range(2)]
        resumed = killed_and_resumed(fn, os.path.join(tmp, "state.npz"))
        got = dict(bk.launch_counts)
        launches[name] = got
        eager_run = eagerly(fn)
        check(same_bits(eager_run, full[0]),
              f"{name}: the replayed loops differ from the eager ones")
        # the scale of a fault: the same solve one iteration short
        short = fn(n=(FUSED_DYN_ITERS if name.startswith("fused")
                      else DYN_CGN_ITERS) - 1)[0]
        spread = [rel(a, b) for a, b in zip(full[1], full[0])]
        gap = [rel(a, b) for a, b in zip(resumed, full[0])]
        errs = [relerr(r[0], truth["dynamic"]) for r in full + [resumed]]
        same = [all(torch.equal(a, b) for a, b in zip(r, full[0]))
                for r in (full[1], resumed)]
        print(f"[8] {name} ({kernels}), chunks of {FUSED_CHUNK}, killed "
              f"after the first and resumed from its file: x (and lambdas) "
              f"{gap!r} from an uninterrupted run, bitwise {same[1]}; two "
              f"uninterrupted runs {spread!r} apart, bitwise {same[0]}; an "
              f"uninterrupted run with the loops stepped eagerly bitwise "
              f"equal; one "
              f"iteration short {rel(short, full[0][0])!r}; relErrors "
              f"{errs!r}; launches of the four runs {got}; card {card}")
        check(all(r.shape == f.shape for r, f in zip(resumed, full[0])),
              f"{name} resumed shapes")
        check(same[0], f"{name}: two uninterrupted runs differ {spread!r}")
        check(same[1], f"{name}: kill/resume differs {gap!r}")
    cgn = launches["cgls_normal_checkpointed bucketed float32"]
    # per run one K3 (A^T b) and one K1 at set-up, one K1 per iteration;
    # the killed run sets up and runs one chunk, the resumed one the rest
    check(cgn == {"banded_fwd": 0, "banded_adj": 3,
                  "banded_ata": 3 + 3 * DYN_CGN_ITERS},
          f"cgls_normal_checkpointed launches {cgn}")
    for name, sites in syncs.items():
        which = ("the mean over its steps" if name == "lsqr damped"
                 else f"iteration {SYNC_ITER}")
        print(f"[8] {name}: {sum(sites.values())!r} host syncs per "
              f"iteration ({which}), by line: "
              + ", ".join(f"{k} {v!r}" for k, v in sorted(
                  sites.items(), key=lambda kv: -kv[1])))
    return dict(walls=walls, launches=launches, searches=searches,
                syncs=syncs, one_iter=one_iter)


def fused_times(fused, card, host_walls):
    """Phase 8's profiles: the device busy time of iteration SYNC_ITER of
    each solver (``lsqr``: of a whole solve, per step) against its wall
    time in [8] (before any profiler session), the idle share, and the
    host-driven solver's wall per iteration in [6]/[7] beside."""
    for name, (step, wall, its) in fused["one_iter"].items():
        parts = {}  # each ran in [8]: no warm-up
        busy = device_ms(step, 1, parts, sessions=1, warm=False) / its
        wall = wall / its
        top = sorted(parts.items(), key=lambda kv: -kv[1])[:6]
        host = host_walls.get(name)
        print(f"[8] {name}, iteration {SYNC_ITER if its == 1 else 'mean'}: "
              f"device busy {busy * 1e3!r} us, wall {wall * 1e3!r} us, "
              f"idle share {1 - busy / wall!r}; the whole solve "
              f"{fused['walls'][name] * 1e3!r} us/iter"
              + (f" (host-driven {host[0]}: {host[1] * 1e3!r} us/iter)"
                 if host else "")
              + "; busy by kernel (us): "
              + ", ".join(f"{k} {v / its * 1e3!r}" for k, v in top)
              + f"; card {card}")


# Phase 9: deblurring. The final relError of each solve and its lambda (k
# for TSVD/TGSVD) from trips_tpu on the CPU on the same inputs (``python3
# demo_reference.py deblur``: JAX 0.9.0, x64 off, float32, as the demos run):
# the 1D demo (demos/demo_1d_deblurring.py, n = 200), the 2D demo with
# --large (demos/demo_2d_deblurring.py: 128x128, 9x9 PSF of spread (3, 3),
# 1% noise), demos/demo_fused_tpu.py --config deblur1d, and
# fused_hybrid_gmres on the 2D inputs. The same run solved again on b
# perturbed by one float32 unit: every final relError moved by at most
# 2.7e-4 (1D GKS dp; 2D GKS gcv 2.0e-4, the rest under 1e-4).
JAX_DEBLUR = {
    "1D TSVD dp": (0.02009361299742136, 10),
    "1D TGSVD dp": (0.02158552110260634, 8),
    "1D Tikhonov dp": (0.026406024557281627, 0.00757343463000616),
    "1D Hybrid GMRES dp": (0.0280225852528115, 0.014763195530528381),
    "1D Hybrid LSQR dp": (0.028009884393942166, 0.01495456993071462),
    "1D GKS dp": (0.032951894158374, 6.920111308628002),
    "2D Arnoldi-Tikhonov dp": (0.23538614945619546, 0.0),
    "2D Hybrid GMRES gcv": (0.17869259320625058, 1.0006149509305106e-09),
    "2D Hybrid LSQR gcv": (0.18204715128369964, 1.340666875926213e-07),
    "2D GKS gcv": (0.29352282708106026, 0.0458646847321257),
    "2D MMGKS derivative": (0.10051751146262866, 5.770718407811954e-06),
    "2D MMGKS framelet": (0.2447749805402716, 0.0014760074938362415),
    "fused GKS gcv": (0.02438090327812814, 0.195791557431221),
    "fused GKS dp": (0.033391713771796006, 7.204313278198242),
    "fused GKS l_curve": (0.02273225973608446, 0.40442126989364624),
    "fused MMGKS gcv": (0.06398963097327078, 8.664673600833339e-08),
    "fused Hybrid LSQR gcv": (0.027720378021863532, 0.00015439138223882765),
    "fused Hybrid GMRES gcv": (0.1786938008298547, 1.0284332274679286e-09),
    "fused Hybrid GMRES dp": (0.1891553497506163, 0.001293584005907178),
    "fused Hybrid GMRES dp reorth": (0.18603758610651136,
                                     0.001137923332862556)}
# The same solves in float64 (``python3 demo_reference.py deblur64``).
JAX_DEBLUR_F64 = {
    "1D TSVD dp": (0.02009361483514318, 10),
    "1D TGSVD dp": (0.021585528324448097, 8),
    "1D Tikhonov dp": (0.02640587057327337, 0.007573434874779871),
    "1D Hybrid GMRES dp": (0.028022580806398828, 0.014763208214592148),
    "1D Hybrid LSQR dp": (0.028009931571351933, 0.01495457443184726),
    "1D GKS dp": (0.03305426610211628, 6.947890989435142),
    "2D Arnoldi-Tikhonov dp": (0.23538664396694822, 0.0),
    "2D Hybrid GMRES gcv": (0.17869161124117605, 1.0006149509305106e-09),
    "2D Hybrid LSQR gcv": (0.18204716035195437, 1.3406341047994785e-07),
    "2D GKS gcv": (0.29309505402083696, 0.04428235033446651),
    "2D MMGKS derivative": (0.10051739410696829, 5.773403058251213e-06),
    "2D MMGKS framelet": (0.24477489224898893, 0.0014760069038536557),
    "fused GKS gcv": (0.02413897961447105, 0.21890380720875488),
    "fused GKS dp": (0.033375952099002654, 7.19900077631172),
    "fused GKS l_curve": (0.022732235866152, 0.40440578466091476),
    "fused MMGKS gcv": (0.06404665851725166, 1.0005676191838169e-09),
    "fused Hybrid LSQR gcv": (0.02772029215128685, 0.00015448119673151662),
    "fused Hybrid GMRES gcv": (0.17869161124117794, 1.0006149509305106e-09),
    "fused Hybrid GMRES dp": (0.18603780116982013, 0.0011379321543933101),
    "fused Hybrid GMRES dp reorth": (0.18603780117493912,
                                     0.0011379321546462831)}
# Float32 solves held to JAX's float64 run, JAX's float32 value printed
# beside. (1) fused GKS with DP: the port's fused solvers depart from JAX's
# float32 formulas in DP's energy and in GCV on a square pencil (section
# 8's comment; ROADMAP Queue 3 item 11, a deliberate departure). (2)
# fused_hybrid_gmres with DP and no reorthogonalization: its float32
# Arnoldi basis loses orthogonality and the DP test runs on it as
# computed, so each float32 implementation ends elsewhere (JAX 0.18916,
# the port on the CPU 0.18179, on the card 0.18605), and one float32 unit
# on b moves none of them by 1e-5: there is no float32 answer to hold it
# to. With reorthogonalization all three land on float64's 0.18604
# (``demo_reference.py deblur_probe``), and that solve is held to JAX's
# float32 run (ROADMAP Queue 3 item 14).
DEBLUR_F64_GATED = ("fused GKS dp", "fused Hybrid GMRES dp")
# ||b|| of the 1D and 2D inputs (float64, host), to prove they are the same
B_DEBLUR_NORMS = (13.582971804957891, 46.817882130486936)
DEBLUR_GATE, DEBLUR_ITERS, DEBLUR_DIM = 1e-3, 30, 3
FRAMELET_ITERS, AT_ITERS, FUSED1D_ITERS, FUSED1D_HYB_ITERS = 15, 8, 15, 20
# float32 applies against float64 on the card, and float64 against scipy
# on the host (the reference's own calls): relative norms
BLUR_F32, BLUR_F64 = 1e-6, 1e-12
DEBLUR_COLS = 8  # columns of the timed and profiled matmat


def deblur_problems(dev, dtype):
    """The inputs of ``demo_reference.py deblur`` through the port's
    problems on ``dev``: (1D dict, 2D dict), operators in ``dtype``."""
    import torch

    from trips_tpu_torch.operators import first_derivative_matrix
    from trips_tpu_torch.problems import Deblurring1D, Deblurring2D

    np.random.seed(0)
    n = 200
    prob = Deblurring1D(device=dev, dtype=dtype)
    A = prob.forward_Op_1D(parameter=10.0, nx=n)
    x1 = prob.gen_xtrue(n, "curve0")
    b1, delta1 = prob.add_noise(prob.gen_data(x1, parameter=10.0),
                                "Gaussian", 0.02)
    A_dense = A.mat.cpu().numpy()
    delta_total = float(np.linalg.norm(b1.reshape(-1) - A_dense @ x1))
    np.random.seed(0)
    prob2 = Deblurring2D(device=dev, dtype=dtype)
    A2 = prob2.forward_Op([9, 9], (3, 3), 128, 128)
    x2 = prob2.gen_true("h_im", nx=128, ny=128)
    b2, delta2 = prob2.add_noise(prob2.gen_data(x2.reshape(-1, 1)),
                                 "Gaussian", 0.01)
    one = dict(A=A, A_dense=A_dense, x=x1, b=b1, delta=float(delta1),
               delta_total=delta_total,
               bt=torch.tensor(b1.reshape(-1), dtype=dtype, device=dev),
               L_sq=np.vstack([first_derivative_matrix(n).toarray(),
                               np.zeros((1, n))]), n=n)
    two = dict(A=A2, x=x2.reshape(-1), b=b2, delta=float(delta2),
               bt=torch.tensor(b2.reshape(-1), dtype=dtype, device=dev))
    return one, two


def deblur_solves(dev, p1, p2):
    """{name: (problem, iterations, solve() -> (x, lambda or k), one)} of
    phase 9 on the inputs ``p1``, ``p2``, as ``demo_reference.py deblur``
    runs them; ``one`` (the fused solvers; else None) makes a call that
    runs iteration SYNC_ITER, whose profile stands for the solve's (a
    whole fused solve is ~10^5 small launches: minutes to profile)."""
    from trips_tpu_torch.operators import (FirstDerivative1D,
                                           FirstDerivative2D,
                                           FrameletOperator)
    from trips_tpu_torch.solvers import (GKS, MMGKS, Arnoldi_Tikhonov,
                                         Hybrid_GMRES, Hybrid_LSQR, Tikhonov,
                                         tGSVD_sol, tSVD_sol)
    from trips_tpu_torch.solvers import fused as F

    its, d = DEBLUR_ITERS, DEBLUR_DIM
    A, A2, b, b2 = p1["A"], p2["A"], p1["bt"], p2["bt"]
    L1 = FirstDerivative1D(p1["n"], device=dev)
    L2 = FirstDerivative2D(128, 128, device=dev)
    W = FrameletOperator(128, 128, 2, dtype=b2.dtype, device=dev)
    Ad, d1, d2 = p1["A_dense"], p1["delta"], p2["delta"]

    def info(out):
        return out[0], out[1]["regParam"]

    def last(out):  # the fused solvers: the whole lambda history
        return out[0], out[1]

    out = {
        "1D TSVD dp": (1, 1, lambda: tSVD_sol(
            Ad, p1["b"], regparam="dp", delta=d1, device=dev)),
        "1D TGSVD dp": (1, 1, lambda: tGSVD_sol(
            Ad, p1["L_sq"], p1["b"], regparam="dp", delta=d1, device=dev)),
        "1D Tikhonov dp": (1, 1, lambda: Tikhonov(
            Ad, p1["b"], np.eye(p1["n"]), regparam="dp", delta=d1,
            device=dev)),
        "1D Hybrid GMRES dp": (1, its, lambda: info(Hybrid_GMRES(
            A, b, n_iter=its, regparam="dp", delta=p1["delta_total"],
            reorth=True))),
        "1D Hybrid LSQR dp": (1, its, lambda: info(Hybrid_LSQR(
            A, b, n_iter=its, regparam="dp", delta=p1["delta_total"],
            reorth=True))),
        "1D GKS dp": (1, its, lambda: info(GKS(
            A, b, L1, projection_dim=d, n_iter=its, regparam="dp",
            delta=d1))),
        "2D Arnoldi-Tikhonov dp": (2, AT_ITERS, lambda: Arnoldi_Tikhonov(
            A2, b2, n_iter=AT_ITERS, regparam="dp", delta=d2)),
        "2D Hybrid GMRES gcv": (2, its, lambda: info(Hybrid_GMRES(
            A2, b2, n_iter=its, regparam="gcv"))),
        "2D Hybrid LSQR gcv": (2, its, lambda: info(Hybrid_LSQR(
            A2, b2, n_iter=its, regparam="gcv"))),
        "2D GKS gcv": (2, its, lambda: info(GKS(
            A2, b2, L2, projection_dim=d, n_iter=its, regparam="gcv"))),
        "2D MMGKS derivative": (2, its, lambda: info(MMGKS(
            A2, b2, L2, pnorm=2, qnorm=1, projection_dim=d, n_iter=its,
            regparam="gcv"))),
        "2D MMGKS framelet": (2, FRAMELET_ITERS, lambda: info(MMGKS(
            A2, b2, W, pnorm=2, qnorm=1, projection_dim=d,
            n_iter=FRAMELET_ITERS, regparam="gcv")))}
    out = {k: v + (None,) for k, v in out.items()}

    def body_at(body, carry, start=0):
        carry = F._run(body, carry, start, SYNC_ITER)
        return lambda: body(SYNC_ITER, carry)

    n = FUSED1D_ITERS
    for mode in ("gcv", "dp", "l_curve"):
        out[f"fused GKS {mode}"] = (1, n, lambda mode=mode: last(F.fused_gks(
            A, b, L1, projection_dim=d, n_iter=n, regparam_mode=mode,
            delta=d1, device=dev)[:2]), lambda mode=mode: body_at(
            F._gks_body(A, b, L1, mode, 1.0, d1, 1.01, d, d + n),
            F._gks_init(A, b, L1, d, n)))
    out["fused MMGKS gcv"] = (1, n, lambda: last(F.fused_mmgks(
        A, b, L1, pnorm=2.0, qnorm=1.0, projection_dim=d, n_iter=n,
        regparam_mode="gcv", device=dev)[:2]), lambda: body_at(
        F._mmgks_body(A, b, L1, "gcv", 2.0, 1.0, 0.1, 1.0, 0.0, 1.01,
                      "holder", None, d, d + n),
        F._mmgks_init(A, b, L1, d, n)))
    nh = FUSED1D_HYB_ITERS
    out["fused Hybrid LSQR gcv"] = (1, nh, lambda: last(F.fused_hybrid_lsqr(
        A, b, n_iter=nh, regparam_mode="gcv", device=dev)), lambda: body_at(
        *F._hybrid_lsqr_parts(A, b, nh, "gcv", 1.0, 0.0, 1.01, False)))
    for mode, reorth in (("gcv", False), ("dp", False), ("dp", True)):
        out[f"fused Hybrid GMRES {mode}" + " reorth" * reorth] = (
            2, its, lambda mode=mode, reorth=reorth: last(
                F.fused_hybrid_gmres(A2, b2, n_iter=its, regparam_mode=mode,
                                     delta=d2, reorth=reorth, device=dev)),
            lambda mode=mode, reorth=reorth: body_at(*F._hybrid_gmres_parts(
                A2, b2, its, mode, 1.0, d2, 1.01, reorth)))
    return out


def deblur_operators(dev, card, gen):
    """Phase 9's operator checks: Blur1D (n = 200), Blur2D (128x128, the
    9x9 PSF and an even 4x6 one) and FrameletOperator(128, 128, 2), float32
    against float64 on the card and float64 against scipy on the host, the
    flipped-PSF rmatvec, the framelet's tight frame and adjointness, one
    conv2d per column apply; device us per apply against the bytes bound.
    -> {operator: device us per matvec}."""
    import torch
    from scipy.ndimage import convolve, convolve1d

    from trips_tpu_torch.operators import Blur1D, Blur2D, FrameletOperator

    f32, f64 = torch.float32, torch.float64
    ops = {
        "Blur1D n=200": lambda dt: Blur1D(200, 10.0, dtype=dt, device=dev),
        "Blur2D 128x128 9x9": lambda dt: Blur2D([9, 9], (3, 3), 128, 128,
                                                dtype=dt, device=dev),
        "Blur2D 128x128 4x6": lambda dt: Blur2D([4, 6], (1.0, 2.0), 128,
                                                128, dtype=dt, device=dev),
        "FrameletOperator(128, 128, 2)": lambda dt: FrameletOperator(
            128, 128, 2, dtype=dt, device=dev)}
    us = {}
    for name, make in ops.items():
        o32, o64 = make(f32), make(f64)
        m, n = o64.shape
        x = torch.rand(n, dtype=f64, device=dev, generator=gen)
        y = torch.rand(m, dtype=f64, device=dev, generator=gen)
        X = torch.rand(n, DEBLUR_COLS, dtype=f64, device=dev, generator=gen)
        Y = torch.rand(m, DEBLUR_COLS, dtype=f64, device=dev, generator=gen)
        errs = {}
        for meth, arg in (("matvec", x), ("rmatvec", y), ("matmat", X),
                          ("rmatmat", Y)):
            ref = getattr(o64, meth)(arg)
            errs[meth] = rel(getattr(o32, meth)(arg.float()), ref)
        xh, yh = x.cpu().numpy(), y.cpu().numpy()
        if name.startswith("Blur1D"):
            host = {"matvec": convolve1d(xh, o64.psf, mode="reflect"),
                    "rmatvec": convolve1d(yh, o64.psf[::-1], mode="reflect")}
        elif name.startswith("Blur2D"):
            psf = o64.psf.cpu().numpy()
            host = {"matvec": convolve(xh.reshape(128, 128), psf,
                                       mode="reflect").reshape(-1),
                    "rmatvec": convolve(yh.reshape(128, 128),
                                        psf[::-1, ::-1],
                                        mode="reflect").reshape(-1)}
        else:
            Wn = o64.Wn.cpu().numpy()
            s = 5  # 2 l + 1
            host = {"matvec": (Wn @ xh.reshape(128, 128, order="F") @ Wn.T)
                    .reshape(-1, order="F"),
                    "rmatvec": (Wn.T @ yh.reshape(128 * s, 128 * s,
                                                  order="F") @ Wn)
                    .reshape(-1, order="F")}
        vs_host = {k: rel(getattr(o64, k)(a).cpu(), torch.from_numpy(v))
                   for k, v, a in ((k, v, x if k == "matvec" else y)
                                   for k, v in host.items())}
        extra = ""
        if name.startswith("Frame"):
            adj = abs(float(o64.matvec(x) @ y - x @ o64.rmatvec(y))) / abs(
                float(o64.matvec(x) @ y))
            tight = rel(o64.rmatvec(o64.matvec(x)), x)
            eye = float((o64.Wn.T @ o64.Wn - torch.eye(
                128, dtype=f64, device=dev)).abs().max())
            extra = (f"; adjointness {adj!r}, ||W^T W x - x|| / ||x|| "
                     f"{tight!r}, max |Wn^T Wn - I| {eye!r}")
            check(adj <= BLUR_F64 and tight <= BLUR_F64 and eye <= BLUR_F64,
                  f"{name} tight frame")
        else:
            key = "aten::conv2d" if name.startswith("Blur2D") else \
                "aten::matmul"
            o32.matmat(X.float())
            convs = {}
            for meth in ("matmat", "rmatmat"):
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU]) as prof:
                    getattr(o32, meth)((X if meth == "matmat" else Y).float())
                convs[meth] = sum(e.count for e in prof.key_averages()
                                  if e.key == key)
            extra = (f"; {key} calls per column apply of {DEBLUR_COLS} "
                     f"columns: {convs}")
            check(all(v == 1 for v in convs.values()),
                  f"{name} one {key} per column apply")
        xs = x.float()
        t_vec = device_ms(lambda: o32.matvec(xs), 50) * 1e3
        Xs = X.float()
        t_mat = device_ms(lambda: o32.matmat(Xs), 50) * 1e3
        # what one matvec reads besides x: the matrix, the flipped PSF, or
        # the two analysis matrices; and its multiply-adds
        leaves = [getattr(o32, a) for a in ("mat", "_fwd_w", "Wn", "Wm")
                  if hasattr(o32, a)]
        if name.startswith("Blur1D"):
            flops = 2 * n * n
        elif name.startswith("Blur2D"):
            flops = 2 * o32.psf.numel() * n
        else:
            rn = o32.Wn.shape[0]
            flops = 2 * (rn * 128 * 128 + rn * 128 * rn)
        bnd = bound(nbytes(xs, o32.matvec(xs), *leaves), flops, F32_FLOPS)
        us[name] = t_vec
        print(f"[9] {name}: float32 against float64 (card) {errs!r} (limit "
              f"{BLUR_F32}); float64 against scipy / NumPy (host) "
              f"{vs_host!r} (limit {BLUR_F64}){extra}; float32 device "
              f"{t_vec!r} us per matvec, {t_mat!r} us per matmat of "
              f"{DEBLUR_COLS}; bound {bnd[0] * 1e3!r} us per matvec "
              f"({bnd[1]}); "
              f"card {card}")
        check(all(v <= BLUR_F32 for v in errs.values()),
              f"{name} float32 against float64 {errs!r}")
        check(all(v <= BLUR_F64 for v in vs_host.values()),
              f"{name} against the host {vs_host!r}")
    return us


def deblur_path(dev, card, gen):
    """Phase 9: the deblurring operators, then every solve of the 1D, 2D
    and fused deblurring demos and fused_hybrid_gmres on the card in
    float32, each final relError held to DEBLUR_GATE of the JAX package's
    (float64 for DEBLUR_F64_GATED), TSVD/TGSVD k equal to JAX's; a second
    run for the wall per iteration, then its device busy time per
    iteration and idle share. No K1-K6 launch on this path."""
    import torch

    from trips_tpu_torch.sparse import banded_kernels as bk

    t0 = time.perf_counter()
    op_us = deblur_operators(dev, card, gen)
    p1, p2 = deblur_problems(dev, torch.float32)
    norms = (float(np.linalg.norm(p1["b"])), float(np.linalg.norm(p2["b"])))
    check(all(abs(a - b) <= 1e-12 * b for a, b in zip(norms, B_DEBLUR_NORMS)),
          f"deblurring inputs ||b|| {norms}")
    solves = deblur_solves(dev, p1, p2)
    truth = {1: p1["x"], 2: p2["x"]}
    walls = {}
    bk.reset_launch_counts()
    for name, (which, its, solve, one) in solves.items():
        errs, pars, hist, outs = [], [], None, []
        for run in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            x, par = solve()
            torch.cuda.synchronize()
            outs.append((x, par))
            if run:
                walls[name] = (time.perf_counter() - t) / its * 1e3
            check(bool(torch.isfinite(x).all()), f"{name} finite")
            xh = x.double().cpu().numpy().reshape(-1)
            errs.append(float(np.linalg.norm(xh - truth[which])
                              / np.linalg.norm(truth[which])))
            if isinstance(par, torch.Tensor):
                hist = par.double().cpu().numpy()
                par = hist[-1]
            pars.append(float(par))
        f64 = name in DEBLUR_F64_GATED
        ref, ref_par = (JAX_DEBLUR_F64 if f64 else JAX_DEBLUR)[name]
        print(f"[9] {name}: relError final {errs[0]!r}, a second run "
              f"{errs[1]!r} (JAX CPU {'float64' if f64 else 'float32'} "
              f"{ref!r}, float32 {JAX_DEBLUR[name][0]!r}, float64 "
              f"{JAX_DEBLUR_F64[name][0]!r}; gate {DEBLUR_GATE}); "
              f"{'k' if 'SVD' in name else 'lambda'} {pars[0]!r}, second "
              f"run {pars[1]!r} (JAX {ref_par!r})"
              + ("" if hist is None else
                 f", the last five {hist[-5:].tolist()!r}")
              + f"; wall {walls[name]!r} ms/iter (the second run, {its} "
              f"iterations, set-up included); card {card}")
        check(max(abs(e - ref) for e in errs) <= DEBLUR_GATE,
              f"{name} final relErrors {errs!r}")
        if one is not None:  # the fused solvers' searches, stepped eagerly
            torch.cuda.synchronize()
            t = time.perf_counter()
            xe, lamse = eagerly(solve)
            torch.cuda.synchronize()
            walls[name + " eager"] = (time.perf_counter() - t) / its * 1e3
            xg, lams0 = outs[0]
            diff = (lamse != lams0).nonzero()
            check(torch.equal(xe, xg) and not len(diff),
                  f"{name}: the replayed searches differ from the eager "
                  "ones" + (f", first at iteration {int(diff[0]) + 1}"
                            if len(diff) else ", in x"))
            print(f"[9] {name}: replayed graphs vs eager searches: x and the "
                  f"{lams0.numel()} lambdas bitwise equal; wall "
                  f"{walls[name]!r} / {walls[name + ' eager']!r} ms/iter; "
                  f"card {card}")
        if "SVD" in name:
            check(pars == [ref_par] * 2, f"{name} k {pars} vs {ref_par}")
        # its profile right after its runs (a profile of the first solve
        # after all of them saw no device time on an H100, six times over);
        # the fused solvers' of iteration SYNC_ITER against its own wall
        profiled = [("", solve, walls[name], its)]
        if one is not None:
            step = one()
            profiled = []
            for how, fn in (("", step), (" eager", partial(eagerly, step))):
                fn()
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                profiled.append((how, fn, (time.perf_counter() - t) * 1e3, 1))
        for how, step, wall, per in profiled:
            parts = {}
            busy = device_ms(step, 1, parts, sessions=1, warm=False) / per
            top = sorted(parts.items(), key=lambda kv: -kv[1])[:5]
            syncs = ("" if one is None else
                     f"; host syncs {sum(count_syncs(step).values())}")
            print(f"[9] {name}{how}"
                  + ("" if one is None else f", iteration {SYNC_ITER}")
                  + f": device busy {busy * 1e3!r} us/iter, wall "
                  f"{wall * 1e3!r} us/iter, idle share "
                  f"{1 - busy / wall!r}{syncs}; busy by kernel (us/iter): "
                  + ", ".join(f"{k} {v / per * 1e3!r}" for k, v in top)
                  + f"; card {card}")
    launched = dict(bk.launch_counts)
    check(not any(launched.values()), f"K1-K3 launched in [9]: {launched}")
    print(f"[9] deblurring took {time.perf_counter() - t0:.1f} s (device us "
          f"per float32 matvec: {op_us!r}); card {card}")


# Phase 10: the streamed out-of-core operator and the batched per-frame
# solve on the dynamic problem of 7. The JAX package's results on the same
# inputs on the CPU: ``python3 demo_reference.py streamed`` (JAX 0.9.0, x64
# off, the NumPy matrix builder; each frame a float32
# BucketedBandedProjector.from_scipy_fan(AA[t], 128, None, angles[t],
# n_groups=8, n_buckets=3), cgls_normal_streamed from 0 for 20 iterations)
# and ``python3 demo_reference.py batched`` (x64 on: the frames' float64
# ELL tables, FirstDerivative2D(128, 128), fused MMGKS with GCV and fused
# GKS with DP at delta / nt, projection_dim 3, 10 iterations), each
# frame's final relError.
STREAMED_ITERS, BATCHED_ITERS = 20, 10
JAX_STREAMED_RELERR = 0.23306438067066026
JAX_BATCHED_RELERR = {
    "mmgks gcv": [
        0.21291280099094884, 0.2145380284519402, 0.2295817193394661,
        0.23457358569985987, 0.214777305873512, 0.23028672237295983,
        0.22976820312255364, 0.22870947939103192, 0.2301333293889392,
        0.22637217606838608, 0.23177180217946364, 0.230282931583593,
        0.22822104954602948, 0.20803410478600703, 0.2087698513625462,
        0.228924323472978, 0.2288977774868922, 0.22969357812695512,
        0.22826937463308836, 0.23152386803001673, 0.22931945439526347,
        0.22836087701377783, 0.20948524572422272, 0.21096442674098068,
        0.21037178454251573, 0.2116026666222667, 0.21445926643885255,
        0.23723111254146018, 0.2368909113799607, 0.23406196542186541,
        0.23359445230818285, 0.23474988553482906, 0.2135134020511134],
    "gks dp": [
        0.23428223448408803, 0.23575078810576597, 0.23477553313204005,
        0.23597052388094297, 0.2348697366341416, 0.2341928613284178,
        0.23226371569592924, 0.23148930222215652, 0.23037723830855147,
        0.22941205385877247, 0.2319029608485643, 0.2305182990207679,
        0.23102910820550343, 0.2319089455332122, 0.2318135414899473,
        0.22969560358995186, 0.22982040870870046, 0.2313833545963429,
        0.23125472787899728, 0.23221836869170528, 0.23019690795741574,
        0.2294128579600287, 0.2317289203666281, 0.2335578958678458,
        0.23223600782753032, 0.2338221072175272, 0.23604130953144106,
        0.240316337672825, 0.23814838408082425, 0.23972631053619153,
        0.23761370242165328, 0.23581675276029704, 0.23471016379859633]}
# Gates: the streamed rmatvec bitwise the resident operator's of 7 (K3
# adds the same terms at the same fixed-point scale: a frame's bound is its
# matrix's whatever the packing, and max|y| is the frame's), the streamed
# normal_matvec within STREAM_RTOL of it (K1's stage 1 sums each row in
# its own packing's order: the frame's pack has other buckets than the
# dynamic one); the CGLS and batched final relErrors against JAX's
# as in 7; the memory an apply holds (bytes requested, since operator
# construction): the two slots, K1's resident tap spans (one copy a frame),
# the output and STREAM_SLACK_IMAGES float32 images of n_pad^2 (a frame's
# images and sinograms and the resident angle ids, far below one slab).
STREAM_RTOL, STREAM_GATE, BATCHED_GATE = 1e-6, 1e-3, 1e-3
STREAM_SLACK_IMAGES = 16
SLOW_CYCLES = 2_000_000  # torch.cuda._sleep before each frame: ~1 ms
# the streamed CGLS's Chrome traces (git-ignored)
TRACE_DIR = Path(__file__).resolve().parent / "trips_tpu_trace" / "streamed"


def enqueue_ms(fn, reps=10):
    """Mean host milliseconds of a call of ``fn()`` until it returns (its
    device work still running), each call on an idle device."""
    import torch

    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t)
        torch.cuda.synchronize()
    return float(np.mean(ts)) * 1e3


def requested_bytes(dev, which):
    """The caching allocator's "current" or "peak" bytes requested on
    ``dev`` (its allocated bytes, but before the rounding up to a cached
    block, which depends on what the cache held)."""
    import torch

    return torch.cuda.memory_stats(dev)[f"requested_bytes.all.{which}"]


def trace_busy_ms(path):
    """(kernels, copies, either) of a Chrome trace: the milliseconds the
    union of its device intervals covers."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]

    def union(cats):
        iv = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") in cats and "dur" in e)
        total, end = 0.0, -np.inf
        for a, b in iv:
            if b > end:
                total += b - max(a, end)
                end = b
        return total / 1e3

    return (union({"kernel"}), union({"gpu_memcpy", "gpu_memset"}),
            union({"kernel", "gpu_memcpy", "gpu_memset"}))


def streamed_path(dev, card, dyn):
    """Phase 10, the streamed operator: the frames of 7 packed on the host
    (float32, int8), streaming forced; launches, bitwise and resident
    gates, the two-slot memory bound, backpressure, the walls against the
    upload and compute alone, ``cgls_normal_streamed`` against JAX's.
    -> K1-K3 launches of the streamed path."""
    import torch

    from trips_tpu_torch.parallel import (StreamedDynamicBandedOperator,
                                          cgls_normal_streamed)
    from trips_tpu_torch.sparse import BucketedBandedProjector
    from trips_tpu_torch.sparse import banded_kernels as bk
    from trips_tpu_torch.utils import telemetry

    AA, angles, nt = dyn["AA"], dyn["angles"], dyn["nt"]
    nx = dyn["dims"][0]
    bv, xt = dyn["bv"], torch.tensor(dyn["x_true"], dtype=torch.float32,
                                     device=dev)
    A64 = dyn["A"].astype(np.float32).astype(np.float64)
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal(A64.shape[1]), dtype=torch.float32,
                     device=dev)
    y = torch.tensor(rng.standard_normal(A64.shape[0]), dtype=torch.float32,
                     device=dev)
    x0 = torch.zeros_like(x)
    launches = {k: 0 for k in bk.launch_counts}
    hist = {}
    for kind, dt in (("float32", None), ("int8", "int8")):
        t0 = time.perf_counter()
        frames = [BucketedBandedProjector.from_scipy_fan(
            AA[t], nx, None, angles=angles[t], n_groups=8, n_buckets=3,
            dtype=dt, device="cpu") for t in range(nt)]
        t1 = time.perf_counter()
        twins = [BucketedBandedProjector(
            op.stacks, op.aidxs, op.is_cols, op.shape, op.nx, op.det_count,
            op.n_groups, op.nnz, op.n_pad, device=dev) for op in frames]
        res = dyn["ops"]["bucketed " + kind]
        cols = np.cumsum([0] + [op.shape[1] for op in frames])
        rows = np.cumsum([0] + [op.shape[0] for op in frames])
        parts = {"matvec": (x, cols), "rmatvec": (y, rows),
                 "normal_matvec": (x, cols)}
        alone = {fn: (lambda f, v, o: lambda: [
            getattr(tw, f)(v[o[t]:o[t + 1]]) for t, tw in enumerate(twins)])(
                fn, *parts[fn]) for fn in parts}
        Ax_frames = torch.cat(alone["matvec"]())
        # the resident operator's applies (compared with below) before the
        # memory count starts: their kept arguments, bounds and K1 spans
        # are remade when earlier phases pushed them out of the wrappers'
        # caches, and are not the streamed apply's
        for fn, v in (("matvec", x), ("rmatvec", y), ("normal_matvec", x)):
            getattr(res, fn)(v)
        torch.cuda.synchronize()
        before = requested_bytes(dev, "current")
        t2 = time.perf_counter()
        sop = StreamedDynamicBandedOperator(frames, device=dev)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        slabs = sop.slab_bytes
        # the host cost of one frame's bucket checks and launch arguments
        # (three kernels), made at construction, off the apply's path
        op0, tw0 = frames[0], sop._twins[0][0]
        t4 = time.perf_counter()
        bounds = bk.pack_bounds(op0._bks, op0.n_groups)
        spans = bk.pack_spans(op0._bks)
        for name, ids in (("banded_fwd", tw0._aidx),
                          ("banded_adj", tw0._aidx), ("banded_ata", None)):
            bk.prepare(name, sop._slots[0], tw0._bks, ids, op0.n_groups,
                       bounds.get(name), spans)
        check_us = (time.perf_counter() - t4) * 1e6
        print(f"[10] {kind}: {nt} host frames packed in {t1 - t0:.2f} s; "
              f"streamed operator (pinned slabs, slots, twins, the frames' "
              f"fixed-point bounds and K1 spans) in {t3 - t2:.2f} s; slabs "
              f"{min(slabs)}..{max(slabs)} bytes, {sum(slabs)} per apply; "
              f"one frame's checks, launch arguments, bounds and spans "
              f"{check_us!r} us on the host")
        errs = {}
        for fn, (v, _) in parts.items():
            bk.reset_launch_counts()
            got = getattr(sop, fn)(v)
            torch.cuda.synchronize()
            per = dict(bk.launch_counts)
            for k in launches:
                launches[k] += per[k]
            want = {"matvec": "banded_fwd", "rmatvec": "banded_adj",
                    "normal_matvec": "banded_ata"}[fn]
            check(per == {k: nt if k == want else 0 for k in per},
                  f"streamed {kind} {fn} launches {per}")
            if fn == "matvec":
                check(torch.equal(got, Ax_frames),
                      f"streamed {kind} matvec differs from the frames'")
            elif fn == "rmatvec":
                check(torch.equal(got, res.rmatvec(v)),
                      f"streamed {kind} rmatvec differs from the resident's")
            else:
                errs[fn] = rel(got, getattr(res, fn)(v))
                check(errs[fn] <= STREAM_RTOL,
                      f"streamed {kind} {fn} vs resident {errs[fn]!r}")
        if kind == "float32":
            xd, yd = x.double().cpu().numpy(), y.double().cpu().numpy()
            for fn, v, ref in (("matvec", x, A64 @ xd),
                               ("rmatvec", y, A64.T @ yd),
                               ("normal_matvec", x, A64.T @ (A64 @ xd))):
                e = rel(getattr(sop, fn)(v).cpu(), torch.from_numpy(ref))
                errs[fn + " vs CSR"] = e
                check(e <= KERNEL_RTOL, f"streamed {fn} vs CSR {e!r}")
        print(f"[10] {kind}: launches per apply K2/K3/K1 {nt} each; matvec "
              f"bitwise the frames' resident matvecs, rmatvec the resident "
              f"dynamic operator's; rel err {errs}")
        del got
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        sop.normal_matvec(x)
        torch.cuda.synchronize()
        peak = requested_bytes(dev, "peak") - before
        slots = 2 * max(slabs)
        spans_b = sum(sp.numel() * sp.element_size() for op in frames
                      for sp in bk.pack_spans(op._bks))
        bound_b = (slots + spans_b + 4 * x.numel()
                   + STREAM_SLACK_IMAGES * 4 * frames[0].n_pad ** 2)
        print(f"[10] {kind}: peak memory of an apply {peak} bytes requested "
              f"(two slots {slots}, K1's spans {spans_b}, bound {bound_b}, "
              f"the whole pack {sum(slabs)})")
        check(slots <= peak <= bound_b, f"streamed {kind} peak {peak}")
        orig = sop._apply_frame

        def slowed(fn, s, t, v):
            torch.cuda._sleep(SLOW_CYCLES)
            return orig(fn, s, t, v)

        sop._apply_frame = slowed
        check(torch.equal(sop.matvec(x), Ax_frames),
              f"streamed {kind} matvec differs with the compute slowed")
        del sop._apply_frame
        print(f"[10] {kind}: matvec bitwise the same with the compute "
              f"stream slowed {SLOW_CYCLES} cycles before each frame")

        # walls: streamed, resident, the upload alone, the frames' applies
        # alone on resident twins
        def upload_alone():
            for t in range(nt):
                sop._slots[t % 2][:slabs[t]].copy_(sop._host[t],
                                                   non_blocking=True)

        copy_ms = cuda_ms(upload_alone, 10)
        walls = {}
        for fn, (v, _) in parts.items():
            walls[fn] = {
                "streamed": cuda_ms(lambda: getattr(sop, fn)(v), 10),
                "resident": cuda_ms(lambda: getattr(res, fn)(v), 10),
                "alone": cuda_ms(alone[fn], 10)}
            w = walls[fn]
            hidden = ((copy_ms + w["alone"] - w["streamed"])
                      / min(copy_ms, w["alone"]))
            host = {k: enqueue_ms(f) for k, f in (
                ("streamed", lambda: getattr(sop, fn)(v)),
                ("alone", alone[fn]))}
            print(f"[10] {kind} {fn}: streamed {w['streamed']!r} ms per "
                  f"apply ({sum(slabs) / w['streamed'] / 1e6!r} GB/s of "
                  f"upload), resident {w['resident']!r} ms, the {nt} "
                  f"frames' applies alone {w['alone']!r} ms, the upload "
                  f"alone {copy_ms!r} ms ({sum(slabs) / copy_ms / 1e6!r} "
                  f"GB/s pinned H2D); hidden share of the upload {hidden!r}"
                  f"; the host's enqueue of an apply: streamed "
                  f"{host['streamed']!r} ms, the frames alone "
                  f"{host['alone']!r} ms ("
                  f"{(host['streamed'] - host['alone']) / nt * 1e3!r} us a "
                  f"frame of the pipeline's own); card {card}")
        # cgls_normal_streamed: the relError after k = 1..20 iterations
        # (each a run from 0), the k = 20 run's launches
        errs_k = []
        for k in range(1, STREAMED_ITERS + 1):
            if k == STREAMED_ITERS:
                bk.reset_launch_counts()
            xs, kk = cgls_normal_streamed(sop, bv, x0, k)
            check(kk == k and bool(torch.isfinite(xs).all()),
                  f"streamed cgls {kind} k {kk}")
            errs_k.append(float((xs - xt).norm() / xt.norm()))
        got = dict(bk.launch_counts)
        check(got == {"banded_fwd": 0, "banded_adj": nt,
                      "banded_ata": nt * (STREAMED_ITERS + 1)},
              f"streamed cgls {kind} launches {got}")
        for k in launches:
            launches[k] += got[k]
        hist[kind] = errs_k
        torch.cuda.synchronize()
        t = time.perf_counter()
        cgls_normal_streamed(sop, bv, x0, STREAMED_ITERS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        # a profiled run of 5 iterations against its own wall
        cgls_normal_streamed(sop, bv, x0, 5)
        torch.cuda.synchronize()
        t = time.perf_counter()
        cgls_normal_streamed(sop, bv, x0, 5)
        torch.cuda.synchronize()
        wall5 = (time.perf_counter() - t) * 1e3
        logdir = TRACE_DIR / kind
        with telemetry.profile(str(logdir), device=dev) as prof:
            cgls_normal_streamed(sop, bv, x0, 5)
        busy = telemetry.device_busy_ms(prof)
        kern, cp, either = trace_busy_ms(logdir / "trace.json")
        print(f"[10] cgls_normal_streamed {kind}: relError final "
              f"{errs_k[-1]!r}, min {min(errs_k)!r} at iteration "
              f"{int(np.argmin(errs_k)) + 1}; launches {got}; wall "
              f"{wall / STREAMED_ITERS * 1e3!r} ms/iter, "
              f"{STREAMED_ITERS * 2 * sop.nnz / wall!r} nnz/s; 5 "
              f"iterations: wall {wall5!r} ms, device kernels {kern!r} ms, "
              f"copies {cp!r} ms, either {either!r} ms (device events "
              f"summed {busy!r}), idle share {1 - either / wall5!r}, compute "
              f"idle share {1 - kern / wall5!r}; card {card}")
        del sop, twins
    f32 = hist["float32"][-1]
    print(f"[10] cgls_normal_streamed float32 final relError {f32!r} (JAX "
          f"CPU {JAX_STREAMED_RELERR!r}, gate {STREAM_GATE}); min float32 "
          f"{min(hist['float32'])!r}, int8 {min(hist['int8'])!r}")
    check(abs(f32 - JAX_STREAMED_RELERR) <= STREAM_GATE,
          f"streamed cgls final relError {f32!r}")
    check(abs(min(hist["int8"]) - min(hist["float32"])) <= INT8_ATOL,
          "streamed int8 min relError gap")
    return launches


def batched_path(dev, card, dyn):
    """Phase 10, the batched per-frame solve: fused MMGKS with GCV and
    fused GKS with DP over the frames' float64 ELL tables, each frame's
    final relError against JAX's; walls per frame and iteration, a
    frame's host reads, beside 7's static per-frame MMGKS."""
    import torch
    from torch.autograd import DeviceType

    from trips_tpu_torch.core import loop
    from trips_tpu_torch.operators import FirstDerivative2D
    from trips_tpu_torch.parallel import batched_frame_solve
    from trips_tpu_torch.sparse import banded_kernels as bk

    AA, B, nt = dyn["AA"], dyn["B"], dyn["nt"]
    nx, ny, _ = dyn["dims"]
    xt = dyn["x_true"].reshape(nt, -1)
    L = FirstDerivative2D(nx, ny, device=dev)
    bk.reset_launch_counts()
    for name, kw in (("mmgks gcv", dict(solver="mmgks")),
                     ("gks dp", dict(solver="gks", regparam_mode="dp",
                                     delta=dyn["delta"] / nt))):
        torch.cuda.synchronize()
        t = time.perf_counter()
        X = batched_frame_solve(AA, B, L, n_iter=BATCHED_ITERS, device=dev,
                                **kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) / nt
        check(tuple(X.shape) == xt.shape and X.dtype == torch.float64
              and bool(torch.isfinite(X).all()), f"batched {name} X")
        Xh = X.cpu().numpy()
        errs = [float(np.linalg.norm(Xh[f] - xt[f]) / np.linalg.norm(xt[f]))
                for f in range(nt)]
        gap = max(abs(e - r) for e, r in zip(errs, JAX_BATCHED_RELERR[name]))
        # one frame's host syncs, the loops' host reads, and its device
        # launches (kernels, copies, memsets)
        def one_frame():
            batched_frame_solve(AA[:1], B[:1], L, n_iter=BATCHED_ITERS,
                                device=dev, **kw)

        loop.TRACE = []
        syncs = count_syncs(one_frame)
        reads = sum(r for _, r, _ in loop.TRACE)
        loop.TRACE = None
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            one_frame()
            torch.cuda.synchronize()
        launched = sum(e.count for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA)
        check(launched > 0, f"batched {name}: no device launch recorded")
        print(f"[10] batched {name}: {nt} frames, relError per frame "
              f"{min(errs)!r}..{max(errs)!r}, largest gap to JAX CPU "
              f"{gap!r} (gate {BATCHED_GATE}); wall {wall * 1e3!r} ms per "
              f"frame, {wall / BATCHED_ITERS * 1e3!r} ms per iteration; "
              f"host syncs per frame {sum(syncs.values())} (the search "
              f"loops' reads {reads}); device launches per frame "
              f"{launched}; 7's static per-frame MMGKS "
              f"{dyn['walls']['static per-frame MMGKS']!r} ms per frame "
              f"iteration; card {card}")
        check(gap <= BATCHED_GATE, f"batched {name} relError gap {gap!r}")
    launched = dict(bk.launch_counts)
    check(not any(launched.values()), f"K1-K3 launched in batched: "
          f"{launched}")


# Phase 11: the sharded operators of parallel/ (whole vectors on every
# rank, one all_reduce per apply). Gates: the banded matvec bitwise the
# unsharded operator's (K2 is bitwise repeatable, computes an angle's row
# alike in any launch of the same plan, and the rows are copied into
# place; a sum with the other ranks' zeros is exact); at world 1 the banded
# rmatvec and normal_matvec bitwise too (the one rank's slab is the whole
# pack: K3 adds the same terms at the same fixed-point scale, K1 sums each
# row alike, and a one-rank sum is the identity); at world 2 within
# SHARD_RTOL (each rank rounds its partial image, then the sum), the ELL
# and BSR operators within SHARD_RTOL of the host scipy product; K1, K2 or
# K3 once per apply and rank, one all_reduce per apply; cgls_normal as 3
# and 10 hold it (FINAL_ATOL of JAX_CGLS_RELERR, STREAM_GATE of
# JAX_STREAMED_RELERR: the same CG on the same matrix).
SHARD_RTOL = 1e-5
SHARD_ITERS = {"tomo": CGLS_ITERS, "dynamic": 20}
SHARD_JOIN_S = 300  # the limit on [11b]'s ranks
SHARD_REPS = 20     # timed applies and collectives
ONE_LAUNCH = {"matvec": {"banded_fwd": 1, "banded_adj": 0, "banded_ata": 0},
              "rmatvec": {"banded_fwd": 0, "banded_adj": 1, "banded_ata": 0},
              "normal_matvec": {"banded_fwd": 0, "banded_adj": 0,
                                "banded_ata": 1}}
KERNEL_OF = {"matvec": "banded_fwd", "rmatvec": "banded_adj",
             "normal_matvec": "banded_ata"}
APPLY_OF = {k: a for a, k in KERNEL_OF.items()}


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def counted(fn, v):
    """(``fn(v)``, K1-K3 launches, all_reduce calls) of one call."""
    import torch

    from trips_tpu_torch.parallel import sharding
    from trips_tpu_torch.sparse import banded_kernels as bk

    before = (dict(bk.launch_counts),
              sharding.collective_counts["all_reduce"])
    out = fn(v)
    torch.cuda.synchronize()
    return (out, {k: bk.launch_counts[k] - before[0][k]
                  for k in bk.launch_counts},
            sharding.collective_counts["all_reduce"] - before[1])


def sharded_gates(sop, ref, x, y, bitwise=("matvec",)):
    """Each apply of ``sop`` against ``ref`` (a callable name -> the
    unsharded output): those named in ``bitwise`` bitwise, the others
    within SHARD_RTOL, one launch and one all_reduce each. -> ({apply: rel
    err}, {apply: launches of its kernel})."""
    errs, launches = {}, {}
    for name, v in (("matvec", x), ("rmatvec", y), ("normal_matvec", x)):
        out, got, coll = counted(getattr(sop, name), v)
        r = ref(name)
        errs[name] = rel(out, r)
        launches[name] = got[KERNEL_OF[name]]
        if name in bitwise:
            check(bool((out == r).all()), f"sharded {name} not bitwise the "
                  f"unsharded one's (rel {errs[name]!r})")
        check(errs[name] <= SHARD_RTOL, f"sharded {name} rel {errs[name]!r}")
        check(got == ONE_LAUNCH[name] and coll == 1,
              f"sharded {name}: launches {got}, all_reduce {coll}")
    return errs, launches


def profiled_kernels(fn, reps):
    """{kernel: device ms per call} of ``reps`` calls of ``fn()`` in one
    profiler session; empty where none ran (NCCL may launch nothing for a
    one-rank all_reduce)."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / reps / 1e3
            for e in prof.key_averages()
            if e.self_device_time_total and e.device_type == DeviceType.CUDA}


def cgn_history(op, bv, x0, xt, its):
    """relError of every ``cgls_normal`` iterate, the loop of 3. -> (list,
    final x)."""
    from trips_tpu_torch.krylov.cgls import _cgn_chunk, _cgn_init

    s, errs = _cgn_init(op, bv, x0), []
    for it in range(1, its + 1):
        s = _cgn_chunk(op, 0.0, s, it)
        errs.append(float((s.x - xt).norm() / xt.norm()))
    return errs, s.x


def cgn_gates(label, errs, which):
    """Hold a sharded cgls_normal's history as 3 (tomo: final and minimum
    against JAX's CGLS) or 10 (dynamic: final against JAX's) do."""
    if which == "tomo":
        ref = np.array(JAX_CGLS_RELERR)
        gaps = (abs(errs[-1] - ref[-1]), abs(min(errs) - ref.min()))
        check(max(gaps) <= FINAL_ATOL, f"{label} cgls_normal {gaps}")
        return (f"relError final {errs[-1]!r} (JAX CPU {float(ref[-1])!r}), "
                f"min {min(errs)!r} (JAX CPU {float(ref.min())!r}), gate "
                f"{FINAL_ATOL}")
    gap = abs(errs[-1] - JAX_STREAMED_RELERR)
    check(gap <= STREAM_GATE, f"{label} cgls_normal gap {gap!r}")
    return (f"relError final {errs[-1]!r} (JAX CPU {JAX_STREAMED_RELERR!r}, "
            f"gate {STREAM_GATE})")


def sharded_world1(dev, card, packs, A, dyn, tomo):
    """Phase 11a: world size 1 over NCCL in this process, every sharded
    class at full width against its unsharded operator or the host
    product; launches and collectives per apply; the applies' times beside
    the unsharded ones and the NCCL all_reduce's device time; cgls_normal
    on the sharded float32 packs. ``packs``: {label: unsharded banded
    operator}; ``tomo``: (bv, x0, xt) of 3. -> {label: {apply: K1-K3
    launches}}."""
    import torch
    import torch.distributed as dist

    from trips_tpu_torch.parallel import (
        ShardedBandedProjector, ShardedBsrOperator,
        ShardedBucketedBandedProjector, ShardedBucketedDynamicBandedOperator,
        ShardedDynamicBandedOperator, ShardedDynamicBsrOperator,
        ShardedDynamicOperator, ShardedEllOperator, make_mesh)
    from trips_tpu_torch.sparse import EllOperator

    check(dist.is_nccl_available(), "torch.distributed has no NCCL here")
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        t0 = time.perf_counter()
        shard = {}
        for label, op in packs.items():
            if label.startswith("dynamic"):
                cls = (ShardedDynamicBandedOperator if "flat" in label
                       else ShardedBucketedDynamicBandedOperator)
                shard[label] = cls.from_dynamic(op, make_mesh(
                    {"time": 1, "angles": 1}), device=dev)
            elif "flat" in label:
                shard[label] = ShardedBandedProjector.from_banded(
                    op, make_mesh({"rows": 1}), device=dev)
            else:
                shard[label] = ShardedBucketedBandedProjector.from_bucketed(
                    op, make_mesh({"angles": 1}), device=dev)
        print(f"[11a] NCCL world 1: {len(shard)} banded packs sharded in "
              f"{time.perf_counter() - t0:.2f} s (slab views of the "
              f"unsharded stacks: {[s.stored_bytes for s in shard.values()]}"
              f" bytes)")
        rng = np.random.default_rng(11)
        launches = {}
        for label, sop in shard.items():
            op = packs[label]
            x = torch.tensor(rng.standard_normal(op.shape[1]),
                             dtype=torch.float32, device=dev)
            y = torch.tensor(rng.standard_normal(op.shape[0]),
                             dtype=torch.float32, device=dev)
            errs, launches[label] = sharded_gates(
                sop, lambda name: getattr(op, name)(x if name != "rmatvec"
                                                    else y), x, y,
                bitwise=tuple(KERNEL_OF))
            # CUDA events (the device's interval, host gaps included),
            # device time (kernels alone) and the host's enqueue
            times = {name: [f(lambda: getattr(o, name)(v), SHARD_REPS)
                            for f in (cuda_ms, device_ms, enqueue_ms)
                            for o in (sop, op)]
                     for name, v in (("matvec", x), ("rmatvec", y),
                                     ("normal_matvec", x))}
            print(f"[11a] {label}: matvec, rmatvec and normal_matvec "
                  f"bitwise the unsharded one's; one "
                  f"launch and one all_reduce per apply; ms per apply, "
                  f"sharded / unsharded, by CUDA events, device time, host "
                  f"enqueue: " + "; ".join(
                      f"{k} {t[0]!r} / {t[1]!r}, {t[2]!r} / {t[3]!r}, "
                      f"{t[4]!r} / {t[5]!r}" for k, t in times.items())
                  + f"; card {card}")

        # the ELL and BSR operators: tomo256x60's A, the dynamic frames
        AA, Ad = dyn["AA"], dyn["A"]
        t0 = time.perf_counter()
        sparse_ops = {
            "ELL tomo256x60": (ShardedEllOperator.from_ell(
                EllOperator.from_scipy(A, device=dev), make_mesh(
                    {"rows": 1}), device=dev), A),
            "BSR tomo256x60": (ShardedBsrOperator.from_scipy(
                A, make_mesh({"rows": 1}), device=dev), A),
            "ELL dynamic": (ShardedDynamicOperator.from_blocks(
                AA, make_mesh({"time": 1, "rows": 1}), device=dev), Ad),
            "BSR dynamic": (ShardedDynamicBsrOperator.from_blocks(
                AA, make_mesh({"time": 1, "rows": 1}), device=dev), Ad)}
        print(f"[11a] ELL and BSR operators built in "
              f"{time.perf_counter() - t0:.2f} s")
        for label, (sop, M) in sparse_ops.items():
            # BSR holds float32 values: the host product of the same
            Mh = (M.astype(np.float32) if "BSR" in label else M).astype(
                np.float64)
            m, n = M.shape
            xh, yh = rng.standard_normal(n), rng.standard_normal(m)
            errs = {}
            for name, v, ref, size in (("matvec", xh, Mh @ xh, sop.shape[1]),
                                       ("rmatvec", yh, Mh.T @ yh,
                                        sop.shape[0])):
                vp = np.zeros(size)
                vp[:len(v)] = v
                vt = torch.tensor(vp, dtype=sop.dtype, device=dev)
                out, _, coll = counted(getattr(sop, name), vt)
                errs[name] = rel(out[:len(ref)].cpu(), torch.from_numpy(ref))
                check(errs[name] <= SHARD_RTOL and coll == 1,
                      f"{label} {name} rel {errs[name]!r}, all_reduce "
                      f"{coll}")
                errs[name + " ms"] = cuda_ms(
                    lambda: getattr(sop, name)(vt), SHARD_REPS)
            print(f"[11a] {label} ({sop.dtype}, shape {sop.shape}) vs the "
                  f"host scipy product: {errs} (gate {SHARD_RTOL}); card "
                  f"{card}")

        # the collective alone: NCCL all_reduce of the applies' buffers
        for what, numel in (("tomo256x60 image", 256 * 256),
                            ("tomo256x60 sinogram", A.shape[0]),
                            ("dynamic images", Ad.shape[1]),
                            ("dynamic sinograms", Ad.shape[0])):
            buf = torch.zeros(numel, dtype=torch.float32, device=dev)
            walls = [cuda_ms(lambda: dist.all_reduce(buf), SHARD_REPS)
                     for _ in range(3)]
            host = enqueue_ms(lambda: dist.all_reduce(buf), SHARD_REPS)
            kernels = profiled_kernels(lambda: dist.all_reduce(buf),
                                       SHARD_REPS)
            print(f"[11a] NCCL all_reduce of the {what} ({numel * 4} bytes, "
                  f"1 rank): CUDA events {walls!r} ms (three runs), host "
                  f"enqueue {host!r} ms; device ms per call by kernel "
                  f"{kernels or 'none (no kernel launched)'}; card {card}")

        bv, x0, xt = tomo
        for label, which in (("bucketed float32", "tomo"),
                             ("dynamic bucketed float32", "dynamic")):
            sop = shard[label]
            if which == "dynamic":
                bv = dyn["bv"]
                xt = torch.tensor(dyn["x_true"], dtype=torch.float32,
                                  device=dev)
                x0 = torch.zeros_like(xt)
            errs, _ = cgn_history(sop, bv, x0, xt, SHARD_ITERS[which])
            print(f"[11a] sharded {label} cgls_normal, "
                  f"{SHARD_ITERS[which]} iterations: "
                  + cgn_gates(label, errs, which))
    finally:
        dist.destroy_process_group()
    return launches


def save_pack(path, op):
    """The NumPy stacks of a bucketed (static or dynamic) pack and what
    ``from_numpy_stacks`` needs beside them."""
    arrays = {f"s{k}_{j}": t.cpu().numpy() for k, st in enumerate(op.stacks)
              for j, t in enumerate(st)}
    meta = {"parts": [len(st) for st in op.stacks],
            "is_cols": list(op.is_cols), "shape": list(op.shape),
            "nx": op.nx, "p": op.det_count, "n_groups": op.n_groups,
            "nnz": int(op.nnz), "n_pad": op.n_pad}
    if hasattr(op, "nt"):
        meta.update(views=op.views, nt=op.nt)
    else:
        meta["aidxs"] = [list(a) for a in op.aidxs]
    np.savez(path, meta=json.dumps(meta), **arrays)


def load_pack(path):
    """``save_pack``'s file -> the operator on the CPU."""
    from trips_tpu_torch.sparse import (BucketedBandedProjector,
                                        BucketedDynamicBandedOperator)

    z = np.load(path)
    meta = json.loads(str(z["meta"]))
    stacks = [[z[f"s{k}_{j}"] for j in range(n)]
              for k, n in enumerate(meta["parts"])]
    common = (meta["shape"], meta["nx"], meta["p"])
    if "nt" in meta:
        return BucketedDynamicBandedOperator.from_numpy_stacks(
            stacks, meta["is_cols"], *common, meta["views"],
            meta["n_groups"], meta["nnz"], meta["nt"], meta["n_pad"],
            device="cpu")
    return BucketedBandedProjector.from_numpy_stacks(
        stacks, meta["aidxs"], meta["is_cols"], *common, meta["n_groups"],
        meta["nnz"], meta["n_pad"], device="cpu")


SHARD_LEGS = {"tomo256x60 bucketed float32": ("tomo", True),
              "tomo256x60 bucketed int8": ("tomo", False),
              "dynamic bucketed float32": ("dynamic", True)}


def sharded_rank(rank, port, tmp):
    """One of [11b]'s two ranks on the one card (gloo on CUDA tensors):
    each leg's pack rebuilt from the NumPy stacks on the CPU and sharded
    to the card, the gates' numbers against the unsharded outputs the
    parent saved, K1-K3's device time over the rank's angles (one rank at
    a time), the gloo all_reduce's wall, cgls_normal; writes
    ``rank<r>.json`` and its final iterates."""
    import datetime

    import torch
    import torch.distributed as dist

    from trips_tpu_torch.parallel import (
        ShardedBucketedBandedProjector, ShardedBucketedDynamicBandedOperator,
        init_multihost, make_mesh)
    from trips_tpu_torch.parallel.sharding import all_reduce
    from trips_tpu_torch.sparse import banded_kernels as bk
    from trips_tpu_torch.sparse.banded_buckets import drive_images

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    init_multihost(f"127.0.0.1:{port}", 2, rank, backend="gloo",
                   timeout=datetime.timedelta(seconds=SHARD_JOIN_S))
    out = {}
    try:
        ref = np.load(f"{tmp}/refs.npz")

        def barrier():  # an all_reduce of one number, on the host
            dist.all_reduce(torch.zeros(1))

        for leg, (which, solve) in SHARD_LEGS.items():
            key = leg.replace(" ", "_")
            op = load_pack(f"{tmp}/{key}.npz")
            t0 = time.perf_counter()
            if which == "dynamic":
                sop = ShardedBucketedDynamicBandedOperator.from_dynamic(
                    op, make_mesh({"time": 1, "angles": 2}), device=dev)
            else:
                sop = ShardedBucketedBandedProjector.from_bucketed(
                    op, make_mesh({"angles": 2}), device=dev)
            res = {"shard_s": time.perf_counter() - t0,
                   "stored_bytes": sop.stored_bytes,
                   "angles": sum(st[0].shape[-4] for st in sop.stacks),
                   "buckets": len(sop.stacks)}
            del op
            x = torch.from_numpy(ref[key + "_x"]).to(dev)
            y = torch.from_numpy(ref[key + "_y"]).to(dev)
            res["errs"], res["launches"] = {}, {}
            for name, v in (("matvec", x), ("rmatvec", y),
                            ("normal_matvec", x)):
                got, launched, coll = counted(getattr(sop, name), v)
                r = torch.from_numpy(ref[f"{key}_{name}"]).to(dev)
                res["errs"][name] = rel(got, r)
                res["launches"][name] = launched
                res["collectives_" + name] = coll
                if name == "matvec":
                    res["bitwise"] = bool((got == r).all())
            # K1-K3 over this rank's angles, one rank at a time
            X, XT = (sop._images(x) if which == "dynamic" else
                     drive_images(x, sop.nx, sop.n_pad))
            na = sum(a.shape[-1] for a in sop._lids)
            Yl = torch.randn(X.shape[:-2] + (na, sop.det_count), device=dev)
            calls = {"banded_fwd": lambda: bk.banded_fwd_buckets(
                         X, XT, sop._bks, sop._lids, sop.det_count,
                         sop.n_groups),
                     "banded_adj": lambda: bk.banded_adj_buckets(
                         Yl, sop._bks, sop._lids, sop.n_groups),
                     "banded_ata": lambda: bk.banded_ata_buckets(
                         X, XT, sop._bks, sop.n_groups)}
            res["kernel_ms"] = {}
            for turn in range(2):
                if turn == rank:
                    res["kernel_ms"] = {k: device_ms(f, SHARD_REPS)
                                        for k, f in calls.items()}
                barrier()
            # the buffer rmatvec and normal_matvec reduce
            img = (sop._zero_images(dev) if which == "dynamic" else
                   torch.zeros(sop.n_pad, sop.n_pad, device=dev))
            walls = []
            for _ in range(SHARD_REPS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                all_reduce(img, sop.mesh)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t)
            res["gloo_ms"] = float(np.median(walls)) * 1e3
            res["gloo_bytes"] = img.numel() * 4
            if solve:
                bv = torch.from_numpy(ref[key + "_b"]).to(dev)
                xt = torch.from_numpy(ref[key + "_xt"]).to(dev)
                errs, xf = cgn_history(sop, bv, torch.zeros_like(xt), xt,
                                       SHARD_ITERS[which])
                res["cgn"] = errs
                np.save(f"{tmp}/{key}_x{rank}.npy", xf.cpu().numpy())
            out[leg] = res
            del sop
            torch.cuda.empty_cache()
        with open(f"{tmp}/rank{rank}.json", "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def sharded_ranks(dev, card, packs, tomo, dyn, whole_ms):
    """Phase 11b: two ranks on the one card over gloo (NCCL refuses two
    ranks on one device). The packs' NumPy stacks and the unsharded
    outputs are saved once; each rank rebuilds the packs on the CPU and
    shards them to the card. Gates as 11a, and the two ranks' final
    iterates bitwise equal; a rank that fails or outlives SHARD_JOIN_S
    fails the phase. ``whole_ms``: {leg: {kernel: device ms of the whole
    operator}} from 4 and 7. -> {leg: [per rank {apply: launches}]}."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from trips_tpu_torch import _build

    _build.load()  # built once, before the ranks start
    bv, x0, xt = tomo
    rng = np.random.default_rng(12)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_shard_") as tmp:
        t0 = time.perf_counter()
        refs = {}
        for leg, (which, solve) in SHARD_LEGS.items():
            key, op = leg.replace(" ", "_"), packs[leg]
            save_pack(f"{tmp}/{key}.npz", op)
            x = torch.tensor(rng.standard_normal(op.shape[1]),
                             dtype=torch.float32, device=dev)
            y = torch.tensor(rng.standard_normal(op.shape[0]),
                             dtype=torch.float32, device=dev)
            refs.update({key + "_x": x, key + "_y": y,
                         key + "_matvec": op.matvec(x),
                         key + "_rmatvec": op.rmatvec(y),
                         key + "_normal_matvec": op.normal_matvec(x)})
            if solve:
                refs[key + "_b"] = bv if which == "tomo" else dyn["bv"]
                refs[key + "_xt"] = xt if which == "tomo" else torch.tensor(
                    dyn["x_true"], dtype=torch.float32)
        np.savez(f"{tmp}/refs.npz",
                 **{k: v.cpu().numpy() for k, v in refs.items()})
        print(f"[11b] packs and unsharded outputs saved in "
              f"{time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        ctx = mp.get_context("spawn")
        port = free_port()
        procs = [ctx.Process(target=sharded_rank, args=(r, port, tmp))
                 for r in range(2)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + SHARD_JOIN_S
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0))
            codes = [p.exitcode for p in procs]
            check(codes == [0, 0], f"[11b] ranks' exit codes {codes} "
                  f"(None: alive past {SHARD_JOIN_S} s)")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        wall = time.perf_counter() - t0
        res = []
        for r in range(2):
            with open(f"{tmp}/rank{r}.json") as f:
                res.append(json.load(f))
        launches = {}
        for leg, (which, solve) in SHARD_LEGS.items():
            key = leg.replace(" ", "_")
            for r, rr in enumerate(res):
                g = rr[leg]
                check(g["bitwise"], f"[11b] {leg} rank {r}: matvec not "
                      f"bitwise the unsharded one's")
                for name, e in g["errs"].items():
                    check(e <= SHARD_RTOL, f"[11b] {leg} rank {r} {name} "
                          f"rel {e!r}")
                    check(g["launches"][name] == ONE_LAUNCH[name]
                          and g["collectives_" + name] == 1,
                          f"[11b] {leg} rank {r} {name}: launches "
                          f"{g['launches'][name]}, all_reduce "
                          f"{g['collectives_' + name]}")
                print(f"[11b] {leg}, rank {r}: {g['angles']} angles in "
                      f"{g['buckets']} buckets, {g['stored_bytes']} bytes "
                      f"(sharded in {g['shard_s']:.2f} s); matvec bitwise "
                      f"the unsharded one's, rmatvec "
                      f"{g['errs']['rmatvec']!r}, normal_matvec "
                      f"{g['errs']['normal_matvec']!r} (gate {SHARD_RTOL});"
                      f" one launch and one all_reduce per apply; device ms "
                      f"over its angles (alone on the card): " + "; ".join(
                          f"{k} {v!r} (whole operator "
                          f"{whole_ms[leg][k]!r})"
                          for k, v in g["kernel_ms"].items())
                      + f"; gloo all_reduce of {g['gloo_bytes']} bytes of "
                      f"CUDA tensors, staged through the host (not a speed "
                      f"of the card): wall {g['gloo_ms']!r} ms; card {card}")
                if solve:
                    print(f"[11b] {leg}, rank {r}: cgls_normal "
                          f"{SHARD_ITERS[which]} iterations: "
                          + cgn_gates(leg, g["cgn"], which))
            if solve:
                xs = [np.load(f"{tmp}/{key}_x{r}.npy") for r in range(2)]
                check(np.array_equal(xs[0], xs[1]), f"[11b] {leg}: the "
                      f"ranks' final iterates differ")
                print(f"[11b] {leg}: the two ranks' final iterates bitwise "
                      f"equal")
            launches[leg] = [rr[leg]["launches"] for rr in res]
        print(f"[11b] two ranks ran in {wall:.1f} s (spawn, CUDA start-up, "
              f"loading and sharding included)")
    return launches


# Phase 12: the gelPhantom dynamic CT path at the reference's size. The
# real bundle (Zenodo 3696817) is not in the repository and nothing
# downloads, so ``gel_bundle`` writes one in its layout
# (tests/test_dataset_fixtures.py:188-218) from a seed: the real bundle's
# geometry (tests/test_gel_geometry.py:27-31: SO 410.66, SD 553.74, pixel
# 0.1, 140 detectors) over 360 angles of 1 degree, its 17 frames, each a
# 256x256 image whose middle 128x128 hold a Shepp-Logan phantom (the
# detector sees a disk about 140 voxels across) with a disk whose radius
# grows with t, projected through the full 360-angle ``gel_operator``
# matrix (NumPy builder) plus 1% Gaussian noise from default_rng(0).
GEL = dict(so=410.66, sd=553.74, pixel=0.1, n_det=140, n_angles=360,
           nt=17, nx=256, step=20, noise=0.01)


@contextlib.contextmanager
def numpy_builder(on=True):
    """``TRIPS_TPU_NO_NATIVE`` set to 1 (the NumPy matrix builder) or
    unset (the C++ one) inside the block, restored after it."""
    old = os.environ.pop("TRIPS_TPU_NO_NATIVE", None)
    if on:
        os.environ["TRIPS_TPU_NO_NATIVE"] = "1"
    try:
        yield
    finally:
        os.environ.pop("TRIPS_TPU_NO_NATIVE", None)
        if old is not None:
            os.environ["TRIPS_TPU_NO_NATIVE"] = old


def gel_frames(nx, nt):
    """The synthetic bundle's images ``(nt, nx, nx)``: a Shepp-Logan
    phantom in the middle half of each side, and a disk of density 0.5
    in it whose radius grows from 0.02 nx by 0.004 nx a frame."""
    from trips_tpu_torch.problems.phantoms import shepp_logan

    base = np.zeros((nx, nx))
    base[nx // 4:nx // 4 + nx // 2, nx // 4:nx // 4 + nx // 2] = \
        shepp_logan(nx // 2)
    yy, xx = np.mgrid[:nx, :nx]
    d2 = (yy - 0.55 * nx) ** 2 + (xx - 0.45 * nx) ** 2
    return np.stack([base + 0.5 * (d2 <= (nx * (0.02 + 0.004 * t)) ** 2)
                     for t in range(nt)])


def gel_bundle(path):
    """Write the synthetic gel bundle to ``path``
    (``GelPhantomData_b4.mat``); return its images ``(nt, nx, nx)``."""
    import scipy.io as spio

    from trips_tpu_torch.problems.gelphantom import gel_operator

    nt, n_angles, n_det = GEL["nt"], GEL["n_angles"], GEL["n_det"]
    deg = np.arange(float(n_angles))
    info = {"angles": deg * (np.pi / 180.0),
            "distanceSourceOrigin": GEL["so"],
            "distanceOriginDetector": GEL["sd"] - GEL["so"],
            "numDetectors": n_det, "pixelSize": GEL["pixel"]}
    with numpy_builder():
        A = gel_operator(info, GEL["nx"], np.arange(n_angles))
    X = gel_frames(GEL["nx"], nt)
    sinos = (A @ X.reshape(nt, -1).T).T.reshape(nt, n_angles, n_det)
    e = np.random.default_rng(0).standard_normal(sinos.shape)
    sinos = sinos + GEL["noise"] * np.linalg.norm(sinos) / np.linalg.norm(
        e) * e
    params = {"distanceSourceDetector": GEL["sd"],
              "distanceSourceOrigin": GEL["so"],
              "geometricMagnification": GEL["sd"] / GEL["so"],
              "numDetectors": float(n_det), "pixelSize": GEL["pixel"],
              "pixelSizeRaw": GEL["pixel"] / 2,
              "effectivePixelSize": 2 * GEL["pixel"] * GEL["so"] / GEL["sd"],
              "angles": deg}
    parr = np.zeros((nt,), dtype=[(k, "O") for k in params])
    for k, v in params.items():
        for t in range(nt):
            parr[k][t] = v
    spio.savemat(path, {"GelPhantomData_b4": {
        "type": "2D", "sinogram": sinos, "parameters": parr}})
    return X


# The final relErrors of the gel solves from trips_tpu on the CPU on the
# same bundle (``python3 demo_reference.py gel``: JAX 0.9.0, x64 off, the
# NumPy matrix builder, ``BatchedBlockDiagOperator`` over the
# ``EllOperator`` that ``device_sparse_operator`` takes there), and ||b||.
JAX_GEL_RELERR = {"CGLS": 0.6762909877269393,
                  "cgls_normal": 0.6762919694579435,
                  "Hybrid LSQR gcv": 0.6763978253551075}
B_GEL_NORM = 4149.342270692701
GEL_ITERS = {"CGLS": 30, "cgls_normal": 30, "Hybrid LSQR gcv": 20}
GEL_GATE = 1e-3
QUEUE_SLEEP_CYCLES = 20_000_000  # torch.cuda._sleep: ~10 ms on an H100
# trips_tpu_torch.demos.demo_l_curve at its defaults (64x64, 30 views, 20
# iterations; the C++ builder): each final relError and lambda from
# ``python3 demo_reference.py l_curve`` (x64 off, the gates) and
# ``l_curve64`` (x64 on, printed beside); demo_small_scale_cgls at its
# defaults (50x50, 50 iterations, tol 1e-3) from the same runs; and
# trips_tpu.bench.iters_to_tol.compare()'s rows in float64 (l_curve64).
JAX_LCURVE = {"GKS (l_curve)": (0.16496954856412005, 0.3454130211454522),
              "MMGKS (l_curve)": (0.05745586548099301, 0.7551278306908265),
              "GKS (dp)": (0.15994798437428312, 8.64365532326664),
              "MMGKS (dp)": (0.05546399160065269, 3.4108661136055973),
              "Hybrid LSQR (gcv)": (0.1684397417270963,
                                    0.0006295758493222571),
              "Hybrid LSQR (l_curve)": (0.1684236773001596,
                                        0.021818487778084237)}
JAX_LCURVE_F64 = {"GKS (l_curve)": (0.16496955141517583, 0.3454118837440751),
                  "MMGKS (l_curve)": (0.05745582772684688,
                                      0.7551274513354684),
                  "GKS (dp)": (0.1599479258831255, 8.643591057237547),
                  "MMGKS (dp)": (0.05546395819511715, 3.4108651201168594),
                  "Hybrid LSQR (gcv)": (0.16885935885487094,
                                        0.0007006010430388746),
                  "Hybrid LSQR (l_curve)": (0.16882457617454996,
                                            0.030362280617125183)}
LCURVE_GATE = 1e-3
JAX_SMALL_CGLS = (14, 0.13220479019133335)  # (its, final relError)
JAX_ITERS_TO_TOL = [("tomo32x30", 32, 33), ("tomo64x40", 49, 51)]


def checked_ms(fn, reps):
    """(device ms per call of ``fn()``, source): the profiler's device time
    over ``reps`` calls, taken only when that session recorded ``reps``
    times the kernels of a session of one call (late profiler sessions of
    one process drop device records, ROADMAP Queue 3 item 18: in a whole
    run, K3's sessions held one launch in ten); three tries, else
    ``queued_ms``."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    act = [torch.profiler.ProfilerActivity.CUDA]

    def session(calls):
        with torch.profiler.profile(activities=act) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if e.self_device_time_total
              and e.device_type == DeviceType.CUDA]
        return (sum(e.count for e in ev),
                sum(e.self_device_time_total for e in ev))

    for _ in range(3):
        one, _ = session(1)
        count, us = session(reps)
        if one and count == reps * one:
            return us / reps / 1e3, "profiler"
    return queued_ms(fn, reps)[0], "events"


def queued_ms(fn, reps):
    """(device ms per call of ``fn()``, whether the calls ran back to
    back): ``reps`` calls enqueued behind a kernel that sleeps longer than
    the host takes to enqueue them, between two CUDA events, so no host
    gap lies between them. [12] times so because late profiler sessions
    of one process drop device records (ROADMAP Queue 3 item 18: in a
    whole run, K3's sessions held one launch in ten)."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles = QUEUE_SLEEP_CYCLES
    for _ in range(4):
        sleep = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        sleep[0].record()
        torch.cuda._sleep(cycles)
        sleep[1].record()
        start.record()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        enqueue = (time.perf_counter() - t) * 1e3
        end.record()
        torch.cuda.synchronize()
        if enqueue < sleep[0].elapsed_time(sleep[1]):
            return start.elapsed_time(end) / reps, True
        cycles *= 4
    return start.elapsed_time(end) / reps, False


def builder_checks(dev, card, A, dyn):
    """Phase 12a: the C++ builder built and loaded, its matrices against
    the NumPy builder's (fan 256x60 and 512x180, parallel 'line' at the
    dynamic cell's 128x128 and 330 angles), the tomo256x60 pack byte-equal
    under both, each builder's seconds."""
    import torch

    from trips_tpu_torch import native
    from trips_tpu_torch.problems import fan_beam_matrix, parallel_beam_matrix
    from trips_tpu_torch.sparse import BucketedBandedProjector

    with numpy_builder(False):
        native.load()
    info = native.build_info
    print(f"[12a] C++ builder {'built' if info['built'] else 'loaded'} in "
          f"{info['seconds']:.3f} s: {info['path']}")
    theta = lambda views: np.linspace(0, np.pi, views,  # noqa: E731
                                      endpoint=False)
    cases = {"fan 256x60": lambda: fan_beam_matrix(256, angles=theta(60)),
             "fan 512x180": lambda: fan_beam_matrix(512, angles=theta(180)),
             "parallel 128x330": lambda: parallel_beam_matrix(
                 128, np.concatenate(dyn["angles"]))}
    built = {}
    for name, make in cases.items():
        secs, mats = {}, {}
        for label, on in (("C++", False), ("NumPy", True)):
            with numpy_builder(on):
                t = time.perf_counter()
                mats[label] = make()
                secs[label] = time.perf_counter() - t
        C, N = mats["C++"], mats["NumPy"]
        # the rows whose pattern differs: a chord along a grid line, put
        # in the other square beside it; its total is the same
        same = np.array([np.array_equal(C.indices[C.indptr[r]:C.indptr[r + 1]],
                                        N.indices[N.indptr[r]:N.indptr[r + 1]])
                         for r in range(C.shape[0])])
        moved = np.flatnonzero(~same)
        keep = np.flatnonzero(same)
        err = float(abs(C[keep] - N[keep]).max()) if len(keep) else 0.0
        tot = (float(np.abs(np.asarray(C[moved].sum(1))
                            - np.asarray(N[moved].sum(1))).max())
               if len(moved) else 0.0)
        print(f"[12a] {name}: {C.shape} nnz C++ {C.nnz} NumPy {N.nnz}; "
              f"{len(moved)} rows with another pattern (chord totals within "
              f"{tot!r}), the other rows' entries within {err!r}; seconds "
              f"C++ {secs['C++']!r}, NumPy {secs['NumPy']!r}")
        check(err <= 1e-9 and tot <= 1e-9 and len(moved) <= C.shape[0] // 100,
              f"{name}: C++ vs NumPy builder")
        built[name] = secs
    stacks, secs = {}, {}
    for label, on in (("C++", False), ("NumPy", True)):
        with numpy_builder(on):
            t = time.perf_counter()
            op = BucketedBandedProjector.from_scipy_fan(
                A, 256, None, angles=theta(60), n_groups=32, device="cpu")
            secs[label] = time.perf_counter() - t
        stacks[label] = op.stacks
    same = all(torch.equal(a, b) for s1, s2 in zip(stacks["C++"],
                                                   stacks["NumPy"])
               for a, b in zip(s1, s2))
    print(f"[12a] tomo256x60 bucketed float32 pack (32 line groups): "
          f"byte-equal under both builders {same}; seconds C++ "
          f"{secs['C++']!r}, NumPy {secs['NumPy']!r}; card host of {card}")
    check(same, "the pack differs between the builders")
    built["pack tomo256x60"] = secs
    return built


def gel_args(op, X, Y):
    """K1-K3 wrapper arguments of ``BatchedBlockDiagOperator`` over the
    bucketed ``op``: images ``X (nt, n_pad, n_pad)`` and sinograms ``Y
    (nt, n_angles, p)`` as its applies pass them (the weights shared:
    frame stride 0)."""
    XT = X.transpose(1, 2).contiguous()
    return {"banded_ata": (X, XT, op._bks, op.n_groups),
            "banded_fwd": (X, XT, op._bks, op._aidx, op.det_count,
                           op.n_groups),
            "banded_adj": (Y, op._bks, op._aidx, op.n_groups)}


def gel_path(dev, card, gen):
    """Phase 12b: the gelPhantom path at the reference's size, K1-K3
    against their plain versions and the host CSR product, the solvers'
    gates, launches, walls and device profiles, and K1-K3's device ms
    per apply. -> the kernel entries of the JSON line."""
    import tempfile

    import torch

    from trips_tpu_torch.core import BatchedBlockDiagOperator
    from trips_tpu_torch.krylov import cgls_normal
    from trips_tpu_torch.problems import (device_sparse_operator,
                                          generate_gelPhantom)
    from trips_tpu_torch.problems.gelphantom import read_frames
    from trips_tpu_torch.solvers import CGLS, Hybrid_LSQR
    from trips_tpu_torch.sparse import BucketedBandedProjector
    from trips_tpu_torch.sparse import banded_kernels as bk

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gel_") as tmp:
        X_true = gel_bundle(f"{tmp}/GelPhantomData_b4.mat")
        t1 = time.perf_counter()
        A, b, AA, B, nx, ny, nt = generate_gelPhantom(
            nx=GEL["nx"], angle_step=GEL["step"], data_dir=tmp)
        angles = read_frames(f"{tmp}/GelPhantomData_b4.mat")["angles"]
    t2 = time.perf_counter()
    check(abs(np.linalg.norm(b) - B_GEL_NORM) <= 1e-9 * B_GEL_NORM,
          f"gel inputs differ from the reference's: ||b|| "
          f"{np.linalg.norm(b)!r}")
    keep = np.arange(0, GEL["n_angles"], GEL["step"])
    op = device_sparse_operator(AA[0], nx=nx, angles=angles[keep],
                                device=dev)
    check(isinstance(op, BucketedBandedProjector), "gel: not the banded pack")
    blk = BatchedBlockDiagOperator(op, nt)
    t3 = time.perf_counter()
    print(f"[12b] gel bundle written in {t1 - t0:.2f} s (360-angle NumPy "
          f"matrix); generate_gelPhantom (C++ builder) {t2 - t1:.2f} s: A "
          f"{A.shape}, {nt} frames of {AA[0].shape} nnz {AA[0].nnz}; pack "
          f"{t3 - t2:.2f} s: {len(op.stacks)} buckets, W "
          f"{[tuple(st[0].shape) for st in op.stacks]}, {op.stored_bytes} "
          f"bytes")

    na, p = len(keep), op.det_count
    X = torch.randn(nt, op.n_pad, op.n_pad, device=dev, generator=gen)
    Y = torch.randn(nt, na, p, device=dev, generator=gen)
    args = gel_args(op, X, Y)
    max_abs, errs = {}, {}
    for name, a in args.items():
        got = getattr(bk, name + "_buckets")(*a)
        ref = getattr(bk, name + "_buckets_ref")(*a)
        torch.cuda.synchronize()
        check(got.shape == ref.shape, f"gel {name} shape")
        check(torch.equal(got, getattr(bk, name + "_buckets")(*a)),
              f"gel {name} differs from run to run")
        errs[name] = rel(got, ref)
        max_abs[name] = float((got - ref).abs().max())
        check(errs[name] <= KERNEL_RTOL, f"gel {name} rel err {errs[name]!r}")
    print(f"[12b] K1-K3 over {nt} frames (weight stride 0) vs plain, rel "
          f"err: {errs}; each bitwise the same in a second run")
    A64 = A.astype(np.float32).astype(np.float64)
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal(A.shape[1]), dtype=torch.float32,
                     device=dev)
    y = torch.tensor(rng.standard_normal(A.shape[0]), dtype=torch.float32,
                     device=dev)
    xd, yd = x.double().cpu().numpy(), y.double().cpu().numpy()
    for name, got, ref in (
            ("matvec", blk.matvec(x), A64 @ xd),
            ("rmatvec", blk.rmatvec(y), A64.T @ yd),
            ("normal_matvec", blk.normal_matvec(x), A64.T @ (A64 @ xd))):
        e = rel(got.cpu(), torch.from_numpy(ref))
        print(f"[12b] float32 {name} vs host block-diagonal CSR (float64): "
              f"rel err {e!r}")
        check(e <= KERNEL_RTOL, f"gel {name} vs CSR {e!r}")
    Ax, Aty = blk.matvec(x), blk.rmatvec(y)
    gap = abs(float(Ax.double() @ y.double())
              - float(x.double() @ Aty.double()))
    adj = gap / float(Ax.double().norm() * y.double().norm())
    print(f"[12b] adjointness {adj!r}")
    check(adj <= KERNEL_RTOL, f"gel adjointness {adj!r}")
    bk.reset_launch_counts()
    blk.matvec(x)
    blk.rmatvec(y)
    blk.normal_matvec(x)
    per = dict(bk.launch_counts)
    check(per == {"banded_fwd": 1, "banded_adj": 1, "banded_ata": 1},
          f"gel: one launch per apply over the frames: {per}")
    share = k1_share(lambda: blk.normal_matvec(x))
    print(f"[12b] K1 over the {nt} frames of the shared stack loads "
          f"{share!r} of the stored bytes it covers")

    # K1-K3 per apply over the frames: device ms, bound, plain, CSR product
    # (before any solver's profile: a session taken after the solvers'
    # saw no device time on the card, ROADMAP Queue 3 item 18)
    names = tuple(REPLACES)
    timed = {k + sfx: checked_ms((lambda f, a: lambda: f(*a))(
        getattr(bk, k + "_buckets" + sfx), args[k]), 2 if sfx else 10)
        for k in names for sfx in ("", "_ref")}
    ms = {k: timed[k][0] for k in names}
    plain = {k: timed[k + "_ref"][0] for k in names}
    parent_k = parent_banded()
    parent_ms = parent_k and parent_k13(parent_k, args["banded_adj"],
                                        args["banded_ata"],
                                        lambda f: checked_ms(f, 10)[0])
    if parent_ms:
        print(f"[12b] K3 and K1 over {nt} frames, this tree and PARENT in "
              f"turns, device ms: {parent_ms}; card {card}")
    # least bytes: the pack (W, S, Pm) and angle ids once, the images and
    # sinograms in and out once; 2 flops per nonzero weight, frame and pass
    pack = sum(nbytes(*k[:4]) for k in op._bks)
    ids = nbytes(*op._aidx)
    nz = sum(int((k[0] != 0).sum()) for k in op._bks) * nt
    img, sino = nbytes(X), nbytes(Y)
    bounds = {"banded_ata": bound(pack + 2 * img, 4 * nz, F32_FLOPS),
              "banded_fwd": bound(pack + ids + img + sino, 2 * nz, F32_FLOPS),
              "banded_adj": bound(pack + ids + sino + img, 2 * nz, F32_FLOPS)}
    M = A.astype(np.float32).tocsr()
    MT = M.T.tocsr()
    (Mt, idx), (MTt, _) = library_csr(M, dev), library_csr(MT, dev)
    xv = torch.randn(M.shape[1], device=dev, generator=gen)
    yv = torch.randn(M.shape[0], device=dev, generator=gen)
    e_lib = max(rel(Mt @ xv, blk.matvec(xv)), rel(MTt @ yv, blk.rmatvec(yv)))
    check(e_lib <= KERNEL_RTOL, f"gel block-diagonal CSR vs the pack {e_lib!r}")
    lib_runs = {"banded_fwd": lambda: Mt @ xv, "banded_adj": lambda: MTt @ yv,
                "banded_ata": lambda: MTt @ (Mt @ xv)}
    lib_timed = {k: checked_ms(f, 10) for k, f in lib_runs.items()}
    library_ms = {k: v[0] for k, v in lib_timed.items()}
    print(f"[12b] one apply over {nt} frames ({pack} B of pack, {nz} nonzero "
          f"weights x frames), device ms ("
          + ", ".join(f"{k} {v[1]}" for k, v in {**timed, **{
              "csr " + k: v for k, v in lib_timed.items()}}.items())
          + "): " + "; ".join(
              f"{k} {ms[k]!r} (bound {bounds[k][0]!r}, {bounds[k][1]}; plain "
              f"{plain[k]!r}; block-diagonal CSR {library_ms[k]!r})"
              for k in names)
          + f"; CSR ({idx} indices, nnz {M.nnz}) agrees with the pack to "
          f"{e_lib!r}; card {card}")
    # the solvers: counts from 0 just before, read just after
    bv = torch.tensor(b, dtype=torch.float32, device=dev)
    x0 = torch.zeros(blk.shape[1], dtype=torch.float32, device=dev)
    x_true = X_true.reshape(-1)
    its = GEL_ITERS
    solves = {
        "CGLS": (lambda: CGLS(blk, bv, x0, its["CGLS"], TOL)[0],
                 lambda info: (its["CGLS"] + 1, its["CGLS"] + 1, 0)),
        "cgls_normal": (lambda: cgls_normal(blk, bv, x0,
                                            its["cgls_normal"])[0],
                        lambda info: (0, 1, its["cgls_normal"] + 1)),
        "Hybrid LSQR gcv": (lambda: Hybrid_LSQR(
            blk, bv, n_iter=its["Hybrid LSQR gcv"], regparam="gcv"),
            lambda info: (info["matvec_count"] // 2,
                          info["matvec_count"] // 2, 0)),
    }
    walls, fns = {}, {}
    bk.reset_launch_counts()
    for name, (fn, expect) in solves.items():
        before = dict(bk.launch_counts)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t) / its[name] * 1e3
        xs, info = out if isinstance(out, tuple) else (out, None)
        got = {k: bk.launch_counts[k] - before[k] for k in before}
        want = expect(info)
        xs = xs.double().cpu().numpy().reshape(-1)
        check(xs.shape == x_true.shape and np.isfinite(xs).all(),
              f"gel {name} solution")
        err = float(np.linalg.norm(xs - x_true) / np.linalg.norm(x_true))
        ref = JAX_GEL_RELERR[name]
        print(f"[12b] {name}: relError final {err!r} (JAX CPU {ref!r}, gate "
              f"{GEL_GATE}); launches {got} (expected K2, K3, K1 {want}); "
              f"wall {walls[name]!r} ms/iter ({its[name]} iterations, set-up "
              f"included); card {card}")
        check((got["banded_fwd"], got["banded_adj"], got["banded_ata"])
              == want, f"gel {name} launches {got} vs {want}")
        check(abs(err - ref) <= GEL_GATE, f"gel {name} final relError {err!r}")
        fns[name] = fn
    launches = dict(bk.launch_counts)
    print(f"[12b] launches in the gel path: {launches}")
    check(all(v > 0 for v in launches.values()),
          "a kernel never launched in the gel path")
    # cgls_normal's loop replayed as a CUDA graph against the same loop
    # stepped eagerly: x and k to the bit, launches equal
    n = its["cgls_normal"]
    (_, k), tg, te, got = graph_vs_eager(
        "gel cgls_normal", lambda: cgls_normal(blk, bv, x0, n),
        lambda j: cgls_normal(blk, bv, x0, j))
    print(f"[12b] cgls_normal, replayed graph vs eager: x and k ({k}) "
          f"bitwise equal, launches {got} in both; wall {tg / n * 1e3!r} / "
          f"{te / n * 1e3!r} ms/iter (set-up and the capture included); "
          f"card {card}")
    for name, fn in fns.items():
        parts = {}
        try:
            busy = device_ms(fn, 1, parts, sessions=1) / its[name]
        except RuntimeError as e:  # ROADMAP Queue 3 item 18
            print(f"[12b] {name}: device busy not measured ({e}); wall "
                  f"{walls[name] * 1e3!r} us/iter; card {card}")
            continue
        top = sorted(parts.items(), key=lambda kv: -kv[1])[:5]
        print(f"[12b] {name}: device busy {busy * 1e3!r} us/iter, wall "
              f"{walls[name] * 1e3!r} us/iter, idle share "
              f"{1 - busy / walls[name]!r}; busy by kernel (us/iter): "
              + ", ".join(f"{k} {v / its[name] * 1e3!r}" for k, v in top)
              + f"; card {card}")

    return [{"name": k + "_gel", "route": "cuda",
             "source": "trips_tpu_torch/csrc/banded.cu",
             "replaces": REPLACES[k], "launches": launches[k],
             "max_abs_err": max_abs[k], "ms": ms[k], "plain_ms": plain[k],
             "timing": timed[k][1],
             "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
             "library_ms": library_ms[k],
             "path": f"gelPhantom, {nt} frames of {nx}x{nx}, {na} angles, "
                     f"BatchedBlockDiagOperator over one float32 pack",
             "library": f"block-diagonal float32 CSR "
                        f"(torch.sparse_csr_tensor, {idx} indices)",
             **({"parent_ms": parent_ms[k]["parent"]}
                if parent_ms and k in parent_ms else {})}
            for k in names]


def demo_twins(dev, card):
    """Phase 12c-d: the twins of demos/demo_l_curve.py and
    demo_small_scale_cgls.py at their defaults, on the card."""
    import torch

    from trips_tpu_torch.demos import demo_l_curve, demo_small_scale_cgls
    from trips_tpu_torch.sparse import banded_kernels as bk

    bk.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = demo_l_curve.main(["--device", str(dev)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    got = dict(bk.launch_counts)
    # GKS: golub_kahan over 3 steps, A.matmat(V), then a K3 and a K2 an
    # iteration; MMGKS: the same set-up and A.rmatvec(b), then two K2 and
    # a K3 an iteration; the hybrids count their own applies
    n, d = 20, 3
    want = [0, 0]
    for name, (_, _, info) in res.items():
        if name.startswith("GKS"):
            k2, k3 = d + 1 + n, d + n
        elif name.startswith("MMGKS"):
            k2, k3 = d + 1 + 2 * n, d + 1 + n
        else:
            k2 = k3 = info["matvec_count"] // 2
        want[0] += k2
        want[1] += k3
    for name, (err, lam, _) in res.items():
        ref, ref_lam = JAX_LCURVE[name]
        print(f"[12c] demo_l_curve {name}: relError final {err!r} (JAX CPU "
              f"float32 {ref!r}, gate {LCURVE_GATE}; float64 "
              f"{JAX_LCURVE_F64[name][0]!r}), lambda {lam!r} (JAX float32 "
              f"{ref_lam!r}, float64 {JAX_LCURVE_F64[name][1]!r})")
        check(abs(err - ref) <= LCURVE_GATE,
              f"demo_l_curve {name} final relError {err!r}")
    print(f"[12c] demo_l_curve: launches {got} (expected K2 {want[0]}, K3 "
          f"{want[1]}), {wall:.2f} s for the six solves and the problem; "
          f"card {card}")
    check((got["banded_fwd"], got["banded_adj"]) == tuple(want)
          and got["banded_ata"] == 0, f"demo_l_curve launches {got}")
    # the six solves again, walled, then profiled (one session)
    OP, b, L, delta, _, _ = demo_l_curve.problem(64, 30, dev)
    bv = torch.tensor(b, dtype=torch.float32, device=dev)
    runs = demo_l_curve.solves(OP, bv, L, delta, n)

    def six():
        for solve in runs.values():
            solve()

    torch.cuda.synchronize()
    t = time.perf_counter()
    six()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    parts = {}
    try:
        busy = device_ms(six, 1, parts, sessions=1, warm=False)
    except RuntimeError as e:  # ROADMAP Queue 3 item 18
        print(f"[12c] demo_l_curve's six solves: wall {wall!r} ms, device "
              f"busy not measured ({e}); card {card}")
    else:
        top = sorted(parts.items(), key=lambda kv: -kv[1])[:5]
        print(f"[12c] demo_l_curve's six solves ({6 * n} iterations): wall "
              f"{wall!r} ms, device busy {busy!r} ms, idle share "
              f"{1 - busy / wall!r}; busy by kernel (ms): "
              + ", ".join(f"{k} {v!r}" for k, v in top) + f"; card {card}")
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, info = demo_small_scale_cgls.main(["--device", str(dev)])
    torch.cuda.synchronize()
    err = float(info["relError"][-1])
    print(f"[12d] demo_small_scale_cgls: its {info['its']} (JAX "
          f"{JAX_SMALL_CGLS[0]}), relError final {err!r} (JAX CPU "
          f"{JAX_SMALL_CGLS[1]!r}, gate {LCURVE_GATE}); "
          f"{time.perf_counter() - t:.2f} s")
    check(info["its"] == JAX_SMALL_CGLS[0], "demo_small_scale_cgls its")
    check(abs(err - JAX_SMALL_CGLS[1]) <= LCURVE_GATE,
          f"demo_small_scale_cgls final relError {err!r}")


def bsr_checks(dev, card, A):
    """Phase 12e: ``BsrOperator`` on tomo256x60's matrix with float32,
    bfloat16 and int8 blocks against the host product of its stored
    values, each apply's device ms beside the exact ``CsrOperator``'s."""
    import torch

    from trips_tpu_torch.sparse import BsrOperator, CsrOperator

    gen = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn(A.shape[1], device=dev, generator=gen)
    y = torch.randn(A.shape[0], device=dev, generator=gen)
    xd, yd = x.double().cpu().numpy(), y.double().cpu().numpy()
    ops = {"csr float32": CsrOperator.from_scipy(A, dtype=torch.float32,
                                                 device=dev)}
    for block in (None, "bfloat16", "int8"):
        ops[f"bsr {block or 'float32'}"] = BsrOperator.from_scipy(
            A, dtype=np.float32, block_dtype=block, device=dev)
    for name, op in ops.items():
        M = CsrOperator.to_scipy(op).astype(np.float64)
        errs = {fn: rel(getattr(op, fn)(v).cpu(), torch.from_numpy(ref))
                for fn, v, ref in (("matvec", x, M @ xd),
                                   ("rmatvec", y, M.T @ yd))}
        t = {fn: checked_ms((lambda f, v: lambda: f(v))(getattr(op, fn), v),
                            10) for fn, v in (("matvec", x), ("rmatvec", y))}
        extra = (f", stored bytes (JAX's blocks) {op.stored_bytes}, density "
                 f"{op.stored_density!r}" if name.startswith("bsr") else "")
        print(f"[12e] {name}: vs the host product of its stored values, rel "
              f"err {errs}; device ms matvec {t['matvec'][0]!r} "
              f"({t['matvec'][1]}), rmatvec {t['rmatvec'][0]!r} "
              f"({t['rmatvec'][1]}){extra}; card {card}")
        check(max(errs.values()) <= KERNEL_RTOL, f"{name} {errs}")


def phase12(dev, card, gen, A, dyn):
    """Phase 12: the C++ builder, the gelPhantom path, the two demo twins,
    ``BsrOperator``, ``iters_to_tol``. -> the gel path's kernel entries."""
    from trips_tpu_torch.bench import iters_to_tol

    t0 = time.perf_counter()
    builder_checks(dev, card, A, dyn)
    secs = {"a": time.perf_counter() - t0}
    with numpy_builder(False):
        entries = gel_path(dev, card, gen)
        secs["b"] = time.perf_counter() - t0 - sum(secs.values())
        demo_twins(dev, card)
        secs["c-d"] = time.perf_counter() - t0 - sum(secs.values())
        bsr_checks(dev, card, A)
        secs["e"] = time.perf_counter() - t0 - sum(secs.values())
        rows = iters_to_tol.compare(device=dev)
    print(f"[12f] iters_to_tol.compare on the card (float64 ELL): {rows}; "
          f"JAX CPU float64 (name, reference, trips_tpu) {JAX_ITERS_TO_TOL}")
    for (name, k_ref, k), (jname, jk_ref, _) in zip(rows, JAX_ITERS_TO_TOL):
        check(name == jname and k_ref == jk_ref
              and abs(k - k_ref) <= max(2, int(0.05 * k_ref)),
              f"iters_to_tol {name}: {k} against {k_ref}")
    secs["f"] = time.perf_counter() - t0 - sum(secs.values())
    print(f"[12] took {time.perf_counter() - t0:.1f} s (by part: "
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items())
          + f"); card {card}")
    return entries


# Phase 13: the port's twins of the demos at full width, each through its
# ``main`` with the arguments of ``TWIN_ARGS`` (those of
# demo_reference.TWINS; ``demo_your_data`` at its defaults, offline on
# the 'H' image) and the default C++ matrix builder, as a user builds.
# JAX_TWINS: the relErrors of the JAX demos on the same arguments, in the
# order their ``relerr`` returned them (``python3 demo_reference.py
# twins``: JAX 0.9.0, x64 off, trips_tpu's C++ builder; ``data_twins``
# for ``demo_your_data``), each held to TWIN_GATE; where the port's float32 formula
# departs from JAX's, to JAX's float64 run, as [8] and [9] hold the same
# solves (JAX_TWINS_F64; JAX's float32 value printed beside). The fused
# dynamic demo's float32 GCV solves are gated too: where their search
# stops follows the rounding (the port's float32 isoTV run on the CPU ends
# 2.5e-3 from JAX's), but on the card K1-K3 now give the same bits every
# run, and there they read 1.3e-5 to 6.0e-5 from JAX's (PERF.md). Their
# twins on float64 data are held to JAX's float64-data run (``python3
# demo_reference.py twins64``), and the demo's own resume to its
# uninterrupted run bit for bit (its ``assert``).
TWIN_ARGS = {
    "demo_tomography": ["--large"],
    "demo_dynamic_ct": ["--nx", "128", "--nt", "33"],
    "demo_1d_deblurring": [],
    "demo_2d_deblurring": ["--large"],
    "demo_fused_tpu deblur1d": ["--config", "deblur1d"],
    "demo_fused_tpu tomo": ["--config", "tomo", "--nx", "256", "--views",
                            "60"],
    "demo_fused_dynamic": ["--nx", "128", "--nt", "33", "--views", "10"],
    "demo_your_data": [],
}
JAX_TWINS = {
    "demo_tomography": [0.09874777204896255, 0.1089005897518851,
                        0.09466278723232295],
    "demo_dynamic_ct": [0.19911505380756225, 0.2056388046428135,
                        0.19599362557544941, 0.1954971233155815,
                        0.2138619330883729],
    "demo_1d_deblurring": [0.02009361299742136, 0.02158552110260634,
                           0.026406024557281627, 0.0280225852528115,
                           0.028009884393942166, 0.032951894158374],
    "demo_2d_deblurring": [0.23538614945619546, 0.17869259320625058,
                           0.18204715128369964, 0.29352282708106026,
                           0.10051751146262866, 0.2447749805402716],
    "demo_fused_tpu deblur1d": [0.02438090327812814, 0.033391713771796006,
                                0.02273225973608446, 0.06398963097327078,
                                0.027720378021863532, 0.0279952084243336,
                                0.028460495108796915],
    "demo_fused_tpu tomo": [0.12610532343387604, 0.12584705650806427,
                            0.13773222267627716, 0.12394478172063828,
                            0.1386227160692215, 0.1385783702135086,
                            0.1377069354057312],
    "demo_fused_dynamic": [0.2106951936389655, 0.2135198251865873,
                           0.21064778173235624],
    "demo_your_data": [0.19812042631270055],
}
# (twin, index of the solve) -> JAX float64: fused GKS with DP on the 1D
# problem is [9]'s "fused GKS dp" (the same solve); on the tomo
# configuration fused GKS with GCV and DP and fused MMGKS with GCV, as [8]
# holds fused GKS and MMGKS (``demo_reference.py twins64``: float64 data,
# the bfloat16 pack; the port's float32 GCV run on the CPU ends at 0.1264,
# JAX's float32 at 0.1261, its float64 at 0.1264)
JAX_TWINS_F64 = {("demo_fused_tpu deblur1d", 1):
                 JAX_DEBLUR_F64["fused GKS dp"][0],
                 ("demo_fused_tpu tomo", 0): 0.12639068568242373,
                 ("demo_fused_tpu tomo", 1): 0.12584688455245555,
                 ("demo_fused_tpu tomo", 3): 0.12400420004040028}
# the fused dynamic demo's isoTV and GS MMGKS with GCV on float64 data
# (``demo_reference.py twins64``); the port's float32 isoTV run on the CPU
# ends at 0.21324, JAX's float32 at 0.21070
JAX_TWINS_DYN_F64 = {"isoTV": 0.21123196240569192,
                     "GS": 0.2135538142822808}
TWIN_GATE = 1e-3
# K2, K3, K1 launches each twin's loops imply (see phase13)
TWIN_LAUNCHES = {
    # GKS (d + 1 + n, d + n), Hybrid LSQR (n, n), MMGKS (d + 1 + 2n,
    # d + 1 + n); d = 3, n = 30
    "demo_tomography": (34 + 30 + 64, 33 + 30 + 34, 0),
    # static frames on ELL; three MMGKS on the frame-varying pack (a K2 per
    # column of A V: 2d + 2n, d + 1 + n; d = 4, n = 20); Hybrid LSQR (n, n)
    "demo_dynamic_ct": (3 * 48 + 20, 3 * 25 + 20, 0),
    "demo_1d_deblurring": (0, 0, 0),
    "demo_2d_deblurring": (0, 0, 0),
    "demo_fused_tpu deblur1d": (0, 0, 0),
    # fused GKS twice per rule (19, 18), fused MMGKS (34, 19), fused Hybrid
    # LSQR (20, 20), cgls twice (1 + 20 each way), cgls_normal twice (one
    # K3 and 1 + 20 K1)
    "demo_fused_tpu tomo": (6 * 19 + 34 + 20 + 2 * 21,
                            6 * 18 + 19 + 20 + 2 * 21 + 2, 2 * 21),
    # fused MMGKS twice (d + 3 + 2n, d + 1 + n; d = 3, n = 10); the
    # checkpointed runs: a whole one, the killed one (set-up and 6
    # iterations), the resumed one (4 iterations, no set-up)
    "demo_fused_dynamic": (2 * 26 + 26 + 18 + 8, 2 * 14 + 14 + 10 + 4, 0),
    "demo_your_data": (0, 0, 0),  # Blur2D: a conv2d
}


def phase13(dev, card):
    """Phase 13: the demo twins at full width on the card: each
    relError against the JAX demo's, K1-K3 launches against the loops'
    counts, the fused dynamic demo's resume bit for bit, each wall."""
    import importlib

    import torch

    from trips_tpu_torch.operators import CenteredSpaceTimeDerivative
    from trips_tpu_torch.problems import generate_synthetic_dynamic
    from trips_tpu_torch.solvers.fused import fused_mmgks
    from trips_tpu_torch.sparse import DynamicBandedOperator
    from trips_tpu_torch.sparse import banded_kernels as bk

    t0 = time.perf_counter()
    walls, total = {}, {k: 0 for k in bk.launch_counts}
    for twin, argv in TWIN_ARGS.items():
        mod = importlib.import_module(
            f"trips_tpu_torch.demos.{twin.split()[0]}")
        bk.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = mod.main(argv + ["--device", str(dev)])
        torch.cuda.synchronize()
        walls[twin] = time.perf_counter() - t
        got = dict(bk.launch_counts)
        for k in total:
            total[k] += got[k]
        if twin == "demo_fused_dynamic":
            out, same = out
            check(same, "demo_fused_dynamic: the resumed run differs")
        out = {k: float(v) for k, v in out.items()}
        errs = list(out.values())
        ref = JAX_TWINS[twin]
        check(len(errs) == len(ref), f"{twin}: {len(errs)} solves")
        lines = []
        for k, (name, err) in enumerate(out.items()):
            r32 = ref[k]
            r = JAX_TWINS_F64.get((twin, k), r32)
            lines.append(f"{name} {err!r} (JAX float32 {r32!r}"
                         + (f", float64 {r!r}" if r != r32 else "") + ")")
            check(abs(err - r) <= TWIN_GATE,
                  f"{twin} {name}: relError {err!r} against {r!r}")
        want = dict(zip(("banded_fwd", "banded_adj", "banded_ata"),
                        TWIN_LAUNCHES[twin]))
        print(f"[13] {twin} {' '.join(argv)}: " + "; ".join(lines)
              + f"; launches {got} (expected {want}); wall "
              f"{walls[twin]:.2f} s; card {card}")
        check(got == want, f"{twin} launches {got} vs {want}")
    # the fused dynamic demo's two GCV solves on float64 data, the gated
    # twins of its float32 ones
    (_, b, AA, _, nx, ny, nt, _, x_true, al) = generate_synthetic_dynamic(
        nx=128, nt=33, views=10, noise_level=0.01, return_angles=True)
    op = DynamicBandedOperator.from_frames(AA, nx, al, n_groups=8,
                                           device=dev)
    Ltv = CenteredSpaceTimeDerivative(nx, ny, nt, device=dev)
    bd = torch.tensor(b, dtype=torch.float64, device=dev)
    for mode in ("isoTV", "GS"):
        x = fused_mmgks(op, bd, Ltv if mode == "isoTV" else None, pnorm=2.0,
                        qnorm=1.0, projection_dim=3, n_iter=10,
                        regparam_mode="gcv", weight_mode=mode,
                        prob_dims=(nx, ny, nt), device=dev)[0]
        err = float(np.linalg.norm(x.double().cpu().numpy().reshape(-1)
                                   - x_true) / np.linalg.norm(x_true))
        ref = JAX_TWINS_DYN_F64[mode]
        print(f"[13] demo_fused_dynamic's {mode} MMGKS with GCV on float64 "
              f"data: relError {err!r} (JAX float64 {ref!r}, gate "
              f"{TWIN_GATE})")
        check(abs(err - ref) <= TWIN_GATE,
              f"fused dynamic {mode} float64 data: {err!r} against {ref!r}")
    took = time.perf_counter() - t0
    print(f"[13] took {took:.1f} s (twins {sum(walls.values()):.1f} s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in walls.items())
          + f"); launches {total}; card {card}")
    return total


# Phase 14: the tall-skinny QR of MMGKS's panels at the dynamic cell's
# shapes (dyn128x33, float32): the data panel, 71,610 rows and k + 2 <= 25
# columns, unweighted (wf is applied before, as solvers/mmgks.py does), and
# for the weighted form's sake weighted too; CenteredSpaceTimeDerivative's
# 1,622,016 rows at k <= 23, weighted. Gates: float32 on these Gaussian
# panels, 2e-5 of the float64 numbers (tests/test_torch_cuda.py TSQR_TOL).
TSQR_CASES = ((71610, 25, False), (71610, 25, True), (1622016, 23, True))
TSQR_GATE = 2e-5


def phase14(dev, card, launches):
    """``tsqr_geqrf`` (``sparse/tall_qr.py``) at TSQR_CASES: R^T R against
    the float64 Gram matrix, R against LAPACK's float64 R up to row signs
    and against the plain version on the card, the same bits twice, one
    launch a call; then its device ms beside the bound (one read of the
    panel and its weights against 2 m k^2 float32 operations), the plain
    version's wall (CUDA events) and the library's device ms
    (``torch.linalg.qr(mode="r")`` of the weighted panel, cuSOLVER).
    ``launches``: phase [7]'s counts per solve. Returns the kernel's entry
    for the ``kernels`` line."""
    import torch
    from trips_tpu_torch.sparse import tall_qr

    t0 = time.perf_counter()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes, worst = {}, 0.0
    for m, k, weighted in TSQR_CASES:
        form = "weighted" if weighted else "unweighted"
        g = torch.Generator(device=dev).manual_seed(m + k)
        x = torch.randn(m, k, generator=g, device=dev)
        w = torch.rand(m, generator=g, device=dev) + 0.25 if weighted else None
        tall_qr.reset_launch_counts()
        R = tall_qr.tall_r(x, w)
        check(torch.equal(R, tall_qr.tall_r(x, w)),
              f"tsqr_geqrf {m}x{k} {form} differs from run to run")
        check(tall_qr.launch_counts == {"tsqr_geqrf": 2, "qr_library": 0},
              f"tsqr_geqrf {m}x{k} {form} launches {tall_qr.launch_counts}")
        X = x.double() if w is None else x.double() * w.double()[:, None]
        Rl = torch.linalg.qr(X, mode="r")[1]
        Rd = R.double()
        d = torch.sign(torch.diagonal(Rd) * torch.diagonal(Rl))
        gap = rel(d[:, None] * Rd, Rl)
        G = X.T @ X
        gram = float((Rd.T @ Rd - G).norm() / G.norm())
        Rp = tall_qr.tall_r_ref(x, w, n_sm=sms)
        plain_gap = rel(R, Rp)
        worst = max(worst, float((R - Rp).abs().max()))
        check(max(gap, gram, plain_gap) <= TSQR_GATE,
              f"tsqr_geqrf {m}x{k} {form}: R {gap!r}, Gram {gram!r}, plain "
              f"{plain_gap!r}")
        del X, G
        ms, source = checked_ms(lambda: tall_qr.tall_r(x, w), 20)
        plain = cuda_ms(lambda: tall_qr.tall_r_ref(x, w, n_sm=sms), 2)
        Xw = x if w is None else x * w[:, None]
        library, _ = checked_ms(lambda: torch.linalg.qr(Xw, mode="r"), 5)
        bnd = bound(nbytes(x, w, R), 2 * m * k * k, F32_FLOPS)
        p = tall_qr.plan(m, k, 4, sms)
        shapes[f"{m}x{k} {form}"] = dict(
            ms=ms, source=source, plain_ms=plain, library_ms=library,
            bound_ms=bnd[0], bound_by=bnd[1], rel_err=gap, gram_err=gram,
            plain_rel_err=plain_gap, plan=p._asdict())
        print(f"[14] tsqr_geqrf {m}x{k} float32 {form}, {p}: {ms!r} ms "
              f"({source}), bound {bnd[0]!r} ms ({bnd[1]}), plain "
              f"{plain!r} ms, library torch.linalg.qr(mode='r') "
              f"{library!r} ms; R against LAPACK float64 {gap!r}, Gram "
              f"{gram!r}, against the plain version {plain_gap!r}; card "
              f"{card}")
        del x, w, Xw, R, Rp
    print(f"[14] took {time.perf_counter() - t0:.1f} s")
    main = shapes["1622016x23 weighted"]
    return {"name": "tsqr_geqrf", "route": "cuda",
            "source": "trips_tpu_torch/csrc/tsqr.cu",
            "replaces": "none: jnp.linalg.qr at "
                        "trips_tpu/solvers/mmgks.py:91-92 (cuSOLVER geqr2 "
                        "on this card)",
            "launches": {name: n for name, n in launches.items()
                         if "MMGKS" in name},
            "max_abs_err": worst, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shapes": shapes}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from trips_tpu_torch import _build
    from trips_tpu_torch.core import loop
    from trips_tpu_torch.krylov import cgls, cgls_normal
    from trips_tpu_torch.krylov.cgls import CHUNK, _cgn_chunk, _cgn_init
    from trips_tpu_torch.operators import FirstDerivative2D, ShearFanProjector
    from trips_tpu_torch.operators import shear_kernels as sk
    from trips_tpu_torch.problems import Tomography, device_sparse_operator
    from trips_tpu_torch.parallel import sharding
    from trips_tpu_torch.solvers import CGLS
    from trips_tpu_torch.sparse import BandedProjector
    from trips_tpu_torch.sparse import banded_kernels as bk

    # phases 2-11 hold the port to JAX numbers made with the NumPy matrix
    # builder; phase 12 builds with the C++ one
    os.environ["TRIPS_TPU_NO_NATIVE"] = "1"
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
    b_noisy, delta = tomo.add_noise(b, "Gaussian", NOISE)
    delta = float(delta)
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
                check(torch.equal(got, getattr(bk, name)(*a)),
                      f"{name} {kind} differs from run to run")
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
        check(torch.equal(got, bk.banded_ata_buckets(*args)),
              f"banded_ata_buckets {kind} differs from run to run")
        share = k1_share(lambda: bk.banded_ata_buckets(*args))
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
        for name, args in (("banded_fwd", fwd_buckets(op, X)),
                           ("banded_adj", adj_buckets(op, Ys))):
            again = getattr(bk, name + "_buckets")(*args)
            check(torch.equal(again, outs[name]),
                  f"{name}_buckets {kind} differs from run to run")
        # K3 in fixed point: zeros in, zeros out; a NaN in, NaN out
        zero = bk.banded_adj_buckets(*adj_buckets(op, torch.zeros_like(Ys)))
        Yn = Ys.clone()
        Yn[1, 2] = float("nan")
        nan = bk.banded_adj_buckets(*adj_buckets(op, Yn))
        check(not zero.any() and bool(torch.isnan(nan).all()),
              f"banded_adj_buckets {kind} on zero / NaN input")
        print(f"[2] {kind} kernels vs plain, worst bucket rel err: "
              + ", ".join(f"{k} {v!r}" for k, v in worst.items())
              + f"; over all {len(op.stacks)} buckets in one launch each: "
              f"banded_ata {e!r} (loads {share!r} of the pack's stored "
              f"bytes), "
              + ", ".join(f"{k} {v!r}" for k, v in e_all.items())
              + "; K1-K3 per bucket and over all buckets bitwise the same "
              "in a second run; K3 of zeros zero, of a NaN all NaN")

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
            if name != "gcontract_ata":
                check(torch.equal(got, getattr(sk, name)(*args, **kw)),
                      f"{name} {kind} differs from run to run")
        print(f"[2] shear {kind} kernels vs plain: " + ", ".join(errs)
              + "; shear_rotate and shear_rotate_adjoint bitwise the same "
              "in a second run")
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
    # K1 and K3 add in fixed point: the same float32 solve again, its
    # history and iterate the same bits as the first's
    runs = []
    for _ in range(2):
        s, errs = _cgn_init(ops["float32"], bv, x0), []
        for it in range(1, CGN_ITERS + 1):
            s = _cgn_chunk(ops["float32"], 0.0, s, it)
            errs.append(float((s.x - xt).norm() / xt_norm))
        runs.append((np.array(errs), s.x))
    same = (np.array_equal(runs[0][0], runs[1][0])
            and torch.equal(runs[0][1], runs[1][1]))
    print(f"[3] cgls_normal float32 run twice: relError histories and "
          f"final iterates bitwise equal: {same}; max |difference| "
          f"{float(np.abs(runs[0][0] - runs[1][0]).max())!r}")
    check(same, "cgls_normal float32 differs from run to run")
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

    # the loops as replayed CUDA graphs (one captured step each) against
    # the same loops stepped eagerly on the same card: x and k to the bit,
    # the launches equal; then the launches of one replay
    graph_runs = {}
    cases = [(f"banded {kind} {solver}", fn, op, False, its)
             for kind, op in ops.items()
             for solver, fn, its in (("cgls", cgls, CGLS_ITERS),
                                     ("cgls_normal", cgls_normal, CGN_ITERS))]
    cases += [(f"shear {kind} G {solver}", fn, op, on, CGLS_ITERS)
              for kind, op in shear_ops.items()
              for solver, fn, on in (("cgls", cgls, False),
                                     ("cgls_normal K6", cgls_normal, True))]
    for label, fn, op, on, its in cases:
        with shear_ata(on):
            (_, k), tg, te, got = graph_vs_eager(
                label, lambda fn=fn, op=op, its=its: fn(op, bv, x0, its, 0.0),
                lambda j, fn=fn, op=op: fn(op, bv, x0, j, 0.0))
        graph_runs[label] = (k, got)
        print(f"[3] {label}, {its} iterations, replayed graph vs eager: x "
              f"and k ({k}) bitwise equal, launches {got} in both; wall "
              f"{tg / k * 1e3!r} / {te / k * 1e3!r} ms/iter (set-up and the "
              f"capture included); card {card}")
    per_replay = {}
    for label, fn, op, on in (
            ("banded float32 cgls", cgls, f32, False),
            ("banded float32 cgls_normal", cgls_normal, f32, False),
            ("shear bfloat16 G cgls", cgls, shear_ops["bfloat16"], False),
            ("shear bfloat16 G cgls_normal K6", cgls_normal,
             shear_ops["bfloat16"], True)):
        counts = []
        with shear_ata(on):
            for j in (1, CHUNK + 1):  # one step eagerly, then CHUNK replays
                bk.reset_launch_counts()
                sk.reset_launch_counts()
                fn(op, bv, x0, j, 0.0)
                torch.cuda.synchronize()
                counts.append({**bk.launch_counts, **sk.launch_counts})
        per_replay[label] = {n: (counts[1][n] - counts[0][n]) / CHUNK
                             for n in counts[0]
                             if counts[1][n] != counts[0][n]}
    print(f"[3] launches per replay of a captured step: {per_replay}")
    check(per_replay["banded float32 cgls_normal"] == {"banded_ata": 1}
          and per_replay["banded float32 cgls"] == {"banded_fwd": 1,
                                                    "banded_adj": 1},
          f"banded launches per replay {per_replay}")

    # ---- 6. the demo's regularized solvers: gates, launches, walls -----
    # (walls here, before any profiler session; device profiles after 5)
    demo = demo_solves(OP, bv, FirstDerivative2D(nx, ny, device=dev), delta)
    demo_wall, demo_launches = {}, {}
    for name, (solve, expect) in demo.items():
        bk.reset_launch_counts()
        xs, info = solve(x_true)
        got = dict(bk.launch_counts)
        want = expect(info)
        hist = np.array(info["relError"])
        final, lam = float(hist[-1]), info["regParam"]
        check(tuple(xs.shape) == (nx * ny, 1)
              and bool(torch.isfinite(xs).all()), f"{name} solution")
        check(len(hist) == len(info["xHistory"]) == len(
            info["regParam_history"]) and np.isfinite(hist).all(),
              f"{name} history")
        demo_launches[name] = got
        runs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            solve()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t) / DEMO_ITERS * 1e3)
        demo_wall[name] = float(np.mean(runs))  # ms per iteration
        ref, gate = JAX_DEMO_RELERR[name], DEMO_GATES[name]
        print(f"[6] {name}: its {info['its']}, relError final {final!r} "
              f"(JAX CPU {ref!r}, gate {gate}), min {float(hist.min())!r} "
              f"at iteration {int(hist.argmin()) + 1}, last lambda {lam!r}; "
              f"launches {got} (expected K2 {want[0]}, K3 {want[1]}); wall "
              f"{demo_wall[name]!r} ms/iter (two solves: {runs!r}, set-up "
              f"included)")
        check((got["banded_fwd"], got["banded_adj"]) == want
              and got["banded_ata"] == 0, f"{name} launches {got} vs {want}")
        check(abs(final - ref) <= gate, f"{name} final relError {final!r}")

    # ---- 7. dynamic CT: gates, launches, walls (before any profiler) ---
    dyn = dynamic_path(dev, card, gen)

    # ---- 8. the all-on-device solvers: gates, launches, walls, syncs ---
    fused = fused_path(dev, card, OP, bv, FirstDerivative2D(nx, ny,
                                                            device=dev),
                       delta, x_true, dyn)

    # ---- 4. times ------------------------------------------------------
    nnz = A.nnz
    kernel_wall = {}  # (path, kind, solver) -> ms/iter of the kernels' runs
    for kind, op in ops.items():
        for solver, fn in (("cgls_normal", cgls_normal), ("cgls", cgls)):
            walls = {}
            # kernels: the loop replayed as a CUDA graph; eager: the same
            # kernels, the loop stepped eagerly; plain: eagerly on the
            # kernels' plain versions
            for label, o in (("plain", plain_copy(op)), ("kernels", op),
                             ("eager", op), ("eager", op), ("kernels", op),
                             ("plain", plain_copy(op))):
                with (loop.eager() if label == "eager"
                      else contextlib.nullcontext()):
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
                if label != "plain":
                    kernel_wall["banded", kind, solver
                                + " eager" * (label == "eager")] = ms
            if kind == "float32":  # host syncs, replayed and eagerly
                syncs = [sum(count_syncs(lambda: fn(op, bv, x0, TIMED_ITERS,
                                                    0.0)).values())]
                with loop.eager():
                    syncs.append(sum(count_syncs(lambda: fn(
                        op, bv, x0, TIMED_ITERS, 0.0)).values()))
                line.append(f"host syncs per iteration {syncs[0] / k!r} "
                            f"replayed, {syncs[1] / k!r} eager")
                # a 2-step solve: its second step is the one replay of a
                # graph captured for it, so the difference of the two walls
                # is the capture's cost (median of 5 each)
                two = {}
                for how in ("graph", "eager") * 5:
                    with (loop.eager() if how == "eager"
                          else contextlib.nullcontext()):
                        torch.cuda.synchronize()
                        t = time.perf_counter()
                        fn(op, bv, x0, 2, 0.0)
                        torch.cuda.synchronize()
                    two.setdefault(how, []).append(
                        (time.perf_counter() - t) * 1e3)
                line.append(f"a 2-step solve {np.median(two['graph'])!r} ms "
                            f"replayed, {np.median(two['eager'])!r} eager "
                            f"(the capture and one replay against one "
                            f"eager step)")
            print(f"[4] {solver} {kind}, {TIMED_ITERS} iterations: "
                  + "; ".join(line))
    # the chunked loops against the parent's (a host read of the stopping
    # test every iteration): LOOP_PAIRS pairs on the float32 pack, the
    # order alternating (parent first in even pairs)
    parent_cg = parent_loops()
    mine_cg = {"cgls": cgls, "cgls_normal": cgls_normal}
    loop_turns = {}
    if parent_cg is None:
        print(f"[4] parent: no checkout under {PARENT}")
    for solver in ("cgls_normal", "cgls") if parent_cg else ():
        runs = {"parent": [], "this": []}
        for pair in range(LOOP_PAIRS):
            order = ("parent", "this") if pair % 2 == 0 else ("this", "parent")
            for label in order:
                fn = (parent_cg if label == "parent" else mine_cg)[solver]
                fn(f32, bv, x0, 2, 0.0)
                torch.cuda.synchronize()
                t = time.perf_counter()
                _, k = fn(f32, bv, x0, TIMED_ITERS, 0.0)
                torch.cuda.synchronize()
                check(k == TIMED_ITERS, f"{label} {solver} k {k}")
                runs[label].append((time.perf_counter() - t) / k * 1e3)
        loop_turns[solver] = runs
        q = {lb: np.percentile(v, [25, 50, 75]) for lb, v in runs.items()}
        wins = sum(a < b for a, b in zip(runs["this"], runs["parent"]))
        print(f"[4] banded float32 {solver}, {TIMED_ITERS} iterations, "
              f"parent (a host read every iteration) vs this (one per "
              f"{CHUNK}), {LOOP_PAIRS} pairs in alternating order: ms/iter "
              f"quartiles parent {q['parent'].tolist()!r}, this "
              f"{q['this'].tolist()!r}; this faster in {wins} of "
              f"{LOOP_PAIRS} pairs; runs {runs!r}")
    def shear_plain(op):
        p = copy.copy(op)
        p._rot, p._rot_t = sk.shear_rotate_ref, sk.shear_rotate_adjoint_ref
        p._ata = sk.gcontract_ata_ref
        p.capturable = False  # the plain versions' loops step eagerly
        return p

    for kind, op in shear_ops.items():
        for solver, fn, on in (("cgls", cgls, False),
                               ("cgls_normal pair", cgls_normal, False),
                               ("cgls_normal K6", cgls_normal, True)):
            walls = {}
            with shear_ata(on):
                for label, o in (("plain", shear_plain(op)), ("kernels", op),
                                 ("eager", op), ("eager", op),
                                 ("kernels", op), ("plain", shear_plain(op))):
                    with (loop.eager() if label == "eager"
                          else contextlib.nullcontext()):
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
                if label != "plain":
                    kernel_wall["shear", kind, solver
                                + " eager" * (label == "eager")] = ms
            print(f"[4] shear {solver} {kind} G, {TIMED_ITERS} iterations: "
                  + "; ".join(line))
    print(f"[4] card: {card}; kernel ms: device time (torch.profiler) "
          f"per call; event ms: CUDA events around the calls (host gaps "
          f"included); bounds at {HBM_BPS:.3g} B/s, {F32_FLOPS:.3g} f32, "
          f"{BF16_FLOPS:.3g} bf16 and {TF32_FLOPS:.3g} TF32 FLOP/s")
    # 256 MB, written between runs where a cold L2 (50 MB) is wanted
    scrub = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    kernel_ms, banded_bound, parent_ms, k1_bounds = {}, {}, {}, {}
    parent_k = parent_banded()
    if parent_k is None:
        print(f"[4] parent: no checkout under {PARENT} (K1 and K3 not "
              f"timed against it)")
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
        # least bytes: K2, K3: every stored weight, S, Pm, scales and
        # angle ids once, the image in, the sinogram or image out (once);
        # K1, which reads only its tap spans: every nonzero weight once (as
        # the benchmark's k1_roofline counts), the image in and out; beside
        # it, the bounds of its spans' bytes and of the whole pack; 2 flops
        # per nonzero weight and pass
        pack = sum(nbytes(*st) for st in op.stacks)
        ids = nbytes(*op._aidx)
        nz = sum(int((st[0] != 0).sum()) for st in op.stacks)
        img = op.n_pad * op.n_pad * 4
        sino = nbytes(Ys)
        wsize = op.stacks[0][0].element_size()
        spans = sum(int((sp >> 16).sum()) for sp in bk.pack_spans(op._bks))
        k1_bounds[kind] = {
            "spans": bound(spans * bk.span_det(wsize) * wsize + 2 * img,
                           4 * nz, F32_FLOPS)[0],
            "pack": bound(pack + 2 * img, 4 * nz, F32_FLOPS)[0]}
        banded_bound[kind] = {
            "banded_ata": bound(nz * wsize + 2 * img, 4 * nz, F32_FLOPS),
            "banded_fwd": bound(pack + ids + img + sino, 2 * nz, F32_FLOPS),
            "banded_adj": bound(pack + ids + sino + img, 2 * nz, F32_FLOPS)}
        wbytes = sum(nbytes(st[0]) for st in op.stacks)
        if parent_k is not None:
            parent_ms[kind] = parent_k13(
                parent_k, adj_buckets(op, Ys), all_buckets(op, X),
                lambda f: device_ms(f, 10))
            print(f"[4] {kind} K3 and K1 over all buckets, this tree and "
                  f"PARENT in turns, device ms: {parent_ms[kind]}; card "
                  f"{card}")
        print(f"[4] {kind} one apply (W {wbytes} B, {nz} nonzero weights), "
              f"one launch per kernel:")
        for name in REPLACES:
            ms, (bms, by) = tot[name], banded_bound[kind][name]
            k1 = (f" (its spans' {k1_bounds[kind]['spans']!r} ms, the "
                  f"pack's {k1_bounds[kind]['pack']!r} ms)"
                  if name == "banded_ata" else "")
            print(f"[4]   {name} {ms!r} ms ({wbytes / ms / 1e6!r} GB/s of "
                  f"W; event ms {events[name]!r}), bound {bms!r} ms "
                  f"({by}){k1}, plain {tot[name + '_ref']!r} ms; by kernel "
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

    # K4 and K5 at each tile shape of the sweep, K5 also in chunks of 2, 4
    # and 8 views (float32 partials summed by a second pass): each held
    # against its plain version, then device ms per launch
    taken = copy.deepcopy(sk.PLANS)
    sweep = {}
    for kind, op in shear_ops.items():
        itemsize = op.G.element_size()
        for name, args, kw in shear_calls(op, gen, sk)[:2]:
            ref = getattr(sk, name + "_ref")(*args, **kw)
            fn = (lambda f, a, k: lambda: f(*a, **k))(getattr(sk, name), args,
                                                      kw)
            gate = (BF16_RTOL if kind == "bfloat16" and name == "shear_rotate"
                    else KERNEL_RTOL)
            for tile in sk.TILES:
                for chunk in ((None,) if name == "shear_rotate"
                              else (None, 2, 4, 8)):
                    sk.PLANS[name][itemsize] = {"tile": tile, "chunk": chunk}
                    sk.clear_plans()
                    e = rel(fn().float(), ref.float())
                    check(e <= gate, f"{name} {kind} tile {tile} chunk "
                          f"{chunk}: rel err {e!r}")
                    sweep[kind, name, tile, chunk] = device_ms(fn, 10)
            print(f"[4] sweep {name} {kind} (device ms; K5 chunk None: "
                  f"whole quarters): " + "; ".join(
                      f"{ty}x{tx} chunk {c} {v!r}"
                      for (k, n, (ty, tx), c), v in sweep.items()
                      if k == kind and n == name))
    sk.PLANS.clear()
    sk.PLANS.update(taken)
    sk.clear_plans()

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
    # the bench's path 4: K4, the two stage-B products and K5 per iteration
    loops.append(("shear bfloat16 G cgls", cgls, shear_ops["bfloat16"], False,
                  ("shear", "bfloat16", "cgls")))
    # each loop replayed as a CUDA graph (the profiler records the
    # replayed kernels one by one) and stepped eagerly, each against its
    # own wall of [4]
    for label, solver, op, on, key in loops:
        for how in ("graph", "eager"):
            wall = kernel_wall[key[:2] + (key[2] + " eager" * (
                how == "eager"),)]
            with shear_ata(on), (loop.eager() if how == "eager"
                                 else contextlib.nullcontext()):
                busy, by_kernel = loop_profile(solver, op, bv, x0)
            top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]
            print(f"[5] {label} ({how}): device busy {busy * 1e3!r} "
                  f"us/iter, wall {wall * 1e3!r} us/iter, idle share "
                  f"{1 - busy / wall!r}; busy by kernel (us/iter): "
                  + ", ".join(f"{k} {v * 1e3!r}" for k, v in top)
                  + f"; card {card}")

    for solver, runs in loop_turns.items():
        for label in ("parent", "this"):
            fn = parent_cg[solver] if label == "parent" else mine_cg[solver]
            busy, by_kernel = loop_profile(fn, f32, bv, x0)
            wall = float(np.median(runs[label]))
            top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:4]
            print(f"[5] banded float32 {solver} {label} loop: device busy "
                  f"{busy * 1e3!r} us/iter, wall {wall * 1e3!r} us/iter "
                  f"(median of the pairs in [4]), idle share "
                  f"{1 - busy / wall!r}; busy by kernel (us/iter): "
                  + ", ".join(f"{k} {v * 1e3!r}" for k, v in top))

    # ---- 6. device profiles of the demo's solvers ----------------------
    for name in ("GKS dp", "Hybrid LSQR dp", "MMGKS dp"):
        parts = {}
        busy = device_ms(demo[name][0], 1, parts) / DEMO_ITERS
        wall = demo_wall[name]
        top = sorted(parts.items(), key=lambda kv: -kv[1])[:6]
        got = demo_launches[name]
        print(f"[6] {name}: device busy {busy * 1e3!r} us/iter, wall "
              f"{wall * 1e3!r} us/iter, idle share {1 - busy / wall!r}; K2 "
              f"{got['banded_fwd'] / DEMO_ITERS!r} and K3 "
              f"{got['banded_adj'] / DEMO_ITERS!r} launches per iteration "
              f"(set-up included); busy by kernel (us/iter): "
              + ", ".join(f"{k} {v / DEMO_ITERS * 1e3!r}" for k, v in top))

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
                     library_bound_ms=library_bound[name][0],
                     **({f"{k}_bound_ms_by_storage": {
                         c: v[k] for c, v in k1_bounds.items()}
                         for k in ("spans", "pack")}
                        if name == "banded_ata" else {}),
                     **({"parent_ms_by_storage": {
                         k: v[name] for k, v in parent_ms.items()}}
                        if name in ("banded_ata", "banded_adj")
                        and parent_ms else {}))
               for name in ("banded_ata", "banded_fwd", "banded_adj")]
    def rotate_extra(name):
        """K4/K5: the float32 canvas numbers and the plan."""
        if name == "gcontract_ata":
            return {}
        f = shear_ms["float32"]
        return {"ms_f32": f[name], "plain_ms_f32": f[name + "_ref"],
                "bound_ms_f32": f["bounds"][name][0],
                "plans": {str(b): v for b, v in sk.PLANS[name].items()}}

    for kind in ("bfloat16", "float32"):  # the bench's G type first
        t = shear_ms[kind]
        kernels += [entry(name, "trips_tpu_torch/csrc/shear.cu",
                          SHEAR_REPLACES[name], shear_launches[kind][name],
                          shear_abs[kind][name], t[name], t[name + "_ref"],
                          t["bounds"][name],
                          t["gcontract_ata_library"]
                          if name == "gcontract_ata" else None, g_dtype=kind,
                          **rotate_extra(name))
                    for name in SHEAR_REPLACES
                    if kind == "bfloat16" or name == "gcontract_ata"]
    # ---- 7. dynamic CT: kernel times, solver profiles ------------------
    kernels += dynamic_times(dyn, dev, card, gen)
    # ---- 8. the all-on-device solvers' profiles --------------------------
    host = {"fused GKS dp": "GKS dp", "fused MMGKS dp": "MMGKS dp",
            "fused Hybrid LSQR gcv": "Hybrid LSQR gcv",
            "fused Hybrid LSQR dp reorth": "Hybrid LSQR dp"}
    host_walls = {k: (v, demo_wall[v]) for k, v in host.items()}
    for mode in ("isoTV", "GS"):
        v = f"dynamic MMGKS {mode}"
        host_walls[f"fused {v}"] = (v, dyn["walls"][v])
    fused_times(fused, card, host_walls)
    # ---- 9. deblurring: operators, the demos' solvers, profiles ---------
    deblur_path(dev, card, gen)
    # ---- 10. the streamed operator and the batched solve ----------------
    t0 = time.perf_counter()
    streamed = streamed_path(dev, card, dyn)
    batched_path(dev, card, dyn)
    print(f"[10] took {time.perf_counter() - t0:.1f} s; launches in the "
          f"streamed path: {streamed}; card {card}")
    check(all(v > 0 for v in streamed.values()),
          "a kernel never launched in the streamed path")
    # ---- 11. the sharded operators ---------------------------------------
    t0 = time.perf_counter()
    flat = BandedProjector.from_scipy_fan(A, nx, None, angles=tomo.theta,
                                          n_groups=32, device=dev)
    packs = {f"bucketed {k}": ops[k] for k in ("float32", "bfloat16",
                                                "int8")}
    packs.update({"flat float32": flat, **{
        f"dynamic {k}": dyn["ops"][k] for k in ("bucketed float32",
                                                 "flat float32")}})
    bk.reset_launch_counts()
    sharding.reset_collective_counts()
    world1 = sharded_world1(dev, card, packs, A, dyn, (bv, x0, xt))
    sharded = dict(bk.launch_counts)
    check(all(v > 0 for v in sharded.values()),
          f"a kernel never launched in the sharded path: {sharded}")
    del flat, packs
    dyn_ms = {e["name"].removesuffix("_frames"):
              e["ms_by_storage"]["bucketed float32"] for e in kernels
              if e["name"].endswith("_frames")}
    world2 = sharded_ranks(
        dev, card, {"tomo256x60 bucketed float32": ops["float32"],
                    "tomo256x60 bucketed int8": ops["int8"],
                    "dynamic bucketed float32":
                        dyn["ops"]["bucketed float32"]},
        (bv, x0, xt), dyn,
        {"tomo256x60 bucketed float32": kernel_ms["float32"],
         "tomo256x60 bucketed int8": kernel_ms["int8"],
         "dynamic bucketed float32": dyn_ms})
    print(f"[11] took {time.perf_counter() - t0:.1f} s; launches in the "
          f"sharded path at world 1: {sharded}, all_reduce calls "
          f"{sharding.collective_counts['all_reduce']}; card {card}")
    static_fused = {k: v for k, v in fused["launches"].items()
                    if "dynamic" not in k and "checkpointed" not in k}
    dynamic_fused = {k: v for k, v in fused["launches"].items()
                     if k not in static_fused}
    for entry in kernels:
        byp = dynamic_fused if entry["name"].endswith("_frames") else (
            static_fused if entry.get("storage") == "float32" else None)
        if byp is not None:
            entry["fused_launches"] = {k: v[entry["name"].removesuffix(
                "_frames")] for k, v in byp.items()}
        if entry["name"].endswith("_frames"):
            entry["streamed_launches"] = streamed[
                entry["name"].removesuffix("_frames")]
        k = entry["name"].removesuffix("_frames")
        if k in APPLY_OF and (entry["name"].endswith("_frames")
                              or entry.get("storage") == "float32"):
            w1, w2 = (("dynamic bucketed float32",) * 2
                      if entry["name"].endswith("_frames") else
                      ("bucketed float32", "tomo256x60 bucketed float32"))
            a = APPLY_OF[k]
            entry["sharded_launches"] = {
                "per apply, world 1 (NCCL)": world1[w1][a],
                "per apply, world 2 (gloo, one card), ranks 0 and 1":
                    [r[a][k] for r in world2[w2]]}
    # ---- 12. the C++ builder, gelPhantom, the demo twins, BSR -----------
    kernels += phase12(dev, card, gen, A, dyn)
    # ---- 13. the six demo twins, the C++ builder ------------------------
    with numpy_builder(False):
        twins = phase13(dev, card)
    for entry in kernels:
        k = entry["name"]
        if k in twins:
            entry["twin_launches"] = twins[k]
    # ---- 14. the tall-skinny QR of MMGKS's panels ------------------------
    kernels.append(phase14(dev, card, dyn["tsqr"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
