#!/usr/bin/env python3
"""Time K1-K3's launch plans against each other on one CUDA card.

Run from the repository root: ``python3 chip_banded_plans.py``. On the
tomo256x60 packs of ``chip_smoke.py`` (float32, bfloat16, int8), each
variant below replaces one kernel's entry of ``banded_kernels.PLANS``
(detectors per tile, the parts that split a tile's lines, the most lines
a part takes, the most slab bytes a block loads at once) for one apply over
all buckets; the variant is checked against the plain version (1e-5 of the
norm) and timed (device time, ``torch.profiler``, mean of 10 applies), in
turns (A B ... B A A B ...), and the median of the turns printed with
each turn's time: one line per (kernel, variant, storage class), after the
card's name and power limit. Needs one card; exits non-zero without.
"""
import copy
import sys

import numpy as np

import chip_smoke as cs


def _slab(kb):
    return {"slab_bytes": {4: kb * 1024, 2: kb * 1024, 1: kb * 1024}}


# kernel -> [(label, changes to its PLANS entry)], the current plan first
# (36 KB slabs allow 6 blocks of 256 threads on an SM, 26 KB and less 8:
# the kernels use 32 registers a thread)
VARIANTS = {
    name: [("current", {})] + [(f"slab {kb} KB", _slab(kb))
                               for kb in (36, 26, 18, 12)]
    for name in ("banded_fwd", "banded_adj", "banded_ata")}
VARIANTS["banded_fwd"] += [("det 64", {"det": {4: 64, 2: 64, 1: 64}}),
                           ("det 32", {"det": {4: 32, 2: 32, 1: 32}})]
VARIANTS["banded_adj"] += [("parts to 32", {"parts": (1, 2, 4, 8, 16, 32)}),
                           ("det 32", {"det": {4: 32, 2: 32, 1: 32}})]
VARIANTS["banded_ata"] += [("det 64", {"det": {4: 64, 2: 64, 1: 64}})]
TURNS = 3  # each variant timed this many times, in turns, order reversed
           # every other turn


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_banded_plans: no CUDA device", file=sys.stderr)
        return 1
    from trips_tpu_torch.problems import Tomography, device_sparse_operator
    from trips_tpu_torch.sparse import banded_kernels as bk

    print(cs.smi("name,power.limit"))
    dev = torch.device("cuda")
    tomo = Tomography(CommitCrime=False, device=dev)
    x_true, nx, ny = tomo.gen_true("grains", nx=cs.NX, ny=cs.NX,
                                   phantom_seed=0)
    OP, _, _, _, A = tomo.gen_data(x_true, nx, ny, cs.VIEWS)
    ops = {"float32": OP}
    for kind, dt in (("bfloat16", torch.bfloat16), ("int8", "int8")):
        ops[kind] = device_sparse_operator(A, dtype=dt, nx=nx,
                                           angles=tomo.theta, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    default = copy.deepcopy(bk.PLANS)
    for name, variants in VARIANTS.items():
        for kind, op in ops.items():
            X = torch.randn(op.n_pad, op.n_pad, device=dev, generator=gen)
            p = op.det_count
            Y = torch.randn(op.shape[0] // p, p, device=dev, generator=gen)
            args = {"banded_fwd": cs.fwd_buckets(op, X),
                    "banded_adj": cs.adj_buckets(op, Y),
                    "banded_ata": cs.all_buckets(op, X)}[name]
            fn = getattr(bk, name + "_buckets")
            ref = getattr(bk, name + "_buckets_ref")(*args)
            times = {}
            turns = [v for k in range(TURNS)
                     for v in (variants if k % 2 == 0 else variants[::-1])]
            for label, change in turns:
                bk.PLANS[name] = {**default[name], **change}
                bk.clear_plans()
                e = cs.rel(fn(*args), ref)
                cs.check(e <= cs.KERNEL_RTOL, f"{name} {label} {kind} {e!r}")
                times.setdefault(label, []).append(cs.device_ms(
                    lambda: fn(*args), 10, sessions=1))
            bk.PLANS[name] = copy.deepcopy(default[name])
            bk.clear_plans()
            pl = bk.launch_plan(name, tuple(b[0].shape[1] for b in op._bks),
                                op.n_pad, op._bks[0][0].element_size())
            print(f"{name} {kind} (current plan: det {pl['det']}, parts "
                  f"{pl['parts']}, lines {pl['lines']}, chunks "
                  f"{[b['chunks'] for b in pl['buckets']]}):")
            for label, ts in times.items():
                print(f"  {label}: median {float(np.median(ts))!r} ms "
                      f"(turns {', '.join(repr(float(t)) for t in ts)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
