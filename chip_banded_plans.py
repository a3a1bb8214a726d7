#!/usr/bin/env python3
"""Time K1-K3's launch plans against each other on one CUDA card.

Run from the repository root: ``python3 chip_banded_plans.py [kernel
...]`` (default all three of ``banded_fwd``, ``banded_adj``,
``banded_ata``). On the tomo256x60 packs of ``chip_smoke.py`` (float32,
bfloat16, int8), and for K1 also the flat float32 pack of its dynamic
problem (33 frames of 128x128, 10 views), each variant below replaces one
kernel's entry of ``banded_kernels.PLANS`` (detectors per tile, the parts
that split a tile's lines, the most lines a part takes, the most slab
bytes a block loads at once; for K1, which walks tap spans, the most
lines a block walks and the room its packed spans get) for one apply over
all buckets (and frames); the variant is checked against the plain
version (1e-5 of the norm) and timed (device time, ``torch.profiler``,
mean of 10 applies), in turns (A B ... B A A B ...), and the median of the
turns printed with each turn's time: one line per (kernel, variant,
pack), after the card's name and power limit. Needs one card; exits
non-zero without.
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
    for name in ("banded_fwd", "banded_adj")}
VARIANTS["banded_fwd"] += [("det 64", {"det": {4: 64, 2: 64, 1: 64}}),
                           ("det 32", {"det": {4: 32, 2: 32, 1: 32}})]
VARIANTS["banded_adj"] += [("parts to 32", {"parts": (1, 2, 4, 8, 16, 32)}),
                           ("det 32", {"det": {4: 32, 2: 32, 1: 32}})]
# K1 walks tap spans: the lines a block takes of a tile set its parts
# (tomo256x60, n = 256: 64 lines 4 parts ... 16 lines 16 parts; the dynamic
# pack, n = 128: half as many), the slab the room for its packed spans (a
# block whose spans do not fit takes its lines in chunks, and reloads them
# for stage 2)
VARIANTS["banded_ata"] = [("current", {})] + [
    (f"{lines} lines, slab {kb} KB", {"max_lines": lines, **_slab(kb)})
    for lines, kbs in ((64, (36, 26, 18)), (32, (36, 26, 18, 12)),
                       (16, (26, 18, 12)))
    for kb in kbs] + [("det 32", {"det": {4: 32, 2: 32, 1: 32}})]
TURNS = 3  # each variant timed this many times, in turns, order reversed
           # every other turn


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_banded_plans: no CUDA device", file=sys.stderr)
        return 1
    from trips_tpu_torch.problems import (Tomography, device_sparse_operator,
                                          generate_synthetic_dynamic)
    from trips_tpu_torch.sparse import DynamicBandedOperator
    from trips_tpu_torch.sparse import banded_kernels as bk

    names = sys.argv[1:] or list(VARIANTS)
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
    if "banded_ata" in names:
        dyn = generate_synthetic_dynamic(**cs.DYN, return_angles=True)
        ops["dynamic flat float32"] = DynamicBandedOperator.from_frames(
            dyn[2], dyn[4], dyn[9], n_groups=8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    default = copy.deepcopy(bk.PLANS)
    for name in names:
        variants = VARIANTS[name]
        for kind, op in ops.items():
            if kind.startswith("dynamic") and name != "banded_ata":
                continue
            nt = getattr(op, "nt", None)
            X = torch.randn(*((nt,) if nt else ()), op.n_pad, op.n_pad,
                            device=dev, generator=gen)
            p = op.det_count
            Y = torch.randn(op.shape[0] // p, p, device=dev, generator=gen)
            args = {"banded_fwd": lambda: cs.fwd_buckets(op, X),
                    "banded_adj": lambda: cs.adj_buckets(op, Y),
                    "banded_ata": lambda: (X, X.transpose(-1, -2)
                                           .contiguous(), op._bks,
                                           op.n_groups)}[name]()
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
            pl = bk.launch_plan(name, tuple(b[0].shape[-3] for b in op._bks),
                                op.n_pad, op._bks[0][0].element_size())
            cut = (f"rows {pl['rows']}" if name == "banded_ata" else
                   f"chunks {[b['chunks'] for b in pl['buckets']]}")
            print(f"{name} {kind} (current plan: det {pl['det']}, parts "
                  f"{pl['parts']}, lines {pl['lines']}, {cut}):")
            for label, ts in times.items():
                print(f"  {label}: median {float(np.median(ts))!r} ms "
                      f"(turns {', '.join(repr(float(t)) for t in ts)})",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
