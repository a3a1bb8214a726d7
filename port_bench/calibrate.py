"""Readings that a cell's limits are set from: the numbers the comparison
computes, for the program as the configuration states it and for a
control (the pack in a lower storage precision), on many seeds, with the
program's set-up made once per storage type.

    python3 -m port_bench.calibrate --workload <cell> --seeds 12 \
        [--first-seed N] [--control bfloat16 --control-seeds 3]

One JSON line per seed and storage type. Each seed draws its pool of
noise as a run with that seed does, so the readings span the data; its
reconstructions are the first ``checked`` of that pool, at the cell's own
sizes, through the same entry, operator and reference as a run.
"""
import argparse
import json
import sys
import time


def readings(cell, kind, entry, dev, dtype, seeds):
    import torch

    from port_bench import harness

    _, b_true = kind.data(cell.cfg)
    op, _, solve, _ = harness.program(cell, kind, entry, dev, dtype)
    n = cell.traffic["checked"]
    for seed in seeds:
        pool = harness.make_pool(b_true, cell.cfg["noise_level"],
                                 cell.traffic["pool"], seed, dev)
        t = time.perf_counter()
        sample = [{k: v.detach().double() for k, v in solve(pool[i]).items()}
                  for i in range(n)]
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) / n
        checks = harness.compare(cell, kind, entry, sample,
                                 pool[:n].double().T.contiguous())
        print(json.dumps({"workload": cell.name, "dtype": dtype,
                          "seed": seed, "recon_s": wall,
                          **{k: c["value"] for k, c in checks.items()}}),
              flush=True)
    del op, solve


def main(argv=None):
    ap = argparse.ArgumentParser(prog="port_bench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=1000)
    ap.add_argument("--control", default=None)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    from port_bench import harness

    if not torch.cuda.is_available():
        print("port_bench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    kind, entry, dev = harness.start(cell, "cuda")
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    readings(cell, kind, entry, dev, cell.cfg["dtype"], seeds)
    if args.control:
        readings(cell, kind, entry, dev, args.control,
                 seeds[:args.control_seeds])
    return 0


if __name__ == "__main__":
    sys.exit(main())
