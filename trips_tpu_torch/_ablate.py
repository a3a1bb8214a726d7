"""Where K4's and K5's time goes: time them with parts of the staged tile
(``csrc/shear.cu``) patched out.

    python3 -m trips_tpu_torch._ablate [--out DIR]

Needs one CUDA card. Each variant is a copy of this package under ``DIR``
(default ``_local/ablate`` of the current directory, which ``.gitignore``
lists) with ``csrc/shear.cu`` patched, built by its own ``_build`` and timed
in a process of its own: device ms per launch (``torch.profiler``, median
of three sessions of 20 launches) of K4 with a bfloat16 output and K5 with a
bfloat16 input at tomo256x60's shapes (C = 400, 60 views), each at the
plans of ``shear_kernels.PLANS`` and at 16x64 tiles (K5 in chunks of 4
views). The variants run in turns, the full kernels first and last. A
patched kernel computes wrong values: it is timed, not checked.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

_PKG = Path(__file__).resolve().parent

# name -> [(text of csrc/shear.cu, its replacement)], applied in order
_STAGE1 = "  for (int e = tid; e < segs * d.w2; e += nt) {"
_STAGE23 = ("      s2[q] = blend<ADJ>(__int_as_float(s.cw[t].z), a1[at], "
            "a1[at + row4]);")
_SHIFTS = "  for (int e = tid; e < p2 + d.ty; e += nt) {"
_NO_STAGE1 = [(_STAGE1, "  for (int e = tid; e < 0; e += nt) {")]
_NO_STAGE123 = _NO_STAGE1 + [
    (_STAGE23, "      s2[q] = static_cast<float>(t + at) * f3;")]
VARIANTS = {
    "full": [],
    "no gathers": [("      lo[m] = ld(p, cc);\n      hi[m] = ld(p, c2);",
                    "      lo[m] = static_cast<float>(cc) + (p == nullptr);\n"
                    "      hi[m] = static_cast<float>(c2);")],
    "no row records": [("      const int4 rw = s.rw[cw.y + u0 + m];",
                        "      const int4 rw = make_int4((cw.y + u0 + m) * C,"
                        " cw.x, cw.z, 0);")],
    "no stage 1": _NO_STAGE1,
    "no stages 1-3": _NO_STAGE123,
    "no stages, no shifts": _NO_STAGE123 + [
        (_SHIFTS, "  for (int e = tid; e < 0; e += nt) {"),
        ("    const int2 tr = s.tr[r + m];",
         "    const int2 tr = make_int2(r, m);")],
}

_TIMER = r'''
import json, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from trips_tpu_torch.operators import ShearFanProjector
from trips_tpu_torch.operators import shear_kernels as sk
assert sk.__file__.startswith(sys.argv[1]), sk.__file__


def device_ms(fn, reps=20, sessions=3):
    fn()
    torch.cuda.synchronize()
    act = [torch.profiler.ProfilerActivity.CUDA]
    runs = []
    for _ in range(sessions):
        with torch.profiler.profile(activities=act) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        runs.append(sum(e.self_device_time_total for e in prof.key_averages()))
    return sorted(runs)[len(runs) // 2] / reps / 1e3


dev = torch.device("cuda")
theta = np.linspace(0, np.pi, 60, endpoint=False)
op = ShearFanProjector(256, angles=theta, g_dtype=torch.bfloat16, device=dev)
C, na, sh = op._C, op.n_angles, op._shifts()
g = torch.Generator(device=dev).manual_seed(0)
Q = torch.randn(3, C, C, device=dev, generator=g)
Gc = torch.randn(na, C, C, device=dev, generator=g).to(torch.bfloat16)
res = {}
for label in ("plans", "16x64"):
    if label == "16x64":
        sk.PLANS["shear_rotate"][2] = {"tile": (16, 64)}
        sk.PLANS["shear_rotate_adjoint"][2] = {"tile": (16, 64), "chunk": 4}
        sk.clear_plans()
    res[label] = {
        "shear_rotate": device_ms(
            lambda: sk.shear_rotate(Q, *sh, out_dtype=torch.bfloat16)),
        "shear_rotate_adjoint": device_ms(
            lambda: sk.shear_rotate_adjoint(Gc, *sh))}
print(json.dumps(res))
'''


def make(out, name, patches):
    """A copy of the package under ``out/<name>`` with ``patches`` applied
    to its ``csrc/shear.cu``."""
    root = out / name.replace(" ", "_").replace(",", "")
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(_PKG, root / "trips_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    cu = root / "trips_tpu_torch" / "csrc" / "shear.cu"
    text = cu.read_text()
    for old, new in patches:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not in shear.cu once")
        text = text.replace(old, new)
    cu.write_text(text)
    return root


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=Path("_local") / "ablate")
    args = ap.parse_args(argv)
    out = args.out.resolve()
    roots = {name: make(out, name, p) for name, p in VARIANTS.items()}
    order = list(VARIANTS) + ["full"]
    for name in order:
        proc = subprocess.run([sys.executable, "-c", _TIMER, str(roots[name])],
                              capture_output=True, text=True, check=False)
        if proc.returncode:
            raise RuntimeError(f"{name} failed:\n{proc.stderr[-4000:]}")
        print(f"{name}: {proc.stdout.strip().splitlines()[-1]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
