"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources under ``csrc/`` (``*.cu``, sharing ``hopper.cuh``) have a
plain C interface, so they compile in seconds without PyTorch's headers;
TMA's tensor maps are encoded through the driver entry point, so nothing
links libcuda. Each source compiles in its own nvcc
process, all started together, and one more links the objects into a
shared library in ``_build/`` beside this file, named by a hash of the
sources and flags: a changed source builds anew, an unchanged one loads the
library already there. Nothing is built at import time; ``load()`` builds
on first use.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_SRC = _PKG / "csrc"
_OUT = _PKG / "_build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# symbol -> argtypes; every entry point returns a CUDA error code (int)
ENTRY_POINTS = {
    # K1-K3: op, kind, nb, 6 pointer arrays (W, S, Pm, scales, aidx,
    # spans), 6 int arrays (na, T, L, Tb, cols, fa), in, inT, out, p, rows,
    # n, p_pad, G, det, parts, lines, span_rows, nf, acc, amax, bound,
    # bstride, finish, stream
    "trips_banded": [_I] * 3 + [_P] * 15 + [_I] * 10 + [_P] * 3 + [_I] * 2
                    + [_P],
    "trips_banded_max_buckets": [],
    # K4: kind, Q, kx, fx, ky, fy, kq, starts, out, na, C, ty, tx, w2, r1,
    # stream
    "trips_shear_rotate": [_I] + [_P] * 8 + [_I] * 6 + [_P],
    # K5: kind, g, kx, fx, ky, fy, order, chunks, starts, qfirst, partials,
    # out, C, nchunks, ty, tx, w2, r1, stream
    "trips_shear_rotate_adj": [_I] + [_P] * 11 + [_I] * 6 + [_P],
    # kind, R, G, P, U, out, na, K, N, nsplit, chunk, stream
    "trips_shear_ata": [_I] + [_P] * 5 + [_I] * 5 + [_P],
    "trips_shear_ata_k_tile": [],
    # kind, X, w, R, work, m, k, tile_rows, warps, blocks, rows_per_block,
    # stream
    "trips_tsqr": [_I] + [_P] * 4 + [_L] + [_I] * 4 + [_L, _P],
}

_lib = None
# what the last load() did: {"path", "built", "seconds", "log"}
build_info: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc"))
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in sorted(_SRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return _OUT / f"libtrips_kernels_{h.hexdigest()[:16]}.so"


def load():
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    t0 = time.perf_counter()
    log = ""
    built = not so.exists()
    if built:
        _OUT.mkdir(exist_ok=True)
        nvcc, tag = _nvcc(), f"{so.stem}.{os.getpid()}"
        jobs = []
        for src in sorted(_SRC.glob("*.cu")):
            obj = _OUT / f"{tag}.{src.stem}.o"
            cmd = [nvcc, *FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        tmp = _OUT / f"{tag}.tmp"
        steps = [(cmd, proc.communicate()[0], proc.returncode)
                 for cmd, _, proc in jobs]
        if not any(rc for *_, rc in steps):
            cmd = [nvcc, "-shared", "-o", str(tmp),
                   *(str(obj) for _, obj, _ in jobs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            steps.append((cmd, proc.stdout + proc.stderr, proc.returncode))
        for _, obj, _ in jobs:
            obj.unlink(missing_ok=True)
        log = "".join(out for _, out, _ in steps)
        for cmd, out, rc in steps:
            if rc:
                raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{out}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    build_info.update(path=str(so), built=built,
                      seconds=time.perf_counter() - t0, log=log)
    _lib = lib
    return lib
