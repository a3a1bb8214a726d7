"""The C++ builder of the projector matrices and of the banded pack's
per-angle work, loaded with ctypes.

Counterpart of ``trips_tpu/native``: the same source (``projector.cpp``,
a copy of that package's), the same four entry points with the same
arguments and returns. ``load()`` compiles the source at first use with
g++ and the reference Makefile's flags into ``_build/`` beside the
package, named by a hash of the source, the flags and the machine (the
flags ask for the host's own instruction set, so a library built on
another machine is not taken); each process builds into a file of its own
and moves it into place, so processes that build at once do not collide.
Nothing is built at import time.

``TRIPS_TPU_NO_NATIVE=1`` turns the library off, as it does in the JAX
package: every entry point then returns None (``scatter_fill`` False) and
its caller takes the NumPy path. Where the JAX package also falls back
when its library does not build or load, this one raises with the
compiler's output: a missing compiler is a fault to see, not a reason to
run at another speed with other roundoff.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import time
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "projector.cpp"
_OUT = Path(__file__).resolve().parent.parent / "_build"
CXX = "g++"
FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")
_P, _I, _I32, _I64, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int32,
                          ctypes.c_int64, ctypes.c_double)
# symbol -> (restype, argtypes)
ENTRY_POINTS = {
    # nx, ny, n_angles, angles, det_count, det_width, so, od, rowptr, col,
    # val, cap -> nnz (-1: capacity overflow)
    "fan_beam_csr": (_I64, [_I, _I, _I, _P, _I, _D, _D, _D, _P, _P, _P,
                            _I64]),
    "parallel_beam_csr": (_I64, [_I, _I, _I, _P, _I, _D, _P, _P, _P, _I64]),
    # nnz, d, line, c, n, p, n_groups, n_pad, t, shift, P -> T_a (-1: a
    # negative tap)
    "pack_angle": (_I32, [_I64, _P, _P, _P, _I32, _I32, _I32, _I32, _P, _P,
                          _P]),
    # nnz, t, i, d, v, W, stride of t, stride of i
    "scatter_fill_f32": (None, [_I64, _P, _P, _P, _P, _P, _I64, _I64]),
    "scatter_fill_bf16": (None, [_I64, _P, _P, _P, _P, _P, _I64, _I64]),
}

_lib = None
# what the last build or load did: {"path", "built", "seconds", "log"}
build_info: dict = {}


def library_path() -> Path:
    h = hashlib.sha256(" ".join((CXX, *FLAGS, platform.machine(),
                                 platform.node())).encode())
    h.update(_SRC.read_bytes())
    return _OUT / f"libprojector_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> str:
    """Compile ``_SRC`` into ``so``; raise with the compiler's output if
    it fails."""
    _OUT.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [CXX, *FLAGS, "-o", str(tmp), str(_SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"the C++ projector builder did not build "
                           f"({' '.join(cmd)}): {e}") from e
    log = proc.stdout + proc.stderr
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"the C++ projector builder did not build "
                           f"({' '.join(cmd)}):\n{log}")
    os.replace(tmp, so)
    return log


def load():
    """The library, built at the first call of the process; None when
    ``TRIPS_TPU_NO_NATIVE=1``. Raises when it does not build or load."""
    global _lib
    if os.environ.get("TRIPS_TPU_NO_NATIVE") == "1":
        return None
    if _lib is not None:
        return _lib
    so = library_path()
    t0 = time.perf_counter()
    built = not so.exists()
    log = _build(so) if built else ""
    lib = ctypes.CDLL(str(so))
    for name, (restype, argtypes) in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    build_info.update(path=str(so), built=built,
                      seconds=time.perf_counter() - t0, log=log)
    _lib = lib
    return lib


def _run(fn_name, nx, ny, angles, det_count, det_width, extra=()):
    lib = load()
    if lib is None:
        return None
    angles = np.ascontiguousarray(angles, dtype=np.float64)
    n_angles = len(angles)
    rows = n_angles * det_count
    cap = rows * (nx + ny + 3)
    rowptr = np.zeros(rows + 1, dtype=np.int64)
    col = np.zeros(cap, dtype=np.int32)
    val = np.zeros(cap, dtype=np.float64)
    nnz = getattr(lib, fn_name)(nx, ny, n_angles, angles.ctypes.data,
                                det_count, det_width, *extra,
                                rowptr.ctypes.data, col.ctypes.data,
                                val.ctypes.data, cap)
    if nnz < 0:  # a ray crosses at most nx + ny + 1 squares: never here
        raise RuntimeError(f"{fn_name}: more than {cap} entries")
    from scipy import sparse as sp

    return sp.csr_matrix((val[:nnz], col[:nnz], rowptr),
                         shape=(rows, nx * ny))


def fan_beam_csr_native(nx, ny, angles, det_count, det_width, so, od):
    """The fan-beam Siddon matrix (CSR, float64; duplicates not summed),
    or None when the library is off."""
    return _run("fan_beam_csr", nx, ny, angles, det_count, det_width,
                extra=(so, od))


def parallel_beam_csr_native(nx, ny, angles, det_count, det_width):
    """The parallel-beam Siddon matrix ('line' model), or None when the
    library is off."""
    return _run("parallel_beam_csr", nx, ny, angles, det_count, det_width)


def _int32(a, bound, what):
    """``a`` as a contiguous int32 array whose entries lie in [0, bound)."""
    a = np.ascontiguousarray(a, np.int32)
    if len(a) and (int(a.min()) < 0 or int(a.max()) >= bound):
        raise IndexError(f"{what} index outside [0, {bound})")
    return a


def pack_angle(d, line, c, n, p, n_groups, n_pad):
    """One angle's shear, predictor and taps (the twin, bit for bit, of
    ``sparse/pack.py``'s ``_pack_angle``). Returns (t, shift, P, T_a), or
    None when the library is off or a tap would be negative (the NumPy
    path then raises)."""
    lib = load()
    if lib is None:
        return None
    d = _int32(d, p, "detector")
    line = _int32(line, n, "line")
    c = np.ascontiguousarray(c, np.int32)
    if not len(d) == len(line) == len(c):
        raise ValueError("d, line and c differ in length")
    t = np.empty(len(d), np.int32)
    shift = np.zeros(n_pad, np.int32)
    P = np.empty((n_groups, p), np.int32)
    ret = lib.pack_angle(len(d), d.ctypes.data, line.ctypes.data,
                         c.ctypes.data, n, p, n_groups, n_pad,
                         t.ctypes.data, shift.ctypes.data, P.ctypes.data)
    if ret < 0:
        return None
    return t, shift, P, max(int(ret), 1)


def scatter_fill(t, i, d, v, W_slab):
    """Fill one angle's ``(T, n_pad, p_pad)`` slab: ``W[t, i, d] = v``.

    ``W_slab`` must be a C-contiguous float32 or bfloat16 NumPy array (the
    bfloat16 path rounds to nearest even, as a NumPy bfloat16 cast does).
    Returns True when it filled the slab, False when the library is off or
    the slab is not one it fills (the caller then fills with NumPy)."""
    if (not isinstance(W_slab, np.ndarray) or W_slab.ndim != 3
            or not W_slab.flags.c_contiguous
            or W_slab.dtype.name not in ("float32", "bfloat16")):
        return False
    lib = load()
    if lib is None:
        return False
    T, n_pad, p_pad = W_slab.shape
    t = _int32(t, T, "tap")
    i = _int32(i, n_pad, "line")
    d = _int32(d, p_pad, "detector")
    v = np.ascontiguousarray(v, np.float32)
    if not len(t) == len(i) == len(d) == len(v):
        raise ValueError("t, i, d and v differ in length")
    fn = (lib.scatter_fill_f32 if W_slab.dtype.name == "float32"
          else lib.scatter_fill_bf16)
    fn(len(t), t.ctypes.data, i.ctypes.data, d.ctypes.data, v.ctypes.data,
       W_slab.ctypes.data, n_pad * p_pad, p_pad)
    return True
