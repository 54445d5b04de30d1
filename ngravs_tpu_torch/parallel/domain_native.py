"""Host-side domain-decomposition helpers in C++ (port of
`ngravs_tpu/parallel/domain_native.py`).

The reference computes Peano-Hilbert keys and split boundaries in C on
every rank (peano.c:356, domain.c:347-1018); here the same host work —
60-bit Morton keys, the argsort, and capacity-clamped weighted split
boundaries — runs in `native/domain_keys.cpp` (ctypes; the host C++
compiler builds it into `build/` at first use), with the JAX package's
numpy path where no compiler is found.  The sort is over (key, index)
pairs, so the order is the stable key order whichever path runs, and every
rank computing it from the same gathered positions gets the same answer.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "domain_keys.cpp")
_BUILD_DIR = os.path.join(_ROOT, "build")
_NATIVE = None


def build_native() -> str | None:
    """Compile `native/domain_keys.cpp` into `build/` (keyed by the
    source's hash); None when there is no host C++ compiler."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None or not os.path.exists(_SRC):
        return None
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(_BUILD_DIR, f"libdomain_keys_{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        for flags in (["-fopenmp"], []):
            r = subprocess.run([cxx, "-O3", *flags, "-fPIC", "-shared",
                                "-std=c++17", "-o", tmp, _SRC],
                               capture_output=True, text=True, timeout=300)
            if r.returncode == 0:
                os.replace(tmp, out)
                return out
        return None
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _native_lib():
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE or None
    lib = build_native()
    if lib is None:
        _NATIVE = False
        return None
    dll = ctypes.CDLL(lib)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    dll.morton_argsort.argtypes = [f32p, ctypes.c_int64, f64p,
                                   ctypes.c_double, i64p, u64p]
    dll.weighted_split.argtypes = [f64p, ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_int64, i64p]
    _NATIVE = dll
    return dll


def _keys_numpy(pos, corner, inv_len):
    c = np.clip(((pos.astype(np.float64) - corner) * inv_len
                 * (1 << 20)).astype(np.int64), 0, (1 << 20) - 1)

    def spread3(x):
        x = x.astype(np.uint64)
        x = (x | (x << np.uint64(32))) & np.uint64(0x1f00000000ffff)
        x = (x | (x << np.uint64(16))) & np.uint64(0x1f0000ff0000ff)
        x = (x | (x << np.uint64(8))) & np.uint64(0x100f00f00f00f00f)
        x = (x | (x << np.uint64(4))) & np.uint64(0x10c30c30c30c30c3)
        x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
        return x

    return (spread3(c[:, 0]) << np.uint64(2)) \
        | (spread3(c[:, 1]) << np.uint64(1)) | spread3(c[:, 2])


def morton_argsort_host(pos: np.ndarray, corner, inv_len: float):
    """Stable Morton-order permutation of [N,3] f32 host positions."""
    pos = np.ascontiguousarray(pos, np.float32)
    n = pos.shape[0]
    corner = np.ascontiguousarray(corner, np.float64)
    dll = _native_lib()
    if dll is not None:
        order = np.empty(n, np.int64)
        keys = np.empty(n, np.uint64)
        dll.morton_argsort(
            pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
            corner.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            float(inv_len),
            order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
        return order
    keys = _keys_numpy(pos, corner, inv_len)
    return np.argsort(keys, kind="stable")


def weighted_split_host(w_sorted: np.ndarray, n_parts: int, cap: int):
    """Contiguous boundaries balancing prefix weights under a capacity
    (domain_findSplit, domain.c:347-460).  Returns [n_parts+1] int64."""
    w = np.ascontiguousarray(w_sorted, np.float64)
    n = w.shape[0]
    dll = _native_lib()
    if dll is not None:
        bounds = np.empty(n_parts + 1, np.int64)
        dll.weighted_split(
            w.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
            n_parts, cap,
            bounds.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return bounds
    cum = np.concatenate([[0.0], np.cumsum(w)])
    total = cum[-1]
    bounds = [0]
    for k in range(1, n_parts):
        b = int(np.searchsorted(cum, k * total / n_parts)) - 1
        b = max(b, 0)
        b = min(max(b, bounds[-1]), bounds[-1] + cap, n)
        b = max(b, n - (n_parts - k) * cap)
        bounds.append(b)
    bounds.append(n)
    return np.asarray(bounds, np.int64)
