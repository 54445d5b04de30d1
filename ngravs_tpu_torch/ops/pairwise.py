"""K1a: the fused walk's pair evaluation, as a CUDA kernel and its twin.

Port of `ngravs_tpu/ops/pairwise_pallas.py:make_pairwise_kernel` in the form
the main path needs: one law (the all-Newton wiring), non-periodic, no
TreePM, with the potential on or off.  `pairwise_eval` keeps the interface
of the JAX kernel's wrapper:

    targets: dict of [B*G, 1] tensors x, y, z, mass (f32), grav (i32),
             fsoft (f32), gid (i32; -1 padding)
    spacked: [B, 8, S] f32 source rows x, y, z, mass, soft, count, grav,
             gid; rows 6/7 are int32 bit patterns (gid -1 padding, -2 node)
    n_src:   [B, 1] int32; only the first n_src[b] rows of block b are read
    returns  acc [B*G, 3] f32, pot [B*G] f32 (zeros without want_pot),
             nia [B*G] int32 valid-pair counts

A CUDA tensor goes to the kernel (`csrc/pairwise.cu`), built with nvcc for
sm_90a at first use into `build/` at the repository root and loaded through
ctypes.  A CPU tensor goes to the plain twin `pairwise_eval_torch`.  There
is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

from ..models.laws import Newtonian

# packed source-table rows (6/7 hold int32 bit patterns)
FX, FY, FZ, FMASS, FSOFT, FCOUNT, IGRAV, IGID = 0, 1, 2, 3, 4, 5, 6, 7

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "pairwise.cu")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]
_LAW = Newtonian()
_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the pair kernel is built from "
                       f"{_CSRC} with the CUDA toolkit")


def build_library(verbose: bool = False) -> str:
    """Compile `csrc/pairwise.cu` into `build/` unless a library built from
    the same source (by content hash) is there.  Returns its path."""
    with open(_CSRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(_BUILD_DIR, f"libngravs_pairwise_{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *_NVCC_FLAGS] + (["-Xptxas", "-v"] if verbose else []) \
        + ["-o", tmp, _CSRC]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
        if verbose:
            print(r.stderr.strip())
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library())
        fn = lib.ngravs_pairwise_newton
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 4)
        _lib = lib
    return _lib


def pairwise_eval_torch(targets: dict, spacked: torch.Tensor,
                        n_src: torch.Tensor, want_pot: bool = True):
    """Plain PyTorch twin of the kernel: the same masks and law, evaluated
    as [B, G, S] tiles (any device)."""
    bg = targets["x"].shape[0]
    nb, _, s = spacked.shape
    g = bg // nb
    col = lambda k: targets[k].reshape(nb, g, 1)
    tgid = col("gid")
    sgid = spacked[:, IGID, :].view(torch.int32)[:, None, :]
    live = torch.arange(s, device=spacked.device)[None, None, :] \
        < n_src.reshape(nb, 1, 1)
    valid = live & (sgid != -1) & (tgid >= 0) & (sgid != tgid)
    dx = spacked[:, None, FX, :] - col("x")
    dy = spacked[:, None, FY, :] - col("y")
    dz = spacked[:, None, FZ, :] - col("z")
    r2 = dx * dx + dy * dy + dz * dz
    r = torch.sqrt(r2)
    h = torch.maximum(col("fsoft"), spacked[:, None, FSOFT, :])
    tm, sm = col("mass"), spacked[:, None, FMASS, :]
    fac = _LAW.force_factor(tm, sm, r2, r, h, 1.0)
    # masked by a select: an invalid pair's factor or offset may be inf/NaN
    acc = torch.stack([torch.sum(torch.where(valid, fac * d, 0.0), dim=-1)
                       for d in (dx, dy, dz)], dim=-1).reshape(bg, 3)
    if want_pot:
        pot = torch.sum(torch.where(
            valid, _LAW.potential_factor(tm, sm, r2, r, h, 1.0), 0.0),
            dim=-1).reshape(bg)
    else:
        pot = torch.zeros(bg, dtype=torch.float32, device=spacked.device)
    nia = torch.sum(valid, dim=-1, dtype=torch.int32).reshape(bg)
    return acc, pot, nia


_T_DTYPES = dict(x=torch.float32, y=torch.float32, z=torch.float32,
                 mass=torch.float32, grav=torch.int32, fsoft=torch.float32,
                 gid=torch.int32)


def _check(targets: dict, spacked: torch.Tensor, n_src: torch.Tensor):
    if spacked.dim() != 3 or spacked.shape[1] != 8 \
            or spacked.dtype != torch.float32:
        raise ValueError(f"spacked must be [B, 8, S] f32, got "
                         f"{tuple(spacked.shape)} {spacked.dtype}")
    nb = spacked.shape[0]
    if n_src.dtype != torch.int32 or n_src.numel() != nb:
        raise ValueError(f"n_src must be [B, 1] int32, got "
                         f"{tuple(n_src.shape)} {n_src.dtype}")
    bg = targets["x"].shape[0]
    if nb == 0 or bg % nb:
        raise ValueError(f"{bg} targets do not split into {nb} blocks")
    for k, dt in _T_DTYPES.items():
        t = targets[k]
        if t.dtype != dt or t.numel() != bg or t.device != spacked.device:
            raise ValueError(f"target column {k!r} must hold {bg} {dt} "
                             f"on {spacked.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    if n_src.device != spacked.device:
        raise ValueError("n_src must be on the device of spacked")


def pairwise_eval(targets: dict, spacked: torch.Tensor, n_src: torch.Tensor,
                  want_pot: bool = True):
    """K1a wrapper: CUDA tensors launch `csrc/pairwise.cu`, CPU tensors take
    `pairwise_eval_torch`.  Counts kernel launches in
    `pairwise_eval.launches`."""
    _check(targets, spacked, n_src)
    if spacked.device.type == "cpu":
        return pairwise_eval_torch(targets, spacked, n_src, want_pot)
    if spacked.device.type != "cuda":
        raise ValueError(f"no pair kernel for device {spacked.device}")
    nb, _, s = spacked.shape
    bg = targets["x"].shape[0]
    group = bg // nb
    for k in ("x", "y", "z", "fsoft", "gid"):
        if not targets[k].is_contiguous():
            raise ValueError(f"target column {k!r} must be contiguous")
    if not spacked.is_contiguous() or not n_src.is_contiguous():
        raise ValueError("spacked and n_src must be contiguous")
    dev = spacked.device
    acc = torch.empty(bg, 3, dtype=torch.float32, device=dev)
    pot = (torch.empty(bg, dtype=torch.float32, device=dev) if want_pot
           else torch.zeros(bg, dtype=torch.float32, device=dev))
    nia = torch.empty(bg, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().ngravs_pairwise_newton(
            targets["x"].data_ptr(), targets["y"].data_ptr(),
            targets["z"].data_ptr(), targets["fsoft"].data_ptr(),
            targets["gid"].data_ptr(), spacked.data_ptr(), n_src.data_ptr(),
            nb, group, s, int(want_pot), acc.data_ptr(),
            pot.data_ptr() if want_pot else None, nia.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"pair kernel launch failed: cudaError {err}")
    pairwise_eval.launches += 1
    return acc, pot, nia


pairwise_eval.launches = 0
