"""K1: the fused walk's pair evaluation, as a CUDA kernel and its twin.

Port of `ngravs_tpu/ops/pairwise_pallas.py:make_pairwise_kernel`, all of it:
one law or a multi-law wiring with the accumulator count row (K1b), the
periodic minimum image (K1c) and the TreePM closed-form truncation (K1d),
with the potential on or off.  `pairwise_eval` keeps the interface of the
JAX kernel's wrapper, and takes the arguments of `make_pairwise_kernel`
(wiring, box_size, accumulator, treepm_asmth) as keywords:

    targets: dict of [B*G, 1] tensors x, y, z, mass (f32), grav (i32),
             fsoft (f32), gid (i32; -1 padding)
    spacked: [B, 8, S] f32 source rows x, y, z, mass, soft, count, grav,
             gid; rows 6/7 are int32 bit patterns (gid -1 padding, -2 node)
    n_src:   [B, 1] int32; only the first n_src[b] rows of block b are read
    returns  acc [B*G, 3] f32, pot [B*G] f32 (zeros without want_pot),
             nia [B*G] int32 valid-pair counts

`wiring=None` is the single Newton law (K1a).  A CUDA tensor goes to the
kernel (`csrc/pairwise.cu`), built with nvcc for sm_90a at first use into
`build/` at the repository root and loaded through ctypes; the wiring
reaches it as a table of law kinds and parameters, and a law the kernel
has no kind for raises.  A CPU tensor goes to the plain twin
`pairwise_eval_torch`.  There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile

import torch

from ..models import laws as L

# packed source-table rows (6/7 hold int32 bit patterns)
FX, FY, FZ, FMASS, FSOFT, FCOUNT, IGRAV, IGID = 0, 1, 2, 3, 4, 5, 6, 7

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "pairwise.cu")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]
_NEWTON = L.Newtonian()
_lib = None

# kernel instance flags and the law table's limits (csrc/pairwise.cu)
F_POT, F_PERIODIC, F_TREEPM, F_MULTI, F_COUNT = 1, 2, 4, 8, 16
MAX_NG, MAX_LAWS = 8, 16
# law kinds of the kernel, by exact law class
_KINDS = {L.NoneLaw: 0, L.Newtonian: 1, L.NegNewtonian: 2, L.Yukawa: 3,
          L.ColoYuk: 4, L.BamBam: 5, L.SourceBamBaryon: 6,
          L.SourceBaryonBam: 7}
# pair columns per slice of the twin (bounds its [B, G, S] temporaries)
_TWIN_SLICE = 8192


class _LawTable(ctypes.Structure):
    _fields_ = [("n_gravs", ctypes.c_int), ("n_laws", ctypes.c_int),
                ("slot", ctypes.c_int * (MAX_NG * MAX_NG)),
                ("kind", ctypes.c_int * MAX_LAWS),
                ("par", ctypes.c_float * (MAX_LAWS * 4))]


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
        fn = lib.ngravs_pairwise
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                       + [ctypes.POINTER(_LawTable)]
                       + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 4)
        _lib = lib
    return _lib


def law_entry(law):
    """(kernel kind, four parameters) of one law; ValueError for a law the
    kernel has no kind for."""
    kind = _KINDS.get(type(law))
    if kind is None:
        raise ValueError(
            f"the pair kernel has no kind for the law {law!r} "
            f"({type(law).__name__}); such a wiring runs on the CPU only")
    if isinstance(law, (L.Yukawa, L.ColoYuk)):
        y = law.yuk if isinstance(law, L.ColoYuk) else law
        a = y.asmth_cells * y.box_size / y.pmgrid if y.pmgrid else 0.0
        m = y.ym
        return kind, (m, 2.0 * a, m * a, a * math.sqrt(math.pi))
    if isinstance(law, L.BamBam):
        return kind, (4.0 * math.pi * law.eps, 0.0, 0.0, 0.0)
    return kind, (0.0, 0.0, 0.0, 0.0)


_tables = {}


def law_table(wiring) -> _LawTable:
    """The wiring as the kernel reads it: a law index per (target gravity,
    source gravity) slot, a kind and four parameters per law.  Cached per
    wiring object."""
    hit = _tables.get(id(wiring))
    if hit is not None and hit[0] is wiring:
        return hit[1]
    groups = wiring.unique_laws()
    ng = wiring.n_gravs
    if ng > MAX_NG or len(groups) > MAX_LAWS:
        raise ValueError(f"the pair kernel takes at most {MAX_NG} gravities "
                         f"and {MAX_LAWS} laws, got {ng} and {len(groups)}")
    tab = _LawTable()
    tab.n_gravs, tab.n_laws = ng, len(groups)
    for li, (law, slots) in enumerate(groups):
        kind, par = law_entry(law)
        tab.kind[li] = kind
        for k in range(4):
            tab.par[4 * li + k] = par[k]
        for tg, sg in slots:
            tab.slot[tg * ng + sg] = li
    _tables[id(wiring)] = (wiring, tab)
    return tab


def instance_flags(wiring=None, box_size: float = 0.0,
                   accumulator: bool | None = None,
                   treepm_asmth: float = 0.0, want_pot: bool = True) -> int:
    """Kernel instance of a configuration: the single Newton law needs no
    table, any other wiring dispatches per pair (the count row only then)."""
    groups = wiring.unique_laws() if wiring is not None else [(_NEWTON, [])]
    multi = not (len(groups) == 1 and type(groups[0][0]) is L.Newtonian)
    use_count = (wiring is not None and wiring.accumulator) \
        if accumulator is None else accumulator
    return ((F_POT if want_pot else 0) | (F_PERIODIC if box_size > 0 else 0)
            | (F_TREEPM if treepm_asmth > 0 else 0) | (F_MULTI if multi else 0)
            | (F_COUNT if multi and use_count else 0))


def instance_name(flags: int) -> str:
    """K1a (one Newton law), else K1 plus b (multi-law dispatch), c
    (periodic), d (TreePM); '+count' for the accumulator row, '/pot' with
    the potential."""
    parts = "".join(c for c, f in (("b", F_MULTI), ("c", F_PERIODIC),
                                   ("d", F_TREEPM)) if flags & f)
    name = "K1" + (parts or "a")
    if flags & F_COUNT:
        name += "+count"
    return name + ("/pot" if flags & F_POT else "")


def law_factors(law, tm, sm, r2, r, h, n, want_pot, inv2a):
    """One law's force and potential factors over a tile, closed-form
    truncated under TreePM (pairwise_pallas.py:74-94)."""
    if not inv2a:
        fac = law.force_factor(tm, sm, r2, r, h, n)
        pot = law.potential_factor(tm, sm, r2, r, h, n) if want_pot else None
        return fac, pot
    u = r * inv2a
    sf, sp = law.kernel_shortrange()
    unsoft = law.accel(tm, sm, r2, r, n) * sf(u) / torch.clamp(r, min=1e-37)
    soft = law.spline(tm, sm, h, r, n)
    inside = u < 3.0
    fac = torch.where(inside, torch.where(r >= h, unsoft, soft), 0.0)
    pot = None
    if want_pot:
        punsoft = -law.potential(tm, sm, r2, r, n) * sp(u)
        psoft = law.spline_pot(tm, sm, h, r, n)
        pot = torch.where(inside, torch.where(r >= h, punsoft, psoft), 0.0)
    return fac, pot


def pairwise_eval_torch(targets: dict, spacked: torch.Tensor,
                        n_src: torch.Tensor, want_pot: bool = True, *,
                        wiring=None, box_size: float = 0.0,
                        accumulator: bool | None = None,
                        treepm_asmth: float = 0.0):
    """Plain PyTorch twin of the kernel: the same masks and laws, the law
    groups dispatched by (target, source) gravity masks as the JAX kernel
    does, evaluated as [B, G, slice] tiles (any device)."""
    groups = wiring.unique_laws() if wiring is not None \
        else [(_NEWTON, [(0, 0)])]
    use_count = (wiring is not None and wiring.accumulator) \
        if accumulator is None else accumulator
    inv2a = 0.5 / treepm_asmth if treepm_asmth > 0 else 0.0
    bg = targets["x"].shape[0]
    nb, _, s = spacked.shape
    g = bg // nb
    dev = spacked.device
    col = lambda k: targets[k].reshape(nb, g, 1)
    tgid, tg, tm = col("gid"), col("grav"), col("mass")
    acc = torch.zeros(nb, g, 3, dtype=torch.float32, device=dev)
    pot = torch.zeros(nb, g, dtype=torch.float32, device=dev)
    nia = torch.zeros(nb, g, dtype=torch.int32, device=dev)
    for c0 in range(0, s, _TWIN_SLICE):
        cs = slice(c0, min(c0 + _TWIN_SLICE, s))
        sp = spacked[:, :, cs]
        sgid = sp[:, IGID, :].view(torch.int32)[:, None, :]
        live = torch.arange(c0, cs.stop, device=dev)[None, None, :] \
            < n_src.reshape(nb, 1, 1)
        valid = live & (sgid != -1) & (tgid >= 0) & (sgid != tgid)
        d = [sp[:, None, f, :] - col(k) for f, k in ((FX, "x"), (FY, "y"),
                                                    (FZ, "z"))]
        if box_size > 0:
            d = [x - box_size * torch.round(x * (1.0 / box_size)) for x in d]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        r = torch.sqrt(r2)
        h = torch.maximum(col("fsoft"), sp[:, None, FSOFT, :])
        sm = sp[:, None, FMASS, :]
        n = sp[:, None, FCOUNT, :] if use_count else 1.0
        if len(groups) == 1:
            fac, pf = law_factors(groups[0][0], tm, sm, r2, r, h, n,
                                   want_pot, inv2a)
        else:
            sg = sp[:, IGRAV, :].view(torch.int32)[:, None, :]
            fac = torch.zeros_like(r2)
            pf = torch.zeros_like(r2) if want_pot else None
            for law, slots in groups:
                mk = torch.zeros_like(valid)
                for i, j in slots:
                    mk = mk | ((tg == i) & (sg == j))
                f_k, p_k = law_factors(law, tm, sm, r2, r, h, n, want_pot,
                                        inv2a)
                fac = torch.where(mk, f_k, fac)
                if want_pot:
                    pf = torch.where(mk, p_k, pf)
        # masked by a select: an invalid pair's factor or offset may be
        # inf/NaN
        acc += torch.stack([torch.sum(torch.where(valid, fac * x, 0.0),
                                      dim=-1) for x in d], dim=-1)
        if want_pot:
            pot += torch.sum(torch.where(valid, pf, 0.0), dim=-1)
        nia += torch.sum(valid, dim=-1, dtype=torch.int32)
    return acc.reshape(bg, 3), pot.reshape(bg), nia.reshape(bg)


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
                  want_pot: bool = True, *, wiring=None,
                  box_size: float = 0.0, accumulator: bool | None = None,
                  treepm_asmth: float = 0.0):
    """K1 wrapper: CUDA tensors launch `csrc/pairwise.cu`, CPU tensors take
    `pairwise_eval_torch`.  Counts kernel launches in
    `pairwise_eval.launches`, and per instance (`instance_name`) in
    `pairwise_eval.counts`."""
    _check(targets, spacked, n_src)
    kw = dict(wiring=wiring, box_size=box_size, accumulator=accumulator,
              treepm_asmth=treepm_asmth)
    if spacked.device.type == "cpu":
        return pairwise_eval_torch(targets, spacked, n_src, want_pot, **kw)
    if spacked.device.type != "cuda":
        raise ValueError(f"no pair kernel for device {spacked.device}")
    flags = instance_flags(want_pot=want_pot, **kw)
    table = law_table(wiring) if flags & F_MULTI else None
    if flags & F_TREEPM:
        for law, _ in (wiring.unique_laws() if wiring is not None
                       else [(_NEWTON, [])]):
            if law.kernel_shortrange() is None:
                raise ValueError(f"the law {law!r} has no closed-form TreePM "
                                 "truncation for the pair kernel")
    nb, _, s = spacked.shape
    bg = targets["x"].shape[0]
    group = bg // nb
    for k in _T_DTYPES:
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
        err = _library().ngravs_pairwise(
            targets["x"].data_ptr(), targets["y"].data_ptr(),
            targets["z"].data_ptr(), targets["mass"].data_ptr(),
            targets["grav"].data_ptr(), targets["fsoft"].data_ptr(),
            targets["gid"].data_ptr(), spacked.data_ptr(), n_src.data_ptr(),
            nb, group, s, flags,
            ctypes.byref(table) if table is not None else None,
            box_size, 1.0 / box_size if box_size > 0 else 0.0,
            0.5 / treepm_asmth if treepm_asmth > 0 else 0.0,
            acc.data_ptr(), pot.data_ptr() if want_pot else None,
            nia.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"pair kernel launch failed: cudaError {err}")
    pairwise_eval.launches += 1
    name = instance_name(flags)
    pairwise_eval.counts[name] = pairwise_eval.counts.get(name, 0) + 1
    return acc, pot, nia


pairwise_eval.launches = 0
pairwise_eval.counts = {}


def reset_counts():
    """Zero the launch counters (total and per instance)."""
    pairwise_eval.launches = 0
    pairwise_eval.counts = {}
