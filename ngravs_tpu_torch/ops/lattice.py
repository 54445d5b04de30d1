"""Periodic lattice (Ewald) correction tables (port of
`ngravs_tpu/ops/lattice.py`).

The reference's per-pair lattice machinery: table generation
(`lattice_init`, forcetree.c:3611-3800), the Newtonian Ewald sums
(`ewald_psi`/`ewald_force`, ngravs.c:761-826 and :1170-1232, alpha = 2 and
n, h in [-4,4]^3) and the screened-Yukawa sums (`yukawa_lattice_psi` /
`yukawa_lattice_force`, ngravs.c:954-1150, alpha = 5.64 and n, h in
[-5,5]^3).

Tables are (EN+1)^3 grids over the octant x in [0, 0.5]^3 (box fractions)
of the force correction and the potential correction.  They are generated
in float64 on the host, by `native/lattice_tables.cpp` (compiled with the
host C++ compiler into `build/` at first use and loaded through ctypes) or,
where that cannot be built, by the vectorised numpy sums below; and cached
as .npy files in `$NGRAVS_TORCH_TABLE_DIR`, by default
`~/.cache/ngravs_tpu_torch_tables`.  `last_generator` says which generator
made the tables of the last call that computed any.

The lookup is the trilinear interpolation with octant sign folding of
`lattice_corr` (forcetree.c:3803-3900), as torch ops.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile

import numpy as np
import torch

CACHE_DIR_ENV = "NGRAVS_TORCH_TABLE_DIR"
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_SRC = os.path.join(_ROOT, "native", "lattice_tables.cpp")
_BUILD_DIR = os.path.join(_ROOT, "build")

NEWTON_MADELUNG = 2.8372975  # classic cubic-lattice value used by Gadget-2

_native = None
last_generator = None  # "native" or "numpy": what made the last tables


def _cache_dir() -> str:
    return os.environ.get(CACHE_DIR_ENV, os.path.expanduser(
        "~/.cache/ngravs_tpu_torch_tables"))


# ---------------------------------------------------------------------------
# Native (C++/OpenMP) generator, compiled into build/ (never into native/)
# ---------------------------------------------------------------------------

def build_native() -> str | None:
    """Compile `native/lattice_tables.cpp` with the host C++ compiler into
    `build/` (keyed by the source's hash); None if that cannot be done."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None or not os.path.exists(_NATIVE_SRC):
        return None
    with open(_NATIVE_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(_BUILD_DIR, f"liblattice_tables_{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        for flags in (["-fopenmp"], []):
            r = subprocess.run([cxx, "-O3", *flags, "-fPIC", "-shared",
                                "-std=c++17", "-o", tmp, _NATIVE_SRC],
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
    global _native
    if _native is None:
        path = build_native()
        _native = False
        if path is not None:
            try:
                dll = ctypes.CDLL(path)
                dbl_p = ctypes.POINTER(ctypes.c_double)
                dll.ewald_newton_tables.argtypes = [ctypes.c_int, dbl_p,
                                                    dbl_p]
                dll.yukawa_lattice_tables.argtypes = [
                    ctypes.c_int, ctypes.c_double, dbl_p, dbl_p]
                _native = dll
            except OSError:
                _native = False
    return _native or None


def _native_tables(kind: str, en: int, ym: float = 0.0):
    """(force [M,3], psi [M]) via the native generator, or None."""
    dll = _native_lib()
    if dll is None:
        return None
    m = (en + 1) ** 3
    force = np.zeros((m, 3))
    psi = np.zeros(m)
    fp = force.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    pp = psi.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    if kind == "newton":
        dll.ewald_newton_tables(en, fp, pp)
    else:
        dll.yukawa_lattice_tables(en, ctypes.c_double(ym), fp, pp)
    return force, psi


# ---------------------------------------------------------------------------
# numpy Ewald sums (vectorised over a batch of octant points x [M,3])
# ---------------------------------------------------------------------------

def _erfc(x):
    from scipy.special import erfc
    return erfc(x)


def ewald_force_newton(x: np.ndarray) -> np.ndarray:
    """Newtonian lattice force correction at octant points x [M,3] (box
    fractions), ngravs.c:1170-1232."""
    alpha = 2.0
    m = x.shape[0]
    force = np.zeros((m, 3))
    r2 = (x * x).sum(1)
    nz = r2 > 0
    force[nz] = x[nz] / (r2[nz] ** 1.5)[:, None]
    rng = np.arange(-4, 5)
    for n0 in rng:
        for n1 in rng:
            for n2 in rng:
                dx = x - np.array([n0, n1, n2])
                r = np.maximum(np.sqrt((dx * dx).sum(1)), 1e-30)
                val = _erfc(alpha * r) + 2 * alpha * r / math.sqrt(math.pi) \
                    * np.exp(-alpha * alpha * r * r)
                force -= dx * (val / r ** 3)[:, None]
    for h0 in rng:
        for h1 in rng:
            for h2 in rng:
                h2n = h0 * h0 + h1 * h1 + h2 * h2
                if h2n == 0:
                    continue
                hdotx = x[:, 0] * h0 + x[:, 1] * h1 + x[:, 2] * h2
                val = 2.0 / h2n * math.exp(-math.pi ** 2 * h2n / alpha ** 2) \
                    * np.sin(2 * math.pi * hdotx)
                force -= np.outer(val, [h0, h1, h2])
    force[~nz] = 0.0
    return force


def ewald_psi_newton(x: np.ndarray) -> np.ndarray:
    """Newtonian lattice potential correction (ngravs.c:761-816)."""
    alpha = 2.0
    m = x.shape[0]
    sum1 = np.zeros(m)
    sum2 = np.zeros(m)
    rng = np.arange(-4, 5)
    for n0 in rng:
        for n1 in rng:
            for n2 in rng:
                dx = x - np.array([n0, n1, n2])
                r = np.maximum(np.sqrt((dx * dx).sum(1)), 1e-30)
                sum1 += _erfc(alpha * r) / r
    for h0 in rng:
        for h1 in rng:
            for h2 in rng:
                h2n = h0 * h0 + h1 * h1 + h2 * h2
                if h2n == 0:
                    continue
                hdotx = x[:, 0] * h0 + x[:, 1] * h1 + x[:, 2] * h2
                sum2 += 1.0 / (math.pi * h2n) * math.exp(
                    -math.pi ** 2 * h2n / alpha ** 2) \
                    * np.cos(2 * math.pi * hdotx)
    r = np.maximum(np.sqrt((x * x).sum(1)), 1e-30)
    return math.pi / alpha ** 2 - sum1 - sum2 + 1.0 / r


def yukawa_lattice_force(x: np.ndarray, ym: float) -> np.ndarray:
    """Screened-Yukawa lattice force correction (ngravs.c:1019-1150, Salin &
    Caillol), alpha = 5.64; `ym` is YUKAWA_IMASS per box length."""
    alpha = 5.64
    m = x.shape[0]
    force = np.zeros((m, 3))
    r2 = (x * x).sum(1)
    nz = r2 > 0
    r0 = np.sqrt(r2[nz])
    force[nz] = (np.exp(-r0 * ym) * (ym + 1.0 / r0) / r2[nz])[:, None] * x[nz]
    rng = np.arange(-5, 6)
    for n0 in rng:
        for n1 in rng:
            for n2 in rng:
                dx = x - np.array([n0, n1, n2])
                r = np.maximum(np.sqrt((dx * dx).sum(1)), 1e-30)
                ep = np.exp(ym * r) * _erfc(alpha * r + ym / (2 * alpha))
                en = np.exp(-ym * r) * _erfc(alpha * r - ym / (2 * alpha))
                val = 0.5 * (ep + en)
                force -= dx * (val / r ** 3)[:, None]
                val = 0.5 * ym * (-ep + en) \
                    + 2 * alpha / math.sqrt(math.pi) * np.exp(
                        -alpha * alpha * r * r - ym * ym / (4 * alpha * alpha))
                force -= dx * (val / r ** 2)[:, None]
    ymk = ym / (2 * math.pi)
    for h0 in rng:
        for h1 in rng:
            for h2 in rng:
                h2n = h0 * h0 + h1 * h1 + h2 * h2
                if h2n == 0:
                    continue
                hdotx = x[:, 0] * h0 + x[:, 1] * h1 + x[:, 2] * h2
                val = 2 * math.exp(
                    -math.pi ** 2 * (h2n + ymk * ymk) / alpha ** 2) \
                    * np.sin(2 * math.pi * hdotx) / (h2n + ymk * ymk)
                force -= np.outer(val, [h0, h1, h2])
    force[~nz] = 0.0
    return force


def yukawa_lattice_psi(x: np.ndarray, ym: float) -> np.ndarray:
    """Screened-Yukawa lattice potential correction (ngravs.c:954-1014)."""
    alpha = 5.64
    m = x.shape[0]
    sum1 = np.zeros(m)
    sum2 = np.zeros(m)
    rng = np.arange(-5, 6)
    for n0 in rng:
        for n1 in rng:
            for n2 in rng:
                dx = x - np.array([n0, n1, n2])
                r = np.maximum(np.sqrt((dx * dx).sum(1)), 1e-30)
                sum1 += _erfc(alpha * r + ym / (2 * alpha)) \
                    * np.exp(ym * r) / (2 * r)
                sum1 += _erfc(alpha * r - ym / (2 * alpha)) \
                    * np.exp(-ym * r) / (2 * r)
    for h0 in rng:
        for h1 in rng:
            for h2 in rng:
                h2n = h0 * h0 + h1 * h1 + h2 * h2
                if h2n == 0:
                    continue
                hdotx = x[:, 0] * h0 + x[:, 1] * h1 + x[:, 2] * h2
                sum2 += 1.0 / (math.pi * h2n + ym * ym / (4 * math.pi)) \
                    * math.exp(-math.pi ** 2 * h2n / alpha ** 2
                               - ym * ym / (4 * alpha * alpha)) \
                    * np.cos(2 * math.pi * hdotx)
    r = np.maximum(np.sqrt((x * x).sum(1)), 1e-30)
    return math.pi / alpha ** 2 - sum1 - sum2 + np.exp(-ym * r) / r


def yukawa_madelung(ym: float) -> float:
    """Yukawa Madelung constant: the reference leaves it unimplemented and
    returns 0 (ngravs.c:896-948); reproduced for parity."""
    return 0.0


# ---------------------------------------------------------------------------
# Table generation and caching
# ---------------------------------------------------------------------------

def _octant_points(en: int) -> np.ndarray:
    ii = np.arange(en + 1)
    g = np.stack(np.meshgrid(ii, ii, ii, indexing="ij"), axis=-1)
    return 0.5 * g.reshape(-1, 3) / en


def _generate(kind: str, en: int, ym: float, native: bool):
    """(force, psi) of one Newton or Yukawa lattice; records the
    generator."""
    global last_generator
    nat = _native_tables(kind, en, ym) if native else None
    if nat is not None:
        last_generator = "native"
        return nat
    last_generator = "numpy"
    x = _octant_points(en)
    if kind == "newton":
        return ewald_force_newton(x), ewald_psi_newton(x)
    return yukawa_lattice_force(x, ym), yukawa_lattice_psi(x, ym)


def lattice_tables_for(kind: str, en: int, params: dict | None = None,
                       cache: bool = True, native: bool = True) -> np.ndarray:
    """Compute (or load) the raw octant tables of one lattice kind:
    [EN+1, EN+1, EN+1, 4] float64 fx, fy, fz, psi in box-fraction units.
    kinds: "none", "newton", "yukawa" and "coloyuk" (params: ym).
    `native=False` forces the numpy sums."""
    params = params or {}
    en1 = en + 1
    if kind == "none":
        return np.zeros((en1, en1, en1, 4))
    tag = kind if kind == "newton" else f"{kind}_{params['ym']:.6e}"
    path = os.path.join(_cache_dir(), f"lattice_spc_table_{en}_{tag}.npy")
    if cache and os.path.exists(path):
        return np.load(path)
    if kind == "newton":
        f, p = _generate("newton", en, 0.0, native)
        p[0] = NEWTON_MADELUNG
    elif kind == "yukawa":
        ym = float(params["ym"])
        f, p = _generate("yukawa", en, ym, native)
        p[0] = yukawa_madelung(ym)
    elif kind == "coloyuk":
        ym = float(params["ym"])
        fn, pn = _generate("newton", en, 0.0, native)
        fy, py = _generate("yukawa", en, ym, native)
        f, p = fy + fn, py + pn
        p[0] = NEWTON_MADELUNG + yukawa_madelung(ym)
    else:
        raise ValueError(f"unknown lattice kind {kind!r}")
    out = np.concatenate([f, p[:, None]], axis=1).reshape(en1, en1, en1, 4)
    if cache:
        os.makedirs(_cache_dir(), exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".npy", dir=_cache_dir())
        os.close(fd)
        np.save(tmp, out)
        os.replace(tmp, path)
    return out


def build_lattice_tables(wiring, en: int, box_size: float, device="cpu",
                         cache: bool = True) -> torch.Tensor:
    """Per-pair [NG*NG, EN+1, EN+1, EN+1, 4] f32 table (pairs flattened
    tg*NG+sg), rescaled to length units (force /L^2, potential /L;
    forcetree.c:3750-3764).  Each law must expose `lattice_kind()`."""
    ng = wiring.n_gravs
    en1 = en + 1
    tabs = np.zeros((ng, ng, en1, en1, en1, 4), np.float64)
    for tg in range(ng):
        for sg in range(ng):
            kind, params = wiring.law(tg, sg).lattice_kind()
            tabs[tg, sg] = lattice_tables_for(kind, en, params, cache=cache)
    tabs[..., :3] /= box_size * box_size
    tabs[..., 3] /= box_size
    return torch.as_tensor(tabs.reshape((ng * ng,) + tabs.shape[2:]),
                           dtype=torch.float32, device=device)


def lattice_correction(tables, fac_intp: float, dx, dy, dz, pair_idx):
    """Trilinear octant lookup (lattice_corr, forcetree.c:3803-3900).

    tables: [NPAIR, EN+1, EN+1, EN+1, 4]; fac_intp: 2*EN/BoxSize;
    dx, dy, dz: displacement SOURCE - TARGET (minimum-imaged), any
    broadcastable shape; pair_idx: int tg*NG+sg of that shape.  Returns
    (fcx, fcy, fcz, pot) with the octant signs applied: the caller adds
    mass * fc to the attraction-positive accumulation."""
    en = tables.shape[1] - 1
    npair = tables.shape[0]
    tflat = tables.reshape(npair * (en + 1) ** 3, 4)

    def fold(d):
        return torch.abs(d), torch.where(d < 0, 1.0, -1.0)

    ax, sx = fold(dx)
    ay, sy = fold(dy)
    az, sz = fold(dz)

    def cell(a):
        u = a * fac_intp
        i = torch.clamp(u.to(torch.int32), 0, en - 1)
        return i.long(), u - i.to(u.dtype)

    i, u = cell(ax)
    j, v = cell(ay)
    k, w = cell(az)
    base = pair_idx.long() * (en + 1) ** 3
    idx = base + (i * (en + 1) + j) * (en + 1) + k

    def corner(di, dj, dk):
        return tflat[idx + (di * (en + 1) + dj) * (en + 1) + dk]

    f = ((1 - u) * (1 - v) * (1 - w))[..., None] * corner(0, 0, 0) \
        + ((1 - u) * (1 - v) * w)[..., None] * corner(0, 0, 1) \
        + ((1 - u) * v * (1 - w))[..., None] * corner(0, 1, 0) \
        + ((1 - u) * v * w)[..., None] * corner(0, 1, 1) \
        + (u * (1 - v) * (1 - w))[..., None] * corner(1, 0, 0) \
        + (u * (1 - v) * w)[..., None] * corner(1, 0, 1) \
        + (u * v * (1 - w))[..., None] * corner(1, 1, 0) \
        + (u * v * w)[..., None] * corner(1, 1, 1)
    return sx * f[..., 0], sy * f[..., 1], sz * f[..., 2], f[..., 3]
