"""TreePM short-range transition tables for any force law (port of
`ngravs_tpu/ops/shortrange.py`).

The reference's oversampled-FFT convolution (`performConvolution`,
ngravs_core.c:72-159; tabulated at the first tree allocation,
forcetree.c:3274-3354) as direct f64 quadrature on the host, in numpy:

    C(u)  = 2 * int_0^inf  ghat(k) exp(-k^2/4) cos(k u) dk
    I(u)  = int_0^u C(u') du'
    ftab(u) = I(u)/u^2 - C(u)/u          (force,     scaled by 1/(4 pi a^2))
    ptab(u) = I(u)/u                     (potential, scaled by 1/(2 pi a))

where ghat is the law's Newton-normalised k-space Green's function
(`normed_greens`) with the TreePM Gaussian split exp(-k^2/4) (Z = 0.5,
forcetree.c:3275) and u = r / (2 Asmth).  The walk subtracts
mass * utor2wpi * ftab(u) from the full force factor (forcetree.c:1958-2027;
utor2wpi = 1/(4 pi Asmth^2), forcetree.c:1708-1711).  For an all-Newton
wiring the tables reproduce erf(u) - 2u/sqrt(pi) exp(-u^2) to table
precision.

As in the JAX package, the potential table holds I(u)/u, where the
reference stores C(u)/u (forcetree.c:3340-3347): the long-range potential
is (a/pi) I(u)/u, and with C/u the reference fails its own Newtonian limit.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..models.wiring import GravityWiring

NTAB_DEFAULT = 2048  # Makefile.reference:52
UMAX = 3.0           # the table spans u in [0, 3) (forcetree.c:3336)


def _normed_greens_f64(law, k: np.ndarray) -> np.ndarray:
    """The law's normed Green's function sampled in f32 (as the JAX package
    samples it) and widened to f64."""
    g = law.normed_greens(torch.as_tensor(k * k, dtype=torch.float32),
                          torch.as_tensor(k, dtype=torch.float32))
    return g.double().numpy()


def shortrange_tables(wiring: GravityWiring, ntab: int = NTAB_DEFAULT,
                      kmax: float = 16.0, nk: int = 8001,
                      device="cpu"):
    """[NG, NG, ntab] (ftab, ptab) f32 tensors on `device`, indexed
    [target][source]; one quadrature per distinct law object."""
    ng = wiring.n_gravs
    k = np.linspace(0.0, kmax, nk)
    dk = k[1] - k[0]
    gauss = np.exp(-0.25 * k * k)
    u_i = UMAX / ntab * (np.arange(ntab) + 0.5)
    ksafe = np.maximum(k, 1e-30)

    ftab = np.zeros((ng, ng, ntab))
    ptab = np.zeros((ng, ng, ntab))
    done = {}
    for tg in range(ng):
        for sg in range(ng):
            law = wiring.law(tg, sg)
            if id(law) in done:
                ftab[tg, sg], ptab[tg, sg] = done[id(law)]
                continue
            integ = _normed_greens_f64(law, k) * gauss
            # single-quadrature forms (no I/u^2 - C/u cancellation):
            #   ftab(u) = 2 int ghat e^{-k^2/4}
            #             (sin(ku) - ku cos(ku)) / (k u^2) dk
            #   ptab(u) = 2 int ghat e^{-k^2/4} sin(ku) / (k u) dk
            f = np.empty(ntab)
            p = np.empty(ntab)
            for lo in range(0, ntab, 256):
                hi = min(lo + 256, ntab)
                x = np.outer(u_i[lo:hi], k)
                sinx, cosx = np.sin(x), np.cos(x)
                uu = u_i[lo:hi][:, None]
                fint = (sinx - x * cosx) / (ksafe * uu * uu)
                fint[:, 0] = 0.0             # k -> 0: k^2 u / 3 -> 0
                f[lo:hi] = 2.0 * np.trapezoid(fint * integ, dx=dk, axis=1)
                pint = sinx / (ksafe * uu)
                pint[:, 0] = 1.0             # k -> 0 limit of sin(ku)/(ku)
                p[lo:hi] = 2.0 * np.trapezoid(pint * integ, dx=dk, axis=1)
            ftab[tg, sg], ptab[tg, sg] = f, p
            done[id(law)] = (f, p)
    return (torch.as_tensor(ftab, dtype=torch.float32, device=device),
            torch.as_tensor(ptab, dtype=torch.float32, device=device))


def _lookup(tab, scale: float, asmth: float, ntab: int, r, pair_idx):
    """scale * tab[pair_idx] at u = r / (2 Asmth), linear between the table
    midpoints, 0 beyond the table; also the `inside` mask."""
    asmthfac = 0.5 / asmth * (ntab / UMAX)
    # linear interpolation between midpoints (the reference floors,
    # forcetree.c:1962; interpolating is strictly more accurate)
    t = r * asmthfac - 0.5
    idx = torch.clamp(t.to(torch.int32), 0, ntab - 2)
    frac = torch.clamp(t - idx, 0.0, 1.0)
    inside = r * asmthfac < ntab
    flat = tab.reshape(-1)
    base = pair_idx.long() * ntab + idx.long()
    v0 = flat[base]
    v1 = flat[base + 1]
    val = v0 + frac * (v1 - v0)
    return torch.where(inside, scale * val, 0.0), inside


def longrange_force_factor(ftab, asmth: float, ntab: int, r, pair_idx):
    """Mass-normalised long-range force factor to subtract: utor2wpi *
    ftab(u), 0 beyond the table (forcetree.c:1958-2027).  ftab: [NG*NG,
    ntab] (or [NG, NG, ntab]); r and pair_idx (tg*NG+sg) broadcast.  The
    caller multiplies by the source mass and divides by r."""
    return _lookup(ftab, 1.0 / (4 * math.pi * asmth * asmth), asmth, ntab,
                   r, pair_idx)


def longrange_pot_factor(ptab, asmth: float, ntab: int, r, pair_idx):
    """Mass-normalised long-range potential utorwpi * ptab(u)
    (forcetree.c:2860-2863 scaling, the I(u)/u table of this module)."""
    return _lookup(ptab, 1.0 / (2 * math.pi * asmth), asmth, ntab, r,
                   pair_idx)


def dump_transition_tables(wiring: GravityWiring, ftab, ptab,
                           asmth: float, box_size: float, output_dir: str,
                           forcetrace: bool = True) -> list:
    """NGRAVS_TREEPM_XITION_CHECK (+ NGRAVS_DEBUG_FORCETRACE): the
    tabulated transition of each distinct law name in the reference's file
    layout (forcetree.c:3299-3391): `ngravs_tpm_<name>_l<ntab>_ol0.txt` in
    `output_dir`, rows `u  C(u)  I(u)` (C = ptab - u ftab, I = u ptab);
    with `forcetrace`, the untruncated against the truncated force
    (forcetree.c:3357-3383).  Returns the files written."""
    ng = wiring.n_gravs
    f_np = np.asarray(torch.as_tensor(ftab).cpu(), np.float64)
    p_np = np.asarray(torch.as_tensor(ptab).cpu(), np.float64)
    ntab = f_np.shape[-1]
    u = UMAX / ntab * (np.arange(ntab) + 0.5)
    asmthfac = 0.5 / asmth * (ntab / UMAX)
    utor2wpi = 1.0 / (4 * math.pi * asmth * asmth)
    accel = lambda law, r: float(law.accel(1.0, 1.0, torch.tensor(
        r * r, dtype=torch.float32), torch.tensor(r, dtype=torch.float32), 1))
    written, seen = [], set()
    for tg in range(ng):
        for sg in range(ng):
            name = wiring.names[tg][sg]
            if name in seen:     # each law name once, like the skipWrite
                continue         # loop (forcetree.c:3304-3309)
            seen.add(name)
            c_u = p_np[tg, sg] - u * f_np[tg, sg]
            i_u = u * p_np[tg, sg]
            path = os.path.join(output_dir,
                                f"ngravs_tpm_{name}_l{ntab}_ol0.txt")
            with open(path, "w") as fh:
                for i in range(ntab):
                    fh.write(f"{u[i]:.15e} {c_u[i]:.15e} {i_u[i]:.15e}\n")
                if forcetrace:
                    law = wiring.law(tg, sg)
                    fh.write("\n# Begin debug forcetrace output\n"
                             f"# Asmth: {asmth:f}\n")
                    r_tab = np.arange(ntab) / asmthfac
                    for i in range(ntab):
                        r = max(r_tab[i], 1e-12)
                        a_full = accel(law, r)
                        a_short = a_full - utor2wpi * f_np[tg, sg, i]
                        fh.write(f"{r:.15e} {a_full:.15e} {a_short:.15e}\n")
                    if box_size > 0:
                        r = r_tab[-1]
                        while r < box_size * 0.5:
                            fh.write(f"{r:.15e} {accel(law, r):.15e} 0.0\n")
                            r += box_size * 0.005
            written.append(path)
    return written
