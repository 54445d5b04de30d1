"""Two Plummer galaxies on a collision orbit (the GalaxyCollision shape).

A frozen copy of the IC writer that drove the port's open-box path
(two 1e12 Msun galaxies with a = 10 kpc, 100 kpc apart, closing at 300
km/s with a 20 kpc impact parameter, the per-type counts of Gadget's
GalaxyCollision.IC), returning arrays instead of writing a file.  The
benchmark owns this copy: it does not follow any other script.

The particles are drawn once, from the configuration's `sample_seed`; a
run's seed maps the whole system by one of the cube's 48 symmetries (a
signed permutation of the axes) and shuffles the particles within each
type.  Every seed then has the same galaxies and the same work in
another order: the octree of a mirrored or axis-swapped set is the
mirrored tree, cell for cell, so the walk's lists keep their sizes.  A
general rotation would change the tree's cells, and with them the work:
rotated seeds ran up to 20% apart where one seed's runs agreed to within
a few %.
"""

from __future__ import annotations

import numpy as np


def plummer(rng, k: int, a: float, m: float, g_int: float):
    """k positions/velocities of a Plummer sphere (scale a, mass m) cut at
    10 a, with isotropic Gaussian velocities of the local dispersion."""
    x = rng.uniform(1e-3, 0.999, k)
    r = np.minimum(a / np.sqrt(x ** (-2.0 / 3.0) - 1.0), 10 * a)
    u = rng.normal(size=(k, 3))
    pos = r[:, None] * u / np.linalg.norm(u, axis=1, keepdims=True)
    sigma = np.sqrt(g_int * m / (6.0 * np.sqrt(r * r + a * a)))
    return pos, rng.normal(size=(k, 3)) * sigma[:, None]


def symmetry(rng) -> np.ndarray:
    """One of the cube's 48 symmetries, drawn uniformly: a signed
    permutation matrix."""
    m = np.zeros((3, 3))
    m[np.arange(3), rng.permutation(3)] = rng.choice([-1.0, 1.0], 3)
    return m


def make(spec: dict, param: dict, seed: int, g_int: float,
         hubble: float) -> dict:
    """The IC of `spec` ({"npart": six per-type counts, "galaxy_mass",
    "plummer_a", "sample_seed"}) mapped by the symmetry of `seed` and
    shuffled within each type: pos, vel, mass, pid, ptype (numpy).  The box is open, so `param` and
    `hubble` set nothing here."""
    npart = [int(c) for c in spec["npart"]]
    m_gal, a = float(spec["galaxy_mass"]), float(spec["plummer_a"])
    rng = np.random.default_rng(int(spec["sample_seed"]))
    n = sum(npart)
    ptype = np.repeat(np.arange(6, dtype=np.int32), npart)
    gal = np.zeros(n, np.int64)
    for t in range(6):           # each type split evenly between galaxies
        idx = np.nonzero(ptype == t)[0]
        gal[idx[len(idx) // 2:]] = 1
    pos = np.zeros((n, 3))
    vel = np.zeros((n, 3))
    for k, (off, v) in enumerate((([-50.0, -10.0, 0.0], [150.0, 0, 0]),
                                  ([50.0, 10.0, 0.0], [-150.0, 0, 0]))):
        sel = gal == k
        p, w = plummer(rng, int(sel.sum()), a, m_gal, g_int)
        pos[sel] = p + off
        vel[sel] = w + v
    run = np.random.default_rng(seed)
    sym = symmetry(run)
    order = np.concatenate([run.permutation(np.nonzero(ptype == t)[0])
                            for t in range(6)])
    pos, vel = pos[order] @ sym.T, vel[order] @ sym.T
    return dict(pos=pos.astype(np.float32), vel=vel.astype(np.float32),
                mass=np.full(n, m_gal * 2 / n, np.float32),
                pid=order.astype(np.int64) + 1, ptype=ptype, u=None)
