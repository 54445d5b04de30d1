"""Direct-summation force test (FORCETEST; port of
`ngravs_tpu/diagnostics/forcetest.py`).

`gravity_forcetest()` (gravtree_forcetest.c:28): a random fraction of the
particles gets exact O(N * Nsel) direct-summation forces, with spline
softening and, in a periodic box, the lattice (Ewald) correction
(force_treeevaluate_direct, forcetree.c:3428-3548), appended to
`forcetest.txt` beside the solver's forces:

    type  ti  pos[3]  acc_direct[3]  acc_tree[3]  id

The sample is the JAX package's (the same numpy generator and seed), so
both packages test the same particles.  `rms_error` summarises the
relative errors as utilities/tpmfp.py bins them.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.direct import direct_forces
from ..trace import read


def force_test(sim, fraction: float | None = None, seed: int = 42,
               write: bool = True):
    """The direct-sum test on the current state of a Simulation, on its
    device, in target chunks of about 2^24 pairs.  Returns (idx,
    acc_direct, acc_solver, rel_err) as numpy arrays; with `write`,
    appends forcetest.txt rows in the reference's layout
    (gravtree_forcetest.c:294-312)."""
    cfg = sim.cfg
    frac = cfg.force_test if fraction is None else fraction
    if frac <= 0:
        frac = 0.01
    p = sim.p
    n = p.n
    rng = np.random.default_rng(seed + sim.step_count)
    nsel = max(1, int(frac * n))
    idx = np.sort(rng.choice(n, size=nsel, replace=False)).astype(np.int32)

    dev = p.pos.device
    fsoft = torch.as_tensor(np.asarray(sim.force_soft, np.float32),
                            device=dev)[p.ptype.long()]
    if cfg.adaptive_gravsoft_forgas and sim.sph is not None:
        fsoft = torch.where(p.ptype == 0, sim.sph.hsml, fsoft)
    box = cfg.box_size if cfg.periodic else 0.0
    # the exact periodic oracle: Ewald tables even under PMGRID
    # (begrun.c:47-49; forcetree.c:3471-3530).  The solver builds them
    # when ForceTest is configured; a direct caller (tpmfp, rdep) gets them
    # here, since a bare minimum-image sum is not the periodic force
    lat = sim.solver.oracle_lattice_tables
    if lat is None:
        lat = sim.solver.lattice_tables
    if lat is None and cfg.periodic:
        from ..ops.lattice import build_lattice_tables
        lat = build_lattice_tables(sim.wiring, cfg.ngravs_en, cfg.box_size,
                                   device=dev)
        sim.solver.oracle_lattice_tables = lat
    acc_d, _ = direct_forces(
        sim.wiring, p.pos, p.mass, p.grav, fsoft,
        tgt_idx=torch.as_tensor(idx, device=dev), box=box,
        chunk=max(1, min(1024, (1 << 24) // n)), want_pot=False,
        lattice_tables=lat)
    acc_d = read(acc_d * sim.units.G).numpy()

    sel = torch.as_tensor(idx, device=dev).long()
    acc_s = p.accel[sel]
    if cfg.pmgrid:
        acc_s = acc_s + p.accel_pm[sel]
    acc_s = read(acc_s).numpy()
    num = np.linalg.norm(acc_s - acc_d, axis=1)
    den = np.maximum(np.linalg.norm(acc_d, axis=1), 1e-30)
    rel = num / den

    if write and sim.log_dir:
        pos = read(p.pos[sel]).numpy()
        ptype = read(p.ptype[sel]).numpy()
        pid = read(p.pid[sel]).numpy()
        with open(os.path.join(sim.log_dir, "forcetest.txt"), "a") as f:
            for k in range(nsel):
                f.write(
                    f"{ptype[k]} {sim.ti_current} "
                    f"{pos[k, 0]:g} {pos[k, 1]:g} {pos[k, 2]:g} "
                    f"{acc_d[k, 0]:g} {acc_d[k, 1]:g} {acc_d[k, 2]:g} "
                    f"{acc_s[k, 0]:g} {acc_s[k, 1]:g} {acc_s[k, 2]:g} "
                    f"{pid[k]}\n")
    return idx, acc_d, acc_s, rel


def rms_error(rel: np.ndarray) -> dict:
    """Summary statistics in the style of utilities/tpmfp.py's binned RMS."""
    return {
        "rms": float(np.sqrt((rel ** 2).mean())),
        "p50": float(np.percentile(rel, 50)),
        "p90": float(np.percentile(rel, 90)),
        "p99": float(np.percentile(rel, 99)),
        "max": float(rel.max()),
        "n": int(rel.size),
    }
