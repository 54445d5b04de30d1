"""The BAM targets' force error of chip_smoke.py's phase 13b, in the JAX
package's fused walk and in the port's, on the CPU.

    JAX_PLATFORMS=cpu python tools/port_studies/bam_targets.py FRACTION

chip_smoke.py's GalaxyCollision-shaped IC with FRACTION of its 60k
particles (the same two galaxies, each type cut alike), the halo (type 1)
as BAM dark matter (gravity 1) and the rest baryons, the `bam` wiring
with NGRAVS_ACCUMULATOR, the geometric criterion at theta 0.5, read as
phase 13b reads it.  One full force pass at the IC through each
package's solver (JAX: the fused walk with the Pallas kernel's plain
version; the port: the fused walk with K1's twin) against the direct sum
with the same wiring; prints the rms relative error by gravity and the
median |a| of each, for the accumulator on and off.  Imports JAX: run it
on the CPU.
"""

import os
import sys
import tempfile
import time

import numpy as np
import torch
import jax

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
jax.config.update("jax_platforms", "cpu")

import chip_smoke as cs  # noqa: E402
from ngravs_tpu.config import read_parameter_file as j_read  # noqa: E402
from ngravs_tpu.integrate.runner import Simulation as JSim  # noqa: E402
from ngravs_tpu_torch.config import read_parameter_file as t_read  # noqa
from ngravs_tpu_torch.integrate.runner import Simulation as TSim  # noqa
from ngravs_tpu_torch.ops.direct import direct_forces  # noqa: E402


def main(frac: float):
    npart = tuple(int(round(k * frac)) for k in cs.NPART)
    run_dir = tempfile.mkdtemp(prefix="bam_targets_")
    param = cs.write_galaxy_collision(run_dir, npart=npart)
    param = cs.rewrite_param(param, param, GravityHalo=1, GravityDisk=0,
                             TypeOfOpeningCriterion=0)
    for acc_on in (True, False):
        kw = dict(direct_crossover=1000, tree_depth=12, n_gravs=2,
                  wiring="bam", ngravs_accumulator=acc_on)
        res = {}
        for name, read, sim_cls, extra in (("jax", j_read, JSim, {}),
                                           ("port", t_read, TSim,
                                            {"device": "cpu"})):
            cfg = read(param, **kw)
            sim = sim_cls(cfg, log_dir="", **extra)
            p = sim.p
            t0 = time.time()
            p_all = p.replace(ti_endstep=p.ti_begstep * 0)
            p2 = sim.solver.compute(p_all, 0, int(p.pos.shape[0]))[0]
            res[name] = np.asarray(p2.accel, np.float64)
            print(f"{name}: force pass on {p.pos.shape[0]} particles, "
                  f"accumulator {acc_on}, {time.time() - t0:.1f} s",
                  flush=True)
            if name == "port":
                tsim = sim
        p = tsim.p
        fsoft = torch.as_tensor(tsim.force_soft)[p.ptype.long()]
        acc_d, _ = direct_forces(tsim.wiring, p.pos, p.mass, p.grav, fsoft,
                                 chunk=512, want_pot=False,
                                 dtype=torch.float64)
        acc_d = acc_d.numpy() * tsim.units.G
        grav = p.grav.numpy()
        norm = np.linalg.norm(acc_d, axis=1)
        for name, acc in res.items():
            rel = np.linalg.norm(acc - acc_d, axis=1) / np.maximum(norm,
                                                                   1e-30)
            rms = [np.sqrt(np.mean(rel[grav == g] ** 2)) for g in (0, 1)]
            print(f"{sum(npart)} particles, accumulator {acc_on}, {name}: "
                  + ", ".join(f"gravity {g} rms {rms[g]:.4e} (median |a| "
                              f"{np.median(norm[grav == g]):.4e})"
                              for g in (0, 1)), flush=True)
        jrel = np.linalg.norm(res["port"] - res["jax"], axis=1) \
            / np.maximum(np.linalg.norm(res["jax"], axis=1), 1e-30)
        print(f"port against JAX: max |da| / |a| {jrel.max():.3e}",
              flush=True)


if __name__ == "__main__":
    torch.set_num_threads(2)
    main(float(sys.argv[1]))
