"""FORCETEST's rms on chip_smoke.py's two-species TreePM box (slice 2) and
on its three-species gas box (phase 13d), in the JAX package and in the
port, on the CPU.

    JAX_PLATFORMS=cpu python tools/port_studies/forcetest_13d.py [NSIDE]

Each box at NSIDE^3 particles a species (16; PMGRID 4 x NSIDE, the card
runs 64^3 at 128 and this keeps the mesh fine enough for 16^3), the card's
settings and wiring (newton_yukawa; three_species with gas), one step in
each package from the same parameterfile, then `force_test` on each
package's state at a fraction that picks 2,048 rows: the rms of |a_tree -
a_direct| / |a_direct| by gravity and over all rows, and the median
|a_direct| by gravity.  Imports JAX: run it on the CPU.
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
from ngravs_tpu.diagnostics.forcetest import force_test as j_ft  # noqa
from ngravs_tpu.integrate.runner import Simulation as JSim  # noqa: E402
from ngravs_tpu_torch.config import read_parameter_file as t_read  # noqa
from ngravs_tpu_torch.diagnostics.forcetest import force_test as t_ft  # noqa
from ngravs_tpu_torch.integrate.runner import Simulation as TSim  # noqa


def main(ns: int):
    cs.BOX_NSIDE = ns
    for label in ("two species (slice 2)", "three species + gas (13d)"):
        run_dir = tempfile.mkdtemp(prefix="ft13d_")
        if label.startswith("two"):
            param = cs.write_cosmo_box(run_dir)
            kw = dict(pmgrid=4 * ns, n_gravs=2, wiring="newton_yukawa",
                      pm_interlace=True)
        else:
            param = cs.write_gas_box(run_dir, name="three_species_box",
                                     three=True)
            kw = dict(pmgrid=4 * ns, n_gravs=3, wiring="three_species",
                      pm_interlace=True)
        for name, read, sim_cls, ft, extra in (
                ("jax", j_read, JSim, j_ft, {}),
                ("port", t_read, TSim, t_ft, {"device": "cpu"})):
            cfg = read(param, **kw)
            t0 = time.time()
            sim = sim_cls(cfg, log_dir="", **extra)
            sim.step()
            n = int(sim.p.pos.shape[0])
            idx, acc_d, _, rel = ft(sim, fraction=2048 / n, write=False)
            grav = np.asarray(sim.p.grav)[idx]
            norm = np.linalg.norm(np.asarray(acc_d), axis=1)
            print(f"{label}, {name}, {n} particles, PMGRID {cfg.pmgrid}, "
                  f"{len(idx)} rows ({time.time() - t0:.1f} s): rms "
                  f"{np.sqrt(np.mean(rel ** 2)):.4e}; by gravity "
                  + ", ".join(
                      f"{g}: rms {np.sqrt(np.mean(rel[grav == g] ** 2)):.4e}"
                      f" (median |a_direct| {np.median(norm[grav == g]):.4e})"
                      for g in range(cfg.n_gravs)), flush=True)


if __name__ == "__main__":
    torch.set_num_threads(2)
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 16)
