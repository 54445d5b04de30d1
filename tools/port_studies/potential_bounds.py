"""The bounds of chip_smoke.py's periodic potential rule (phase 14), from the
JAX package on the CPU.

    JAX_PLATFORMS=cpu python tools/port_studies/potential_bounds.py \
        box|tab|ewald|stock|glass NSIDE [STEPS] [--card-density] \
        [--jax-only]

Builds chip_smoke.py's IC of a periodic path at NSIDE per lattice side
(PMGRID 2 x NSIDE, as the card's 2 x 64^3 boxes have PMGRID 128), runs
STEPS steps (2; the glass path's 5) in the JAX package and in the port
from the same parameterfile (with --card-density in a box cut to NSIDE /
64 of the card's 50,000 kpc/h side, so that the particle spacing,
softening, mesh cell and Yukawa lengths are the card's), calls
`update_full_potential` in each and holds both to the periodic direct sum
with the lattice correction (float64 arithmetic) on 2,048 sampled targets:
per gravity, d = pot - pot_direct, mean(d) and rms(d - mean d) /
rms(pot_direct).  Paths: box (slice 2, newton_yukawa TreePM), tab (slice
4b, the yukawa preset), ewald (slice 4a, newton_yukawa pure tree), stock
(13c, newton pure tree), glass (phase 10a, MAKEGLASS).  --jax-only skips
the port's run (the oracle then takes JAX's particle state).  Imports JAX:
run it on the CPU, not on the card.
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
from ngravs_tpu_torch.ops import lattice  # noqa: E402


def main(which: str, ns: int, steps: int, density: str,
         packages=("jax", "port")):
    cs.BOX_NSIDE = cs.GLASS_NSIDE = ns
    if density == "card":
        # the card's particle spacing, softening, mesh cell and Yukawa
        # lengths in a box cut to NSIDE / 64 of its side
        cs.BOX_SIZE = 50000.0 * ns / 64
    cs.ORACLE_TARGETS = min(cs.ORACLE_TARGETS, 2 * ns ** 3)
    run_dir = tempfile.mkdtemp(prefix=f"pot_{which}_{ns}_")
    if which == "glass":
        param = cs.write_glass_box(run_dir)
        kw = dict(pmgrid=2 * ns, pm_interlace=True, make_glass=1)
    else:
        param = cs.write_cosmo_box(run_dir)
        kw = {"box": dict(pmgrid=2 * ns, n_gravs=2, wiring="newton_yukawa",
                          pm_interlace=True),
              "tab": dict(pmgrid=2 * ns, n_gravs=2, wiring="yukawa",
                          pm_interlace=True),
              "ewald": dict(n_gravs=2, wiring="newton_yukawa", solver="tree",
                            type_of_opening_criterion=0),
              "stock": dict(n_gravs=2, wiring="newton", solver="tree",
                            type_of_opening_criterion=0)}[which]
    pots = {}
    for name, read, sim_cls, extra in (("jax", j_read, JSim, {}),
                                       ("port", t_read, TSim,
                                        {"device": "cpu"})):
        if name not in packages:
            continue
        cfg = read(param, **kw)
        t0 = time.time()
        sim = sim_cls(cfg, log_dir="", **extra)
        for _ in range(steps):
            sim.step()
        sim.update_full_potential()
        pots[name] = torch.as_tensor(np.asarray(sim.p.potential))
        print(f"{name}: {steps} steps to ti {sim.ti_current}, "
              f"{time.time() - t0:.1f} s", flush=True)
    # the oracle's particles: the port's state, else JAX's
    tsim = sim if "port" in packages else TSim(t_read(param, **kw),
                                               log_dir="", device="cpu")
    if "port" not in packages:
        tsim.p = tsim.p.replace(
            pos=torch.as_tensor(np.asarray(sim.p.pos)),
            grav=torch.as_tensor(np.asarray(sim.p.grav)))
    sim = tsim
    p, cfg = sim.p, sim.cfg
    tabs = lattice.build_lattice_tables(sim.wiring, cfg.ngravs_en,
                                        cfg.box_size)
    idx = cs.oracle_targets(p.n, "cpu")
    pot_d = cs.potential_oracle(sim.wiring, sim.force_soft, sim.units.G, p,
                                idx, cfg.box_size, tabs)
    if len(pots) == 2:
        jp, tp = pots["jax"], pots["port"]
        print(f"port against JAX: max|dpot| / max|pot| "
              f"{float((jp - tp).abs().max() / jp.abs().max()):.3e}")
    for name, pot in pots.items():
        for g, m, e in cs.periodic_pot_errors(pot[idx.long()], pot_d,
                                              p.grav[idx.long()],
                                              cfg.n_gravs):
            size = f"{ns}^3" if which == "glass" else f"2 x {ns}^3"
            print(f"{which} {size} ({density} density) {name} gravity "
                  f"{g}: mean(d) {m:.6e},"
                  f" rms(d - mean d) / rms(pot_direct) {e:.6e}", flush=True)


if __name__ == "__main__":
    torch.set_num_threads(3)
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    main(args[0], int(args[1]), int(args[2]) if len(args) > 2 else 2,
         "card" if "--card-density" in sys.argv else "box",
         ("jax",) if "--jax-only" in sys.argv else ("jax", "port"))
