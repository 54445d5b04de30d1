"""Two-particle radial force-law probe (the port's analog of the repo's
utilities/rdep.py, itself a rebuild of the reference's utilities/rdep.py):
a test particle at a range of separations from a central one, and the
force the solver recovers (the direct sweep, plus PM where enabled) beside
the Newtonian expectation, to check a wired force law.

    python -m ngravs_tpu_torch.utilities.rdep [--wiring newton] [--pmgrid 0]
        [--box 10000] [--points 32] [--rmin 1] [--rmax 3000]
        [--device cuda|cpu]

Runs on the CUDA card unless `--device cpu` asks for the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np

TWO_GRAV = ("yukawa", "newton_yukawa", "bam")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--wiring", default="newton")
    ap.add_argument("--pmgrid", type=int, default=0)
    ap.add_argument("--box", type=float, default=10000.0)
    ap.add_argument("--points", type=int, default=32)
    ap.add_argument("--rmin", type=float, default=1.0)
    ap.add_argument("--rmax", type=float, default=3000.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from ..config import SimulationConfig
    from ..integrate.runner import Simulation
    from ..particles import Particles

    box = args.box
    two = args.wiring in TWO_GRAV
    cfg = SimulationConfig(
        time_begin=0.0, time_max=1.0, gravity_constant_internal=1.0,
        softening=(args.rmin / 4,) * 6, max_size_timestep=0.01,
        periodic=args.pmgrid > 0, box_size=box if args.pmgrid > 0 else 0.0,
        pmgrid=args.pmgrid, n_gravs=2 if two else 1,
        type_to_grav=(0, 0, 1, 0, 0, 0) if two else (0,) * 6,
        time_bet_snapshot=0.0, time_of_first_snapshot=1e30,
        time_bet_statistics=0.0, wiring=args.wiring, ngravs_en=32,
        solver="direct")

    rs = np.logspace(np.log10(args.rmin), np.log10(args.rmax), args.points)
    print("# r   |F_solver|   |F_expected_newton|")
    c = box / 2 if args.pmgrid > 0 else 0.0
    rows = []
    for r in rs:
        pos = np.array([[c, c, c], [c + r, c, c]], np.float32)
        p = Particles.create(pos, np.zeros((2, 3), np.float32),
                             np.array([1000.0, 1e-6], np.float32),
                             [1, 2], [1, 2], cfg.type_to_grav,
                             device=args.device)
        sim = Simulation(cfg, particles=p, log_dir="", device=args.device)
        sim.compute_forces(full=True)
        a = sim.p.accel[1]
        if args.pmgrid:
            a = a + sim.p.accel_pm[1]
        a = float(np.linalg.norm(a.cpu().numpy()))
        rows.append((float(r), a))
        print(f"{r:.6g} {a:.6g} {1000.0 / r ** 2:.6g}")
    return rows


if __name__ == "__main__":
    main()
