"""TreePM force-accuracy harness (the port's analog of the repo's
utilities/tpmfp.py, a rebuild of the reference's utilities/tpmfp.py):
random particles around a massive central one, the solver's forces (tree
or TreePM) against the exact periodic direct sum (`force_test`), and the
RMS relative error in log bins of the distance from the centre, across
the tree/PM transition (the plot utilities/tpmfp.gpt drew).

    python -m ngravs_tpu_torch.utilities.tpmfp [--pmgrid 64] [--n 4096]
        [--box 10000] [--real 4] [--bins 24] [--gradient fd4|spectral]
        [--en 32] [--asmth 0] [--interlace] [--cenm 1e6]
        [--device cuda|cpu] [--cpu]

Runs on the CUDA card unless `--device cpu` (or `--cpu`) asks for the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pmgrid", type=int, default=64)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--box", type=float, default=10000.0)
    ap.add_argument("--real", type=int, default=4, help="realizations")
    ap.add_argument("--bins", type=int, default=24)
    ap.add_argument("--gradient", default="fd4", choices=("fd4", "spectral"),
                    help="PM k-space gradient (spectral = exact ik)")
    ap.add_argument("--en", type=int, default=32,
                    help="Ewald oracle table resolution (NGRAVS_EN)")
    ap.add_argument("--asmth", type=float, default=0.0,
                    help="override Asmth (grid cells); 0 = default 1.25")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--cpu", action="store_true",
                    help="the CPU (the same as --device cpu)")
    ap.add_argument("--interlace", action="store_true",
                    help="enable PM grid interlacing")
    ap.add_argument("--cenm", type=float, default=1e6,
                    help="central mass (reference tpmfp.py:68-69: testm=1, "
                         "cenm=1e6 so the central force dominates and the "
                         "binned error probes the solver, not shot noise)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device

    from ..config import SimulationConfig
    from ..diagnostics.forcetest import force_test, rms_error
    from ..integrate.runner import Simulation
    from ..particles import Particles

    box = args.box
    samples_r, samples_e = [], []
    for real in range(args.real):
        rng = np.random.default_rng(100 + real)
        cfg = SimulationConfig(
            time_begin=0.0, time_max=1.0, gravity_constant_internal=1.0,
            softening=(box / 3000,) * 6, max_size_timestep=0.01,
            periodic=True, box_size=box, pmgrid=args.pmgrid,
            time_bet_snapshot=0.0, time_of_first_snapshot=1e30,
            time_bet_statistics=0.0, wiring="newton", ngravs_en=args.en,
            pm_gradient=args.gradient, pm_interlace=args.interlace,
            **({"asmth": args.asmth} if args.asmth else {}))
        # a random realization around a massive centre (tpmfp.py:86-116)
        n = args.n
        pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
        pos[0] = box / 2
        mass = np.full(n, 1.0, np.float32)
        mass[0] = args.cenm
        p = Particles.create(pos, np.zeros((n, 3), np.float32), mass,
                             np.arange(n), np.ones(n, np.int32),
                             cfg.type_to_grav, device=device)
        sim = Simulation(cfg, particles=p, log_dir="", device=device)
        sim.compute_forces(full=True)
        idx, _, _, rel = force_test(sim, fraction=0.25, write=False)
        r = np.linalg.norm(sim.p.pos.cpu().numpy()[idx] - box / 2, axis=1)
        samples_r.append(r)
        samples_e.append(rel)
        print(f"# realization {real}: {rms_error(rel)}")

    r = np.concatenate(samples_r)
    e = np.concatenate(samples_e)
    lo, hi = np.log10(max(r.min(), 1e-3)), np.log10(r.max())
    edges = np.logspace(lo, hi, args.bins + 1)
    print("# r_mid  rms_rel_err  count")
    rows = []
    for i in range(args.bins):
        m = (r >= edges[i]) & (r < edges[i + 1])
        if m.sum() == 0:
            continue
        rows.append((float(np.sqrt(edges[i] * edges[i + 1])),
                     float(np.sqrt((e[m] ** 2).mean())), int(m.sum())))
        print(f"{rows[-1][0]:.6g} {rows[-1][1]:.6g} {rows[-1][2]}")
    return rows


if __name__ == "__main__":
    main()
