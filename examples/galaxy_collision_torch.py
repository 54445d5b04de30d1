"""The reference's shipped example on the PyTorch port: two colliding
galaxies, 60k particles, the N_GRAVS=2 stock (all-Newton) wiring —
`GalaxyCollision.IC` + `Configuration.reference` (README.md:30-32).

    python examples/galaxy_collision_torch.py [--steps N] [--out DIR]
        [--paramfile P --ic IC] [--n N] [--device cuda|cpu]
        [--devices K [--backend nccl|gloo]]

With the reference's parameterfile and IC (`--paramfile`, `--ic`) it runs
them unmodified.  Without them, or when they are absent, it says so and
builds the synthetic GalaxyCollision-shaped IC of `chip_smoke.py` (two
Plummer spheres on a collision orbit, the reference's per-type counts;
`--n` scales the counts down).  With no --steps it integrates to TimeMax.
The run is on the CUDA card unless `--device cpu` asks for the CPU;
`--devices K` runs K ranks (`parallel.runner.DistributedSimulation`), as
`python -m ngravs_tpu_torch.run --devices K` does.
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def synthetic_param(out: str, n: int) -> str:
    """The synthetic IC and its parameterfile in `out`, the reference's
    per-type counts scaled to about n particles."""
    from chip_smoke import NPART, write_galaxy_collision
    total = sum(NPART)
    counts = tuple(c * n // total for c in NPART)
    return write_galaxy_collision(out, npart=counts)


def _rank(mesh, param: str, overrides: dict, steps: int):
    """One rank of a --devices K run."""
    from ngravs_tpu_torch.config import read_parameter_file
    from ngravs_tpu_torch.integrate.runner import load_initial_conditions
    from ngravs_tpu_torch.parallel.runner import DistributedSimulation
    from ngravs_tpu_torch.units import set_units
    cfg = read_parameter_file(param, **overrides)
    p, _ = load_initial_conditions(cfg, set_units(cfg), device="cpu")
    sim = DistributedSimulation(cfg, p, mesh=mesh)
    t0 = time.time()
    sim.run(max_steps=steps or None)
    dt = time.time() - t0
    if mesh.rank == 0:
        print(f"done: t={sim.time:.4f} steps={sim.step_count} "
              f"snapshots={sim.snapshot_count} ranks={mesh.size} "
              f"({sim.num_force_updates / max(dt, 1e-9):.0f} "
              "particle-steps/s)")
    sim.close()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=0,
                    help="stop after N steps (0 = run to TimeMax)")
    ap.add_argument("--out", default="galaxy_collision_out",
                    help="output directory (snapshots + logs)")
    ap.add_argument("--paramfile", default=None,
                    help="the reference's Configuration.reference")
    ap.add_argument("--ic", default=None,
                    help="the reference's GalaxyCollision.IC")
    ap.add_argument("--n", type=int, default=60000,
                    help="particles of the synthetic IC")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--devices", type=int, default=0,
                    help="run K ranks (0: one device, no ranks)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    args = ap.parse_args()

    from ngravs_tpu_torch.config import read_parameter_file
    from ngravs_tpu_torch.integrate.runner import Simulation

    os.makedirs(args.out, exist_ok=True)
    have = [f for f in (args.paramfile, args.ic) if f]
    if len(have) == 2 and all(os.path.exists(f) for f in have):
        param = args.paramfile
        overrides = dict(init_cond_file=args.ic, output_dir=args.out)
    else:
        print("reference parameterfile / IC "
              + (f"not found ({', '.join(have)})" if have else "not given")
              + f": building the synthetic {args.n}-particle "
              "GalaxyCollision-shaped IC", flush=True)
        param = synthetic_param(args.out, args.n)
        overrides = dict(output_dir=args.out)
    if args.devices:
        from ngravs_tpu_torch.parallel.mesh import launch
        launch(_rank, args.devices, device=args.device, backend=args.backend,
               args=(param, overrides, args.steps))
        return
    cfg = read_parameter_file(param, **overrides)
    sim = Simulation(cfg, device=args.device)
    t0 = time.time()
    sim.run(max_steps=args.steps or None)
    dt = time.time() - t0
    print(f"done: t={sim.time:.4f} steps={sim.step_count} "
          f"snapshots={sim.snapshot_count} "
          f"({sim.num_force_updates / max(dt, 1e-9):.0f} particle-steps/s)")
    sim.close()


if __name__ == "__main__":
    main()
