"""The cosmological comoving TreePM + SPH box on the PyTorch port:
multi-species gravity (Newton + Yukawa), the periodic PM mesh, adiabatic
gas, a: 0.1 -> 1.0, in standard Gadget units (kpc/h, 1e10 Msun/h, km/s).

    python examples/cosmological_box_torch.py [--n-side 16] [--steps N]
        [--box L] [--pmgrid G] [--out DIR] [--device cuda|cpu]
        [--devices K [--backend nccl|gloo]]

ICs are a jittered lattice with masses matching Omega0 (check_omega,
init.c:181-208), as in examples/cosmological_box.py; for production runs
feed real ICs via `python -m ngravs_tpu_torch.run <paramfile>`.  The run
is on the CUDA card unless `--device cpu` asks for the CPU.  `--devices K`
runs K ranks (`parallel.runner.DistributedSimulation`, the replicated
full step; the gas u becomes entropy before the first step).
"""

import argparse
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def build(args):
    """(config, particles, gas state) of the box, on the CPU."""
    import torch

    from ngravs_tpu_torch.config import SimulationConfig
    from ngravs_tpu_torch.particles import Particles, SphState
    from ngravs_tpu_torch.units import set_units

    box, ns = args.box, args.n_side
    omega0, omega_b = 1.0, 0.1
    cfg = SimulationConfig(
        comoving_integration=True, omega0=omega0, omega_lambda=0.0,
        omega_baryon=omega_b, hubble_param=1.0,
        time_begin=0.1, time_max=1.0,
        periodic=True, box_size=box, pmgrid=args.pmgrid,
        softening=(box / ns / 30,) * 6, max_size_timestep=0.02,
        err_tol_int_accuracy=0.025,
        n_gravs=2, type_to_grav=(0, 1, 0, 0, 0, 0), wiring="newton_yukawa",
        output_dir=args.out, snapshot_file_base="snapshot",
        time_bet_snapshot=0.1, time_of_first_snapshot=0.2,
        time_bet_statistics=0.05)
    rng = np.random.default_rng(42)
    g = (np.stack(np.meshgrid(*[np.arange(ns)] * 3, indexing="ij"), -1)
         .reshape(-1, 3) + 0.5) / ns * box
    n = len(g)
    gas = np.mod(g + rng.normal(0, 0.02 * box / ns, g.shape), box)
    dm = np.mod(g + rng.normal(0, 0.02 * box / ns, g.shape)
                + 0.5 * box / ns, box)
    pos = np.concatenate([gas, dm]).astype(np.float32)
    vel = rng.normal(0, 1.0, pos.shape).astype(np.float32)
    ptype = np.concatenate([np.zeros(n, np.int32), np.ones(n, np.int32)])
    units = set_units(cfg)
    rhocrit = 3 * units.hubble ** 2 / (8 * math.pi * units.G)
    m_tot = omega0 * rhocrit * box ** 3
    mass = np.concatenate([
        np.full(n, omega_b / omega0 * m_tot / n),
        np.full(n, (omega0 - omega_b) / omega0 * m_tot / n)]) \
        .astype(np.float32)
    p = Particles.create(pos, vel, mass, np.arange(2 * n), ptype,
                         cfg.type_to_grav, device="cpu")
    sph = SphState.zeros(2 * n, "cpu")
    sph = sph.replace(entropy=torch.full((2 * n,), 1.0))   # u, (km/s)^2
    return cfg, p, sph


def _rank(mesh, args):
    """One rank of a --devices K run."""
    from ngravs_tpu_torch.parallel.runner import DistributedSimulation
    cfg, p, sph = build(args)
    sim = DistributedSimulation(cfg, p, sph=sph, mesh=mesh,
                                entropy_is_u=True)
    t0 = time.time()
    sim.run(max_steps=args.steps or None)
    dt = time.time() - t0
    if mesh.rank == 0:
        print(f"done: a={sim.time:.4f} steps={sim.step_count} "
              f"ranks={mesh.size} "
              f"({sim.num_force_updates / max(dt, 1e-9):.0f} "
              "particle-steps/s)")
    sim.close()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-side", type=int, default=16)
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--box", type=float, default=10000.0, help="kpc/h")
    ap.add_argument("--pmgrid", type=int, default=64)
    ap.add_argument("--out", default="cosmo_box_out")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--devices", type=int, default=0,
                    help="run K ranks (0: one device, no ranks)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    args = ap.parse_args()

    from ngravs_tpu_torch.integrate.runner import Simulation

    os.makedirs(args.out, exist_ok=True)
    if args.devices:
        from ngravs_tpu_torch.parallel.mesh import launch
        launch(_rank, args.devices, device=args.device,
               backend=args.backend, args=(args,))
        return
    cfg, p, sph = build(args)
    sim = Simulation(cfg, particles=p.to(args.device), sph=sph,
                     device=args.device)
    t0 = time.time()
    sim.run(max_steps=args.steps or None)
    dt = time.time() - t0
    print(f"done: a={sim.time:.4f} steps={sim.step_count} "
          f"({sim.num_force_updates / max(dt, 1e-9):.0f} particle-steps/s)")
    sim.close()


if __name__ == "__main__":
    main()
