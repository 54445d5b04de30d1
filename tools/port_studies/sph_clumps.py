"""The single device's SPH target blocks on a clumped gas IC, with and
without `HydroSolver.split_level`, on the CPU.

    python tools/port_studies/sph_clumps.py [N_PER_CLUMP]

Two Gaussian gas clumps (N_PER_CLUMP each, 4,000 by default: not a whole
number of 64-target blocks, so that one block of the Morton-sorted gas
takes the end of one clump and the start of the other) 6 sigma apart in
an open box, the stock wiring, DesNumNgb 33 +- 3.  One full force pass
(`Simulation.compute_forces(full=True)`: gravity, the density iteration,
the hydro pass) from the same state with `split_level` None and 3 (the
LET full step's level): the candidate cap and frontier cap it ends with,
the cap growths, the density iterations, the bytes of one candidate
gather (blocks x cand_cap x 4) and the seconds.  Imports no JAX.
"""

import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from ngravs_tpu_torch.config import SimulationConfig  # noqa: E402
from ngravs_tpu_torch.integrate.runner import Simulation  # noqa: E402
from ngravs_tpu_torch.particles import Particles, SphState  # noqa: E402

CFG = dict(time_begin=0.0, time_max=1.0, gravity_constant_internal=1.0,
           softening=(0.02,) * 6, max_size_timestep=0.01, n_gravs=1,
           type_to_grav=(0,) * 6, wiring="newton", des_num_ngb=33,
           max_num_ngb_deviation=3, tree_group_size=256, tree_bucket_size=16,
           tree_depth=8, time_bet_snapshot=0.0, time_of_first_snapshot=1e30,
           time_bet_statistics=0.0)


def clumps(n_clump: int, seed: int = 5):
    """Two gas clumps (sigma 1) at x = -3 and x = +3, u = 1, mass 1 / N."""
    rng = np.random.default_rng(seed)
    pos = np.concatenate([rng.normal(0, 1.0, (n_clump, 3)) + [-3, 0, 0],
                          rng.normal(0, 1.0, (n_clump, 3)) + [3, 0, 0]])
    n = len(pos)
    vel = rng.normal(0, 0.05, (n, 3))
    return (pos.astype(np.float32), vel.astype(np.float32),
            np.full(n, 1.0 / n, np.float32), np.zeros(n, np.int32))


def run(n_clump: int, split_level):
    cfg = SimulationConfig(**CFG)
    pos, vel, mass, ptype = clumps(n_clump)
    n = len(pos)
    p = Particles.create(pos, vel, mass, np.arange(n), ptype,
                         cfg.type_to_grav, device="cpu")
    sph = SphState.zeros(n, "cpu").replace(
        entropy=torch.ones(n, dtype=torch.float32))
    sim = Simulation(cfg, particles=p, sph=sph, log_dir="", device="cpu")
    sim.hydro.split_level = split_level
    t0 = time.time()
    sim.compute_forces(full=True)
    secs = time.time() - t0
    h = sim.hydro
    blocks = sim.hydro._blocks(sim._sph_tree(), sim.p, sim.ti_current,
                               n).shape[0]
    print(f"2 x {n_clump} gas, split_level {split_level}: {blocks} blocks "
          f"of {h.group}, cand_cap {h.cand_cap}, frontier_cap "
          f"{h.frontier_cap}, cap growths "
          f"{sim.trace.counts.get('sph.cap_growths', 0)}, density "
          f"iterations {sim.trace.counts['sph.density_iters']}, one gather "
          f"{blocks * h.cand_cap * 4 / 2 ** 20:.2f} MiB, {secs:.1f} s; "
          f"median density {float(sim.sph.density.median()):.5g}",
          flush=True)
    return sim


if __name__ == "__main__":
    torch.set_num_threads(2)
    k = int(sys.argv[1]) if len(sys.argv) > 1 else 4000
    a, b = run(k, None), run(k, 3)
    rel = lambda f: float(((getattr(a.sph, f) - getattr(b.sph, f)).abs()
                           / getattr(a.sph, f).abs().clamp(min=1e-30))
                          .max())
    print(f"split against unsplit: density {rel('density'):.3e}, hsml "
          f"{rel('hsml'):.3e} (max relative)", flush=True)
