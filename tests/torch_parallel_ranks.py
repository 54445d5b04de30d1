"""Rank programs for the port's multi-device tests (`test_torch_parallel_*`).

Each function runs in a spawned rank process (`parallel.mesh.launch`,
gloo, CPU, one intra-op thread), reads its inputs from an `.npz` written
by the test, and writes its outputs to `<out>_<rank>.npz` for the test
process to compare.  This module imports the port only, never JAX, so the
ranks start without it.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def run_ranks(fn, world: int, tmp_path, *args, backend="gloo",
              device="cpu") -> list:
    """fn(mesh, out, *args) on `world` ranks (gloo on the CPU unless asked
    otherwise), met at a file store in tmp_path; the ranks' outputs, in
    rank order."""
    from ngravs_tpu_torch.parallel.mesh import launch
    tag = f"{fn.__name__}_{world}_{len(os.listdir(tmp_path))}"
    out = os.path.join(str(tmp_path), tag)
    launch(fn, world, backend=backend, device=device,
           init_method=f"file://{out}.store", args=(out,) + args,
           threads=1)
    return [dict(np.load(f"{out}_{r}.npz", allow_pickle=True))
            for r in range(world)]


def save(out: str, mesh, **arrays):
    np.savez(f"{out}_{mesh.rank}.npz", **arrays)


def config(kw):
    from ngravs_tpu_torch.config import SimulationConfig
    return SimulationConfig(**kw)


def particles(inp: dict, cfg):
    from ngravs_tpu_torch.particles import Particles
    return Particles.create(inp["pos"], inp["vel"], inp["mass"], inp["pid"],
                            inp["ptype"], cfg.type_to_grav, device="cpu")


def shard(inp: dict, mesh):
    """This rank's rows of a whole padded particle state."""
    from ngravs_tpu_torch.interop import particle_shard_from_numpy
    return particle_shard_from_numpy(inp, mesh.rank, mesh.size, "cpu")


def stepping_kit(cfg):
    from ngravs_tpu_torch.cosmology import make_tables
    from ngravs_tpu_torch.models.wiring import build_wiring
    from ngravs_tpu_torch.units import set_units
    units = set_units(cfg)
    return units, build_wiring(cfg), make_tables(cfg, units)


# --------------------------------------------------------------------------

def collectives(mesh, out):
    r, k = mesh.rank, mesh.size
    x = torch.arange(3, dtype=torch.float32) + 10 * r
    blocks = torch.arange(k * 2, dtype=torch.int32).reshape(k, 2) + 100 * r
    ints = torch.tensor([r + 5, -r], dtype=torch.int32)
    save(out, mesh, gather=mesh.all_gather(x).numpy(),
         a2a=mesh.all_to_all(blocks).numpy(),
         psum=mesh.psum(x).numpy(), pmin=mesh.pmin(ints).numpy(),
         pmax=mesh.pmax(ints).numpy(),
         flag=mesh.pmax(torch.tensor([r == k - 1])).numpy(),
         up=mesh.ring(x, 1).numpy(), down=mesh.ring(x, -1).numpy())


def direct_step(mesh, out, cfg_kw, inp_path):
    """The direct step on a whole padded state, or on the shard that the
    port's `shard_particles` cuts from particles whose count does not
    split over the ranks."""
    from ngravs_tpu_torch.parallel.mesh import (make_sharded_step,
                                                shard_particles)
    cfg = config(cfg_kw)
    z = dict(np.load(inp_path))
    p = shard(z, mesh) if len(z["pos"]) % mesh.size == 0 \
        else shard_particles(particles(z, cfg), mesh)
    step = make_sharded_step(cfg, *stepping_kit(cfg), mesh)
    p2, min_end = step(p, 0, 0, cfg.time_begin)
    save(out, mesh, accel=p2.accel.numpy(), min_end=int(min_end),
         pid=p2.pid.numpy(), ti_endstep=p2.ti_endstep.numpy())


def dt_displacement(mesh, out, cfg_kw, inp_path):
    from ngravs_tpu_torch.parallel.mesh import sharded_dt_displacement
    cfg = config(cfg_kw)
    p = shard(dict(np.load(inp_path)), mesh)
    units = stepping_kit(cfg)[0]
    save(out, mesh, dt=sharded_dt_displacement(
        cfg, units, p, np.float32(cfg.time_begin), mesh))


def pm_forces(mesh, out, wiring_spec, inp_path, opts, dtype="float32"):
    from ngravs_tpu_torch.models import laws as L
    from ngravs_tpu_torch.models.wiring import GravityWiring
    from ngravs_tpu_torch.ops.pm import PMSolver
    from ngravs_tpu_torch.parallel.pm_sharded import ShardedPMSolver
    box, pmgrid = wiring_spec
    w = GravityWiring([[L.Newtonian(), L.Newtonian()],
                       [L.Newtonian(), L.Yukawa(5.0, box, pmgrid=pmgrid)]])
    pm = PMSolver(w, pmgrid, box, 2, g_const=1.0, **opts)
    z = np.load(inp_path)
    nloc = z["pos"].shape[0] // mesh.size
    sl = slice(mesh.rank * nloc, (mesh.rank + 1) * nloc)
    pos, mass, grav = (torch.as_tensor(z[k][sl]) for k in ("pos", "mass",
                                                          "grav"))
    pos, mass = pos.to(getattr(torch, dtype)), mass.to(getattr(torch, dtype))
    spm = ShardedPMSolver(pm, mesh, 2)
    acc = spm.forces(pos, mass, grav)
    acc2 = spm.forces(pos, mass, grav)
    save(out, mesh, acc=acc.numpy(), pot=spm.potential(pos, mass,
                                                       grav).numpy(),
         repeat=bool(torch.equal(acc, acc2)))


def reshard(mesh, out, inp_path, alloc_factor):
    from ngravs_tpu_torch.parallel.tree_sharded import (reshard_by_cost,
                                                        reshard_by_morton)
    z = dict(np.load(inp_path))
    p = shard(z, mesh)
    p = p.replace(grav_cost=torch.as_tensor(
        z["grav_cost"][mesh.rank * p.n:(mesh.rank + 1) * p.n]))
    pm = reshard_by_morton(p, mesh)
    pc = reshard_by_cost(p, mesh, alloc_factor=alloc_factor)
    save(out, mesh, morton_pid=pm.pid.numpy(), cost_pid=pc.pid.numpy(),
         cost_mass=pc.mass.numpy())


def tree_steps(mesh, out, cfg_kw, inp_path, opening, modes, pm_window):
    """The replicated and the LET step from one Morton-resharded state."""
    from ngravs_tpu_torch.parallel.tree_sharded import (LetTreeStep,
                                                        ReplicatedTreeStep,
                                                        reshard_by_morton)
    cfg = config(cfg_kw)
    kit = stepping_kit(cfg)
    p = reshard_by_morton(shard(dict(np.load(inp_path)), mesh), mesh)
    res = {"pid": p.pid.numpy()}
    ti, pm = pm_window
    extra = (0, ti) if cfg.pmgrid and pm else ()
    for mode in modes:
        make = ReplicatedTreeStep if mode == "rep" else LetTreeStep
        step = make(cfg, *kit, mesh, opening=opening, pm_step=pm)
        r = step(p, 0, ti, cfg.time_begin, *extra)
        res[f"{mode}_acc"] = (r.p.accel + r.p.accel_pm).numpy()
        res[f"{mode}_pm"] = r.p.accel_pm.numpy()
        res[f"{mode}_meta"] = np.array([r.min_end, r.n_active, r.pm_beg,
                                        r.pm_end])
    save(out, mesh, **res)


def simulate(mesh, out, cfg_kw, inp_path, opts):
    """A DistributedSimulation run; opts: steps, use_let, log_dir,
    restart_at (save a restart there, finish, then resume a fresh run from
    it and finish again), snapshot (write one set at the end),
    resume_from (a restart file to start from)."""
    from ngravs_tpu_torch.ops import pairwise
    from ngravs_tpu_torch.parallel.runner import DistributedSimulation
    cfg = config(cfg_kw)
    inp = dict(np.load(inp_path))
    pairwise.reset_counts()

    def make():
        return DistributedSimulation(cfg, particles(inp, cfg), mesh=mesh,
                                     log_dir=opts.get("log_dir", ""),
                                     use_let=opts.get("use_let", False))
    sim = make()
    if opts.get("resume_from"):
        sim.resume(opts["resume_from"])
    res = {}
    syncs = []
    for k in range(opts["steps"]):
        if opts.get("restart_at") == k:
            sim.save_restart(opts["restart_path"])
        sim.step()
        syncs.append((sim.ti_current, sim.pm_ti_begstep, sim.pm_ti_endstep))
    p, _ = sim.gather_ordered()
    res.update(pos=p.pos.numpy(), vel=p.vel.numpy(), pid=p.pid.numpy(),
               accel=p.accel.numpy(), accel_pm=p.accel_pm.numpy(),
               ti_endstep=p.ti_endstep.numpy(),
               ti_begstep=p.ti_begstep.numpy(),
               aphys_old=p.aphys_old.numpy(), syncs=np.array(syncs),
               local_pid=sim.p.pid.cpu().numpy(),
               updates=sim.num_force_updates,
               k1=pairwise.pairwise_eval.launches)
    if cfg.flexsteps:
        res["present"] = np.array([sim.present_min_step,
                                   sim.present_max_step])
    if opts.get("restart_at") is not None:
        again = make()
        again.resume(opts["restart_path"])
        for _ in range(opts["steps"] - opts["restart_at"]):
            again.step()
        q, _ = again.gather_ordered()
        res.update({f"resumed_{k}": getattr(q, k).numpy()
                    for k in ("pos", "vel", "accel", "ti_endstep",
                              "ti_begstep", "old_acc")})
        res.update({f"orig_{k}": getattr(p, k).numpy()
                    for k in ("old_acc",)})
    if opts.get("snapshot"):
        res["snapshot"] = sim.write_snapshot_now(opts["snapshot"])
    save(out, mesh, **res)
