"""Command-line entry point:

    python -m ngravs_tpu_torch.run <paramfile> [0|1|2] [--device cuda|cpu]
        [--devices K [--backend nccl|gloo]]

Port of `ngravs_tpu/run.py` (reference main.c:39-54): restartflag 0 starts
from the ICs, 1 resumes from the restart file in OutputDir, 2 starts from
the last snapshot in OutputDir.  The run is on the CUDA card unless
`--device cpu` asks for the CPU; without a card it raises.

`--devices K` is the `mpirun -n K` analog: K ranks on this host, spawned
processes over `torch.distributed` running `parallel.runner.
DistributedSimulation` (collisionless).  On the card rank r takes cuda:r
over NCCL; `--backend gloo` lets K ranks share fewer cards; `--device cpu`
runs the ranks on the CPU over gloo.  The first line names the backend.
"""

from __future__ import annotations

import glob
import os
import re
import sys

from .config import read_parameter_file, write_usedvalues
from .integrate.runner import Simulation


def _take(argv, flag, choices=None):
    """Remove `flag VALUE` from argv; the value, None when absent, or
    ValueError when it is missing or not one of `choices`."""
    if flag not in argv:
        return None
    k = argv.index(flag)
    if k + 1 >= len(argv) or (choices and argv[k + 1] not in choices):
        raise ValueError(f"{flag} takes "
                         + (" or ".join(choices) if choices else "a value"))
    value = argv[k + 1]
    del argv[k:k + 2]
    return value


def main(argv=None):
    argv = list(argv) if argv is not None else sys.argv[1:]
    try:
        devices = _take(argv, "--devices")
        backend = _take(argv, "--backend", ("nccl", "gloo"))
    except ValueError as e:
        print(e, file=sys.stderr)
        return 1
    device = "cuda"
    if "--device" in argv:
        k = argv.index("--device")
        if k + 1 >= len(argv) or argv[k + 1] not in ("cuda", "cpu"):
            print("--device takes cuda or cpu", file=sys.stderr)
            return 1
        device = argv[k + 1]
        del argv[k:k + 2]
    if not argv:
        print("usage: python -m ngravs_tpu_torch.run <parameterfile> "
              "[restartflag] [--device cuda|cpu] [--devices K "
              "[--backend nccl|gloo]]", file=sys.stderr)
        return 1
    paramfile = argv[0]
    restartflag = int(argv[1]) if len(argv) > 1 else 0
    cfg = read_parameter_file(paramfile)
    if devices is not None:
        from .parallel.mesh import default_backend
        backend = backend or default_backend(device)
        return _main_distributed(paramfile, restartflag, int(devices),
                                 device, backend)
    try:
        # parameter echo (begrun.c:619): <paramfile>-usedvalues
        write_usedvalues(cfg, paramfile + "-usedvalues")
    except OSError:
        pass  # read-only parameterfile location
    if cfg.output_dir:
        try:
            # copy of the echo into the output dir (begrun.c:678-681)
            os.makedirs(cfg.output_dir, exist_ok=True)
            write_usedvalues(cfg, os.path.join(
                cfg.output_dir, os.path.basename(paramfile) + "-usedvalues"))
        except OSError:
            pass
    if restartflag == 1:
        # resume from restart files (main.c:47-50, restart.c:35)
        sim = Simulation(cfg, device=device)
        sim.resume()
    elif restartflag == 2:
        # start fresh from the last snapshot (init.c:84-85)
        snaps = sorted(glob.glob(
            f"{cfg.output_dir}/{cfg.snapshot_file_base}_*"))
        if not snaps:
            print("no snapshot found for RestartFlag=2", file=sys.stderr)
            return 1
        sim = Simulation(cfg, ic_path=snaps[-1], device=device)
        sim.snapshot_count = len(snaps)
    else:
        sim = Simulation(cfg, device=device)
    print(f"ngravs_tpu_torch: {sim.p.n} particles on {sim.device}, "
          f"n_gravs={cfg.n_gravs}, wiring={cfg.wiring}, "
          f"t in [{cfg.time_begin}, {cfg.time_max}]")
    steps = sim.run()
    print(f"done: {steps} steps, {sim.snapshot_count} snapshots, "
          f"final time {sim.time:.6g}")
    sim.close()
    return 0


def _last_snapshot(cfg):
    """The newest snapshot set in OutputDir (its base name), or None."""
    snaps = sorted({re.sub(r"(\.\d+)?(\.hdf5)?$", "", f) for f in glob.glob(
        f"{cfg.output_dir}/{cfg.snapshot_file_base}_*")})
    return snaps[-1] if snaps else None


def _rank_main(mesh, paramfile: str, restartflag: int):
    """One rank of a `--devices K` run."""
    from .integrate.runner import load_initial_conditions
    from .io.gadget_format import read_snapshot_set
    from .parallel.runner import GAS_REFUSAL, DistributedSimulation
    from .particles import Particles
    from .units import set_units
    cfg = read_parameter_file(paramfile)
    units = set_units(cfg)
    sph = None
    if restartflag == 2:
        # the newest snapshot set, as an IC (init.c:84-85)
        snap = read_snapshot_set(_last_snapshot(cfg))
        if snap.header.npart[0]:
            raise NotImplementedError(GAS_REFUSAL)
        vel = snap.vel * (cfg.time_begin ** 1.5
                          if cfg.comoving_integration else 1.0)
        p = Particles.create(snap.pos, vel, snap.mass, snap.pid, snap.ptype,
                             cfg.type_to_grav, device="cpu")
    else:
        p, sph = load_initial_conditions(cfg, units, device="cpu")
    sim = DistributedSimulation(cfg, p, sph=sph, mesh=mesh)
    if restartflag == 1:
        # resume from the multi-device restart file (restart.c:35)
        sim.resume()
    if mesh.rank == 0:
        print(f"ngravs_tpu_torch: {sim.n_real} particles over {mesh.size} "
              f"ranks ({mesh.backend}, {mesh.device}), n_gravs="
              f"{cfg.n_gravs}, wiring={cfg.wiring}, t in "
              f"[{cfg.time_begin}, {cfg.time_max}]", flush=True)
    steps = sim.run()
    if mesh.rank == 0:
        print(f"done: {steps} steps, {sim.snapshot_count} snapshots, "
              f"final time {sim.time:.6g}", flush=True)
    sim.close()


def _main_distributed(paramfile: str, restartflag: int, devices: int,
                      device: str, backend: str):
    """The `mpirun -n K` analog: K spawned ranks on this host."""
    from .parallel.mesh import check_launch, launch
    check_launch(devices, device, backend)
    cfg = read_parameter_file(paramfile)
    if restartflag == 2 and _last_snapshot(cfg) is None:
        print("no snapshot found for RestartFlag=2", file=sys.stderr)
        return 1
    print(f"ngravs_tpu_torch: --devices {devices} over {backend} on "
          f"{device}", flush=True)
    launch(_rank_main, devices, backend=backend, device=device,
           args=(paramfile, restartflag))
    return 0


if __name__ == "__main__":
    sys.exit(main())
