"""Command-line entry point:

    python -m ngravs_tpu_torch.run <paramfile> [0|2] [--device cuda|cpu]

Port of `ngravs_tpu/run.py` (reference main.c:39-54): restartflag 0 starts
from the ICs, 2 from the last snapshot in OutputDir.  The run is on the
CUDA card unless `--device cpu` asks for the CPU; without a card it
raises.  Restartflag 1 (resume from restart files) and the JAX package's
multi-device `--devices K` are not yet ported and raise.
"""

from __future__ import annotations

import glob
import os
import sys

from .config import read_parameter_file, write_usedvalues
from .integrate.runner import Simulation


def main(argv=None):
    argv = list(argv) if argv is not None else sys.argv[1:]
    if "--devices" in argv:
        raise NotImplementedError(
            "--devices (multi-device runs) is not yet ported to "
            "ngravs_tpu_torch (ROADMAP Queue 1 item 18)")
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
              "[restartflag] [--device cuda|cpu]", file=sys.stderr)
        return 1
    paramfile = argv[0]
    restartflag = int(argv[1]) if len(argv) > 1 else 0
    if restartflag == 1:
        raise NotImplementedError(
            "restartflag 1 (resume from restart files) is not yet ported "
            "to ngravs_tpu_torch (ROADMAP Queue 1 item 10)")
    cfg = read_parameter_file(paramfile)
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
    if restartflag == 2:
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


if __name__ == "__main__":
    sys.exit(main())
