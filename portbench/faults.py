"""Faults planted in the port underneath a run, to show that the check
comes out not correct on each.  The benchmark's own runs never plant one;
`calibrate.py --fault <name>` and the CPU tests do.

Each fault is a context manager taking the cell (whose files it may
change for the program only) that patches the port while it is open:

- `unchanged_state`: every step after the first three returns the state
  unchanged;
- `half_the_sources`: the gravity solve sees the particles of odd id with
  no mass and the rest at double mass (half of the sum left out, the mean
  taken over the rest);
- `altered_forces`: the kicked particles' accelerations reversed where the
  solver produces them;
- `drift_skipped`: the drift leaves the positions where they were;
- `pm_left_out`: the PM solve returns no force;
- `yukawa_as_newton`: the program runs the `newton` wiring where the
  configuration states `newton_yukawa` (every law Newton).

The cells run on one card, so no exchange between chips exists to leave
out.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(obj, attr, new):
    old = getattr(obj, attr)
    setattr(obj, attr, new)
    try:
        yield
    finally:
        setattr(obj, attr, old)


def unchanged_state(cell):
    from ngravs_tpu_torch.integrate.runner import Simulation
    real = Simulation.step
    calls = {"n": 0}

    def step(self):
        calls["n"] += 1
        if calls["n"] <= 3:
            real(self)
    return _patched(Simulation, "step", step)


def half_the_sources(cell):
    from ngravs_tpu_torch.ops.solver import GravitySolver
    real = GravitySolver.compute

    def compute(self, p, *a, **kw):
        keep = (p.pid % 2 == 0).to(p.mass.dtype)
        p2, n_ia, tree = real(self, p.replace(mass=p.mass * keep * 2.0),
                              *a, **kw)
        return p2.replace(mass=p.mass), n_ia, tree
    return _patched(GravitySolver, "compute", compute)


def altered_forces(cell):
    from ngravs_tpu_torch.ops.solver import GravitySolver
    real = GravitySolver.compute

    def compute(self, p, ti_current, *a, **kw):
        p2, n_ia, tree = real(self, p, ti_current, *a, **kw)
        act = (p.ti_endstep == ti_current)[:, None]
        return p2.replace(accel=torch.where(act, -p2.accel, p2.accel)), \
            n_ia, tree
    return _patched(GravitySolver, "compute", compute)


def drift_skipped(cell):
    from ngravs_tpu_torch.integrate.runner import Simulation
    real = Simulation._drift_to

    def drift_to(self, ti1):
        pos = self.p.pos
        real(self, ti1)
        self.p = self.p.replace(pos=pos)
    return _patched(Simulation, "_drift_to", drift_to)


def pm_left_out(cell):
    from ngravs_tpu_torch.ops.solver import GravitySolver

    def pm_forces(self, p):
        return torch.zeros_like(p.pos)
    return _patched(GravitySolver, "pm_forces", pm_forces)


@contextlib.contextmanager
def yukawa_as_newton(cell):
    port = cell.config["port"]
    old = dict(port)
    port["wiring"] = "newton"
    try:
        yield
    finally:
        port.clear()
        port.update(old)


FAULTS = {f.__name__: f for f in (
    unchanged_state, half_the_sources, altered_forces, drift_skipped,
    pm_left_out, yukawa_as_newton)}
