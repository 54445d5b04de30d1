"""The single device's SPH target blocks on clumped gas, against the JAX
package, on the CPU.

Two gas clumps whose gas is not a whole number of 64-target blocks: in
Morton order one block would take the end of one clump and the start of
the other, and its neighbour walk would span the gap between them.  The
port's `HydroSolver` keeps its blocks within cells of level `SPLIT_LEVEL`
(as the LET full step's always did): with the blocks as the sorted order
gives them (`split_level = None`) the density pass grows the candidate cap
of every block to at least twice what the split blocks need (from a cap of
128, grown where a block overflows it: 4,096 against 2,048 here).  One
full force pass (gravity, the density iteration, the hydro pass) from the
same state in each package: density and Hsml within 1e-5 relative, the
tolerance of tests/test_torch_sph_runs.py.
"""

import numpy as np
import torch
import jax.numpy as jnp

from ngravs_tpu.config import SimulationConfig as JConfig
from ngravs_tpu.integrate.runner import Simulation as JSimulation
from ngravs_tpu.particles import Particles as JParticles
from ngravs_tpu.particles import SphState as JSph

from ngravs_tpu_torch.config import SimulationConfig as TConfig
from ngravs_tpu_torch.integrate.runner import Simulation as TSimulation
from ngravs_tpu_torch.interop import particles_from_numpy, sph_from_numpy
from ngravs_tpu_torch.ops.sph import SPLIT_LEVEL

from test_torch_sph_runs import SPH_FIELDS, _np

torch.set_num_threads(1)

CFG = dict(time_begin=0.0, time_max=1.0, gravity_constant_internal=1.0,
           softening=(0.02,) * 6, max_size_timestep=0.01, n_gravs=1,
           type_to_grav=(0,) * 6, wiring="newton", des_num_ngb=33,
           max_num_ngb_deviation=3, tree_group_size=256, tree_bucket_size=16,
           tree_depth=8, time_bet_snapshot=0.0, time_of_first_snapshot=1e30,
           time_bet_statistics=0.0, solver="direct")


def _clumps(n_clump=1000, seed=5):
    """Two gas clumps (sigma 1) at x = -3 and +3 (tools/port_studies/
    sph_clumps.py); u = 1."""
    rng = np.random.default_rng(seed)
    pos = np.concatenate([rng.normal(0, 1.0, (n_clump, 3)) + [-3, 0, 0],
                          rng.normal(0, 1.0, (n_clump, 3)) + [3, 0, 0]])
    n = len(pos)
    return (pos.astype(np.float32),
            rng.normal(0, 0.05, (n, 3)).astype(np.float32),
            np.full(n, 1.0 / n, np.float32), np.zeros(n, np.int32))


def test_clumped_gas_blocks_match_jax():
    pos, vel, mass, ptype = _clumps()
    n = len(pos)
    assert (n // 2) % 64 != 0
    jc = JConfig(**CFG)
    jp = JParticles.create(pos, vel, mass, np.arange(n), ptype,
                           jc.type_to_grav)
    jsph = JSph.zeros(n).replace(entropy=jnp.ones(n, jnp.float32),
                                 vel_pred=jnp.asarray(vel))
    js = JSimulation(jc, particles=jp, sph=jsph, log_dir="")
    caps = {}
    for split in (None, SPLIT_LEVEL):
        ts = TSimulation(TConfig(**CFG), particles=particles_from_numpy(
            _np(jp), "cpu"), sph=sph_from_numpy(_np(jsph, SPH_FIELDS),
                                                "cpu"),
            log_dir="", device="cpu")
        assert ts.hydro.split_level == SPLIT_LEVEL
        ts.hydro.split_level = split
        ts.hydro.cand_cap = 128               # grown where it overflows
        if split is None:
            # the density iteration alone
            ts.hydro.density(ts._sph_tree(), ts.p, ts.sph, ts.ti_current,
                             n, ts.solver.depth, float(ts.tbi))
        else:
            ts.compute_forces(full=True)
        caps[split] = ts.hydro.cand_cap
    js.compute_forces(full=True)
    # the unsplit blocks grow the candidate cap for every block
    assert caps[None] >= 2 * caps[SPLIT_LEVEL], caps
    for name in ("density", "hsml"):
        w = np.asarray(getattr(js.sph, name))
        np.testing.assert_allclose(getattr(ts.sph, name).numpy(), w,
                                   rtol=1e-5, atol=1e-7 * np.abs(w).max(),
                                   err_msg=name)
    assert (ts.sph.density.numpy() > 0).all()
